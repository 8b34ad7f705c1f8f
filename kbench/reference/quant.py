"""Quantizers of the configurations, written from their descriptions in
plain PyTorch: the weights' RTN INT4 with groups of 128 along the input,
the KV cache's INT8 with one absmax scale per (token, head), and the
lower precisions the controls compute in (INT4 and FP8 E4M3 products).
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

F32 = torch.float32


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def rtn_int4(w: torch.Tensor, group: int = 128) -> torch.Tensor:
    """w [K, N] -> its symmetric RTN INT4 values (float32): per column and
    group of ``group`` input rows, scale = absmax / 7, codes rounded half
    away from zero into [-8, 7]."""
    K, N = w.shape
    g = w.to(F32).reshape(K // group, group, N)
    scale = torch.clamp(g.abs().amax(1, keepdim=True) / 7.0, min=1e-12)
    q = torch.clamp(round_half_away(g / scale), -8, 7)
    return (q * scale).reshape(K, N)


def kv_quant(x: torch.Tensor, qmax: float = 127.0) -> torch.Tensor:
    """x [..., D] through a cache of one absmax scale per row: codes
    rounded half to even into [-qmax - 1, qmax], read back as float32."""
    xf = x.to(F32)
    scale = torch.clamp(xf.abs().amax(-1, keepdim=True) / qmax, min=1e-12)
    return torch.clamp(torch.round(xf / scale), -qmax - 1, qmax) * scale


def fake_int(x: torch.Tensor, qmax: float, dim: int) -> torch.Tensor:
    """Symmetric integer quantization along ``dim`` (one scale per row of
    the other dims), with the straight-through gradient."""
    xf = x.to(F32)
    s = torch.clamp(xf.detach().abs().amax(dim, keepdim=True) / qmax,
                    min=1e-12)
    q = torch.clamp(torch.round(xf / s), -qmax - 1, qmax) * s
    return xf + (q - xf).detach()


def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """FP8 E4M3 with one scale per row along ``dim`` (absmax to 448), with
    the straight-through gradient."""
    xf = x.to(F32)
    s = torch.clamp(xf.detach().abs().amax(dim, keepdim=True) / 448.0,
                    min=1e-12)
    q = (xf / s).to(torch.float8_e4m3fn).to(F32) * s
    return xf + (q - xf).detach()


def lowp_lin(int4_names: Iterable[str]) -> Callable:
    """A projection one precision below the configuration's: INT4 for the
    products it runs in int8 (``int4_names``), FP8 E4M3 for those it runs
    in bf16; activations scaled per row, weights per column."""
    int4 = set(int4_names)

    def lin(x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
        if name in int4:
            return fake_int(x, 7.0, -1) @ fake_int(w, 7.0, 0)
        return fake_fp8(x, -1) @ fake_fp8(w, 0)
    return lin
