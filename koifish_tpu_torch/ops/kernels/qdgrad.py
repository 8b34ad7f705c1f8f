"""Per-tile dynamic-int8 dgrad: the CUDA kernels' wrapper, their plain
versions and the dispatch.

The kernels (``csrc/qdgrad.cu``) replace the JAX package's Pallas
``_dgrad_call`` (``koifish_tpu/ops/pallas/qdgrad.py``, row 11): dx = dy ·
(wq·sw)ᵀ with dy folded by the column scales, quantized per row and per
1024-column tile, and multiplied in int8:

    for each 1024-column tile j:  t = dy_j·sw_j;  sx = max(rowmax|t|·(1/127), 1e-12)
                                  dx += (q8(t)·wq_jᵀ)_int32 · sx

in two launches: a quantize pass (``qdgrad_quant``: dy read once into the
codes q [M, N] int8 and the scales sx [M, N/1024] f32 that the Pallas kernel
forms in VMEM) and a ``wgmma`` s8 GEMM over them (``qdgrad_int8_tile``).

``dgrad_int8_tile_or_none`` keeps the JAX dispatch rule on n % 1024 (the tile
defines the scales); the TPU-only limits on m, k do not carry over. Other n
return None and the caller runs the bf16 dot against the dequantized codes.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.ops.kernels.quantize import int8_dot, quantize_plain
from koifish_tpu_torch.utils import kernel_log

NAME = "qdgrad"
COUNT = "qdgrad_int8_tile"    # launch counter of the GEMM
QUANT = "qdgrad_quant"        # launch counter of the quantize pass
BN = 1024                     # columns of dy per scale tile

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load(NAME)
        quant, gemm = lib.koifish_qdgrad_quant, lib.koifish_qdgrad
        # dy sw q sx | M N | stream
        quant.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + \
            [ctypes.c_void_p]
        # q wq sx dx | M N K | stream
        gemm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        quant.restype = gemm.restype = ctypes.c_int
        _fn = (lib, quant, gemm)
    return _fn


def dgrad_int8_tile_plain(dy: torch.Tensor, wq: torch.Tensor,
                          sw: torch.Tensor) -> torch.Tensor:
    """dx [M, K] bf16 of dy [M, N], wq [K, N] int8, sw [N] (or [1, N]) f32,
    tile by tile as the kernel computes it. The update acc += d·sx is one
    fused multiply-add (as XLA compiles the Pallas kernel), emulated in f64:
    d·sx is exact there and the sum rounds once to f64, then to f32."""
    m, n = dy.shape
    sw = sw.reshape(n).to(torch.float32)
    acc = torch.zeros((m, wq.shape[0]), dtype=torch.float32, device=dy.device)
    for j in range(0, n, BN):
        t = dy[:, j:j + BN].to(torch.float32) * sw[j:j + BN]
        q, sx = quantize_plain(t, 1, "jit")
        d = int8_dot(q, wq[:, j:j + BN].T).to(torch.float64)
        acc = (acc.to(torch.float64) + d * sx.to(torch.float64)
               ).to(torch.float32)
    return acc.to(torch.bfloat16)


def dgrad_quant_plain(dy: torch.Tensor, sw: torch.Tensor):
    """The quantize pass: (q [M, N] int8, sx [M, N/1024] f32), the codes and
    scales of dy [M, N] folded by sw [N] per row and 1024-column tile."""
    m, n = dy.shape
    t = dy.to(torch.float32) * sw.reshape(n).to(torch.float32)
    qs, sxs = zip(*(quantize_plain(t[:, j:j + BN], 1, "jit")
                    for j in range(0, n, BN)))
    return torch.cat(qs, dim=1), torch.cat(sxs, dim=1)


def dgrad_gemm_plain(q: torch.Tensor, wq: torch.Tensor,
                     sx: torch.Tensor) -> torch.Tensor:
    """The GEMM: dx [M, K] bf16 = Σ_j (q_j·wq_jᵀ)_int32 · sx_j over the
    1024-column tiles j in order, each step one fused multiply-add (emulated
    in f64, as ``dgrad_int8_tile_plain``)."""
    m, n = q.shape
    acc = torch.zeros((m, wq.shape[0]), dtype=torch.float32, device=q.device)
    for j in range(n // BN):
        d = int8_dot(q[:, j * BN:(j + 1) * BN], wq[:, j * BN:(j + 1) * BN].T)
        acc = (acc.to(torch.float64) + d.to(torch.float64)
               * sx[:, j:j + 1].to(torch.float64)).to(torch.float32)
    return acc.to(torch.bfloat16)


def dgrad_int8_tile(dy: torch.Tensor, wq: torch.Tensor,
                    sw: torch.Tensor) -> torch.Tensor:
    """dx [M, K] bf16 through the kernel (a CPU tensor takes the plain
    version). dy [M, N] bf16 and wq [K, N] int8 contiguous, N % 1024 == 0."""
    if dy.device.type == "cpu":
        return dgrad_int8_tile_plain(dy, wq, sw)
    m, n = dy.shape
    k = wq.shape[0]
    if wq.shape[1] != n or sw.numel() != n or n % BN:
        raise ValueError(f"qdgrad: dy{tuple(dy.shape)} wq{tuple(wq.shape)} "
                         f"sw{tuple(sw.shape)}: need dy [M, N], wq [K, N], "
                         f"sw [N] with N a multiple of {BN}")
    for name, t, dt in (("dy", dy, torch.bfloat16), ("wq", wq, torch.int8),
                        ("sw", sw, torch.float32)):
        if t.device != dy.device:
            raise ValueError(f"qdgrad: {name} lies on {t.device}, need "
                             f"{dy.device}")
        if t.dtype != dt:
            raise ValueError(f"qdgrad: {name} is {t.dtype}, need {dt}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"qdgrad: {name} must be contiguous and "
                             f"16-byte aligned")
    lib, quant, gemm = _kernel()
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    q = torch.empty((m, n), dtype=torch.int8, device=dy.device)
    sx = torch.empty((m, n // BN), dtype=torch.float32, device=dy.device)
    rc = quant(dy.data_ptr(), sw.data_ptr(), q.data_ptr(), sx.data_ptr(), m, n,
               stream)
    _build.check(lib, rc, f"qdgrad quantize pass dy{tuple(dy.shape)}")
    kernel_log.count(QUANT)
    dx = torch.empty((m, k), dtype=torch.bfloat16, device=dy.device)
    rc = gemm(q.data_ptr(), wq.data_ptr(), sx.data_ptr(), dx.data_ptr(), m, n,
              k, stream)
    _build.check(lib, rc, f"qdgrad dy{tuple(dy.shape)} k={k}")
    kernel_log.count(COUNT)
    return dx


def dgrad_int8_tile_or_none(dy: torch.Tensor, wq: torch.Tensor,
                            sw: torch.Tensor) -> Optional[torch.Tensor]:
    """dx = dy · (wq·sw)ᵀ through the per-tile int8 kernel, or None when n is
    not a multiple of the 1024-column scale tile (the caller runs the bf16
    dequant dot). dy [M, N]; wq [K, N] int8 (forward codes); sw [1, N] f32."""
    m, n = dy.shape
    k = wq.shape[0]
    if n % BN:
        kernel_log.fallback(COUNT, f"m={m} n={n} k={k}: n is not a multiple "
                            f"of {BN} -> bf16 dequant dot")
        return None
    kernel_log.choice(COUNT, f"m={m} n={n} k={k}")
    return dgrad_int8_tile(dy.to(torch.bfloat16).contiguous(),
                           wq.contiguous(),
                           sw.reshape(n).to(torch.float32).contiguous())
