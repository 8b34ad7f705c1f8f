"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/flash_fwd.cu``) replaces the JAX package's Pallas
forward kernels in ``koifish_tpu/ops/pallas/flash.py`` — the column-layout
(``_fwd_cols_single``, ``_flash_cols_fwd_call``) and head-major
(``_fwd_single``, ``_flash_fwd_call``) variants alike: q/k/v arrive as
``[B, T, H, D]`` views with arbitrary strides, so both layouts reach it
without a transpose copy.

Rounding points follow the Pallas kernels: q is scaled in f32 and rounded
to bf16 before QKᵀ, p is rounded to bf16 before PV, masked logits are
-1e30 (not -inf) and the row sum is clamped at 1e-30.
"""
from __future__ import annotations

import ctypes

import torch

from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.utils import kernel_log

NAME = "flash_fwd"
HEAD_DIMS = (64, 128, 256)
_NEG_INF = -1e30

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load(NAME)
        fn = lib.koifish_flash_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, window: int = 0):
    """Plain PyTorch version: (o [B,T,Hq,D] in q's dtype, lse [B,Hq,T] f32).
    One tile over the whole sequence — the math of the single-tile Pallas
    kernels (``_fwd_cols_single_kernel``)."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qs = (q.to(torch.float32) * scale).to(torch.bfloat16).to(torch.float32)
    qs = qs.reshape(B, T, Hkv, g, D)
    s = torch.einsum("bthgd,bshd->bhgts", qs, k.to(torch.float32))
    pos = torch.arange(T, device=q.device)
    allowed = pos[None, :] <= pos[:, None]
    if window > 0:
        allowed &= pos[None, :] > pos[:, None] - window
    s = torch.where(allowed, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)                     # [B,Hkv,g,T,1]
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bhgts,bshd->bthgd",
                      p.to(torch.bfloat16).to(torch.float32),
                      v.to(torch.float32))
    o = pv / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l)).reshape(B, Hq, T)
    return o.reshape(B, T, Hq, D).to(q.dtype), lse


def _check(q, k, v, window):
    B, T, Hq, D = q.shape
    shape = f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}"
    if k.dim() != 4 or k.shape != v.shape or k.shape[:2] != (B, T) \
            or k.shape[3] != D:
        raise ValueError(f"flash_fwd: {shape}: need q [B,T,Hq,D] and "
                         f"k, v [B,T,Hkv,D] of the same B, T, D")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_fwd: {shape}: Hq must be a multiple of Hkv")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_fwd: {shape}: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"flash_fwd: window {window} < 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"flash_fwd: {name} lies on {t.device}, need "
                             f"the CUDA device of q ({q.device})")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_fwd: {name} is {t.dtype}, need bf16")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"flash_fwd: {name} strides {t.stride()} of {shape}: need a "
                f"unit last-dim stride and 16-byte aligned rows")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, window: int = 0):
    """Causal (+ sliding-window) GQA flash attention forward.

    q [B,T,Hq,D], k/v [B,T,Hkv,D] bf16 (any strides with a unit last-dim
    stride). Returns (o [B,T,Hq,D] bf16, lse [B,Hq,T] f32). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, window=window)
    _check(q, k, v, window)
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    o = torch.empty((B, T, Hq, D), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, T, Hq, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(window), stream)
    _build.check(lib, rc, f"flash_fwd q{tuple(q.shape)}")
    kernel_log.count(NAME)
    return o, lse
