"""Quantized-KV decode attention: the CUDA kernel's wrapper and plain version.

The kernel (``csrc/decode_attn.cu``) replaces the JAX package's Pallas
``_decode_kernel_call``/``_decode_kernel`` in
``koifish_tpu/ops/pallas/decode_attn.py``: one-token GQA attention read
straight from INT8 or packed-INT4 K/V codes. K scales multiply the logits,
V scales fold into p (rounded to bf16 before PV), and each lane stops at its
own ``lengths[b]``.

Layout (``serve/kvcache.py``): codes are head-major ``[B, Hkv, S, D]`` int8,
or ``[B, Hkv, S, D/2]`` uint8 for INT4 with byte i holding element i (low
nibble) and element i + D/2 (high nibble), biased by 8; scales are
``[B, Hkv, S]`` f32.
"""
from __future__ import annotations

import ctypes

import torch

from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.utils import kernel_log

NAME = "decode_attn"
HEAD_DIMS = (64, 128, 192, 256)
_NEG_INF = -1e30

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load(NAME)
        fn = lib.koifish_decode_attn
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., D//2] uint8 -> [..., D] int8 codes in [-8, 7] (block-split)."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-1)


def decode_attention_plain(q, k_codes, v_codes, k_scale, v_scale, lengths,
                           scale: float) -> torch.Tensor:
    """Plain PyTorch version: [B, Hq, Dv] bf16, one tile over the cache."""
    B, Hq, D = q.shape
    Hkv, S = k_codes.shape[1], k_codes.shape[2]
    g = Hq // Hkv
    int4 = k_codes.dtype == torch.uint8
    kc = unpack_int4(k_codes) if int4 else k_codes
    vc = unpack_int4(v_codes) if int4 else v_codes
    qf = q.to(torch.bfloat16).to(torch.float32).reshape(B, Hkv, g, D)
    s_int = torch.einsum("bhgd,bhsd->bhgs", qf, kc.to(torch.float32))
    logits = s_int * k_scale.to(torch.float32)[:, :, None, :] * scale
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    logits = torch.where(valid[:, None, None, :], logits, _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = (p * v_scale.to(torch.float32)[:, :, None, :]).to(torch.bfloat16)
    o = torch.einsum("bhgs,bhsd->bhgd", pv.to(torch.float32),
                     vc.to(torch.float32)) / l
    return o.reshape(B, Hq, vc.shape[-1]).to(torch.bfloat16)


def _check(q, k_codes, v_codes, k_scale, v_scale, lengths):
    B, Hq, D = q.shape
    Hkv, S = k_codes.shape[1], k_codes.shape[2]
    int4 = k_codes.dtype == torch.uint8
    dv = v_codes.shape[-1] * (2 if int4 else 1)
    shape = (f"q{tuple(q.shape)} k{tuple(k_codes.shape)} "
             f"v{tuple(v_codes.shape)} {k_codes.dtype}")
    if k_codes.dtype not in (torch.int8, torch.uint8) \
            or v_codes.dtype != k_codes.dtype:
        raise ValueError(f"decode_attn: {shape}: need int8 or packed uint8 "
                         f"codes of one dtype")
    if k_codes.dim() != 4 or k_codes.shape[0] != B \
            or k_codes.shape[3] * (2 if int4 else 1) != D \
            or tuple(v_codes.shape[:3]) != (B, Hkv, S) or Hq % Hkv:
        raise ValueError(f"decode_attn: {shape}: need q [B,Hq,D], codes "
                         f"[B,Hkv,S,D(/2)] with Hq % Hkv == 0")
    if D not in HEAD_DIMS or dv not in HEAD_DIMS:
        raise ValueError(f"decode_attn: {shape}: d={D}, dv={dv} must be in "
                         f"{HEAD_DIMS}")
    if tuple(k_scale.shape) != (B, Hkv, S) \
            or tuple(v_scale.shape) != (B, Hkv, S):
        raise ValueError(f"decode_attn: {shape}: scales must be "
                         f"[{B}, {Hkv}, {S}]")
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"decode_attn: lengths {tuple(lengths.shape)} "
                         f"{lengths.dtype}: need int32 [{B}]")
    if q.dtype != torch.bfloat16 or k_scale.dtype != torch.float32 \
            or v_scale.dtype != torch.float32:
        raise ValueError(f"decode_attn: {shape}: need bf16 q and f32 scales")
    for name, t in (("q", q), ("k", k_codes), ("v", v_codes),
                    ("k_scale", k_scale), ("v_scale", v_scale),
                    ("lengths", lengths)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"decode_attn: {name} lies on {t.device}, need "
                             f"the CUDA device of q ({q.device})")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attn: {name} of {shape} must be "
                             f"contiguous and 16-byte aligned")


def decode_attention_quant(q, k_codes, v_codes, k_scale, v_scale, lengths,
                           scale: float) -> torch.Tensor:
    """One-token attention over a quantized cache -> [B, Hq, Dv] bf16.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_codes, v_codes, k_scale, v_scale,
                                      lengths, scale)
    q = q.contiguous()
    _check(q, k_codes, v_codes, k_scale, v_scale, lengths)
    B, Hq, D = q.shape
    Hkv, S = k_codes.shape[1], k_codes.shape[2]
    int4 = k_codes.dtype == torch.uint8
    dv = v_codes.shape[-1] * (2 if int4 else 1)
    out = torch.empty((B, Hq, dv), dtype=torch.bfloat16, device=q.device)
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, Hq, Hkv, S, D, dv, int(int4), float(scale),
            stream)
    _build.check(lib, rc, f"decode_attn q{tuple(q.shape)}")
    kernel_log.count(NAME)
    return out
