"""Quantized-KV decode attention: the CUDA kernel's wrappers and plain
versions, and the KV quantizer.

The kernel (``csrc/decode_attn.cu``) replaces the JAX package's Pallas
``_decode_kernel_call``/``_decode_kernel`` in
``koifish_tpu/ops/pallas/decode_attn.py``: one-token GQA attention read
straight from INT8 or packed-INT4 K/V codes. K scales multiply the logits,
V scales fold into p (rounded to bf16 before PV), and each lane stops at its
own ``lengths[b]``. The live rows are split over the blocks of a
thread-block cluster (``plan``); each rank takes a run of ``TILE``-position
tiles (``rank_tiles``) and rank 0 merges the ranks' (m, l, o) in rank order.

Two entries:

- ``decode_attention_quant``: attention over the cache as it is.
- ``decode_attention_write``: quantize the new token's K/V (``quant_kv``),
  write codes and scales at row ``slots[b]`` of lane b, then attend over
  the updated cache, in one launch (the decode step's write and attention).

Layout (``serve/kvcache.py``): codes are head-major ``[B, Hkv, S, D]`` int8,
or ``[B, Hkv, S, D/2]`` uint8 for INT4 with byte i holding element i (low
nibble) and element i + D/2 (high nibble), biased by 8; scales are
``[B, Hkv, S]`` f32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.ops.kernels.slotwrite import slot_write_plain
from koifish_tpu_torch.utils import kernel_log

NAME = "decode_attn"
WRITE = "kv_write"      # launch counter of the fused write
HEAD_DIMS = (64, 128, 192, 256)
TILE = 64               # positions a tile: the unit of the split
GROUP = 8               # q heads a block
MAX_SPLITS = 8          # blocks a cluster
BLOCKS_PER_SM = 1       # the split's aim (a sweep on the H100: PERF.md §6)
_NEG_INF = -1e30

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load(NAME)
        fn = lib.koifish_decode_attn
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def quant_kv(x: torch.Tensor, fmt: QFormat
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) absmax quantization of a K/V vector [..., D].
    Rounds half to even (``torch.round``, as ``jnp.round``). INT4 returns
    block-split packed bytes [..., D//2]. On a CUDA tensor PyTorch computes
    ``absmax / qmax`` as ``absmax * fl(1 / qmax)``; the kernel's write
    does the same."""
    qmax = 127.0 if fmt is QFormat.INT8 else 7.0
    xf = x.to(torch.float32)
    absmax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(absmax / qmax, min=1e-12)
    q = torch.clamp(torch.round(xf / scale[..., None]), -qmax - 1, qmax
                    ).to(torch.int8)
    if fmt is QFormat.INT4:
        d = q.shape[-1]
        b = (q + 8).to(torch.uint8)
        q = b[..., : d // 2] | (b[..., d // 2:] << 4)
    return q, scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., D//2] uint8 -> [..., D] int8 codes in [-8, 7] (block-split)."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-1)


def plan(B: int, Hq: int, Hkv: int, S: int, sms: int = 132) -> int:
    """The cluster's split of the live rows: blocks per (b, kv head, head
    group), 1..8, from the grid and S alone (never the lengths: no host
    sync, and a CUDA graph can hold the launch): as many as keep the grid
    within ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs, and no more than
    S has tiles. On an H100 a second block a SM cost more (cluster launch,
    merge) than it saved at B = 32 and B = 8 (PERF.md §6); at B = 1 eight
    kv heads take 8 splits each."""
    groups = -(-(Hq // Hkv) // GROUP)
    want = (BLOCKS_PER_SM * sms) // (B * Hkv * groups)
    return max(1, min(MAX_SPLITS, -(-S // TILE), want))


def rank_tiles(length: int, S: int, splits: int) -> List[Tuple[int, int]]:
    """Each rank's tiles [t0, t1) as the kernel derives them from a lane's
    length: the live tiles in runs of ceil(live / splits), empty past
    them."""
    live = -(-max(0, min(length, S)) // TILE)
    per = max(1, -(-live // splits))
    return [(min(live, r * per), min(live, (r + 1) * per))
            for r in range(splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _unpacked(k_codes, v_codes):
    if k_codes.dtype == torch.uint8:
        return unpack_int4(k_codes), unpack_int4(v_codes)
    return k_codes, v_codes


def _partial(q, kc, vc, k_scale, v_scale, rows, scale: float,
             pv_dtype=torch.bfloat16):
    """(m, l, o) of each (lane, q head) over the cache rows where ``rows``
    [B, S] is set, with p·v_scale rounded to ``pv_dtype`` against this
    part's own max: m, l [B, Hkv, g, 1], o [B, Hkv, g, Dv] f32. An empty
    part is m = -1e30, l = 0, o = 0."""
    B, Hq, D = q.shape
    Hkv = kc.shape[1]
    qf = q.to(torch.bfloat16).to(torch.float32).reshape(B, Hkv, Hq // Hkv, D)
    s_int = torch.einsum("bhgd,bhsd->bhgs", qf, kc.to(torch.float32))
    logits = s_int * k_scale.to(torch.float32)[:, :, None, :] * scale
    live = rows[:, None, None, :]
    logits = torch.where(live, logits, _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(logits - m), 0.0)
    pv = (p * v_scale.to(torch.float32)[:, :, None, :]).to(pv_dtype)
    o = torch.einsum("bhgs,bhsd->bhgd", pv.to(torch.float32),
                     vc.to(torch.float32))
    return m, p.sum(dim=-1, keepdim=True), o


def _merge(parts) -> torch.Tensor:
    """The parts' (m, l, o) merged in order -> O / max(L, 1e-30) f32."""
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    L = torch.zeros_like(M)
    O = torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        f = torch.exp(m - M)
        L = L + l * f
        O = O + o * f
    return O / L.clamp_min(1e-30)


def decode_attention_plain(q, k_codes, v_codes, k_scale, v_scale, lengths,
                           scale: float) -> torch.Tensor:
    """Plain PyTorch version: [B, Hq, Dv] bf16, one tile over the cache."""
    B, Hq, D = q.shape
    Hkv, S = k_codes.shape[1], k_codes.shape[2]
    g = Hq // Hkv
    kc, vc = _unpacked(k_codes, v_codes)
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


def decode_attention_splits_plain(q, k_codes, v_codes, k_scale, v_scale,
                                  lengths, scale: float, splits: int,
                                  drop_last: bool = False,
                                  pv_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain emulation of the kernel's split: each rank's (m, l, o) over its
    tiles (``rank_tiles``), p·v_scale rounded against the rank's own max,
    merged in rank order -> [B, Hq, Dv] f32. ``drop_last`` leaves out the
    last live rank of every lane that has two or more (a planted fault)."""
    B, Hq, _ = q.shape
    S = k_codes.shape[2]
    kc, vc = _unpacked(k_codes, v_codes)
    dev = q.device
    pos = torch.arange(S, device=dev)[None, :]
    ranges = [rank_tiles(int(n), S, splits) for n in lengths.tolist()]
    live = [sum(t1 > t0 for t0, t1 in r) for r in ranges]
    parts = []
    for r in range(splits):
        lo = torch.tensor([rg[r][0] * TILE for rg in ranges], device=dev)
        hi = torch.tensor([rg[r][1] * TILE for rg in ranges], device=dev)
        rows = (pos >= lo[:, None]) & (pos < hi[:, None]) \
            & (pos < lengths.to(dev)[:, None])
        if drop_last:
            last = torch.tensor([n >= 2 and r == n - 1 for n in live],
                                device=dev)
            rows = rows & ~last[:, None]
        parts.append(_partial(q, kc, vc, k_scale, v_scale, rows, scale,
                              pv_dtype))
    return _merge(parts).reshape(B, Hq, vc.shape[-1])


def decode_attention_write_plain(q, k_new, v_new, k_codes, v_codes, k_scale,
                                 v_scale, slots, lengths, scale: float
                                 ) -> torch.Tensor:
    """Plain version of the fused entry: ``quant_kv`` of the new K/V [B,
    Hkv, D(v)], ``slot_write_plain`` of codes and scales into the four
    buffers (in place), then ``decode_attention_plain`` -> [B, Hq, Dv]."""
    fmt = QFormat.INT4 if k_codes.dtype == torch.uint8 else QFormat.INT8
    kq, ksc = quant_kv(k_new, fmt)
    vq, vsc = quant_kv(v_new, fmt)
    for buf, val in ((k_codes, kq), (v_codes, vq), (k_scale, ksc),
                     (v_scale, vsc)):
        buf.copy_(slot_write_plain(buf, val, slots))
    return decode_attention_plain(q, k_codes, v_codes, k_scale, v_scale,
                                  lengths, scale)


def _check(q, k_codes, v_codes, k_scale, v_scale, lengths, new=None):
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
    if B * Hkv > 65535:
        raise ValueError(f"decode_attn: {shape}: B·Hkv = {B * Hkv} > 65535")
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
    named = [("q", q), ("k", k_codes), ("v", v_codes), ("k_scale", k_scale),
             ("v_scale", v_scale), ("lengths", lengths)]
    if new is not None:
        k_new, v_new, slots = new
        if tuple(k_new.shape) != (B, Hkv, D) \
                or tuple(v_new.shape) != (B, Hkv, dv) \
                or k_new.dtype != torch.bfloat16 \
                or v_new.dtype != torch.bfloat16:
            raise ValueError(f"decode_attn: {shape}: new K/V "
                             f"{tuple(k_new.shape)} {k_new.dtype} / "
                             f"{tuple(v_new.shape)}: need bf16 "
                             f"[{B}, {Hkv}, {D}] and [{B}, {Hkv}, {dv}]")
        if tuple(slots.shape) != (B,) or slots.dtype != torch.int32:
            raise ValueError(f"decode_attn: slots {tuple(slots.shape)} "
                             f"{slots.dtype}: need int32 [{B}]")
        named += [("k_new", k_new), ("v_new", v_new), ("slots", slots)]
    for name, t in named:
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"decode_attn: {name} lies on {t.device}, need "
                             f"the CUDA device of q ({q.device})")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attn: {name} of {shape} must be "
                             f"contiguous and 16-byte aligned")


def _launch(q, k_codes, v_codes, k_scale, v_scale, lengths, scale, new):
    """One launch of the kernel (``new``: (k_new, v_new, slots) or None);
    allocates the output and nothing else."""
    B, Hq, D = q.shape
    Hkv, S = k_codes.shape[1], k_codes.shape[2]
    int4 = k_codes.dtype == torch.uint8
    dv = v_codes.shape[-1] * (2 if int4 else 1)
    splits = plan(B, Hq, Hkv, S, _sm_count(q.device))
    out = torch.empty((B, Hq, dv), dtype=torch.bfloat16, device=q.device)
    knew, vnew, slots = (t.data_ptr() for t in new) if new is not None \
        else (None, None, None)
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), knew, vnew, slots, B, Hq, Hkv, S, D, dv,
            int(int4), float(scale), splits, stream)
    _build.check(lib, rc, f"decode_attn q{tuple(q.shape)}")
    kernel_log.count(NAME)
    if new is not None:
        kernel_log.count(WRITE)
    return out


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
    return _launch(q, k_codes, v_codes, k_scale, v_scale, lengths, scale,
                   None)


def decode_attention_write(q, k_new, v_new, k_codes, v_codes, k_scale,
                           v_scale, slots, lengths, scale: float
                           ) -> torch.Tensor:
    """Quantize the new token's K/V [B, Hkv, D(v)] bf16, write codes and
    scales at row ``slots[b]`` of lane b of the cache (in place), and
    attend over the updated cache -> [B, Hq, Dv] bf16: one launch on a
    CUDA tensor (counted under ``decode_attn`` and ``kv_write``), the plain
    version on a CPU tensor."""
    if q.device.type == "cpu":
        return decode_attention_write_plain(q, k_new, v_new, k_codes,
                                            v_codes, k_scale, v_scale, slots,
                                            lengths, scale)
    q = q.contiguous()
    new = (k_new.to(torch.bfloat16).contiguous(),
           v_new.to(torch.bfloat16).contiguous(), slots.to(torch.int32))
    _check(q, k_codes, v_codes, k_scale, v_scale, lengths, new)
    return _launch(q, k_codes, v_codes, k_scale, v_scale, lengths, scale,
                   new)
