"""Attention ops — causal prefill and single-token decode (plain paths).

Shapes: q [B, T, Hq, D]; k/v [B, S, Hkv, D]; GQA via a head-group reshape,
no repeated K. ``causal_attention`` sends the self-attention case
(``mask is None and causal``, tq == tk, dv == d, d in 64/128/256) through
``FlashAttention`` (``ops/kernels/flash.py``: the flash kernels forward and
backward on the card), as the JAX package's ``ops/attention.py:79-83``
sends it to Pallas; every other case runs the plain, autograd-
differentiated path below. Under a sequence-parallel policy
(``ops/tracectx.sp_scope``, pushed by ``make_train_step``) the
self-attention case runs the plain ring over the policy's mesh instead
(``parallel/ring_attention.py``: one controller's ranks on a ``Mesh``,
this process's rank on a ``ProcessMesh``), as JAX
``ops/attention.py:59-77`` does.
A causal self-attention case the flash kernels do not take (MLA's dv != d,
other head dims) logs a ``flash_attention`` fallback through
``utils/kernel_log``, as the JAX package's flash entry does.
"""
from __future__ import annotations

from typing import Optional

import torch

from koifish_tpu_torch.ops.kernels import flash as kflash
from koifish_tpu_torch.ops.tracectx import current_sp
from koifish_tpu_torch.utils import kernel_log

_NEG_INF = -1e30


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """logits [B, Hkv, G, Tq, Tk] in f32 without repeating K."""
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, tq, hkv, hq // hkv, d)
    return torch.einsum("bthgd,bshd->bhgts", qg.to(torch.float32),
                        k.to(torch.float32))


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None, window: int = 0,
                     causal: bool = True, backend: Optional[str] = None
                     ) -> torch.Tensor:
    """Causal (optionally sliding-window / extra-masked) attention.

    mask: optional [B, Tq, Tk] or [Tq, Tk] boolean mask (True = attend),
    ANDed with the end-aligned causal mask; ``causal=False`` uses the
    explicit mask alone. ``backend="ref"`` forces the plain path."""
    b, tq, hq, d = q.shape
    tk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    sp = current_sp()
    if (sp is not None and backend != "ref"
            and mask is None and causal and window == 0 and tq == tk
            and v.shape[-1] == d
            and tq % sp.mesh.shape[sp.axis] == 0):
        # sequence-parallel training: T sharded over the sp axis, the
        # differentiable plain ring (the kernel ring has no gradient)
        from koifish_tpu_torch.parallel.ring_attention import (
            ring_attention_sharded)
        fn = ring_attention_sharded(sp.mesh, sp.axis, scale)
        return fn(q, k, v).to(q.dtype)
    if backend != "ref" and mask is None and causal:
        if (tq == tk and v.shape[-1] == d and d in kflash.HEAD_DIMS
                and hq % k.shape[2] == 0):
            out = kflash.FlashAttention.apply(q, k, v, scale, window)
            return out.to(q.dtype)
        kernel_log.fallback(
            "flash_attention",
            f"q{tuple(q.shape)} k{tuple(k.shape)} dv={v.shape[-1]} "
            f"window={window}: need tq==tk, d in {kflash.HEAD_DIMS}, dv==d, "
            f"hq%hkv==0")

    logits = _gqa_scores(q, k) * scale              # [B,Hkv,G,Tq,Tk]
    dev = q.device
    if causal:
        qpos = torch.arange(tq, device=dev)[:, None] + (tk - tq)
        kpos = torch.arange(tk, device=dev)[None, :]
        allowed = kpos <= qpos
        if window > 0:
            allowed &= kpos > qpos - window
    else:
        allowed = torch.ones((tq, tk), dtype=torch.bool, device=dev)
    if mask is not None:
        m = mask if mask.dim() == 3 else mask[None]
        allowed = (allowed[None] & m)[:, None, None]  # [B,1,1,Tq,Tk]
    else:
        allowed = allowed[None, None, None]
    logits = torch.where(allowed, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v.to(torch.float32))
    return out.reshape(b, tq, hq, v.shape[-1]).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_mask: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-step decode attention over a (dequantized or bf16) cache.
    q [B, Hq, D]; k/v [B, S, Hkv, D]; kv_mask [B, S] marks live slots."""
    b, hq, d = q.shape
    hkv = k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, hq // hkv, d)
    logits = torch.einsum("bhgd,bshd->bhgs", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    logits = torch.where(kv_mask[:, None, None, :], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v_cache.to(torch.float32))
    return out.reshape(b, hq, v_cache.shape[-1]).to(q.dtype)
