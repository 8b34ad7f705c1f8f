"""Multi-head Latent Attention (DeepSeek-V2/V3 family).

The JAX package's ``models/mla.py``: q and kv low-rank latents, a decoupled
RoPE head slice shared by the heads, and a value head dim of its own
(reference: src/Transformer/DeepSeek.cpp:76-112). The latents are
up-projected to per-head K/V once a token, so the standard cache and
attention serve it; ``serve/mla_cache.py`` keeps the latents instead.

Layer params (besides ln1/ln2/o/mlp):
  wq_a [E, rq], q_norm_a [rq], wq_b [rq, H*(dn+dr)]    (or wq [E, H*(dn+dr)])
  wkv_a [E, rkv + dr], kv_norm_a [rkv]
  wkv_b [rkv, H*(dn + dv)]
  o     [H*dv, E]
where dn = qk_nope_head_dim, dr = qk_rope_head_dim, dv = v_head_dim.

The JAX function builds the rope table ``rope_freqs(dr, card.max_pos)`` in
every call, which XLA folds into a constant; eager PyTorch would build it
again on each layer of each step (163,840 x 32 for DeepSeek-V2), so
``mla_rope`` builds it once per card and device and keeps it.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import torch

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.ops.matmul import qmatmul
from koifish_tpu_torch.ops.norms import rmsnorm
from koifish_tpu_torch.ops.rope import apply_rope, rope_freqs
from koifish_tpu_torch.ops.tracectx import current_tp
from koifish_tpu_torch.parallel import comm
from koifish_tpu_torch.utils.device import resolve_device


#: the latent projections and norms, which tensor parallelism replicates
_PROJ = ("wq_a", "q_norm_a", "wq_b", "wq", "wkv_a", "kv_norm_a", "wkv_b")


def mla_dims(card: ModelCard) -> Tuple[int, int, int, int, int]:
    return (card.q_lora_rank, card.kv_lora_rank, card.qk_nope_head_dim,
            card.qk_rope_head_dim, card.v_head_dim)


@functools.lru_cache(maxsize=8)
def _rope_table(dr: int, max_pos: int, theta: float, scaling: tuple,
                device: torch.device):
    return rope_freqs(dr, max_pos, theta, dict(scaling) if scaling else None,
                      device=device)


def mla_rope(card: ModelCard, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (cos, sin) tables [max_pos, dr/2] of the decoupled rope slice,
    built once per card and device."""
    return _rope_table(card.qk_rope_head_dim, card.max_pos,
                       float(card.rope_theta), card.rope_scaling,
                       torch.device(device))


def init_mla_layer(card: ModelCard, generator: torch.Generator,
                   dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """normal(0.02) projections (``o`` scaled by 1/sqrt(2L)) and unit
    latent norms, drawn on ``device``."""
    dev = resolve_device(device)
    E, H = card.n_embd, card.n_head
    rq, rkv, dn, dr, dv = mla_dims(card)
    std = 0.02
    res_std = std / math.sqrt(2 * card.n_layer)

    def nrm(shape, s=std):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * s).to(dtype)

    lp: Dict[str, Any] = {
        "wkv_a": nrm((E, rkv + dr)),
        "kv_norm_a": torch.ones((rkv,), dtype=dtype, device=dev),
        "wkv_b": nrm((rkv, H * (dn + dv))),
        "o": nrm((H * dv, E), res_std),
    }
    if rq > 0:
        lp["wq_a"] = nrm((E, rq))
        lp["q_norm_a"] = torch.ones((rq,), dtype=dtype, device=dev)
        lp["wq_b"] = nrm((rq, H * (dn + dr)))
    else:
        lp["wq"] = nrm((E, H * (dn + dr)))
    return lp


def mla_queries(card: ModelCard, lp: Dict[str, Any], x: torch.Tensor
                ) -> torch.Tensor:
    """x [B, T, E] -> q [B, T, H, dn+dr], before rope."""
    rq, _, dn, dr, _ = mla_dims(card)
    if rq > 0:
        qa = rmsnorm(qmatmul(x, lp["wq_a"]), lp["q_norm_a"],
                     eps=card.norm_eps)
        q = qmatmul(qa, lp["wq_b"])
    else:
        q = qmatmul(x, lp["wq"])
    return q.reshape(*x.shape[:2], -1, dn + dr)


def mla_latents(card: ModelCard, lp: Dict[str, Any], x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, E] -> (c_kv [B, T, rkv] normed, k_rope [B, T, 1, dr]
    before rope)."""
    _, rkv, _, dr, _ = mla_dims(card)
    kv_a = qmatmul(x, lp["wkv_a"])                      # [B, T, rkv+dr]
    c_kv = rmsnorm(kv_a[..., :rkv], lp["kv_norm_a"], eps=card.norm_eps)
    return c_kv, kv_a[..., rkv:].reshape(*x.shape[:2], 1, dr)


def mla_qkv(card: ModelCard, lp: Dict[str, Any], x: torch.Tensor,
            positions: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, T, E] -> q, k [B, T, H, dn+dr], v [B, T, H, dv]: rope on the
    decoupled dr slice at table ``positions`` ([T] or [B, T]), k_rope
    shared across heads. Under tensor parallelism (a rank's card holds
    n_head/tp) the replicated projections run whole and the rank keeps its
    heads, as the rank's rows of the row-parallel ``o`` take them."""
    B, T, _ = x.shape
    _, _, dn, dr, dv = mla_dims(card)
    tp = current_tp()
    if tp is not None:
        # whole products of replicated weights, of which this rank reads
        # its heads: their gradients and x's are partial, summed over tp
        x = comm.copy_to(x, tp.group)
        lp = {k: comm.copy_to(w, tp.group) if k in _PROJ and
              isinstance(w, torch.Tensor) else w for k, w in lp.items()}
    q = mla_queries(card, lp, x)
    c_kv, k_rope = mla_latents(card, lp, x)
    kv = qmatmul(c_kv, lp["wkv_b"]).reshape(B, T, -1, dn + dv)
    H = card.n_head
    if tp is not None:
        q, kv = (t[:, :, tp.rank * H:(tp.rank + 1) * H] for t in (q, kv))
    k_nope, v = kv[..., :dn], kv[..., dn:]

    cos, sin = mla_rope(card, x.device)
    positions = positions.long()
    q_rope = apply_rope(q[..., dn:], cos, sin, positions)
    k_rope = apply_rope(k_rope, cos, sin, positions).expand(B, T, H, dr)
    q = torch.cat([q[..., :dn], q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    return q, k, v
