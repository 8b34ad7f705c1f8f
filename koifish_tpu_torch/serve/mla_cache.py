"""Latent-compressed MLA decode: DeepSeek's absorbed-attention form.

The JAX package's ``serve/mla_cache.py``. The standard path
(``models/mla.py``) up-projects the latents to per-head K/V and fills the
generic cache, S·H·(dqk + dv) values a layer. This cache keeps only the
latents, ``c_kv`` [S, rkv] and the shared roped ``k_rope`` [S, dr] (what
the reference's CPU decoder stores: src/Transformer/DeepSeek.cpp:108), and
absorbs the up-projections into the attention:

  score(h, t) = <q_nope·W_uk[·,h,·], c_kv[t]> + <q_rope[h], k_rope[t]>
  out(h)      = (Σ_t p_t · c_kv[t]) · W_uv[·,h,·]

Plain PyTorch in f32, as the JAX module is XLA; the projections go through
``qmatmul``. The cache is written in place; ``pos`` advances in the
returned copy.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.models.mla import (mla_dims, mla_latents, mla_queries,
                                          mla_rope)
from koifish_tpu_torch.models.transformer import (Params, _linear_l, _norm,
                                                  gather_embed, lm_head, mlp)
from koifish_tpu_torch.ops.rope import apply_rope
from koifish_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class MLACache:
    c_kv: torch.Tensor     # [L, B, S, rkv] bf16
    k_rope: torch.Tensor   # [L, B, S, dr] bf16
    pos: torch.Tensor      # [B] int32

    @property
    def size(self) -> int:
        return self.c_kv.shape[2]


def mla_cache_for(card: ModelCard, batch: int, size: int,
                  device=None) -> MLACache:
    dev = resolve_device(device)
    _, rkv, _, dr, _ = mla_dims(card)
    return MLACache(
        c_kv=torch.zeros((card.n_layer, batch, size, rkv),
                         dtype=torch.bfloat16, device=dev),
        k_rope=torch.zeros((card.n_layer, batch, size, dr),
                           dtype=torch.bfloat16, device=dev),
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev))


def _latents(card: ModelCard, lp, x, positions, cos, sin):
    """x [B, T, E] -> (c_kv [B, T, rkv], k_rope [B, T, dr]), rope at write."""
    c, kr = mla_latents(card, lp, x)
    return c, apply_rope(kr, cos, sin, positions)[:, :, 0]


def _queries(card: ModelCard, lp, x, positions, cos, sin):
    """x [B, T, E] -> (q_nope [B, T, H, dn], q_rope [B, T, H, dr])."""
    dn = card.qk_nope_head_dim
    q = mla_queries(card, lp, x)
    return q[..., :dn], apply_rope(q[..., dn:], cos, sin, positions)


def _absorbed_attention(card: ModelCard, lp, q_nope, q_rope, c_kv, k_rope,
                        valid) -> torch.Tensor:
    """q_* [B, T, H, ·]; c_kv [B, S, rkv]; k_rope [B, S, dr]; valid
    [B, T, S] -> the attention output [B, T, H*dv] bf16."""
    _, rkv, dn, dr, dv = mla_dims(card)
    H = card.n_head
    w_b = lp["wkv_b"].reshape(rkv, H, dn + dv).to(torch.float32)
    w_uk, w_uv = w_b[..., :dn], w_b[..., dn:]
    scale = 1.0 / ((dn + dr) ** 0.5)
    f32 = torch.float32

    qc = torch.einsum("bthd,rhd->bthr", q_nope.to(f32), w_uk)   # absorb W_uk
    s = (torch.einsum("bthr,bsr->bths", qc, c_kv.to(f32))
         + torch.einsum("bthd,bsd->bths", q_rope.to(f32), k_rope.to(f32)))
    s = torch.where(valid[:, :, None, :], s * scale, -1e30)
    p = torch.softmax(s, dim=-1)
    out_c = torch.einsum("bths,bsr->bthr", p, c_kv.to(f32))
    out = torch.einsum("bthr,rhd->bthd", out_c, w_uv)
    return out.reshape(*out.shape[:2], H * dv).to(torch.bfloat16)


def _block_tail(card: ModelCard, lp, x, a):
    """The layer after its attention: o projection, residual, FFN."""
    x = x + _linear_l(a, lp, "o")
    h2 = _norm(card, x, lp["ln2"], lp.get("ln2_b"))
    return x + mlp(card, lp, h2)


def mla_prefill(card: ModelCard, params: Params, tokens: torch.Tensor,
                cache: MLACache) -> Tuple[torch.Tensor, MLACache]:
    """Prefill from an empty latent cache, written in place. Returns the
    last position's logits [B, V] f32 and the cache with ``pos`` + T."""
    B, T = tokens.shape
    dev = tokens.device
    positions = torch.arange(T, dtype=torch.int64, device=dev)
    cos, sin = mla_rope(card, dev)
    x = gather_embed(params["wte"], tokens)
    causal = (positions[None, :, None] >= positions[None, None, :]
              ).expand(B, T, T)
    S = cache.size
    for li, lp in enumerate(params["layers"]):
        h = _norm(card, x, lp["ln1"], lp.get("ln1_b"))
        c, kr = _latents(card, lp, h, positions, cos, sin)
        q_nope, q_rope = _queries(card, lp, h, positions, cos, sin)
        a = _absorbed_attention(card, lp, q_nope, q_rope, c, kr, causal)
        x = _block_tail(card, lp, x, a)
        cache.c_kv[li, :, :T] = c[:, :S].to(torch.bfloat16)
        cache.k_rope[li, :, :T] = kr[:, :S].to(torch.bfloat16)
    x = _norm(card, x, params["ln_f"], params.get("ln_f_b"))
    logits = lm_head(card, params, x[:, -1:])[:, 0]
    return logits, dataclasses.replace(cache, pos=cache.pos + T)


def mla_decode_step(card: ModelCard, params: Params, token: torch.Tensor,
                    cache: MLACache) -> Tuple[torch.Tensor, MLACache]:
    """One decode step over the latent cache (linear slots, no ring),
    written in place: token [B] -> logits [B, V] f32 and the cache with
    ``pos`` + 1."""
    B = token.shape[0]
    dev = token.device
    positions = torch.clamp(cache.pos, max=card.max_pos - 1)[:, None].long()
    cos, sin = mla_rope(card, dev)
    x = gather_embed(params["wte"], token[:, None])
    slots = torch.clamp(cache.pos, max=cache.size - 1).long()
    bidx = torch.arange(B, device=dev)
    valid = (torch.arange(cache.size, device=dev)[None, :]
             < torch.clamp(cache.pos + 1, max=cache.size)[:, None])
    for li, lp in enumerate(params["layers"]):
        h = _norm(card, x, lp["ln1"], lp.get("ln1_b"))
        c1, kr1 = _latents(card, lp, h, positions, cos, sin)
        cache.c_kv[li][bidx, slots] = c1[:, 0].to(torch.bfloat16)
        cache.k_rope[li][bidx, slots] = kr1[:, 0].to(torch.bfloat16)
        q_nope, q_rope = _queries(card, lp, h, positions, cos, sin)
        a = _absorbed_attention(card, lp, q_nope, q_rope, cache.c_kv[li],
                                cache.k_rope[li], valid[:, None])
        x = _block_tail(card, lp, x, a)
    x = _norm(card, x, params["ln_f"], params.get("ln_f_b"))
    logits = lm_head(card, params, x)[:, 0]
    return logits, dataclasses.replace(cache, pos=cache.pos + 1)
