"""BROWN attention — learned fixed attention (the JAX package's
``models/brown.py``; the reference's ``BROWN_attn`` neuron,
TGraph.cpp:400-489). The attention probabilities are a learned per-head
[T, T] table, not computed from the tokens; the values are the normed
embedding reshaped into heads (and roped), with no V projection::

    h    = norm(x)
    v    = rope(reshape(h, [B, T, H, D]))
    prob = softmax(causal_mask(W_attn / sqrt(D)))      # [H, T, T]
    y    = x + proj(reshape(prob @ v, [B, T, E]))

followed by the layer's ordinary FFN. The table is [H, n_ctx, n_ctx] f32,
sliced to the run's T. Plain PyTorch, as the JAX module is XLA: the
attention is a table, so no attention kernel runs. Train and forward only:
serving raises (``serve/engine.prefill``), as in JAX. Under tensor
parallelism its leaves are replicated (``parallel/sharding.py``): every
rank computes the whole attention.
"""
from __future__ import annotations

import math

import torch

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.ops.matmul import qmatmul
from koifish_tpu_torch.ops.rope import apply_rope


def init_brown_layer(card: ModelCard, gen: torch.Generator,
                     dtype=torch.bfloat16, device=None):
    """One BROWN attention's leaves: the learned logits ``brown_w`` (f32,
    [H, n_ctx, n_ctx]) and ``brown_proj``."""
    E, H, T = card.n_embd, card.n_head, card.n_ctx
    if H * card.head_dim != E:
        raise ValueError(
            f"BROWN attention reshapes the embedding into heads directly "
            f"(no V projection, TGraph.cpp:428): needs n_head*head_dim == "
            f"n_embd, got {H}*{card.head_dim} != {E}")
    std = 0.02

    def nrm(shape, s):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * s

    return {"brown_w": nrm((H, T, T), std),
            "brown_proj": nrm((E, E), std / math.sqrt(2 * card.n_layer)
                              ).to(dtype)}


def brown_attn(card: ModelCard, lp, x: torch.Tensor, cos, sin,
               positions) -> torch.Tensor:
    """x [B, T, E] -> x + the BROWN attention output (pre-FFN residual)."""
    from koifish_tpu_torch.models.transformer import _norm
    B, T, E = x.shape
    # the table's head count: a tensor-parallel rank's card holds a share
    # of n_head, while the table (replicated) runs whole on every rank
    H, D = lp["brown_w"].shape[0], card.head_dim
    h = _norm(card, x, lp["ln1"], lp.get("ln1_b"))
    v = h.reshape(B, T, H, D)
    if card.pos_embed == "rope":
        v = apply_rope(v, cos, sin, positions)
    w = lp["brown_w"][:, :T, :T].to(torch.float32) / (D ** 0.5)
    if card.causal:
        tri = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        w = torch.where(tri[None], w, float("-inf"))
    prob = torch.softmax(w, dim=-1).to(x.dtype)           # [H, T, T]
    wv = torch.einsum("hts,bshd->bthd", prob, v)
    return x + qmatmul(wv.reshape(B, T, E), lp["brown_proj"])
