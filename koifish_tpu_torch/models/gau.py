"""Gated Attention Unit layer (the JAX package's ``models/gau.py``; the
reference's GatedAttention neuron, TGraph.cpp:491-545, whose live build
cannot construct it). One block replaces the (attention, FFN) pair::

    h = norm(x)
    u = silu(h @ Wu);  v = silu(h @ Wv)          # [B, T, F] (upU / upV)
    a = attention(rope(h Wq), rope(h Wk), value=v's heads)
    y = x + (u * a) @ Wd                         # gate, then down

The gating attention has n_kv_head heads for q and k, so its output has F
channels: its value width F/H differs from the head dim, which keeps it off
the flash kernels in both packages (``koifish_tpu/ops/pallas/flash.py:112``;
the port logs a ``flash_attention`` fallback, as JAX does). Train and
forward only: serving raises (``serve/engine.prefill``), as in JAX.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.ops.attention import causal_attention
from koifish_tpu_torch.ops.matmul import qmatmul
from koifish_tpu_torch.ops.rope import apply_rope
from koifish_tpu_torch.ops.tracectx import current_tp
from koifish_tpu_torch.parallel import comm

#: the projections that tensor parallelism replicates
_REPLICATED = ("upU", "upV", "gau_q", "gau_k")


def init_gau_layer(card: ModelCard, gen: torch.Generator,
                   dtype=torch.bfloat16, device=None):
    """One GAU block's leaves: upU / upV / down and the gating q / k."""
    E, Fn, D = card.n_embd, card.n_ffn, card.head_dim
    H = card.n_kv_head
    if Fn % H:
        raise ValueError(f"GAU needs n_ffn {Fn} divisible by n_kv_head {H}")
    std = 0.02
    res_std = std / math.sqrt(2 * card.n_layer)

    def nrm(shape, s=std):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (w * s).to(dtype)

    return {"upU": nrm((E, Fn)), "upV": nrm((E, Fn)),
            "down": nrm((Fn, E), res_std), "gau_q": nrm((E, H * D)),
            "gau_k": nrm((E, H * D))}


def gau_block(card: ModelCard, lp, x: torch.Tensor, cos, sin,
              positions) -> torch.Tensor:
    """x [B, T, E] -> x + the GAU output. Under tensor parallelism (a
    rank's card holds F/tp and n_kv_head/tp) the replicated projections
    run whole, the rank keeps its heads and its F columns of u, and the
    row-parallel ``down``'s partials are summed in f32 and rounded once
    (``models/transformer._linear_l``)."""
    from koifish_tpu_torch.models.transformer import _linear_l, _norm
    B, T, _ = x.shape
    D = card.head_dim
    h = _norm(card, x, lp["ln1"], lp.get("ln1_b"))
    tp = current_tp()
    w = {k: lp[k] for k in _REPLICATED}
    if tp is not None:
        # whole products of replicated weights, of which this rank reads
        # its heads: their gradients and h's are partial, summed over tp
        h = comm.copy_to(h, tp.group)
        w = {k: comm.copy_to(v, tp.group) if isinstance(v, torch.Tensor)
             else v for k, v in w.items()}
    Fw, Hw = w["upU"].shape[-1], w["gau_q"].shape[-1] // D
    u = F.silu(qmatmul(h, w["upU"]).to(torch.float32)).to(x.dtype)
    v = F.silu(qmatmul(h, w["upV"]).to(torch.float32)).to(x.dtype)
    q = qmatmul(h, w["gau_q"]).reshape(B, T, Hw, D)
    k = qmatmul(h, w["gau_k"]).reshape(B, T, Hw, D)
    if card.pos_embed == "rope":
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
    Fn, H = card.n_ffn, card.n_kv_head
    if tp is not None:                 # this rank's heads and F columns
        q, k = (t[:, :, tp.rank * H:(tp.rank + 1) * H] for t in (q, k))
        u, v = (t[..., tp.rank * Fn:(tp.rank + 1) * Fn] for t in (u, v))
    a = causal_attention(q, k, v.reshape(B, T, H, Fn // H),
                         causal=card.causal).reshape(B, T, Fn)
    if tp is not None:
        return x + _linear_l(u * a, lp, "down")
    return x + qmatmul(u * a, lp["down"])
