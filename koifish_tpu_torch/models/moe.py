"""Mixture-of-Experts FFN (Qwen3-MoE family).

The JAX package's ``models/moe.py``: GShard-style top-k routing with expert
capacity, dispatch and combine as scatter and gather over a capacity
buffer [Ne, C, E], and the expert FFNs batched over the stacked expert axis
(three batched products). Plain PyTorch, as the JAX module is XLA.

Every expert runs over its whole capacity buffer each call, empty or not,
as in the JAX package. The expert products take bf16 operands and give
their f32 accumulation unrounded (``jnp.einsum(...,
preferred_element_type=jnp.float32)``): on a CUDA tensor through
``torch.bmm(..., out_dtype=torch.float32)``, on a CPU tensor through an
f32 ``torch.bmm`` of the operands upcast (the products of two bf16 values
are exact in f32, so only the summation order differs).

Layer params: ``router`` [E, Ne]; ``egate``/``eup`` [Ne, E, Fm];
``edown`` [Ne, Fm, E].

Expert parallelism under a ``TPPolicy``: a rank holds ``Ne/tp`` experts of
the stacks. Every rank routes every token (the router is replicated),
runs its own experts over their capacity buffers, and combines only the
assignments to them; the partial combines are summed over the group in
f32 and rounded once.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.ops.tracectx import current_tp
from koifish_tpu_torch.parallel import comm
from koifish_tpu_torch.utils.device import resolve_device

CAPACITY_FACTOR = 1.25


class Routes(NamedTuple):
    """The routing of S tokens: each (token, slot) assignment's expert,
    gate, place in its expert's capacity buffer and whether it fits."""
    gate: torch.Tensor     # [S*k] f32, renormalised top-k probabilities
    expert: torch.Tensor   # [S*k] int64
    slot: torch.Tensor     # [S*k] int64, C-1 where dropped
    keep: torch.Tensor     # [S*k] bool
    capacity: int


def capacity(card: ModelCard, n_tokens: int,
             capacity_factor: float = CAPACITY_FACTOR) -> int:
    """C = max(int(S·k·factor / Ne), 4), as the JAX package sizes it."""
    return max(int(n_tokens * card.n_experts_active * capacity_factor
                   / card.n_experts), 4)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [n, m, k] @ b [n, k, p] with f32 accumulation and an f32 result."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def route(card: ModelCard, router: torch.Tensor, x2: torch.Tensor,
          capacity_factor: float = CAPACITY_FACTOR) -> Routes:
    """Route x2 [S, E]: the f32 router softmax, its top-k renormalised,
    and each assignment's slot by the running count of its expert over
    the flattened (token, slot) list; assignments past the capacity are
    dropped (kept at slot C-1 with ``keep`` False)."""
    S = x2.shape[0]
    Ne, k = card.n_experts, card.n_experts_active
    logits = torch.matmul(x2.to(torch.float32),
                          router.to(x2.dtype).to(torch.float32))   # [S, Ne]
    probs = torch.softmax(logits, dim=-1)
    gate_v, gate_i = torch.topk(probs, k, dim=-1)                  # [S, k]
    gate_v = gate_v / torch.clamp(gate_v.sum(-1, keepdim=True), min=1e-9)
    C = capacity(card, S, capacity_factor)
    flat_i = gate_i.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat_i, Ne).to(torch.int32)
    slot = torch.cumsum(onehot, dim=0).gather(1, flat_i[:, None])[:, 0] - 1
    keep = slot < C
    slot = torch.where(keep, slot, C - 1).long()
    return Routes(gate_v.reshape(-1), flat_i, slot, keep, C)


def moe_ffn(card: ModelCard, lp: Dict[str, Any], x: torch.Tensor,
            capacity_factor: float = CAPACITY_FACTOR) -> torch.Tensor:
    """x [B, T, E] -> the MoE FFN's output [B, T, E] in x's dtype."""
    B, T, E = x.shape
    S = B * T
    Ne, k = card.n_experts, card.n_experts_active
    x2 = x.reshape(S, E)
    tp = current_tp()
    n_loc = lp["egate"].shape[0]
    if tp is not None and n_loc != Ne:
        # a shard of the experts: each rank's router gradient is partial
        r = route(card, comm.copy_to(lp["router"], tp.group), x2,
                  capacity_factor)
    else:
        tp = None
        r = route(card, lp["router"], x2, capacity_factor)

    # dispatch: scatter the kept assignments into [Ne, C, E]
    xk = x2.repeat_interleave(k, dim=0) * r.keep[:, None].to(x.dtype)
    buf = torch.zeros((Ne, r.capacity, E), dtype=x.dtype, device=x.device)
    buf.index_put_((r.expert, r.slot), xk, accumulate=True)

    e0 = 0 if tp is None else tp.rank * n_loc
    if tp is not None:
        buf = buf[e0:e0 + n_loc]

    # expert FFNs over the whole buffer, batched over the expert axis
    g = _bmm_f32(buf, lp["egate"].to(x.dtype))
    u = _bmm_f32(buf, lp["eup"].to(x.dtype))
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    y = _bmm_f32(h, lp["edown"].to(x.dtype))                      # [Ne, C, E]

    # combine: gather each assignment's result, weight it, sum over k
    if tp is None:
        out = y[r.expert, r.slot]
        out = out * (r.gate * r.keep.to(torch.float32))[:, None]
        out = out.reshape(S, k, E).sum(1)
        return out.reshape(B, T, E).to(x.dtype)
    mine = (r.expert >= e0) & (r.expert < e0 + n_loc)
    out = y[(r.expert - e0).clamp(0, n_loc - 1), r.slot]
    out = out * (r.gate * (r.keep & mine).to(torch.float32))[:, None]
    out = comm.reduce_from(out.reshape(S, k, E).sum(1), tp.group)
    return out.reshape(B, T, E).to(x.dtype)


def init_moe_layer(card: ModelCard, generator: torch.Generator,
                   dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """normal(0.02) router and expert stacks, drawn on ``device``."""
    dev = resolve_device(device)
    E, Ne, Fm = card.n_embd, card.n_experts, card.moe_ffn or card.n_ffn

    def nrm(shape):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * 0.02).to(dtype)
    return {"router": nrm((E, Ne)), "egate": nrm((Ne, E, Fm)),
            "eup": nrm((Ne, E, Fm)), "edown": nrm((Ne, Fm, E))}
