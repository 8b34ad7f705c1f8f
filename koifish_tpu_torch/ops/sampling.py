"""On-device token sampling: temperature / top-k / top-p / min-p + greedy.

The same filtering as the JAX package's ``ops/sampling.py``. Exact top-k is
``torch.topk``. Randomness comes from a ``torch.Generator``: a categorical
draw is the Gumbel-max of the filtered logits, as ``jax.random.categorical``
does, but the bits differ from ``jax.random``'s, so sampled tokens are not
comparable across the two packages (filtered distributions are).
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = float("-inf")


def _categorical(gen: Optional[torch.Generator],
                 logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits) (Gumbel-max), [B] int64."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits.to(torch.float32) + gumbel, dim=-1)


def _filtered_logits(logits: torch.Tensor, temperature: float, top_k: int,
                     top_p: float, min_p: float, sort_full: bool):
    """(vals [B, K], idx [B, K]): tempered logits of the candidate set with
    the top-p / min-p cuts applied as -inf."""
    V = logits.shape[-1]
    if top_k and 0 < top_k < V:
        # cut at the logits dtype (temperature is monotonic — the top-k
        # set is invariant), upcast only the K survivors
        vals, idx = torch.topk(logits, top_k, dim=-1, largest=True,
                               sorted=True)
        vals = vals.to(torch.float32) / temperature
    elif sort_full:
        lf = logits.to(torch.float32) / temperature
        vals, idx = torch.sort(lf, dim=-1, descending=True)
    else:
        vals = logits.to(torch.float32) / temperature
        idx = torch.arange(V, device=logits.device).expand(logits.shape)
    probs = torch.softmax(vals, dim=-1)
    if top_p < 1.0:
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose *previous* cumulative mass < top_p
        keep = (cum - probs) < top_p
        vals = torch.where(keep, vals, _NEG_INF)
    if min_p > 0.0:
        pmax = probs.amax(dim=-1, keepdim=True)
        vals = torch.where(probs >= min_p * pmax, vals, _NEG_INF)
    return vals, idx


def sample_logits(gen: Optional[torch.Generator], logits: torch.Tensor,
                  temperature: float = 0.6, top_k: int = 50,
                  top_p: float = 0.95, min_p: float = 0.0,
                  approx: bool = False, method: str = "topk"
                  ) -> torch.Tensor:
    """Returns sampled token ids [B] (int32). temperature<=0 → greedy.

    ``method="metropolis"`` draws from the full softmax of the raw logits
    (the reference's GOPT_Metropolis live path). ``approx`` is accepted for
    config parity; top-k is always exact here."""
    del approx
    if method == "metropolis":
        return _categorical(gen, logits).to(torch.int32)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    vals, idx = _filtered_logits(logits, temperature, top_k, top_p, min_p,
                                 sort_full=True)
    choice = _categorical(gen, vals)                       # [B]
    return torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)


def filtered_probs(logits: torch.Tensor, temperature: float = 0.6,
                   top_k: int = 50, top_p: float = 0.95, min_p: float = 0.0,
                   approx: bool = False, method: str = "topk"
                   ) -> torch.Tensor:
    """The DENSE [B, V] f32 distribution ``sample_logits`` draws from."""
    del approx
    B, V = logits.shape
    if method == "metropolis":
        return torch.softmax(logits.to(torch.float32), dim=-1)
    if temperature <= 0.0:
        return torch.nn.functional.one_hot(
            torch.argmax(logits, dim=-1), V).to(torch.float32)
    vals, idx = _filtered_logits(logits, temperature, top_k, top_p, min_p,
                                 sort_full=False)
    probs = torch.softmax(vals, dim=-1)
    dense = torch.zeros((B, V), dtype=torch.float32, device=logits.device)
    return dense.scatter_add_(1, idx, probs)
