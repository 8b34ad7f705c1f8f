"""The plain reference of a training step, in float32: the recipe's loss,
gradients, global-norm clip and AdamW, over the same weights and the same
rows as the program, with the parameters and moments kept in the storage
types the recipe states (bf16 with stochastic rounding, or f32).

Stochastic rounding is the recipe's: 16 random bits added to the f32 bit
pattern and the high 16 kept, the bits the murmur3 finalizer of (flat
element index xor seed), one uint32 seed a leaf (in sorted-name order)
drawn each step from a CPU ``torch.Generator`` seeded with the run's
training seed, offset by 0x9E3779B9 for the first moment and twice that
for the second. Written here from that description in int64 arithmetic.

Rows run in blocks (``rows``) whose gradients sum to the whole batch's:
the loss is the mean over every token of the batch.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from kbench.reference.models import (forward_hidden, logits, plain_lin,
                                     strict_f32)
from kbench.weights import named
from kbench.work import Shapes

M32 = 0xFFFFFFFF
C1, C2 = 0x85EBCA6B, 0xC2B2AE35
GOLDEN = 0x9E3779B9
T_SPIKE = 50.0
CHUNK = 1 << 24


def sr_bf16(x: torch.Tensor, seed: int) -> torch.Tensor:
    """Stochastic rounding of f32 ``x`` to bf16 with ``seed``."""
    xf = x.to(torch.float32).reshape(-1)
    out = torch.empty(xf.shape, dtype=torch.bfloat16, device=x.device)
    s = int(seed) & M32
    for a in range(0, xf.numel(), CHUNK):
        b = min(a + CHUNK, xf.numel())
        h = torch.arange(a, b, dtype=torch.int64, device=x.device) ^ s
        h = h ^ (h >> 16)
        h = (h * C1) & M32
        h = h ^ (h >> 13)
        h = (h * C2) & M32
        h = (h ^ (h >> 16)) & 0xFFFF
        bits = xf[a:b].view(torch.int32).to(torch.int64) & M32
        hi = (((bits + h) & M32) >> 16).to(torch.int32)
        hi = torch.where(hi >= 1 << 15, hi - (1 << 16), hi).to(torch.int16)
        out[a:b] = hi.view(torch.bfloat16)
    return out.view(x.shape)


def store(x: torch.Tensor, dtype, seed: Optional[int]) -> torch.Tensor:
    if dtype == torch.float32:
        return x.to(torch.float32)
    return sr_bf16(x, seed)


def lr_at(step: int, base: float, warmup: int, total: int,
          min_ratio: float = 0.1) -> float:
    """Linear warmup into a cosine decay to ``min_ratio`` of ``base``."""
    warm = min(step / max(warmup, 1), 1.0) if warmup else 1.0
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    lo = base * min_ratio
    return (lo + 0.5 * (base - lo) * (1 + math.cos(math.pi * t))) * warm


def batch_loss_and_grads(sh: Shapes, params32: List[torch.Tensor], tree,
                         tokens: torch.Tensor, lin: Callable, rows: int):
    """Mean next-token CE of ``tokens`` [B, T+1] and its gradients (f32),
    accumulated over blocks of ``rows`` rows."""
    B, T1 = tokens.shape
    n = B * (T1 - 1)
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    for s in range(0, B, rows):
        tb = tokens[s: s + rows]
        h = forward_hidden(sh, tree, tb[:, :-1], lin=lin)
        lg = logits(sh, tree, h, lin=lin)
        ce = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                             tb[:, 1:].reshape(-1).long(), reduction="sum")
        (ce / n).backward()
        total += ce.detach().double()
        del h, lg, ce
    grads = [p.grad for p in params32]
    for p in params32:
        p.grad = None
    return float(total / n), grads


def _rebuild(tree, leaves32: List[torch.Tensor]):
    """``tree``'s structure with ``leaves32`` in sorted-name order."""
    it = iter(leaves32)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(x) for x in t]
        return next(it)
    return build(tree)


def run_steps(sh: Shapes, recipe: dict, tree: Dict,
              batches: Sequence[torch.Tensor], sr_seed: int, total_steps: int,
              lin: Callable = plain_lin, rows: int = 4) -> Dict[str, object]:
    """The recipe's first ``len(batches)`` steps from the weights ``tree``
    (bf16, updated in place). Returns each step's loss, each leaf's first
    clipped gradient norm, and each leaf's change over all the steps."""
    strict_f32()
    leaves = named(tree)
    names = [n for n, _ in leaves]
    store_p = [p for _, p in leaves]
    p0 = [p.detach().clone() for p in store_p]
    mdt = torch.bfloat16 if recipe.get("moment_dtype") == "bf16" \
        else torch.float32
    m = [torch.zeros(p.shape, dtype=mdt, device=p.device) for p in store_p]
    v = [torch.zeros(p.shape, dtype=mdt, device=p.device) for p in store_p]
    b1, b2 = recipe.get("beta1", 0.9), recipe.get("beta2", 0.95)
    eps, wd = recipe.get("eps", 1e-8), recipe.get("weight_decay", 0.1)
    clip = recipe.get("grad_clip", 1.0)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(sr_seed)
    losses, first_norms = [], None
    for step, tokens in enumerate(batches):
        p32 = [p.detach().to(torch.float32).requires_grad_(True)
               for p in store_p]
        loss, grads = batch_loss_and_grads(sh, p32, _rebuild(tree, p32),
                                           tokens, lin, rows)
        del p32
        losses.append(loss)
        gnorm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = [g * scale for g in grads]
        if first_norms is None:
            first_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
        seeds = torch.randint(0, 2 ** 32, (len(store_p),), generator=gen,
                              dtype=torch.int64).tolist()
        lr = lr_at(step, recipe["lr"], recipe["warmup"], total_steps)
        t = step + 1
        for i, (p, g) in enumerate(zip(store_p, grads)):
            pf = p.to(torch.float32)
            mi = b1 * m[i].to(torch.float32) + (1 - b1) * g
            vi = b2 * v[i].to(torch.float32) + (1 - b2) * g * g
            m[i] = store(mi, mdt, (seeds[i] + GOLDEN) & M32)
            v[i] = store(vi, mdt, (seeds[i] + 2 * GOLDEN) & M32)
            upd = (mi / (1 - b1 ** t)) / (torch.sqrt(vi / (1 - b2 ** t))
                                          + eps)
            upd = torch.clamp(upd, -T_SPIKE, T_SPIKE)
            if p.dim() >= 2:
                upd = upd + wd * pf
            p.copy_(store(pf - lr * upd, p.dtype, seeds[i]))
            del pf, mi, vi, upd
        del grads
    change = [float(torch.linalg.vector_norm(
        p.to(torch.float32) - q.to(torch.float32)))
        for p, q in zip(store_p, p0)]
    return {"names": names, "losses": losses, "first_grad": first_norms,
            "change": change}
