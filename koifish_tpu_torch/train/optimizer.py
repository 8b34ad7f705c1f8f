"""Optimizers: AdamW and Muon with the reference's stability guards (the
JAX package's ``train/optimizer.py``; reference ``PIPE_Adamw`` /
``PIPE_Muon``, Pipe.hpp:18-147, Optimizer.cu:135-580).

- f32 optimizer math on bf16 parameter storage;
- a global grad-norm clip before the update;
- the per-element update spike guard ``T_SPIKE`` (Pipe.hpp:42): updates
  larger than T_SPIKE·lr are clamped and counted;
- Muon: momentum, then Newton–Schulz (or Chebyshev) orthogonalization
  with RMS-matched scaling; other leaves take AdamW;
- stochastic rounding on bf16 writebacks with the murmur3 finalizer of
  the JAX package, bit for bit given the same uint32 seed.

Plain PyTorch on tensors: XLA runs this code in the JAX package, so it is
not a kernel of the repo. On a sharded state (``train/sharded.py``) each
rank updates its shards: the global norm sums the squares of every shard,
a replicated leaf once; stochastic rounding hashes each element's index
in the whole leaf; a Muon leaf gathers the whole matrix to orthogonalize
it; LARS takes the whole leaf's norms. ``apply_updates`` writes the new
parameters and moments IN PLACE into the tensors it was given (one leaf's
temporaries at a time), which keeps a step's optimizer memory at one copy
of the state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from koifish_tpu_torch.utils.dump import _path_str
from koifish_tpu_torch.utils.tree import (flatten_with_path, leaves,
                                          unflatten_like)

T_SPIKE = 50.0  # reference Pipe.hpp:42
_M32 = 0xFFFFFFFF
_SR_CHUNK = 1 << 25     # elements per chunk of the hash (memory)


@dataclasses.dataclass
class OptState:
    m: Any                    # first moment / momentum (f32 or bf16)
    v: Optional[Any]          # second moment (adamw); size-0 for Muon leaves
    step: int                 # host-side step count
    spikes: torch.Tensor      # int32 scalar: spike-guard trips so far


def _real_grad(g) -> bool:
    """Empty stubs (frozen leaves) are not gradients."""
    return g is not None and g.numel() > 0


def _is_float(p) -> bool:
    return isinstance(p, torch.Tensor) and p.is_floating_point()


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in leaves(tree) if _real_grad(x)]
    return torch.sqrt(sum(sq))


def clip_by_global_norm(grads, max_norm: float, dist=None):
    """(grads scaled to at most ``max_norm`` in f32, their global norm),
    with one ``torch._foreach_*`` launch for the norms and one for the
    scaling instead of several per leaf. ``dist``: a sharded state's
    layout (``train/sharded.ShardedLayout``): the norm of the whole tree
    over every rank's shards."""
    flat = leaves(grads)
    live = [i for i, g in enumerate(flat) if _real_grad(g)]
    g32 = [flat[i].to(torch.float32) for i in live]
    if dist is not None:
        gnorm = dist.global_norm(torch._foreach_norm(g32) if g32 else [],
                                 live)
    else:
        gnorm = (torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(g32))) if g32 else torch.zeros(()))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    for i, g in zip(live, torch._foreach_mul(g32, scale)):
        flat[i] = g
    return unflatten_like(grads, flat), gnorm


def _muon_leaf(p, optimizer: str, path: str = "") -> bool:
    """Leaves Muon orthogonalizes: 2D hidden weight matrices (embeddings,
    positions and the untied head stay on AdamW)."""
    if optimizer != "muon" or p.dim() != 2 or p.shape[0] < 64 \
            or p.shape[1] < 64:
        return False
    return path.rsplit(".", 1)[-1] not in ("wte", "wpe", "head")


def _stub(p) -> torch.Tensor:
    return torch.zeros((0,), dtype=torch.float32, device=p.device)


def init_opt_state(params, optimizer: str = "adamw",
                   moment_dtype: str = "f32") -> OptState:
    """Moments for float leaves (size-0 stubs elsewhere; Muon leaves carry
    no second moment). ``moment_dtype``: storage, "f32" or "bf16" — the
    update math is f32 either way."""
    mdt = torch.bfloat16 if moment_dtype == "bf16" else torch.float32
    flat = flatten_with_path(params)
    m = [torch.zeros(p.shape, dtype=mdt, device=p.device) if _is_float(p)
         else _stub(p) for _, p in flat]
    v = [torch.zeros(p.shape, dtype=mdt, device=p.device)
         if _is_float(p) and not _muon_leaf(p, optimizer, _path_str(path))
         else _stub(p) for path, p in flat]
    dev = flat[0][1].device if flat else torch.device("cpu")
    return OptState(m=unflatten_like(params, m),
                    v=unflatten_like(params, v), step=0,
                    spikes=torch.zeros((), dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# stochastic rounding
# ---------------------------------------------------------------------------

def _i32(u: int) -> int:
    """The int32 value with the bits of the uint32 ``u``."""
    u &= _M32
    return u - (1 << 32) if u >= (1 << 31) else u


_C1, _C2 = _i32(0x85EBCA6B), _i32(0xC2B2AE35)   # murmur3 finalizer


def _global_index(a: int, b: int, shard, device) -> torch.Tensor:
    """The flat indices in the whole leaf of a shard's flat elements
    [a, b) (int32; a column shard's are not contiguous)."""
    loc = torch.arange(a, b, dtype=torch.int64, device=device)
    out = torch.zeros_like(loc)
    stride_l = stride_g = 1
    for d in reversed(range(len(shard.local))):
        c = torch.div(loc, stride_l, rounding_mode="floor") % shard.local[d]
        out += (c + shard.start[d]) * stride_g
        stride_l *= shard.local[d]
        stride_g *= shard.shape[d]
    return out.to(torch.int32)


def stochastic_round(x: torch.Tensor, seed: int, out_dtype,
                     shard=None) -> torch.Tensor:
    """Round f32 ``x`` to bf16 stochastically (a plain cast to any other
    dtype): add 16 random bits to the f32 bit pattern and keep the high 16.
    The bits are the murmur3 finalizer of (flat element index ^ seed), as
    in the JAX package — bit for bit given the same uint32 ``seed`` (the
    JAX package draws it with ``jax.random.bits``). ``shard``: ``x`` is a
    rank's shard (``parallel/sharding.Shard``) and each element hashes its
    index in the whole leaf, as GSPMD's global iota does, so a shard's
    rounding is the slice of the whole leaf's. The uint32 arithmetic
    runs on int32 bit patterns: multiplication and addition wrap modulo
    2^32 as uint32 ones do, and each right shift is masked to a logical
    one. Chunked to bound the temporaries."""
    if out_dtype != torch.bfloat16:
        return x.to(out_dtype)
    whole = math.prod(shard.shape) if shard is not None else x.numel()
    if whole >= 1 << 31:
        raise ValueError(f"stochastic_round: {whole} elements: the "
                         f"element index must fit in 31 bits")
    if shard is not None and not shard.sharded:
        shard = None
    seed = _i32(int(seed))
    xf = x.to(torch.float32).reshape(-1)
    out = torch.empty(xf.shape, dtype=torch.int16, device=x.device)
    for a in range(0, xf.numel(), _SR_CHUNK):
        b = min(a + _SR_CHUNK, xf.numel())
        h = (torch.arange(a, b, dtype=torch.int32, device=x.device)
             if shard is None else _global_index(a, b, shard, x.device))
        h ^= seed
        h ^= (h >> 16) & 0xFFFF
        h *= _C1
        h ^= (h >> 13) & 0x7FFFF
        h *= _C2
        h ^= (h >> 16) & 0xFFFF
        h &= 0xFFFF
        h += xf[a:b].view(torch.int32)                  # bits + random
        h >>= 16
        h &= 0xFFFF                                     # the high 16 bits
        # the same 16 bits as a signed int16 value: (hi ^ 0x8000) - 0x8000
        h ^= 0x8000
        h -= 0x8000
        out[a:b].copy_(h)
    return out.view(torch.bfloat16).reshape(x.shape)


def _tag_seed(seed: Optional[int], tag: int) -> Optional[int]:
    """One stream per (leaf, tensor role): params 0, m 1, v 2."""
    if seed is None:
        return None
    return (int(seed) + tag * 0x9E3779B9) & _M32


def _store(x: torch.Tensor, dtype, seed: Optional[int], tag: int,
           shard=None) -> torch.Tensor:
    """Writeback to storage ``dtype``: stochastic when a seed is given."""
    if seed is None or dtype == x.dtype:
        return x.to(dtype)
    return stochastic_round(x, _tag_seed(seed, tag), dtype, shard)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_update(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay, step,
                 decay_mask=True, sr_seed=None):
    """One AdamW step of one leaf: (new_p, new_m, new_v, spikes), the new
    tensors in the storage dtypes of p, m and v."""
    mdt, vdt = m.dtype, v.dtype
    pf = p.to(torch.float32)
    m = beta1 * m.to(torch.float32) + (1 - beta1) * g
    v = beta2 * v.to(torch.float32) + (1 - beta2) * torch.square(g)
    mhat = m / (1 - beta1 ** step)
    vhat = v / (1 - beta2 ** step)
    upd = mhat / (torch.sqrt(vhat) + eps)
    spiked = torch.abs(upd) > T_SPIKE            # spike guard (T_spike)
    upd = torch.clamp(upd, -T_SPIKE, T_SPIKE)
    if decay_mask:
        upd = upd + weight_decay * pf
    new_p = _store(pf - lr * upd, p.dtype, sr_seed, 0)
    return (new_p, _store(m, mdt, sr_seed, 1), _store(v, vdt, sr_seed, 2),
            spiked.sum(dtype=torch.int32))


# ---------------------------------------------------------------------------
# Muon
# ---------------------------------------------------------------------------

_NS_COEFFS = (3.4445, -4.7750, 2.0315)  # quintic Newton–Schulz coefficients


def newton_schulz(G: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Approximate UVᵀ of G's SVD by the quintic odd-polynomial iteration,
    in bf16 (reference PIPE_Muon::CU_core, Optimizer.cu:487-580)."""
    a, b, c = _NS_COEFFS
    X = G.to(torch.bfloat16)
    transposed = X.shape[0] > X.shape[1]
    if transposed:
        X = X.T
    X = X / (torch.linalg.norm(X.to(torch.float32)) + 1e-7
             ).to(torch.bfloat16)
    for _ in range(steps):
        A = X @ X.T
        B = b * A + c * (A @ A)
        X = a * X + B @ X
    if transposed:
        X = X.T
    return X.to(torch.float32)


def _cheb_cubic_schedule(l0: float = 1e-3, steps: int = 10):
    """Minimax (Chebyshev-equioscillation) cubic coefficients (a, b) per
    step of the polar iteration over the singular-value interval [l, u]
    (the JAX package's derivation, ``optimizer.py:214-237``)."""
    coeffs, l, u = [], l0, 1.0
    for _ in range(steps):
        s = l * l + l * u + u * u
        babs = 2.0 / (l * (l * u + u * u)
                      + (2.0 * s / 3.0) * math.sqrt(s / 3.0))
        E = 1.0 - babs * l * (l * u + u * u)
        coeffs.append((babs * s, -babs))
        l, u = 1.0 - E, 1.0 + E
    return coeffs


def chebyshev_orth(G: torch.Tensor, steps: int = 10,
                   l0: float = 1e-3) -> torch.Tensor:
    """UVᵀ by the Chebyshev-accelerated cubic iteration, in f32."""
    X = G.to(torch.float32)
    transposed = X.shape[0] > X.shape[1]
    if transposed:
        X = X.T
    X = X / (torch.linalg.norm(X) + 1e-7)
    for a, b in _cheb_cubic_schedule(l0, steps):
        X = a * X + b * ((X @ X.T) @ X)
    if transposed:
        X = X.T
    return X


def muon_update(p, g, mom, *, lr, momentum, weight_decay, sr_seed=None,
                ortho: str = "ns", shard=None, whole=None):
    """One Muon step of one 2D leaf: (new_p, new_mom, spikes). On a shard
    (``shard``, with ``whole``: a pair of functions, the whole matrix from
    every rank's shard and this rank's slice of a whole one) the lookahead
    is gathered, orthogonalized whole and sliced back."""
    mdt = mom.dtype
    pf = p.to(torch.float32)
    mom = momentum * mom.to(torch.float32) + g
    if ortho not in ("ns", "chebyshev"):
        raise ValueError(f"muon_ortho={ortho!r}: 'ns' or 'chebyshev' "
                         "('gluon' is declared-only in the reference too)")
    orth = chebyshev_orth if ortho == "chebyshev" else newton_schulz
    look = momentum * mom + g                 # nesterov-style lookahead
    shape = p.shape
    if whole is not None:
        look, shape = whole[0](look), shard.shape
    u = orth(look)
    u = u * (0.2 * (max(shape[0], shape[-1]) ** 0.5))       # RMS match
    if whole is not None:
        u = whole[1](u)
    spiked = torch.abs(u) > T_SPIKE
    u = torch.clamp(u, -T_SPIKE, T_SPIKE)
    new_p = _store(pf - lr * (u + weight_decay * pf), p.dtype, sr_seed, 0,
                   shard)
    return (new_p, _store(mom, mdt, sr_seed, 1, shard),
            spiked.sum(dtype=torch.int32))


# ---------------------------------------------------------------------------
# combined apply
# ---------------------------------------------------------------------------

def lars_trust_ratio(p, g, lars_ratio: float, dims=None) -> torch.Tensor:
    """min(||w|| / (||g|| + 1e-8), lars_ratio) (GTensor::rLARS), the norms
    over ``dims`` (kept, to scale ``g``) or over every element."""
    keep = dims is not None
    wnorm = torch.linalg.vector_norm(p.to(torch.float32), dim=dims,
                                     keepdim=keep)
    gnorm = torch.linalg.vector_norm(g.to(torch.float32), dim=dims,
                                     keepdim=keep)
    return torch.clamp(wnorm / (gnorm + 1e-8), max=lars_ratio)


def _lars_ratios(idx, ps, gs, lars_ratio: float, dist) -> Dict[int, Any]:
    """{i: trust ratio} of leaves ``idx``. A sharded leaf's ||w|| and ||g||
    are the whole leaf's: the squares summed over every axis it is cut on
    (``dist.sum_over_shards``), then the roots. A stacked leaf (a pipeline
    stage's [L/P, ...] leaf, ``Shard.stacked``) takes one ratio a layer,
    its norms over dims 1.., shaped to scale the leaf layer by layer; its
    layers lie whole on their stage (the pipeline runs alone), so the
    norms are the stage's own."""
    stacked = {i for i in idx
               if dist is not None and dist.shards[i].stacked}
    out = {i: lars_trust_ratio(ps[i], gs[i], lars_ratio) for i in idx
           if i not in stacked
           and (dist is None or not dist.shards[i].sharded)}
    for i in stacked:
        out[i] = lars_trust_ratio(ps[i], gs[i], lars_ratio,
                                  tuple(range(1, ps[i].dim())))
    cut = [i for i in idx if i not in out]
    if cut:
        sq = dist.sum_over_shards({i: torch.stack([
            torch.sum(torch.square(ps[i].to(torch.float32))),
            torch.sum(torch.square(gs[i].to(torch.float32)))]) for i in cut})
        for i in cut:
            wnorm, gnorm = torch.sqrt(sq[i])
            out[i] = torch.clamp(wnorm / (gnorm + 1e-8), max=lars_ratio)
    return out


_GROUP_ELEMS = 1 << 26   # elements per foreach group (bounds temporaries)


def _adamw_foreach(ps, gs, ms, vs, *, lr, beta1, beta2, eps, wds, step,
                   seeds, shards=None, owned=None):
    """``adamw_update`` for a list of leaves at once: the same operations in
    the same order per element (so the same bits), launched as
    ``torch._foreach_*`` launches over all leaves instead of ~30 launches
    per leaf. Writes params and moments in place; returns the spike count.
    Stochastic rounding (``seeds`` not None) stays per leaf. ``shards``:
    the leaves' layouts on a sharded state; ``owned``: 1 where this rank
    counts the leaf's spikes, 0 where another rank's copy does."""
    sh = shards or [None] * len(ps)
    f32 = torch.float32
    pf = [p.to(f32) for p in ps]
    m = torch._foreach_mul([x.to(f32) for x in ms], beta1)
    torch._foreach_add_(m, torch._foreach_mul(gs, 1 - beta1))
    v = torch._foreach_mul([x.to(f32) for x in vs], beta2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_pow(gs, 2),
                                              1 - beta2))
    for i, (dst, x) in enumerate(zip(ms, m)):
        dst.copy_(_store(x, dst.dtype, None if seeds is None else seeds[i],
                         1, sh[i]))
    for i, (dst, x) in enumerate(zip(vs, v)):
        dst.copy_(_store(x, dst.dtype, None if seeds is None else seeds[i],
                         2, sh[i]))
    torch._foreach_div_(m, 1 - beta1 ** step)            # mhat
    torch._foreach_div_(v, 1 - beta2 ** step)            # vhat
    torch._foreach_sqrt_(v)
    torch._foreach_add_(v, eps)
    torch._foreach_div_(m, v)                            # upd
    # spike guard: count |upd| > T_SPIKE (as a sum of signs), then clamp
    over = torch._foreach_abs(m)
    torch._foreach_sub_(over, T_SPIKE)
    torch._foreach_clamp_min_(over, 0.0)
    torch._foreach_sign_(over)
    per_leaf = torch.stack(torch._foreach_norm(over, 1))
    if owned is not None:
        per_leaf = per_leaf * torch.tensor(owned, dtype=per_leaf.dtype,
                                           device=per_leaf.device)
    spikes = per_leaf.sum()
    del over
    torch._foreach_clamp_min_(m, -T_SPIKE)
    torch._foreach_clamp_max_(m, T_SPIKE)
    torch._foreach_add_(m, torch._foreach_mul(pf, wds))  # + wd·p
    torch._foreach_mul_(m, lr)
    new = torch._foreach_sub(pf, m)
    for i, (dst, x) in enumerate(zip(ps, new)):
        dst.copy_(_store(x, dst.dtype, None if seeds is None else seeds[i],
                         0, sh[i]))
    return spikes.to(torch.int32)


def _groups(idx, sizes):
    """Consecutive runs of ``idx`` of at most _GROUP_ELEMS elements (a
    larger leaf is a group of its own)."""
    out, cur, n = [], [], 0
    for i in idx:
        if cur and n + sizes[i] > _GROUP_ELEMS:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += sizes[i]
    if cur:
        out.append(cur)
    return out


@torch.no_grad()
def apply_updates(params, grads, opt: OptState, *, optimizer: str, lr,
                  beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
                  muon_momentum=0.95, grad_clip=1.0, lars_ratio=0.0,
                  muon_ortho="ns", sr_seeds: Optional[Sequence[int]] = None,
                  dist=None) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One optimizer step over the whole tree (grads already averaged):
    (params, opt, metrics). Parameters and moments are updated IN PLACE
    (the returned trees hold the same tensors). ``sr_seeds``: one uint32
    seed per leaf (leaf order) for stochastic rounding on every bf16
    writeback, or None for round-to-nearest. AdamW leaves are updated
    together (``_adamw_foreach``), Muon leaves one by one. ``dist``: the
    layout of a sharded state (``train/sharded.ShardedLayout``): params,
    grads and moments are this rank's shards, the norm and the spike count
    are the whole tree's."""
    grads, gnorm = clip_by_global_norm(grads, grad_clip, dist)
    shards = dist.shards if dist is not None else [None] * len(leaves(params))
    step = opt.step + 1
    spikes = torch.zeros((), dtype=torch.int32, device=opt.spikes.device)
    flat = flatten_with_path(params)
    g_leaves, m_leaves = leaves(grads), leaves(opt.m)
    v_leaves = leaves(opt.v) if opt.v is not None else [None] * len(flat)
    live = [i for i, ((_, p), g) in enumerate(zip(flat, g_leaves))
            if _is_float(p) and _real_grad(g)]
    if lars_ratio > 0.0:
        ps = [p for _, p in flat]
        # no ratio on norms and biases: a stacked leaf's layer of dim < 2
        ratios = _lars_ratios([i for i in live if ps[i].dim() - (
            shards[i] is not None and shards[i].stacked) >= 2], ps,
            g_leaves, lars_ratio, dist)
        for i, r in ratios.items():
            g_leaves[i] = g_leaves[i] * r
    adam = []
    for i in live:
        (path, p), g, m, v = flat[i], g_leaves[i], m_leaves[i], v_leaves[i]
        decay = p.dim() >= 2               # no weight decay on norms/biases
        if not _muon_leaf(p if shards[i] is None else
                          torch.empty(shards[i].shape, device="meta"),
                          optimizer, _path_str(path)):
            adam.append(i)
            continue
        whole = (dist.whole(i) if dist is not None and shards[i].sharded
                 else None)
        np_, nm, sp = muon_update(
            p, g, m, lr=lr, momentum=muon_momentum,
            weight_decay=weight_decay if decay else 0.0,
            sr_seed=sr_seeds[i] if sr_seeds is not None else None,
            ortho=muon_ortho, shard=shards[i], whole=whole)
        p.copy_(np_)
        m.copy_(nm)
        if dist is None or dist.owned[i]:
            spikes += sp
    sizes = [p.numel() for _, p in flat]
    for grp in _groups(adam, sizes):
        spikes += _adamw_foreach(
            [flat[i][1] for i in grp], [g_leaves[i] for i in grp],
            [m_leaves[i] for i in grp], [v_leaves[i] for i in grp], lr=lr,
            beta1=beta1, beta2=beta2, eps=eps,
            wds=[weight_decay if flat[i][1].dim() >= 2 else 0.0
                 for i in grp],
            step=step, seeds=(None if sr_seeds is None
                              else [sr_seeds[i] for i in grp]),
            shards=[shards[i] for i in grp],
            owned=(None if dist is None else [dist.owned[i] for i in grp]))
    if dist is not None:
        spikes = dist.sum_world(spikes).to(torch.int32)
    metrics = {"grad_norm": gnorm, "spikes": spikes}
    return params, OptState(m=opt.m, v=opt.v, step=step,
                            spikes=opt.spikes + spikes), metrics
