"""The collectives of the process mesh (``parallel/mesh.ProcessMesh``).

The JAX package leaves every collective to GSPMD; here each one is a call
in the port's own code, through these functions. A CUDA tensor goes to the
backend as it is, except under gloo (the CPU, and ranks that share a card)
for ``send`` and ``recv``: gloo hands their CUDA pointer to the socket and
the process aborts, so they are copied through a pinned host buffer. Gloo
takes the other collectives on CUDA tensors (``chip_smoke.py``'s parallel
phase tries each on the card).

The autograd functions are Megatron's: ``copy_to`` (identity forward,
all-reduce backward) in front of a column-parallel region, ``reduce_from``
(all-reduce forward in f32, identity backward) behind a row-parallel one,
``gather_from`` (all-gather forward, own slice backward) for a replicated
computation that reads every shard, and its mirror ``split_to`` (own slice
forward, all-gather backward) into a sharded one. ``permute`` is the JAX
ring's ``ppermute``: each rank of an axis sends to the next and receives
from the one before, the reverse permute its backward.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

def _staged(device: torch.device) -> bool:
    """Whether a point-to-point transfer on ``device`` goes through host
    memory (a CUDA tensor under gloo)."""
    return device.type == "cuda" and dist.get_backend() == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (None: a group of one)."""
    if group is None:
        return t
    dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """In place from global rank ``src`` (None: a group of one)."""
    if group is None:
        return t
    dist.broadcast(t, src, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank), in rank order."""
    n = group_size(group)
    if n == 1:
        return [t]
    src = t.contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return out


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = all_gather(t, group)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def send(t: torch.Tensor, dst: int):
    """Start sending ``t`` to global rank ``dst``; returns a handle with
    ``wait()``."""
    src = _host(t) if _staged(t.device) else t.contiguous()
    return dist.isend(src, dst)


def exchange(t: torch.Tensor, dst: int, src: int) -> torch.Tensor:
    """Send ``t`` to global rank ``dst`` while receiving a tensor of its
    shape and dtype from global rank ``src`` (one step of a ring: both
    posted together, so no rank waits on another's send)."""
    dev = t.device
    staged = _staged(dev)
    out = _host(t) if staged else t.contiguous()
    buf = torch.empty(t.shape, dtype=t.dtype, device="cpu" if staged else dev,
                      pin_memory=staged)
    for h in dist.batch_isend_irecv([dist.P2POp(dist.isend, out, dst),
                                     dist.P2POp(dist.irecv, buf, src)]):
        h.wait()
    return buf.to(dev) if staged else buf


def recv(shape, dtype, src: int, device) -> torch.Tensor:
    """Receive a tensor of ``shape``/``dtype`` from global rank ``src``."""
    dev = torch.device(device)
    staged = _staged(dev)
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if staged else dev, pin_memory=staged)
    dist.recv(buf, src)
    return buf.to(dev) if staged else buf


# ---------------------------------------------------------------------------
# autograd functions of tensor parallelism
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.to(torch.float32).contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // group_size(group)
        return x.narrow(dim, group_rank(group) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g.contiguous(), ctx.group, ctx.dim), None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, index):
        ctx.ranks, ctx.index = ranks, index
        n = len(ranks)
        return exchange(x, ranks[(index + 1) % n], ranks[(index - 1) % n])

    @staticmethod
    def backward(ctx, g):
        n, i = len(ctx.ranks), ctx.index
        return (exchange(g, ctx.ranks[(i - 1) % n], ctx.ranks[(i + 1) % n]),
                None, None)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient is summed over ``group``."""
    if group is None:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The f32 sum of every rank's partial ``x``; identity backward."""
    if group is None:
        return x.to(torch.float32)
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim``; the gradient of a rank's
    part is its slice of the (replicated) gradient."""
    if group is None:
        return x
    return _GatherFrom.apply(x, group, dim)


def split_to(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice of a replicated ``x`` along ``dim`` (the ranks of
    ``group`` in order, equal slices); the gradient of the whole is every
    rank's slice gradient, all-gathered."""
    if group is None:
        return x
    if x.shape[dim] % group_size(group):
        raise ValueError(f"split_to: dim {dim} of {tuple(x.shape)} does not "
                         f"divide over {group_size(group)} ranks")
    return _SplitTo.apply(x, group, dim)


def permute(x: torch.Tensor, ranks: List[int], index: int) -> torch.Tensor:
    """The ring step of an axis whose global ranks are ``ranks`` (this rank
    at ``index``): ``x`` goes to ``ranks[index + 1]`` and the result is
    ``ranks[index - 1]``'s (both mod the ring). Differentiable: the
    gradient takes the reverse step."""
    if len(ranks) == 1:
        return x
    return _Permute.apply(x, list(ranks), index)
