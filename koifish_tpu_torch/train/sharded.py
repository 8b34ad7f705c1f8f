"""Sharded training: a TrainState cut into rank-local shards over a process
mesh (the JAX package's ``train/sharded.py``).

The JAX package puts the state on a Mesh and lets GSPMD insert the
collectives; here each rank holds its shards (``shard_train_state``) and
``train/trainer.make_train_step`` runs the collectives itself when the
state carries a ``ShardedLayout``:

- TP: the layers of ``parallel/sharding.local_card`` under a
  ``TPPolicy`` (the row-parallel sums, the vocab-parallel embedding and
  head in the model code);
- DP: each rank's batch rows (``shard_batch``); the masked loss is the
  global masked mean (each rank's numerator over the global token count),
  and the gradients are summed over ``dp`` (``parallel/overlap.py``);
- FSDP: params and moments also cut on their other axis over ``dp`` (a
  gama QTensor's codes and scales with their parent weight's spec); the
  step gathers the whole (tp-local) params, and the gradients are
  reduce-scattered back to the shards;
- the optimizer's global norm, spike count, stochastic rounding, Muon and
  LARS see the whole tree (``train/optimizer.py`` with ``dist=``).

LoRA adapters and LLAMA_VAE's ``evae`` stack are refused on a mesh of more
than one rank, where the JAX package's ``shard_params`` fails
(``parallel/sharding.check_mesh_params``).

``gather_train_state`` rebuilds the whole state (for a checkpoint that is
the same file as a one-rank run's, written by rank 0).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from koifish_tpu_torch.ops.tracectx import TPPolicy
from koifish_tpu_torch.parallel import comm
from koifish_tpu_torch.parallel.sharding import (Shard, check_mesh_params,
                                                 gather_leaf, gather_params,
                                                 leaf_shards, local_card,
                                                 rebuild, shard_params, take)
from koifish_tpu_torch.train.optimizer import OptState
from koifish_tpu_torch.train.trainer import TrainState
from koifish_tpu_torch.utils.tree import leaves


class ShardedLayout:
    """Where every leaf of a sharded state lives: the mesh, each leaf's
    ``Shard`` and whether FSDP is on. ``owned[i]`` is 1 on the one rank
    that counts leaf i in a whole-tree sum (norms, spikes) and 0 on the
    ranks with a copy of the same part."""

    def __init__(self, mesh, shards: List[Shard], fsdp: bool = False):
        self.mesh, self.shards, self.fsdp = mesh, shards, fsdp
        self.owned = []
        for sh in shards:
            split = set(sh.axes())
            own = all(mesh.index(a) == 0 for a in mesh.shape
                      if a not in split)
            self.owned.append(1.0 if own else 0.0)

    # -- the step's parallel pieces --------------------------------------

    def tp_policy(self, card) -> Optional[TPPolicy]:
        m = self.mesh
        if m.size("tp") == 1:
            return None
        return TPPolicy(group=m.group("tp"), rank=m.index("tp"),
                        size=m.size("tp"), vocab=card.vocab_size,
                        src=m.ranks("tp")[0])

    def run_card(self, card):
        return local_card(card, self.mesh.size("tp"))

    def fsdp_dim(self, i: int) -> Optional[int]:
        """The dim of leaf i cut over ``dp`` (FSDP), or None."""
        if not self.fsdp:
            return None
        sp = self.shards[i].spec
        return sp.index("dp") if "dp" in sp else None

    def gather_fsdp(self, x: torch.Tensor, i: int) -> torch.Tensor:
        d = self.fsdp_dim(i)
        if d is None:
            return x
        return comm.all_gather_cat(x.detach(), self.mesh.group("dp"), d)

    @staticmethod
    def with_leaves(params, flat: List[torch.Tensor]):
        """``params`` over the FSDP-gathered leaves ``flat``: a QTensor's
        logical shape grows with its codes (the scales and codes of a gama
        weight are gathered as any FSDP leaf)."""
        def qshape(qt, vals):
            return tuple(n * (g // c) for n, g, c in
                         zip(qt.shape, vals["codes"].shape, qt.codes.shape))
        return rebuild(params, flat, qshape)

    def loss_weights(self, tokens: torch.Tensor, loss_mask) -> torch.Tensor:
        """[A] f32: micro-batch a's local mean loss times this weight is
        its share of the global masked mean (this rank's counted tokens
        over the dp group's)."""
        A = tokens.shape[0]
        if loss_mask is not None:
            cnt = loss_mask[:, :, 1:].to(torch.float32).reshape(A, -1).sum(-1)
        else:
            cnt = torch.full((A,), float(tokens[0, :, 1:].numel()),
                             device=tokens.device)
        total = comm.all_reduce_(cnt.clone(), self.mesh.group("dp"))
        return cnt / torch.clamp(total, min=1.0)

    # -- whole-tree sums --------------------------------------------------

    def sum_world(self, x: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce_(x.to(torch.float32).clone(),
                                self.mesh.world_group)

    def global_norm(self, norms, live: List[int]) -> torch.Tensor:
        """The norm of the whole tree from each leaf's local norm."""
        if not live:
            return torch.zeros(())
        sq = torch.stack(list(norms)) ** 2
        w = torch.tensor([self.owned[i] for i in live], dtype=sq.dtype,
                         device=sq.device)
        return torch.sqrt(self.sum_world((sq * w).sum()))

    def leaf_norms(self, grads: List[torch.Tensor]) -> torch.Tensor:
        sq = torch.stack([
            torch.sum(torch.square(g.to(torch.float32))) * self.owned[i]
            if g.numel() else torch.zeros((), device=g.device)
            for i, g in enumerate(grads)])
        return torch.sqrt(self.sum_world(sq))

    def sum_over_shards(self, parts: Dict[int, torch.Tensor]
                        ) -> Dict[int, torch.Tensor]:
        """{i: x summed over the axes leaf i is cut on}: each leaf's local
        partial sums made whole-leaf sums, one all-reduce per axis for all
        the leaves cut on the same axes (a replicated leaf's as it is)."""
        by_axes: Dict[tuple, List[int]] = {}
        for i in parts:
            by_axes.setdefault(tuple(self.shards[i].axes()), []).append(i)
        out = {}
        for axes, idx in by_axes.items():
            x = torch.stack([parts[i].to(torch.float32) for i in idx])
            for a in axes:
                x = comm.all_reduce_(x, self.mesh.group(a))
            out.update(zip(idx, x.unbind(0)))
        return out

    def whole(self, i: int):
        """(whole matrix from every rank's shard, this rank's slice of a
        whole one) for leaf i: the Muon leaf's gather."""
        sh = self.shards[i]
        return (lambda x: gather_leaf(x, sh, self.mesh),
                lambda full: take(full, sh))


def shard_train_state(state: TrainState, mesh, tp: str = "tp",
                      fsdp: Optional[str] = None) -> TrainState:
    """This rank's shards of a whole TrainState: params and moments under
    the TP(/FSDP) layout (the moments share the params' specs: ZeRO-style
    optimizer sharding comes with fsdp), the step count and generator as
    they are. ``fsdp``: None or ``"dp"``."""
    if fsdp not in (None, "dp"):
        raise ValueError(f"fsdp={fsdp!r}: the FSDP axis is 'dp'")
    check_mesh_params(state.params, math.prod(
        mesh.size(a) for a in ("dp", "tp", "sp")))
    shards = leaf_shards(state.params, mesh, tp, fsdp)
    params = shard_params(state.params, mesh, shards=shards)
    for p in leaves(params):
        if p.is_floating_point():
            p.requires_grad_(True)

    def cut(tree):
        if tree is None:
            return None
        return rebuild(tree, [take(x, sh) if x.numel() else x
                              for x, sh in zip(leaves(tree), shards)])

    opt = OptState(m=cut(state.opt.m), v=cut(state.opt.v),
                   step=state.opt.step, spikes=state.opt.spikes.clone())
    return TrainState(params=params, opt=opt, gen=state.gen,
                      layout=ShardedLayout(mesh, shards,
                                           fsdp=fsdp is not None))


def gather_train_state(state: TrainState) -> TrainState:
    """The whole TrainState from every rank's shards (every rank of the
    mesh takes part and gets it)."""
    lay = state.layout
    if lay is None:
        return state
    params = gather_params(state.params, lay.shards, lay.mesh)

    def whole(tree):
        if tree is None:
            return None
        return rebuild(tree, [
            gather_leaf(x, sh, lay.mesh) if x.numel() and sh.sharded else x
            for x, sh in zip(leaves(tree), lay.shards)])

    opt = OptState(m=whole(state.opt.m), v=whole(state.opt.v),
                   step=state.opt.step, spikes=state.opt.spikes)
    return TrainState(params=params, opt=opt, gen=state.gen)


def shard_batch(batch: Dict[str, Any], mesh, dp: str = "dp",
                global_batch: Optional[int] = None) -> Dict[str, Any]:
    """This rank's rows of [A, B, T] batch arrays (the batch axis on
    ``dp``). Where a rank is fed its rows only, pass them with
    ``global_batch`` and they are checked and kept."""
    from koifish_tpu_torch.parallel.multihost import per_host_batch_slice
    n = mesh.size(dp)
    out = {}
    for k, v in batch.items():
        B = v.shape[1]
        if global_batch is not None and B * n == global_batch:
            out[k] = v
            continue
        if B % n:
            raise ValueError(f"shard_batch: batch {B} does not divide over "
                             f"{dp}={n}")
        out[k] = v[:, per_host_batch_slice(B, mesh)]
    return out


