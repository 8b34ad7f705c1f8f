"""Fuyou — evolutionary optimization of experts (EOE, arXiv:2509.24436); the
JAX package's ``train/fuyou.py`` (the reference's Fuyou scheduler,
Scheduler.hpp:193-243, Scheduler.cpp:385-660, and its PSO / mutation /
crossover kernels, operator.cuh:340-391).

An "expert" is a layer-range branch: a swarm of K candidate weight sets
for a slice of layers is trained in turn, and every ``switch`` iterations
the swarm is pulled toward the best-scoring branch by PSO and/or genetic
crossover + mutation. The updates are elementwise PyTorch ops on the
params' device. Their random draws are arguments of ``_pso_step`` and
``_ga_step``; ``Fuyou`` makes them with ``pso_draws`` / ``ga_draws`` from a
``torch.Generator``, where the JAX package draws from ``jax.random``.

On a sharded state (``train/sharded.py``) each rank keeps its branches and
velocities as shards of the whole layers: every draw is taken at the whole
leaf's shape from a generator seeded alike on every rank and sliced to the
rank's shard, so the swarm is the one-rank swarm's, cut. A QTensor layer's
leaves (its packed codes too) take the steps as any leaf, as in the JAX
package (ROADMAP.md queue 3, known quirks).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from koifish_tpu_torch.utils.tree import (flatten_with_path, leaves,
                                          tree_map, unflatten_like)


@dataclasses.dataclass
class FuyouConfig:
    branches: int = 4
    switch: int = 100            # iterations per branch before rotating
    method: str = "pso_ga"       # pso | ga | mix | pso_ga
    crossover: float = 0.6
    mutation: float = 0.001
    social: float = 2.0          # PSO social coefficient
    inertia: float = 0.7
    layer_lo: int = 0            # branch layer range [lo, hi)
    layer_hi: int = -1           # -1 = all layers

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "FuyouConfig":
        return cls(branches=int(j.get("branch", 4)),
                   switch=int(j.get("switch", 100)),
                   method=str(j.get("method", "pso_ga")),
                   crossover=float(j.get("crossover", 0.6)),
                   mutation=float(j.get("mutation", 0.001)),
                   social=float(j.get("social", 2.0)))


def _copy_tree(t):
    """A copy of every tensor: branch stores must not alias the params the
    optimizer updates in place."""
    return tree_map(lambda x: x.detach().clone(), t)


def _slice_layers(params, lo, hi):
    return [dict(lp) for lp in params["layers"][lo:hi]]


def pso_draws(branch, gen: torch.Generator) -> List[torch.Tensor]:
    """One U[0, 1) f32 tensor per leaf of ``branch``, in leaf order."""
    return [torch.rand(x.shape, generator=gen, device=x.device)
            for x in leaves(branch)]


def ga_draws(branch, gen: torch.Generator
             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(U[0, 1), N(0, 1)) f32 tensors per leaf of ``branch``."""
    return [(torch.rand(x.shape, generator=gen, device=x.device),
             torch.randn(x.shape, generator=gen, device=x.device))
            for x in leaves(branch)]


def _pso_step(branch, best, velocity, draws: Sequence[torch.Tensor], *,
              inertia: float, social: float):
    """v <- w·v + c·r·(best - x);  x <- x + v  (CU_PSO_2D); ``draws`` holds
    r for each leaf. Returns (branch, velocity)."""
    out_x, out_v = [], []
    for x, b, v, r in zip(leaves(branch), leaves(best), leaves(velocity),
                          draws):
        xf = x.to(torch.float32)
        vf = inertia * v + social * r * (b.to(torch.float32) - xf)
        out_v.append(vf)
        out_x.append((xf + vf).to(x.dtype))
    return unflatten_like(branch, out_x), unflatten_like(velocity, out_v)


def _ga_step(branch, best, draws: Sequence[Tuple[torch.Tensor, torch.Tensor]],
             *, crossover: float, mutation: float):
    """Uniform crossover with the best branch, then Gaussian mutation
    (CU_crossover_ / CU_mutation_); ``draws`` holds (u, n) for each leaf."""
    out = []
    for x, b, (u, n) in zip(leaves(branch), leaves(best), draws):
        y = torch.where(u < crossover, b, x)
        out.append((y.to(torch.float32) + n * mutation).to(x.dtype))
    return unflatten_like(branch, out)


class Fuyou:
    """The swarm around the params::

        fy = Fuyou(cfg, state.params)
        params = fy.inject(state.params)          # activate branch 0
        ... train ``switch`` iters, record the loss ...
        params = fy.rotate(params, recent_loss, gen)
    """

    def __init__(self, cfg: FuyouConfig, params, layout=None):
        """``layout``: a sharded state's ``ShardedLayout`` (``params`` are
        this rank's shards), else None."""
        self.cfg = cfg
        n_layers = len(params["layers"])
        self.lo = cfg.layer_lo
        self.hi = cfg.layer_hi if cfg.layer_hi > 0 else n_layers
        base = _slice_layers(params, self.lo, self.hi)
        self.shards = None
        if layout is not None:
            self.shards = [sh for (path, _), sh in
                           zip(flatten_with_path(params), layout.shards)
                           if path[0] == "layers"
                           and self.lo <= path[1] < self.hi]
        self.branches: List[Any] = [_copy_tree(base)
                                    for _ in range(cfg.branches)]
        self.velocity = [tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), base)
            for _ in range(cfg.branches)]
        self.scores = np.full(cfg.branches, np.inf)
        self.cur = 0

    def inject(self, params):
        out = dict(params)
        layers = list(params["layers"])
        layers[self.lo:self.hi] = _copy_tree(self.branches[self.cur])
        out["layers"] = layers
        return out

    def extract(self, params):
        self.branches[self.cur] = _copy_tree(
            _slice_layers(params, self.lo, self.hi))

    @property
    def best(self) -> int:
        return int(np.argmin(self.scores))

    def rotate(self, params, recent_loss: float, gen: torch.Generator):
        """Record the active branch's score, pull the others toward the
        best, switch to the next branch and return params with it injected
        (ExploreOptimization, gLLM.cpp:673-677)."""
        self.extract(params)
        self.scores[self.cur] = recent_loss
        self._exploit(gen)
        self.cur = (self.cur + 1) % self.cfg.branches
        return self.inject(params)

    def _draws(self, fn, branch, gen: torch.Generator):
        """``fn(branch, gen)``'s draws; on a sharded state drawn at the
        whole leaves' shapes and sliced to this rank's shards."""
        if self.shards is None:
            return fn(branch, gen)
        from koifish_tpu_torch.parallel.sharding import take
        whole = unflatten_like(branch, [
            torch.empty((), device=x.device).expand(sh.shape)
            for x, sh in zip(leaves(branch), self.shards)])
        return [tuple(take(t, sh) for t in d) if isinstance(d, tuple)
                else take(d, sh) for d, sh in zip(fn(whole, gen), self.shards)]

    def _exploit(self, gen: torch.Generator):
        if not np.isfinite(self.scores).any():
            return
        best = self.branches[self.best]
        method = self.cfg.method
        for i in range(self.cfg.branches):
            if i == self.best or not np.isfinite(self.scores[i]):
                continue
            if method in ("pso", "pso_ga", "mix"):
                self.branches[i], self.velocity[i] = _pso_step(
                    self.branches[i], best, self.velocity[i],
                    self._draws(pso_draws, self.branches[i], gen),
                    inertia=self.cfg.inertia, social=self.cfg.social * 0.01)
            if method in ("ga", "pso_ga", "mix"):
                self.branches[i] = _ga_step(
                    self.branches[i], best,
                    self._draws(ga_draws, self.branches[i], gen),
                    crossover=self.cfg.crossover, mutation=self.cfg.mutation)
