"""Rank workers for the slice-20 tests (``tests/test_torch_slice20*.py``):
the method combinations on a process mesh, each rank a process started by
``koifish_tpu_torch.parallel.multihost.spawn`` on the CPU (gloo).

As in ``tests/torch_dist_helpers.py`` this module imports torch and the
port only. A worker reads ``inp`` (``torch.save`` of plain data made by the
test), runs what it names and writes what rank r saw to ``out/rank{r}.pt``.
Planted faults are named in ``inp`` and applied here, in the rank, by
patching the port for one run.
"""
from __future__ import annotations

import contextlib
import os

import torch

from koifish_tpu_torch.config import ModelCard, TrainCard
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.utils.tree import leaves

from torch_dist_helpers import _join, _np, _save


@contextlib.contextmanager
def planted(fault):
    """A fault of the port, in force for one run: ``"lars_local"`` (LARS
    takes each shard's own norms), ``"lars_whole_stack"`` (no pipeline
    stage leaf is marked stacked, so LARS takes one ratio over each whole
    [L, ...] stack and one on the stacked norms: the layout before slice
    21), ``"fuyou_shard_draws"`` (the swarm draws
    at the shard's shape), ``"pp_stage_index"`` (the pipeline's stage
    leaves hash their local index), ``"spec_seed"`` (rank 1 seeds its
    speculative generators otherwise)."""
    undo = []

    def patch(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "lars_local":
        from koifish_tpu_torch.train.sharded import ShardedLayout
        patch(ShardedLayout, "sum_over_shards", lambda self, parts: parts)
    elif fault == "lars_whole_stack":
        import dataclasses

        from koifish_tpu_torch.parallel import pipeline as pl
        real = pl._pp_layout

        def whole(*a, **k):
            lay = real(*a, **k)
            lay.shards = [dataclasses.replace(sh, stacked=False)
                          for sh in lay.shards]
            return lay
        patch(pl, "_pp_layout", whole)
    elif fault == "fuyou_shard_draws":
        from koifish_tpu_torch.train.fuyou import Fuyou
        patch(Fuyou, "_draws", lambda self, fn, branch, gen: fn(branch, gen))
    elif fault == "pp_stage_index":
        from koifish_tpu_torch.parallel import pipeline as pl
        from koifish_tpu_torch.parallel.sharding import Shard
        from koifish_tpu_torch.train.sharded import ShardedLayout

        def local(mesh, stage_layers, other, axis="pp"):
            shards = [Shard(tuple(x.shape), (None,) * x.dim(),
                            (0,) * x.dim(), tuple(x.shape))
                      for x in leaves({"other": other,
                                       "stages": stage_layers})]
            lay = ShardedLayout(mesh, shards)
            n = len(leaves(other))      # a stage counts its own leaves
            lay.owned = lay.owned[:n] + [1.0] * (len(shards) - n)
            return lay
        patch(pl, "_pp_layout", local)
    elif fault == "spec_seed":
        import torch.distributed as dist

        from koifish_tpu_torch.cli import bubble
        real = bubble.speculative_generate

        def reseeded(*a, **k):
            return real(*a, **dict(k, seed=dist.get_rank()))
        patch(bubble, "speculative_generate", reseeded)
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)


def _adapters(lora):
    """A ``train/lora.add_lora`` that keeps the port's tree and puts in
    the JAX CLI's adapters (the two draw from different generators)."""
    from koifish_tpu_torch.train import lora as tlora
    real = tlora.add_lora

    def add(*a, **k):
        out = real(*a, **k)
        jt = params_from_numpy(lora, device="cpu")
        for lp, jl in zip(out["layers"], jt["layers"]):
            for name in [n for n in lp if n.endswith("_lora")]:
                lp[name] = jl[name]
        return out
    return add


def _cli(argv, out_dir, fault=None, lora=None):
    """``koifish.main(argv)`` in this rank's group: (losses, grad norms,
    the run's result dict)."""
    from koifish_tpu_torch.cli import koifish
    from koifish_tpu_torch.train import lora as tlora
    result = {}
    real = tlora.add_lora
    if lora is not None:
        tlora.add_lora = _adapters(lora)
    try:
        with planted(fault):
            rc = koifish.main(list(argv) + ["--device", "cpu", "--out-dir",
                                            out_dir], result)
    finally:
        tlora.add_lora = real
    assert rc == 0, rc
    infos = result["infos"]
    return infos.losses, list(infos.grad_norms), result


def _moments(result):
    """The first moments of a ``koifish.main`` result's state, whole (every
    rank takes part), as numpy."""
    from koifish_tpu_torch.train.sharded import gather_train_state
    st = result.get("state")
    if st is None:
        return None
    return [_np(x) for x in leaves(gather_train_state(st).opt.m)]


def _pp_step(mesh, run):
    """Pipeline steps (1F1B, 4 micro-batches) of ``run``'s card and init
    on ``mesh``, one a batch: (losses, grad norms, every first moment and
    every param whole, as numpy)."""
    from koifish_tpu_torch.parallel import comm
    from koifish_tpu_torch.parallel import pipeline as pl
    from koifish_tpu_torch.train.optimizer import init_opt_state
    card = ModelCard.from_arch(run["arch"], **run["card"])
    tcard = TrainCard(**run["tcard"])
    sl, ot = pl.stack_for_pipeline(params_from_numpy(run["init"],
                                                     device="cpu"),
                                   mesh.size("pp"), stage=mesh.index("pp"))
    opt = init_opt_state({"stages": sl, "other": ot}, tcard.optimizer)
    step = pl.make_pp_train_step(card, tcard, mesh, 4, 10)
    losses, gnorms = [], []
    for b in run["batches"]:
        sl, ot, opt, m = step(sl, ot, opt, torch.from_numpy(b).long())
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    def whole(other, stages):
        return ([_np(x) for x in leaves(other)]
                + [_np(comm.all_gather_cat(x.detach(), mesh.group("pp"), 0))
                   for x in leaves(stages)])
    return (losses, gnorms, whole(opt.m["other"], opt.m["stages"]),
            whole(ot, sl))


def _swarm(mesh, run, fault=None):
    """Fuyou over this rank's shards of ``run``'s init (``shard_train_state``
    under ``run["fsdp"]``): two rotations with set scores from a generator
    seeded alike on every rank; every branch and velocity gathered whole,
    as numpy."""
    from koifish_tpu_torch.parallel.sharding import gather_leaf
    from koifish_tpu_torch.train.fuyou import Fuyou, FuyouConfig
    from koifish_tpu_torch.train.sharded import shard_train_state
    from koifish_tpu_torch.train.trainer import init_train_state
    card = ModelCard.from_arch(run["arch"], **run["card"])
    st = init_train_state(card, TrainCard(batch=2),
                          params=params_from_numpy(run["init"],
                                                   device="cpu"),
                          device="cpu")
    st = shard_train_state(st, mesh, fsdp="dp" if run.get("fsdp") else None)
    fy = Fuyou(FuyouConfig(branches=3, method="pso_ga", mutation=1e-2),
               st.params, layout=st.layout)
    gen = torch.Generator().manual_seed(5)
    params = fy.inject(st.params)
    with planted(fault), torch.no_grad():
        for loss in (3.0, 2.5, 2.8):
            # the active branch moves between rotations, as training would
            params = dict(params, layers=[
                {n: (w * 1.01 if w.is_floating_point() else w)
                 if isinstance(w, torch.Tensor) else w
                 for n, w in lp.items()} for lp in params["layers"]])
            params = fy.rotate(params, loss, gen)
    out = []
    for tree in fy.branches + fy.velocity:
        out.append([_np(gather_leaf(x, sh, mesh))
                    for x, sh in zip(leaves(tree), fy.shards)])
    return out


def slice20_worker(inp_path: str, out: str) -> None:
    """Every job of ``inp["jobs"]`` on one group of ``inp["world"]`` ranks,
    in order; each job's result under its name."""
    inp = torch.load(inp_path, weights_only=False)
    world = inp["world"]
    mesh = _join({"dp": world})      # the group; each job makes its mesh
    res = {}
    for name, job in inp["jobs"].items():
        d = os.path.join(out, f"{name}{mesh.rank}")
        kind = job["kind"]
        if kind == "cli":
            losses, gnorms, r = _cli(job["argv"], d, job.get("fault"),
                                     job.get("lora"))
            res[name] = (losses, gnorms, _moments(r))
        elif kind == "cli_raises":
            try:
                _cli(job["argv"], d, lora=job.get("lora"))
                res[name] = None
            except NotImplementedError as e:
                res[name] = str(e)
        elif kind == "pp_step":
            from koifish_tpu_torch.parallel import make_process_mesh
            with planted(job.get("fault")):
                res[name] = _pp_step(make_process_mesh({"pp": world}, "cpu"),
                                     job)
        elif kind == "swarm":
            from koifish_tpu_torch.parallel import make_process_mesh
            res[name] = _swarm(make_process_mesh(job["axes"], "cpu"), job,
                               job.get("fault"))
        elif kind == "bubble":
            from koifish_tpu_torch.cli import bubble
            turns = []
            try:
                with planted(job.get("fault")):
                    bubble.main(list(job["argv"]), turns=turns)
            except RuntimeError as e:
                res[name] = ("raised", str(e))
                continue
            res[name] = [(t["prompt_ids"], t["tokens"], t["stats"])
                         for t in turns]
        else:
            raise ValueError(kind)
    _save(out, mesh, res)
