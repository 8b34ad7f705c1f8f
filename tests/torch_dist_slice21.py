"""Rank workers for ``tests/test_torch_slice21.py``: the pipeline's LARS
and ``bubble --tp 2`` on the zoo cards the JAX package serves, each rank a
process started by ``koifish_tpu_torch.parallel.multihost.spawn`` on the
CPU (gloo).

As in ``tests/torch_dist_helpers.py`` this module imports torch and the
port only. A worker reads ``inp`` (``torch.save`` of plain data made by the
test), runs each job it names and writes what rank r saw to
``out/rank{r}.pt``.
"""
from __future__ import annotations

import torch

from koifish_tpu_torch.config import ModelCard, TrainCard
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.utils.tree import flatten_with_path

from torch_dist_helpers import _join, _np, _save
from torch_dist_slice20 import planted


def path_key(path) -> str:
    return "/".join(str(k) for k in path)


def pp_lars_steps(mesh, run):
    """Pipeline steps (1F1B, ``run["n_micro"]`` micro-batches) of ``run``'s
    card from its init, one a batch: (losses, grad norms, {path: first
    moment}), a stage leaf's moment gathered whole over ``pp`` ([L, ...])."""
    from koifish_tpu_torch.parallel import comm
    from koifish_tpu_torch.parallel import pipeline as pl
    from koifish_tpu_torch.train.optimizer import init_opt_state
    card = ModelCard.from_arch(run["arch"], **run["card"])
    tcard = TrainCard(**run["tcard"])
    sl, ot = pl.stack_for_pipeline(params_from_numpy(run["init"],
                                                     device="cpu"),
                                   mesh.size("pp"), stage=mesh.index("pp"))
    opt = init_opt_state({"stages": sl, "other": ot}, tcard.optimizer)
    step = pl.make_pp_train_step(card, tcard, mesh, run["n_micro"], 10)
    losses, gnorms = [], []
    for b in run["batches"]:
        sl, ot, opt, m = step(sl, ot, opt, torch.from_numpy(b).long())
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    moments = {}
    for path, x in flatten_with_path(opt.m):
        if path[0] == "stages":
            x = comm.all_gather_cat(x.detach(), mesh.group("pp"), 0)
        moments[path_key(path)] = _np(x)
    return losses, gnorms, moments


def slice21_worker(inp_path: str, out: str) -> None:
    """Every job of ``inp["jobs"]`` on one group of ``inp["world"]`` ranks,
    in order; each job's result under its name. Kinds: ``"pp_lars"``
    (``pp_lars_steps`` on a ``{"pp": world}`` mesh, under the planted
    ``"fault"`` of ``torch_dist_slice20.planted`` if any) and ``"bubble"``
    (``bubble.main(argv)``: each turn's prompt ids and tokens, or the
    NotImplementedError it raised)."""
    inp = torch.load(inp_path, weights_only=False)
    mesh = _join({"dp": inp["world"]})    # the group; each job its mesh
    res = {}
    for name, job in inp["jobs"].items():
        if job["kind"] == "pp_lars":
            from koifish_tpu_torch.parallel import make_process_mesh
            pp = make_process_mesh({"pp": inp["world"]}, "cpu")
            with planted(job.get("fault")):
                res[name] = pp_lars_steps(pp, job)
        elif job["kind"] == "bubble":
            from koifish_tpu_torch.cli import bubble
            turns = []
            try:
                bubble.main(list(job["argv"]), turns=turns)
            except NotImplementedError as e:
                res[name] = ("raised", str(e))
                continue
            res[name] = [(t["prompt_ids"], t["tokens"]) for t in turns]
        else:
            raise ValueError(job["kind"])
    _save(out, mesh, res)
