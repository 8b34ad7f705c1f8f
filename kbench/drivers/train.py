"""Driver ``train``: pretraining through the port's train step.

Set-up writes a token shard from the seed into ``TMPDIR`` and reads it
back through ``data/tokenset.TokenDataset`` (the native batch server),
makes the weights on the device from the seed, builds the step that
``train/trainer.train_loop`` runs (``make_train_step``) and its state
(``init_train_state``), and drives that one object through the mix's
``checked_steps`` on rows that all differ: they load the kernels, and
their losses, the first gradient (read from the first moment after one
step) and the parameters' change after them are what the reference is
held to. The window then runs the same step on the same state, one batch
after another, as ``train_loop`` does: a step is timed to the transfer of
its loss to the host. After the window the state is freed and the plain
reference follows the checked steps on the same weights and rows.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np

from kbench import harness, trace, weights, work
from kbench.reference.quant import lowp_lin
from kbench.reference.train import run_steps
from kbench.traffic import check_keys

#: the keys of a mix this driver reads (``why`` documents it)
KEYS = {"driver", "why", "batch", "seq_len", "shard_tokens", "checked_steps",
        "profiled_steps", "reference_rows"}


def _program_card(rc: harness.RunContext):
    from koifish_tpu_torch.config import CLIParams
    p = CLIParams.from_json(rc.config["koifish"])
    tr = rc.traffic
    check_keys(tr, KEYS, "train mix")
    tcard = dataclasses.replace(
        p.train, batch=int(tr["batch"]), dump_every=0,
        seed=weights.subseed(rc.seed, "train"))
    if p.model.n_ctx != int(tr["seq_len"]):
        raise ValueError(f"the mix's seq_len {tr['seq_len']} is not the "
                         f"configuration's Ctx {p.model.n_ctx}")
    rec = rc.config["recipe"]
    got = {"lr": tcard.lr, "warmup": tcard.warmup, "epochs": tcard.epochs,
           "min_ratio": tcard.lr_min_ratio, "beta1": tcard.beta1,
           "beta2": tcard.beta2, "eps": tcard.eps,
           "weight_decay": tcard.weight_decay, "grad_clip": tcard.grad_clip,
           "moment_dtype": tcard.moment_dtype, "remat": tcard.remat,
           "int8_matmul": tcard.int8_matmul, "int8_min_kn": tcard.int8_min_kn,
           "int8_dgrad": tcard.int8_dgrad, "int8_wgrad": tcard.int8_wgrad,
           "fused_ce": tcard.fused_ce}
    off = {k: (got[k], rec[k]) for k in got if got[k] != rec[k]}
    if off or tcard.optimizer != "adamw" or tcard.grad_accum != 1:
        raise ValueError(f"the program's train card departs from the "
                         f"recipe: {off}")
    return p.model, tcard


def _shard(rc: harness.RunContext, d: str) -> str:
    from koifish_tpu_torch.data.tokenset import (MAGIC_GPT2, MAGIC_QWEN3,
                                                  write_shard)
    data = rc.config["data"]
    rng = np.random.default_rng(weights.subseed(rc.seed, "shard"))
    toks = rng.integers(0, int(data["vocab"]), int(rc.traffic["shard_tokens"]),
                        dtype=np.int64)
    magic = MAGIC_GPT2 if data["magic"] == "gpt2" else MAGIC_QWEN3
    path = os.path.join(d, "train_000.bin")
    write_shard(path, toks, magic=magic, vocab_size=int(data["vocab"]))
    return path


def _leaf_norms(tree, scale: float = 1.0) -> List[float]:
    import torch
    return [float(torch.linalg.vector_norm(t.detach().to(torch.float32)))
            * scale
            for _, t in weights.named(tree)]


def run(rc: harness.RunContext) -> harness.Result:
    import torch
    from koifish_tpu_torch.data import TokenDataset
    from koifish_tpu_torch.train.optimizer import apply_updates
    from koifish_tpu_torch.train.trainer import (init_train_state,
                                                 make_train_step)
    from koifish_tpu_torch.utils.tree import leaves, unflatten_like

    dev = rc.device
    sync = (torch.cuda.synchronize if dev == "cuda" else (lambda: None))
    sh = work.Shapes.from_config(rc.config)
    card, tcard = _program_card(rc)
    B, T = tcard.batch, card.n_ctx
    n_check = int(rc.traffic["checked_steps"])
    errors: List[str] = []

    tmp = tempfile.mkdtemp(prefix="kbench-shard-")
    try:
        ds = TokenDataset(_shard(rc, tmp))
        total_steps = max(ds.total // (B * T), 1) * tcard.epochs
        epoch = 0

        def epoch_batches():
            # each pass over the shard in an order of its own, so that a
            # window longer than the shard runs on
            name = "order" if epoch == 0 else f"order-{epoch}"
            return ds.batches(B, T, seed=weights.subseed(rc.seed, name),
                              epochs=tcard.epochs)

        it = epoch_batches()
        waits: List[float] = []

        def fetch():
            nonlocal it, epoch
            t = time.perf_counter()
            b = next(it, None)
            if b is None:
                epoch += 1
                it = epoch_batches()
                b = next(it)
            out = {"tokens": torch.from_numpy(np.ascontiguousarray(
                b["tokens"])).to(dev, torch.int64)}
            waits.append(time.perf_counter() - t)
            return out

        tree = weights.make(sh, rc.seed, dev)
        state = init_train_state(card, tcard, params=tree)
        if [id(x) for x in leaves(state.params)] != \
                [id(x) for _, x in weights.named(state.params)]:
            errors.append("the program's leaf order is not the recipe's "
                          "sorted-name order")
        step = make_train_step(card, tcard, total_steps)

        # the checked steps: warm-up, and what the reference is held to
        checked, losses = [], []
        first_grad = None
        for i in range(n_check):
            batch = fetch()
            checked.append(batch["tokens"][0].cpu())
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            if i == 0:
                first_grad = _leaf_norms(state.opt.m, 1.0 / (1 - tcard.beta1))
        rows = torch.cat(checked).numpy()
        if len(np.unique(rows, axis=0)) != len(rows):
            errors.append("the checked steps' rows are not all different")
        p0 = weights.make(sh, rc.seed, dev)
        change = [float(torch.linalg.vector_norm(
            a.detach().to(torch.float32) - b.to(torch.float32)))
            for (_, a), (_, b) in zip(weights.named(state.params),
                                      weights.named(p0))]
        del p0
        sync()
        setup_s = time.perf_counter() - rc.t0

        # the window
        waits.clear()
        prof = None
        n_prof = int(rc.traffic.get("profiled_steps", 2))
        attempted = failed = 0
        t_open = time.perf_counter()

        def one():
            nonlocal state, attempted, failed
            batch = fetch()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            attempted += 1
            if not (0.0 < loss < 100.0 and np.isfinite(gnorm)):
                failed += 1

        prof_wall, prof_waits = 0.0, slice(0, 0)
        while time.perf_counter() - t_open < rc.seconds:
            if rc.trace and prof is None and \
                    time.perf_counter() - t_open >= rc.seconds / 2:
                t, w0 = time.perf_counter(), len(waits)
                prof = trace.profile(
                    lambda: [one() for _ in range(n_prof)], sync,
                    os.path.join(rc.out_dir, "trace.json"))
                prof_wall = time.perf_counter() - t
                prof_waits = slice(w0, len(waits))
                continue
            one()
        window_s = time.perf_counter() - t_open
        peak = (torch.cuda.max_memory_allocated() if dev == "cuda" else 0)

        opt_ms: List[float] = []
        if rc.trace and dev == "cuda":
            g = torch.Generator(device=dev)
            g.manual_seed(weights.subseed(rc.seed, "grads"))
            grads = [torch.randn(p.shape, generator=g, device=dev,
                                 dtype=p.dtype) * 1e-3
                     for p in leaves(state.params)]
            grads = unflatten_like(state.params, grads)
            seeds = list(range(len(leaves(state.params))))
            for _ in range(3):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                apply_updates(state.params, grads, state.opt,
                              optimizer="adamw", lr=1e-7, beta1=tcard.beta1,
                              beta2=tcard.beta2, eps=tcard.eps,
                              weight_decay=tcard.weight_decay,
                              grad_clip=tcard.grad_clip, sr_seeds=seeds)
                e1.record()
                e1.synchronize()
                opt_ms.append(e0.elapsed_time(e1))
            del grads
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    del state, step, tree
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()

    # the reference follows the checked steps
    ref_tree = weights.make(sh, rc.seed, dev)
    ref = run_steps(sh, rc.config["recipe"], ref_tree,
                    [c.to(dev) for c in checked], tcard.seed, total_steps,
                    rows=int(rc.traffic.get("reference_rows", 4)))
    del ref_tree
    keep = harness.moving(ref["first_grad"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    checks = [
        harness.check("loss_gap", loss_gap, rc.limits),
        harness.check("grad_gap", harness.rel_gap(first_grad,
                                                  ref["first_grad"]),
                      rc.limits),
        harness.check("change_gap", harness.median_gap(
            change, ref["change"], keep), rc.limits),
    ]

    control = None
    if rc.control:
        rec = rc.config["recipe"]
        gate = int(rec["int8_min_kn"]) if rec["int8_matmul"] else None
        int4 = [n for n, k, m in sh.linears() if gate and k * m >= gate]
        if gate and sh.E * sh.V >= gate:
            int4.append("head")
        ctree = weights.make(sh, rc.seed, dev)
        ctl = run_steps(sh, rec, ctree, [c.to(dev) for c in checked],
                        tcard.seed, total_steps, lin=lowp_lin(int4),
                        rows=int(rc.traffic.get("reference_rows", 4)))
        del ctree
        control = {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(ctl["losses"], ref["losses"])),
            "grad_gap": harness.rel_gap(ctl["first_grad"], ref["first_grad"]),
            "change_gap": harness.median_gap(ctl["change"], ref["change"],
                                             keep),
            "change_gap_worst": harness.rel_gap(ctl["change"], ref["change"],
                                                keep)}
    layer_detail = {"names": ref["names"], "keep": keep, "control": control,
                    "change_gap_worst": harness.rel_gap(change, ref["change"],
                                                        keep),
                    "program": {"losses": losses, "first_grad": first_grad,
                                "change": change},
                    "reference": {k: ref[k] for k in ("losses", "first_grad",
                                                      "change")}}
    tokens_per_step = B * T
    rec = dict(rc.config["recipe"])
    rec["moment_bytes"] = 2 if rec.get("moment_dtype") == "bf16" else 4
    w = work.train_step(sh, B, T, rec)
    # the per-layer readings leave out the profiled steps, which the
    # profiler slows
    del waits[prof_waits]
    layer: Dict[str, object] = {
        "spans": {"data_wait": list(waits)},
        "steps": attempted - (n_prof if prof is not None else 0),
        "window_s": window_s - prof_wall,
        "step_work": w, "optimizer_ms": opt_ms, "detail": layer_detail,
    }
    res = harness.Result(
        attempted=attempted, failed=failed,
        e2e={"setup_s": setup_s,
             "train_tok_s": attempted * tokens_per_step / window_s},
        layer=layer, checks=checks, memory_peak_bytes=int(peak),
        errors=errors)
    if prof is not None:
        res.busy_s, res.window_s = prof["busy_s"], prof["window_s"]
        res.breakdown = {"device_ops": prof["device_ops"],
                         "idle_gaps": prof["idle_gaps"]}
        layer["trace"] = dict(prof, steps=n_prof)
    return res
