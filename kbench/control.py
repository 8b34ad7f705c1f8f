"""The readings the limits are set from, for one cell, in one process:

    python3 kbench/control.py --workload <name> --seeds 1,2,3 --seconds 15 [--fault half]

For each seed it runs the cell's driver with a short window and prints one
JSON line: the program's compared numbers and, computed after the
reference, the control's (the reference one precision below the
configuration's, in the program's place). ``--fault`` plants a fault in
the program underneath the run (``FAULTS``), so that the line's program
numbers are the fault's. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _half_batch(make):
    """The train step on the first half of the batch's rows only: the
    mean is taken over the rest."""
    def wrapped(*a, **k):
        step = make(*a, **k)

        def half(state, batch):
            b = dict(batch)
            b["tokens"] = batch["tokens"][:, : batch["tokens"].shape[1] // 2]
            return step(state, b)
        return half
    return wrapped


def _unchanged(make):
    """A train step that hands back its state as it found it."""
    def wrapped(*a, **k):
        step = make(*a, **k)

        def same(state, batch):
            import torch
            from koifish_tpu_torch.utils.tree import leaves
            keep = [p.detach().clone() for p in leaves(state.params)]
            keep_m = [m.clone() for m in leaves(state.opt.m)]
            keep_v = [v.clone() for v in leaves(state.opt.v)]
            new, metrics = step(state, batch)
            with torch.no_grad():
                for dst, src in zip(leaves(new.params) + leaves(new.opt.m)
                                    + leaves(new.opt.v),
                                    keep + keep_m + keep_v):
                    dst.copy_(src)
            return new, metrics
        return same
    return wrapped


def _altered_token(sample):
    """The sampler's token moved to the next id, where it is produced."""
    def wrapped(gen, logits, *a, **k):
        tok = sample(gen, logits, *a, **k)
        return (tok + 1) % logits.shape[-1]
    return wrapped


#: fault -> (module, attribute, wrapper)
FAULTS = {
    "half": ("koifish_tpu_torch.train.trainer", "make_train_step",
             _half_batch),
    "unchanged": ("koifish_tpu_torch.train.trainer", "make_train_step",
                  _unchanged),
    "token": ("koifish_tpu_torch.serve.engine", "sample_logits",
              _altered_token),
}


@contextlib.contextmanager
def plant(fault):
    """The program with ``fault`` planted (None: as it is)."""
    if fault is None:
        yield
        return
    import importlib
    mod_name, attr, wrap = FAULTS[fault]
    mod = importlib.import_module(mod_name)
    orig = getattr(mod, attr)
    setattr(mod, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def readings(workload: str, seed: int, seconds: float, fault=None,
             device: str = "cuda", config=None, traffic=None,
             limits=None) -> dict:
    """One run's compared numbers, the control's, and its settings."""
    from kbench import harness, manifest
    cell, cfg, mix, cell_limits = manifest.cell_parts(workload)
    rc = harness.RunContext(
        config=config or cfg, traffic=traffic or mix,
        limits=limits or cell_limits, seed=seed, seconds=seconds, trace=False,
        t0=time.perf_counter(), out_dir=harness.run_dir(ROOT, cell["name"]),
        device=device, control=fault is None)
    with plant(fault):
        res = manifest.driver(rc.traffic["driver"]).run(rc)
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()
    ctl = res.layer.get("control") or res.layer.get("detail", {}).get(
        "control")
    out = {"workload": workload, "seed": seed, "fault": fault,
           "correct": res.correct, "errors": res.errors,
           "attempted": res.attempted,
           "program": {n: v for n, v, _ in res.checks}, "control": ctl,
           "e2e": res.e2e}
    det = res.layer.get("detail")
    if det:
        out["change_gap_worst"] = det.get("change_gap_worst")
    if "checked" in res.layer:
        out["checked"] = res.layer["checked"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    args = ap.parse_args(argv)
    from koifish_tpu_torch.ops.kernels import _build
    _build.build()
    for s in args.seeds.split(","):
        t = time.perf_counter()
        out = readings(args.workload, int(s), args.seconds, args.fault)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
