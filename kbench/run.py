"""One run of one cell of the benchmark of ``koifish_tpu_torch``.

    python3 kbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in ``BENCHMARK.json``, its configuration, traffic mix,
driver, limits and per-layer readers by name under ``kbench/``, runs the
driver on the card (set-up, the measured window, the reference), and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit.
The same numbers end standard error. A run without a card, or with fewer
cards than the cell asks for, fails and prints no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: modules that may not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "koifish_tpu")


def _env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    no library is asked to load JAX; one host thread for the CPU's
    numerical libraries (the host work is launching, and idle pool threads
    only contend with it)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded() -> list:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()

    from kbench import harness, manifest, work
    bench = manifest.load()
    cell, config, traffic, limits = manifest.cell_parts(args.workload, bench)

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"kbench: the cell needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the port's kernels, built once into build/kernels/ in parallel (a
    # later run finds them by their sources' digest); fails where the
    # port is absent
    from koifish_tpu_torch.ops.kernels import _build
    _build.build()

    rc = harness.RunContext(
        config=config, traffic=traffic, limits=limits,
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace), t0=T0,
        out_dir=harness.run_dir(ROOT, cell["name"]))
    res = manifest.driver(traffic["driver"]).run(rc)

    kind = torch.cuda.get_device_name(0)
    run = {"layer": res.layer, "peaks": work.peaks(kind)}
    metrics = {}
    if args.trace:
        for m in manifest.metrics_of(bench, "per_layer", cell["name"]):
            v = manifest.reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in manifest.metrics_of(bench, "end_to_end", cell["name"]):
            metrics[m["name"]] = {"value": res.e2e[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": int(cell["chips"]),
              "memory_peak_bytes": int(res.memory_peak_bytes),
              "power_limit_w": harness.power_limit_w()}
    if args.trace:
        device["busy_s"] = res.busy_s
        device["window_s"] = res.window_s

    bad = forbidden_loaded()
    if bad:
        print(f"kbench: modules {bad} are loaded; the benchmark measures "
              f"koifish_tpu_torch alone", file=sys.stderr)
        return 3

    out = {"correct": res.correct, "attempted": res.attempted,
           "failed": res.failed, "metrics": metrics, "device": device}
    if args.trace and res.breakdown is not None:
        out["breakdown"] = res.breakdown
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, v, lim in res.checks}
    with open(os.path.join(rc.out_dir, f"run-{args.seed}-{args.trace}.json"),
              "w") as f:
        json.dump({"e2e": res.e2e, "layer": res.layer, "checks": res.checks,
                   "errors": res.errors, "device": device}, f,
                  default=lambda o: getattr(o, "__dict__", str(o)))
    for e in res.errors:
        print(f"kbench error: {e}", file=sys.stderr)
    print(f"kbench {cell['name']}: " + " ".join(
        f"{k}={v!r}" for k, v in res.e2e.items()), file=sys.stderr)
    print(json.dumps(out), flush=True)
    for n, v, lim in res.checks:
        print(f"check {n} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
