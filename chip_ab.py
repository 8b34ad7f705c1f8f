#!/usr/bin/env python3
"""A/B one change of the port on one GPU: old, new, new, old in one call.

    python3 chip_ab.py OLD_TREE PHASE [--train] [--host]

OLD_TREE is a copy of the repository at the old version (``koifish_tpu_torch/``,
``chip_smoke.py`` and ``configs/``, for example unpacked with ``git archive``
into a directory that ``.gitignore`` lists, such as ``build/ab_old``); the
new version is the tree around this script. Each of the four runs is a
fresh process in its tree that builds that tree's kernels and calls one
kernel phase of ``chip_smoke.py`` (``flash_bwd_phase``, ``fused_ce_phase``,
...), printing each kernel's ``ms``; with ``--train`` the second and fourth
runs also train Qwen3-0.6B (B=8) and GPT2-124M (B=32) for 6 steps through
``chip_smoke.train_model``. With ``--host`` every run also prints the host
microseconds of one eager call of the GEMM wrapper (m = 128, INT4) and of
each flash backward wrapper (B 1, T 128, D 128), through that tree's own
modules. Compare the two versions only within one call: two calls may land
on two cards or on a busier host.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

RUN = r'''
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
g = torch.Generator(device="cuda"); g.manual_seed(0)
r = getattr(cs, sys.argv[1])(torch, g)
print("K", {k: round(v["ms"], 4) for k, v in r.items()}, flush=True)
if "train" in sys.argv[2:]:
    cs.train_model(torch, "Qwen3-0.6B", "qwen3_0.6b.json", 8, steps=6)
    cs.train_model(torch, "GPT2-124M", "gpt2_124m.json", 32, steps=6)
if "host" in sys.argv[2:]:
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.ops.kernels import flash as kf, matmul as km
    from koifish_tpu_torch.quant.rtn import quantize
    def rnd(*s):
        return torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    w = quantize(torch.randn((1024, 1024), generator=g, device="cuda") * 0.02,
                 QFormat.INT4, group=128)
    x = rnd(128, 1024)
    q, k, v, do = rnd(1, 128, 16, 128), rnd(1, 128, 8, 128), \
        rnd(1, 128, 8, 128), rnd(1, 128, 16, 128)
    o, lse = kf.flash_attention_fwd(q, k, v, scale=128 ** -0.5)
    calls = {"qmm m128": lambda: km.qmatmul(x, w),
             "flash_bwd_dkv": lambda: kf.flash_bwd_dkv(q, k, v, o, lse, do,
                                                       scale=0.1),
             "flash_bwd_dq": lambda: kf.flash_bwd_dq(q, k, v, o, lse, do,
                                                     scale=0.1)}
    print("H", {n: [round(cs.host_us(torch, f), 1) for _ in range(3)]
                for n, f in calls.items()}, "us", flush=True)
'''

KEEP = ("K ", "H ", "  check", "  time", "  host", "  median", "  losses",
        "chip_smoke")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_tree")
    ap.add_argument("phase")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--host", action="store_true")
    args = ap.parse_args()
    old = os.path.abspath(args.old_tree)
    if not os.path.exists(os.path.join(old, "chip_smoke.py")):
        sys.exit(f"chip_ab: {old} holds no chip_smoke.py")
    failed = False
    for i, (name, tree) in enumerate((("old", old), ("new", ROOT),
                                      ("new", ROOT), ("old", old))):
        extra = (["train"] if args.train and i in (1, 3) else []) \
            + (["host"] if args.host else [])
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", RUN, args.phase] + extra,
                             cwd=tree, capture_output=True, text=True)
        print(f"=== run {i} {name} rc={out.returncode} "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        print("\n".join(ln for ln in out.stdout.splitlines()
                        if ln.startswith(KEEP)), flush=True)
        if out.returncode:
            failed = True
            print(out.stdout[-3000:], out.stderr[-5000:], flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
