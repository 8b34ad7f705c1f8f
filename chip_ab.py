#!/usr/bin/env python3
"""A/B one change of the port on one GPU: old, new, new, old in one call.

    python3 chip_ab.py OLD_TREE PHASE[,PHASE...] [--train] [--host] [--shapes]
                       [--decode] [--paged] [--sp] [--ring-steps] [--mamba]

OLD_TREE is a copy of the repository at the old version
(``koifish_tpu_torch/``, ``chip_smoke.py`` and ``configs/``, for example
unpacked with ``git archive`` into a directory that ``.gitignore`` lists, such
as ``build/ab_old``); the new version is the tree around this script. Each of
the four runs is a fresh process in its tree that first builds all of that
tree's kernels (none is built inside a timed call), then calls one kernel
phase of ``chip_smoke.py`` (``flash_bwd_phase``, ``fused_ce_phase``, ...;
several, comma-separated; ``-`` for none), printing each kernel's
``ms`` (for a phase that returns one flat result, as ``flash_phase`` does,
or a result and its launches, as ``ring_phase`` does, every number of it
whose key ends in ``ms``, and for ``ring_phase`` each sp's graph-replay
``ms`` and ``eager_ms`` from its ``by_sp``); with ``--train`` the second and
fourth runs also train Qwen3-0.6B (B=8) and GPT2-124M (B=32) for 6 steps, and
GPT2-774M as shipped (``configs/gpt2_774m.json``: int8 matmuls and the int8
fused CE, B=16, warmup 10) for 12 steps (the median of steps 2-11: its
host-bound steps spread by ~300 ms), then the same card with ``int8_dgrad:
"tile"`` (the fc dgrad through the per-tile int8 kernels) for 12 steps,
through ``chip_smoke.train_model``. With ``--host`` every run also prints the
host microseconds of one eager call of the GEMM wrapper (m = 128, INT4), of
the GEMV wrapper (m = 1 INT8 codes and m = 32 INT4; K 1024, N 1024), of the
int8 GEMV wrapper ``qmv_int8`` (m = 1 and m = 32 on the same INT8 codes: the
chat path's per-call cost), of the flash forward wrapper and of each flash
backward wrapper (B 1, T 128, D 128), through that tree's own modules. With ``--shapes``
every run also times the flash forward wrapper at the training shapes of
Qwen3-0.6B (B 8, T 1024, Hq 16, Hkv 8, D 128) and GPT2-124M (B 32, T 1024, Hq
12, D 64), CUDA-graph replays as ``chip_smoke.time_ms`` takes them. With
``--decode`` every run also times, through that tree's own modules, the INT8
decode attention wrapper and one layer's write plus attention (the fused
entry where the tree has it, else the two quantizer calls, the slot write
and the attention that the decode step made) at the slice's (B 32, lengths
129-192), the batcher's (B 32, lengths 16-640), chat's (B 1, lengths
100-1024) and a g = 8 shape (Hq 64, Hkv 8, B 8, lengths 256-1024), all S
1024, D 128, as graph replays and as the host µs of one eager call; then
runs ``chip_smoke.batcher_phase`` (its aggregate decode tok/s) with the
device launches a step of its profiled decode chunk. With ``--paged`` every
run also times, through that tree's own modules, one layer's paged
attention and its write plus attention at the paged run's shape (B 32, Hq
16, Hkv 8, D 128, a 4-page table, lengths 129-192): the fused entry where
the tree has it, else ``page_write_many`` and the gather
``_paged_attention_ref`` that the paged decode step made; as graph replays
and as the host µs of one eager call; then builds Qwen3-0.6B with k-means
NF4 weights, runs ``chip_smoke.paged_phase`` (its tok/s) and profiles one
paged decode chunk (8 decode + sample steps at B 32) for its device
launches a step. With ``--sp`` every run whose tree has the
sequence-parallel path profiles one warm step of ``koifish --sp 4``'s
train step on the config of ``chip_smoke.sp_train_phase``
(``configs/qwen3_0.6b.json`` as shipped, its QAT rules too, B 16 x 1024,
params from its seed, its first batch): device time by kernel (the ten
largest) and the idle share, under the profiler (~65 s for its ~80,000
launches). With ``--ring-steps`` every run profiles one call of the
kernel ring (``parallel.ring_attention_pallas_sharded``) at
``chip_smoke.RING_SHAPE`` and sp 4, 2 and 8: each device kernel's µs in
launch order (the slot fill's copies, then one ring step a launch) and
the host's ms a call (20 calls enqueued without a synchronise). With
``--mamba`` every run whose tree has the Mamba path trains mamba-130m
(``chip_smoke.MAMBA_130M``: 24 layers, d 768, V 50,280) at B 8 x 1024,
remat on, from the same seed on the same seeded batch: the median of 5
steps after 2 warm ones, the peak memory, the losses, then one more step
profiled (device time by kernel and the idle share). Compare the
two versions only within one call: two calls may land on two cards or on a
busier host. The first line printed is the card's name and power limit.
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
from koifish_tpu_torch.ops.kernels import _build
_build.build()   # every kernel before any timing, not at its first use
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
g = torch.Generator(device="cuda"); g.manual_seed(0)
def rnd(*s):
    return torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
def launches_a_step(torch, label, fn, steps=1):
    import time
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = sum(e.count for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and getattr(e, "self_device_time_total", 0) > 0)
    print(f"P {label}: {n / steps:.1f} device launches a step, wall "
          f"{wall * 1e3 / steps:.3f} ms/step", flush=True)
for phase in sys.argv[1].split(",") if sys.argv[1] != "-" else []:
    r = getattr(cs, phase)(torch, g)
    if isinstance(r, tuple):   # (result, launches): ring_phase
        r = r[0]
    if "ms" in r:   # one flat result (flash_phase, ring_phase)
        flat = {phase: r} | {f"{phase}.{k}": {"ms": v} for k, v in r.items()
                             if k.endswith("ms") and k != "ms"}
        for sp, d in r.get("by_sp", {}).items():   # ring_phase: each sp
            flat |= {f"{phase}.sp{sp}.{k}": {"ms": d[k]}
                     for k in ("ms", "eager_ms")}
        r = flat
    print("K", {k: round(v["ms"], 4) for k, v in r.items()
                if isinstance(v, dict)}, flush=True)
if "train" in sys.argv[2:]:
    cs.train_model(torch, "Qwen3-0.6B", "qwen3_0.6b.json", 8, steps=6)
    cs.train_model(torch, "GPT2-124M", "gpt2_124m.json", 32, steps=6)
    import dataclasses
    from koifish_tpu_torch.config import CLIParams
    p = CLIParams.load("configs/gpt2_774m.json")
    for label, over in (("GPT2-774M int8 as shipped", {}),
                        ("GPT2-774M int8_dgrad tile", {"int8_dgrad": "tile"})):
        cs.train_model(torch, label, "gpt2_774m.json", p.train.batch,
                       steps=12, tcard=dataclasses.replace(
                           p.train, warmup=10, dump_every=1, seed=p.seed,
                           **over))
if "host" in sys.argv[2:]:
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.ops.kernels import flash as kf, matmul as km
    from koifish_tpu_torch.ops.kernels import qmv_int8 as kq8
    from koifish_tpu_torch.quant.rtn import quantize
    w = quantize(torch.randn((1024, 1024), generator=g, device="cuda") * 0.02,
                 QFormat.INT4, group=128)
    w8 = quantize(torch.randn((1024, 1024), generator=g, device="cuda") * 0.02,
                  QFormat.INT8, group=128)
    x, x1, x32 = rnd(128, 1024), rnd(1, 1024), rnd(32, 1024)
    q, k, v, do = rnd(1, 128, 16, 128), rnd(1, 128, 8, 128), \
        rnd(1, 128, 8, 128), rnd(1, 128, 16, 128)
    o, lse = kf.flash_attention_fwd(q, k, v, scale=128 ** -0.5)
    calls = {"qmm m128": lambda: km.qmatmul(x, w),
             "qmv m1 INT8": lambda: km.qmatmul(x1, w8),
             "qmv m32 INT4": lambda: km.qmatmul(x32, w),
             "qmv_int8 m1": lambda: kq8.qmv_int8(x1, w8.codes, w8.scales),
             "qmv_int8 m32": lambda: kq8.qmv_int8(x32, w8.codes, w8.scales),
             "flash_fwd": lambda: kf.flash_attention_fwd(q, k, v,
                                                         scale=0.1),
             "flash_bwd_dkv": lambda: kf.flash_bwd_dkv(q, k, v, o, lse, do,
                                                       scale=0.1),
             "flash_bwd_dq": lambda: kf.flash_bwd_dq(q, k, v, o, lse, do,
                                                     scale=0.1)}
    print("H", {n: [round(cs.host_us(torch, f), 1) for _ in range(3)]
                for n, f in calls.items()}, "us", flush=True)
if "shapes" in sys.argv[2:]:
    from koifish_tpu_torch.ops.kernels import flash as kf
    ms = {}
    for label, B, Hq, Hkv, D in (("qwen3 B8 T1024 D128", 8, 16, 8, 128),
                                 ("gpt2 B32 T1024 D64", 32, 12, 12, 64)):
        q, k, v = rnd(B, 1024, Hq, D), rnd(B, 1024, Hkv, D), rnd(B, 1024, Hkv, D)
        ms[label] = round(cs.time_ms(torch, lambda: kf.flash_attention_fwd(
            q, k, v, scale=D ** -0.5)), 4)
    print("S flash_fwd", ms, "ms", flush=True)
if "decode" in sys.argv[2:]:
    import time
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.ops.kernels import decode_attn as kd
    from koifish_tpu_torch.ops.kernels import slotwrite as ksw
    from koifish_tpu_torch.serve.kvcache import _quant_kv
    fused = hasattr(kd, "decode_attention_write")
    dev, host = {}, {}
    for label, B, Hq, lo, hi in (("slice", 32, 16, 129, 193),
                                 ("batcher", 32, 16, 16, 641),
                                 ("chat", 1, 16, 100, 1025),
                                 ("g8", 8, 64, 256, 1025)):
        Hkv, S, D = 8, 1024, 128
        kc, ks = _quant_kv(torch.randn((B, Hkv, S, D), generator=g,
                                       device="cuda"), QFormat.INT8)
        vc, vs = _quant_kv(torch.randn((B, Hkv, S, D), generator=g,
                                       device="cuda"), QFormat.INT8)
        q, kn, vn = rnd(B, Hq, D), rnd(B, Hkv, D), rnd(B, Hkv, D)
        lengths = torch.randint(lo, hi, (B,), generator=g, device="cuda",
                                dtype=torch.int32)
        slots = (torch.rand((B,), generator=g, device="cuda")
                 * lengths).to(torch.int32)
        sc = D ** -0.5
        attn = lambda: kd.decode_attention_quant(q, kc, vc, ks, vs, lengths,
                                                 sc)
        if fused:
            step = lambda: kd.decode_attention_write(q, kn, vn, kc, vc, ks,
                                                     vs, slots, lengths, sc)
        else:
            def step():
                kq, ksc = _quant_kv(kn, QFormat.INT8)
                vq, vsc = _quant_kv(vn, QFormat.INT8)
                ksw.slot_write_many([(kc, kq), (vc, vq), (ks, ksc),
                                     (vs, vsc)], slots)
                return attn()
        dev[label] = [round(cs.time_ms(torch, f, iters=50), 4)
                      for f in (attn, step)]
        host[label] = [round(cs.host_us(torch, f), 1) for f in (attn, step)]
    print("D decode ms [attention, write + attention]", dev, flush=True)
    print("D decode host us [attention, write + attention]", host, flush=True)
    cs.profile_window = launches_a_step
    cs.batcher_phase(torch)
if "paged" in sys.argv[2:]:
    import dataclasses
    from koifish_tpu_torch.config import CLIParams, QuantCard
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.ops.kernels import slotwrite as ksw
    from koifish_tpu_torch.ops.sampling import sample_logits
    from koifish_tpu_torch.quant import quantize_params
    from koifish_tpu_torch.serve import paged as P
    B, Hq, Hkv, D, maxp, NP = 32, 16, 8, 128, 4, 68
    lengths = torch.randint(129, 193, (B,), generator=g, device="cuda",
                            dtype=torch.int32)
    live = torch.randperm(NP, generator=g, device="cuda")[:2 * B]
    table = torch.cat([live.reshape(B, 2), torch.randint(
        0, NP, (B, maxp - 2), generator=g, device="cuda")], 1
        ).to(torch.int32).contiguous()
    kp, vp = rnd(Hkv, NP, 128, D), rnd(Hkv, NP, 128, D)
    q, kn, vn = rnd(B, Hq, D), rnd(B, Hkv, D), rnd(B, Hkv, D)
    pos = (lengths - 1).long()
    pids = table.gather(1, (pos // 128)[:, None])[:, 0].contiguous()
    rows = (pos % 128).to(torch.int32)
    sc = D ** -0.5
    read = getattr(P, "_paged_attention", P._paged_attention_ref)
    attn = lambda: read(q, kp, vp, lengths, table, sc)
    if hasattr(P, "paged_attention_write"):
        step = lambda: P.paged_attention_write(q, kn, vn, kp, vp, lengths,
                                               table, pids, rows, sc)
    else:
        def step():
            ksw.page_write_many([(kp, kn), (vp, vn)], pids, rows)
            return P._paged_attention_ref(q, kp, vp, lengths, table, sc)
    print("G paged layer ms [attention, write + attention]",
          [round(cs.time_ms(torch, f, iters=50), 4) for f in (attn, step)],
          "host us", [round(cs.host_us(torch, f), 1) for f in (attn, step)],
          flush=True)
    p = CLIParams.load("configs/qwen3_0.6b.json")
    card = p.model
    gq = torch.Generator(device="cuda")
    gq.manual_seed(p.seed)
    qp = quantize_params(init_params(card, gq),
                         QuantCard.from_json(cs.KMEANS_RULES), card)
    cs.profile_window = lambda *a, **k: None
    cs.paged_phase(torch, card, qp)
    pc, alloc = P.init_paged_cache(card.n_layer, 32, card.n_kv_head,
                                   card.head_dim, max_pages=4)
    pc = dataclasses.replace(alloc.ensure(pc, 137),
                             pos=torch.full_like(pc.pos, 128))
    tok = torch.randint(0, card.vocab_size, (32,), generator=g, device="cuda")

    def chunk():
        c, t = pc, tok
        for _ in range(8):
            logits, c = P.decode_step_paged(card, qp, t, c)
            t = sample_logits(g, logits, 0.6, 50, 0.95)
    launches_a_step(torch, "paged decode chunk (8 steps, B=32)", chunk, 8)
if "sp" in sys.argv[2:] and not hasattr(cs, "sp_train_phase"):
    print("P sp: this tree has no sequence-parallel path", flush=True)
elif "sp" in sys.argv[2:]:
    import os, shutil
    from koifish_tpu_torch.data import TokenDataset
    from koifish_tpu_torch.ops.tracectx import SPPolicy
    from koifish_tpu_torch.parallel import make_mesh
    from koifish_tpu_torch.train import init_train_state, make_train_step
    root = os.path.join("build", "ab_sp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _, cfg, p = cs._sp_config(os.path.abspath(root))
    card, tcard = p.model, p.train
    b = next(TokenDataset(cfg["datasets"]["train"]["glob"]).batches(
        tcard.batch, card.n_ctx))
    batch = {"tokens": torch.from_numpy(b["tokens"]).to("cuda", torch.int64)}
    state = init_train_state(card, tcard)
    policy = SPPolicy("sp", make_mesh({"dp": 1, "tp": 1, "sp": cs.SP_WAYS},
                                      devices="cuda"))
    step = make_train_step(card, tcard, total_steps=cs.SP_STEPS,
                           qcard=p.quant if p.quant.rules else None,
                           sp=policy)

    def one():
        global state
        state, metrics = step(state, batch)
        float(metrics["loss"])
    cs.profile_window(torch, f"Qwen3-0.6B --sp {cs.SP_WAYS} step "
                      f"(B={tcard.batch}, T={card.n_ctx}, remat="
                      f"{tcard.remat}, QAT)", one)
    shutil.rmtree(root)
if "mamba" in sys.argv[2:] and not hasattr(cs, "MAMBA_130M"):
    print("P mamba: this tree has no Mamba path", flush=True)
elif "mamba" in sys.argv[2:]:
    import time
    from koifish_tpu_torch.config import ModelCard, TrainCard
    from koifish_tpu_torch.train import init_train_state, make_train_step
    m = cs.MAMBA_130M
    mult = m["pad_vocab_size_multiple"]
    card = ModelCard.from_arch(
        "MAMBA", vocab_size=-(-m["vocab_size"] // mult) * mult,
        n_layer=m["n_layer"], n_embd=m["d_model"], n_head=12, n_kv_head=12,
        head_dim=m["d_model"] // 12, n_ffn=4 * m["d_model"], n_ctx=1024,
        max_pos=1024)
    tcard = TrainCard(batch=8)
    state = init_train_state(card, tcard, device="cuda")
    step = make_train_step(card, tcard, total_steps=10)
    toks = torch.randint(0, card.vocab_size, (1, 8, card.n_ctx + 1),
                         device="cuda", generator=g)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, {"tokens": toks})
        losses.append(round(float(metrics["loss"]), 5))
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"  median {sorted(times)[2]:.2f} ms/step, mamba-130m B 8 x 1024 "
          f"remat (runs {[round(t, 2) for t in times]}); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
          f"{losses}", flush=True)

    def one():
        global state
        state, metrics = step(state, {"tokens": toks})
        float(metrics["loss"])
    cs.profile_window(torch, "mamba-130m train step (B 8 x 1024)", one)
if "ring_steps" in sys.argv[2:]:
    import time
    from torch.profiler import ProfilerActivity, profile
    from koifish_tpu_torch.parallel import (make_mesh,
                                            ring_attention_pallas_sharded)
    B, T, Hq, Hkv, D = cs.RING_SHAPE
    q, k, v = rnd(B, T, Hq, D), rnd(B, T, Hkv, D), rnd(B, T, Hkv, D)
    for sp in (4, 2, 8):
        fn = ring_attention_pallas_sharded(make_mesh({"sp": sp},
                                                     devices="cuda"), "sp")
        for _ in range(3):
            fn(q, k, v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn(q, k, v)
        host = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(q, k, v)
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if str(e.device_type).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
        print(f"R ring sp {sp}: host {host:.3f} ms a call; kernels us",
              [(e.name.split("(")[0].split("<")[0][-24:],
                round(e.time_range.end - e.time_range.start, 1))
               for e in evs], flush=True)
'''

KEEP = ("K ", "H ", "S ", "D ", "P ", "G ", "R ", "  check", "  time", "  host",
        "  median", "  losses", "  aggregate", "  completed", "chip_smoke",
        "[profile] Qwen3-0.6B --sp", "[profile] mamba", "  device busy")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_tree")
    ap.add_argument("phase")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--shapes", action="store_true")
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--ring-steps", action="store_true")
    ap.add_argument("--mamba", action="store_true")
    args = ap.parse_args()
    old = os.path.abspath(args.old_tree)
    if not os.path.exists(os.path.join(old, "chip_smoke.py")):
        sys.exit(f"chip_ab: {old} holds no chip_smoke.py")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    failed = False
    for i, (name, tree) in enumerate((("old", old), ("new", ROOT),
                                      ("new", ROOT), ("old", old))):
        extra = (["train"] if args.train and i in (1, 3) else []) \
            + (["host"] if args.host else []) \
            + (["shapes"] if args.shapes else []) \
            + (["decode"] if args.decode else []) \
            + (["paged"] if args.paged else []) \
            + (["sp"] if args.sp else []) \
            + (["ring_steps"] if args.ring_steps else []) \
            + (["mamba"] if args.mamba else [])
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", RUN, args.phase] + extra,
                             cwd=tree, capture_output=True, text=True)
        print(f"=== run {i} {name} rc={out.returncode} "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        print("\n".join(ln for ln in out.stdout.splitlines()
                        if ln.startswith(KEEP) or "paged steps at" in ln
                        or " launches/step  " in ln),
              flush=True)
        if out.returncode:
            failed = True
            print(out.stdout[-3000:], out.stderr[-5000:], flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
