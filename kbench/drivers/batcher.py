"""Driver ``batcher``: serving through the port's ``ContinuousBatcher``
under a closed loop of clients.

Set-up makes the float weights on the device from the seed, quantizes them
with the configuration's quantizer card (``quant.quantize_params``),
builds the batcher with the mix's engine settings, and warms exactly the
prefill buckets the mix's prompt lengths reach and the decode dispatch, by
serving one request at each bucket through ``step``. Then every client
sends its first request; the first ``step`` fills the pool, and the window
opens. In the window each client sends its next request as soon as it sees
its last one finished (no think time). A request's time to first token
runs from its sending to the return of the ``step`` that produced the
token.

The logits the timed path samples from are read where it samples them
(the batcher's and the engine's ``_sample``): the sampler's ``top_k`` best
of each row, values and ids. After the window a sample of the finished
requests, drawn from the seed and holding the longest, is run through the
plain reference over its prompt and served tokens, and each captured
logit is held to the reference's at the same id.
"""
from __future__ import annotations

import gc
import math
import os
import time
from typing import Dict, List

import numpy as np

from kbench import harness, trace, weights, work
from kbench.reference.serve import (below_kth, logit_gap, quantized_tree,
                                    request_logits)
from kbench.traffic import Requests, check_keys

#: the keys of a mix this driver reads (``source``, ``assumed`` and
#: ``why`` document it)
KEYS = {"driver", "source", "assumed", "why", "clients", "prompt", "output",
        "engine", "checked_requests", "profiled_steps"}
ENGINE_KEYS = {"slots", "cache_size", "decode_chunk", "kv_bits", "sampler"}


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class Capture:
    """The ``k`` best logits (values, ids) of every row the timed path
    samples from: one list for the prefills (in admission order), one for
    the decode steps, with each dispatch's lanes."""

    def __init__(self, batcher, engine_mod, batching_mod, k: int):
        import torch
        self.pre: List = []
        self.dec: List = []
        self.dispatches: List = []     # (first dec index, [(slot, req, n0)])
        self._mods = (engine_mod, batching_mod)
        self._orig = (engine_mod._sample, batching_mod._sample)
        self.batcher = batcher
        self._orig_decode = batcher._decode

        def best(logits):
            v, i = torch.topk(logits.to(torch.float32), k, dim=-1)
            return v, i.to(torch.int32)

        def pre_sample(gen, logits, sampler, _f=self._orig[1]):
            self.pre.append(best(logits))
            return _f(gen, logits, sampler)

        def dec_sample(gen, logits, sampler, _f=self._orig[0]):
            self.dec.append(best(logits))
            return _f(gen, logits, sampler)

        def decode(token, pool, streaming, _f=self._orig_decode):
            snap = [(s, r, len(r.tokens)) for s, r in
                    enumerate(batcher.slots) if r is not None]
            self.dispatches.append((len(self.dec), snap))
            return _f(token, pool, streaming)

        engine_mod._sample = dec_sample
        batching_mod._sample = pre_sample
        batcher._decode = decode

    def close(self):
        self._mods[0]._sample, self._mods[1]._sample = self._orig
        del self.batcher._decode          # the class's method again
        self.batcher = self._orig_decode = None

    def reset(self):
        self.pre.clear()
        self.dec.clear()
        self.dispatches.clear()


def run(rc: harness.RunContext) -> harness.Result:
    import torch
    from koifish_tpu_torch.config import CLIParams, SamplerCard
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.quant import quantize_params
    from koifish_tpu_torch.serve import batching as batching_mod
    from koifish_tpu_torch.serve import engine as engine_mod
    from koifish_tpu_torch.serve.batching import ContinuousBatcher, Request

    dev = rc.device
    sync = (torch.cuda.synchronize if dev == "cuda" else (lambda: None))
    mix, eng = rc.traffic, rc.traffic["engine"]
    check_keys(mix, KEYS, "batcher mix")
    check_keys(eng, ENGINE_KEYS, "batcher engine")
    sh = work.Shapes.from_config(rc.config)
    p = CLIParams.from_json(rc.config["koifish"])
    card = p.model
    errors: List[str] = []
    kv_fmt = {8: QFormat.INT8, 4: QFormat.INT4, 16: QFormat.BF16}[
        int(eng["kv_bits"])]
    smp = eng["sampler"]
    sampler = SamplerCard(temperature=float(smp["temperature"]),
                          top_k=int(smp["top_k"]), top_p=float(smp["top_p"]),
                          seed=weights.subseed(rc.seed, "sampler"))

    tree = weights.make(sh, rc.seed, dev)
    qp = quantize_params(tree, p.quant, card, device=dev)
    del tree
    batcher = ContinuousBatcher(
        card, qp, n_slots=int(eng["slots"]),
        cache_size=int(eng["cache_size"]), kv_fmt=kv_fmt, sampler=sampler,
        decode_chunk=int(eng["decode_chunk"]), device=dev)
    kc = int(smp["top_k"])
    cap = Capture(batcher, engine_mod, batching_mod, kc)
    reqs = Requests(mix, rc.seed, int(rc.config["data"]["vocab"]))
    rid = [0]
    sent: Dict[int, float] = {}
    first: Dict[int, float] = {}
    order: List = []               # every submitted request, in order

    def submit(r, now):
        req = Request(rid=rid[0], prompt=r.prompt, max_new=r.max_new)
        rid[0] += 1
        sent[req.rid] = now
        order.append(req)
        batcher.submit(req)
        return req

    try:
        # warm the prefill buckets the prompt lengths reach, and a decode
        lo, hi = int(mix["prompt"]["min"]), int(mix["prompt"]["max"])
        b = _bucket(lo)
        lens = []
        while b < 2 * _bucket(hi):
            lens.append(min(b, hi))
            b *= 2
        rng = np.random.default_rng(weights.subseed(rc.seed, "warm"))
        for i, n in enumerate(lens):
            batcher.submit(Request(
                rid=-1 - i, prompt=rng.integers(0, sh.V, n).tolist(),
                max_new=int(eng["decode_chunk"]) + 2))
        while batcher.step():
            pass
        batcher.results.clear()
        cap.reset()

        # every client sends its first request; the loop runs until each
        # of these has its first token (the pool full, the first queue
        # drained), so that every request timed in the window was sent by
        # the closed loop at its own pace
        clients = int(mix["clients"])
        now = time.perf_counter()
        live: List = [submit(reqs.get(i), now) for i in range(clients)]
        initial = list(live)
        nxt = clients
        while not all(r.tokens for r in initial):
            batcher.step()
            now = time.perf_counter()
            for k_, r in enumerate(live):
                if r.tokens and r.rid not in first:
                    first[r.rid] = now
                if r.done:
                    live[k_] = submit(reqs.get(nxt), now)
                    nxt += 1
        sync()
        setup_s = time.perf_counter() - rc.t0

        # the window
        ttft_win: List[float] = []
        admitted: List = []
        seen = {r.rid: len(r.tokens) for r in live}
        n_tok = 0
        prof = prof_span = None
        n_prof = int(mix.get("profiled_steps", 3))
        d_open = len(cap.dispatches)
        wall_open = batcher.decode_wall_s
        t_open = time.perf_counter()

        def one():
            nonlocal n_tok, nxt, live
            batcher.step()
            t = time.perf_counter()
            still = []
            for r in live:
                if r.tokens and r.rid not in first:
                    first[r.rid] = t
                    ttft_win.append(t - sent[r.rid])
                    admitted.append(r)
                n_tok += len(r.tokens) - seen.get(r.rid, 0)
                seen[r.rid] = len(r.tokens)
                if r.done:
                    nr = submit(reqs.get(nxt), t)
                    nxt += 1
                    seen[nr.rid] = 0
                    still.append(nr)
                else:
                    still.append(r)
            live = still

        while time.perf_counter() - t_open < rc.seconds:
            if rc.trace and prof is None and \
                    time.perf_counter() - t_open >= rc.seconds / 2:
                d0, a0 = len(cap.dispatches), len(admitted)
                t, w0 = time.perf_counter(), batcher.decode_wall_s
                prof = trace.profile(lambda: [one() for _ in range(n_prof)],
                                     sync, os.path.join(rc.out_dir,
                                                        "trace.json"))
                prof_span = (d0, len(cap.dispatches), a0, len(admitted),
                             time.perf_counter() - t,
                             batcher.decode_wall_s - w0)
                continue
            one()
        window_s = time.perf_counter() - t_open
        peak = (torch.cuda.max_memory_allocated() if dev == "cuda" else 0)
        dec_wall = batcher.decode_wall_s - wall_open
        win_dispatches = cap.dispatches[d_open:]
        pre = [torch.cat(x).reshape(-1, kc).cpu() for x in zip(*cap.pre)]
        dec = [torch.stack(x).cpu() for x in zip(*cap.dec)]
        dispatches = list(cap.dispatches)
    finally:
        cap.close()
    finished = [r for r in order if r.done]
    del batcher, qp, live
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()

    # where each finished request's positions were captured: its
    # admission's row, then (step, lane) of each decode step
    k = int(eng["decode_chunk"])
    n_pre = len(pre[0]) if pre else 0
    rows: Dict[int, List] = {r.rid: [i] for i, r in enumerate(order)
                             if i < n_pre}
    for start, snap in dispatches:
        for slot, r, n0 in snap:
            for j in range(k):
                if n0 + j >= r.max_new:
                    break
                rows[r.rid].append((start + j, slot))

    def captured(r):
        """The program's [n, kc] best logits and ids at r's positions."""
        at = rows[r.rid][: len(r.tokens)]
        parts = [(pre[0][at[0]], pre[1][at[0]])]
        parts += [(dec[0][t, s_], dec[1][t, s_]) for t, s_ in at[1:]]
        return (torch.stack([v for v, _ in parts]).to(dev),
                torch.stack([i for _, i in parts]).to(dev))

    for r in finished:
        if len(rows.get(r.rid, [])) != len(r.tokens):
            errors.append(f"request {r.rid}: {len(r.tokens)} tokens, "
                          f"{len(rows.get(r.rid, []))} captured")
        if len(r.tokens) != r.max_new:
            errors.append(f"request {r.rid}: {len(r.tokens)} tokens served "
                          f"of {r.max_new}")

    # the reference over a sample of the finished requests
    n_check = min(int(mix["checked_requests"]), len(finished))
    checks = []
    control = None
    if n_check == 0:
        errors.append("no request finished")
    else:
        longest = max(finished, key=lambda r: len(r.prompt) + len(r.tokens))
        rest = [r for r in finished if r is not longest]
        pick = np.random.default_rng(weights.subseed(rc.seed, "check")
                                     ).permutation(len(rest))[:n_check - 1]
        sample = [longest] + [rest[i] for i in sorted(pick)]
        qtree = quantized_tree(weights.make(sh, rc.seed, dev))
        worst_gap = worst_below = ctl_gap = 0.0
        theta = float(rc.config.get("rope_theta", 1e6))
        for r in sample:
            ref = request_logits(sh, qtree, r.prompt, r.tokens, theta,
                                 device=dev)
            worst_gap = max(worst_gap, float(
                logit_gap(ref, *captured(r)).max()))
            worst_below = max(worst_below, float(below_kth(
                ref, torch.tensor(r.tokens, device=dev), kc).max()))
            if rc.control:
                low = request_logits(sh, qtree, r.prompt, r.tokens, theta,
                                     control=True, device=dev)
                ctl_gap = max(ctl_gap, float(logit_gap(
                    ref, *torch.topk(low, kc, dim=-1)).max()))
                del low
            del ref
        del qtree
        if rc.control:
            control = {"logit_gap": ctl_gap}
        checks = [harness.check("logit_gap", worst_gap, rc.limits),
                  harness.check("served_below_topk", worst_below, rc.limits)]

    # the work of the window, counted as run
    pk = work.peaks(torch.cuda.get_device_name(0)) if dev == "cuda" else None

    def decode_ctx(disp):
        out = []
        for _, snap in disp:
            for j in range(k):
                out.append([len(r.prompt) + n0 + j for _, r, n0 in snap
                            if n0 + j < r.max_new])
        return out

    # the per-layer readings leave out the profiled steps, which the
    # profiler slows
    d0, d1, a0, a1, p_wall, p_dec = prof_span or (0, 0, 0, 0, 0.0, 0.0)
    base = len(dispatches) - len(win_dispatches)
    unprof_disp = [d for i, d in enumerate(win_dispatches)
                   if not d0 <= base + i < d1]
    unprof_adm = admitted[:a0] + admitted[a1:]
    prompts = [len(r.prompt) for r in admitted]
    layer: Dict[str, object] = {
        "window_s": window_s - p_wall, "decode_wall_s": dec_wall - p_dec,
        "decode_steps": len(unprof_disp) * k,
        "prefill_s": sum(r.ttft_s for r in unprof_adm),
        "prompt_tokens": sum(len(r.prompt) for r in unprof_adm),
        "control": control,
        "ttft_s": ttft_win,
        "checked": {"requests": n_check, "tokens": sum(
            len(r.tokens) for r in (sample if n_check else []))},
        "serve_work": (work.serve_least(
            sh, [len(r.prompt) for r in unprof_adm], decode_ctx(unprof_disp),
            pk) if pk else None),
    }
    if prof is not None:
        # the profiled steps' own work: their dispatches and admissions
        layer["trace"] = dict(prof, work=work.serve_least(
            sh, prompts[a0:a1], decode_ctx(dispatches[d0:d1]), pk)
            if pk else None)
    res = harness.Result(
        attempted=len(ttft_win), failed=0,
        e2e={"setup_s": setup_s, "serve_tok_s": n_tok / window_s,
             "ttft_p90_ms": (_quantile(ttft_win, 0.9) * 1e3 if ttft_win
                             else math.nan)},
        layer=layer, checks=checks, memory_peak_bytes=int(peak),
        errors=errors)
    if prof is not None:
        res.busy_s, res.window_s = prof["busy_s"], prof["window_s"]
        res.breakdown = {"device_ops": prof["device_ops"],
                         "idle_gaps": prof["idle_gaps"]}
    return res


def _quantile(xs: List[float], q: float) -> float:
    """The ``q`` quantile (linear between order statistics)."""
    s = sorted(xs)
    pos = q * (len(s) - 1)
    i = int(pos)
    return s[i] if i + 1 >= len(s) else s[i] + (s[i + 1] - s[i]) * (pos - i)
