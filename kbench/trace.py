"""The device trace of a few steady steps: ``torch.profiler`` with CPU and
CUDA activity, written as a Chrome trace into the run's directory, read
back and deleted (the logic of the port's ``utils/xprof.op_profile`` and
``chip_smoke.py::profile_window``, frozen here).

- ``busy_s``: the union of the device's kernel, copy and set intervals
  (overlapping launches on several streams count once);
- ``window_s``: the host clock around the profiled steps, which end in a
  synchronise;
- ``device_ops``: device seconds summed by operation name, largest first;
- ``idle_gaps``: the longest stretches with nothing on the device, each
  named by the innermost host operation running at its start.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import time
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile(fn: Callable[[], None], sync: Callable[[], None],
            out_path: str) -> Dict[str, object]:
    """Run ``fn`` once under the profiler and read its trace."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    sync()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    prof.export_chrome_trace(out_path)
    try:
        with open(out_path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(out_path)       # tens of MB: what is kept is read here
    out = read_events(events)
    out["window_s"] = wall
    return out


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def read_events(events: List[dict], top: int = 10) -> Dict[str, object]:
    """busy seconds, device ops and idle gaps of a Chrome trace's events
    (times in microseconds)."""
    dev: List[Tuple[float, float]] = []
    by_name: Dict[str, float] = collections.Counter()
    host: List[Tuple[float, float, str]] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            by_name[ev.get("name", "?")] += dur / 1e6
        elif cat in ("cpu_op", "python_function", "user_annotation"):
            host.append((ts, ts + dur, ev.get("name", "?")))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = []
    for (a0, b0), (a1, _) in zip(busy, busy[1:]):
        if a1 > b0:
            gaps.append((b0, a1 - b0))
    gaps.sort(key=lambda g: -g[1])
    host.sort()
    starts = [h[0] for h in host]

    def host_at(t: float) -> str:
        """The innermost (latest-starting) host op covering ``t``."""
        i = bisect.bisect_right(starts, t)
        best = None
        for j in range(i - 1, max(i - 4000, -1), -1):
            a, b, name = host[j]
            if a <= t <= b:
                best = name
                break
        return best or "(no host op)"

    idle = [[host_at(t), d / 1e6] for t, d in gaps[:top]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_s, "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": idle}
