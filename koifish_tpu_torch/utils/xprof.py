"""Offline trace analysis — per-op device-time attribution (the JAX
package's ``utils/xprof.py``, over ``torch.profiler``'s Chrome traces in
place of xplane captures).

The reference prints per-phase timers (``SUM``: tQKV_forw/tFFN/...,
GST_util.hpp:178-198). A step's device work is many kernel launches, so
phase attribution comes from the device trace. This module turns a capture
of ``utils.profiler.trace`` into a ranked op-time table::

    from koifish_tpu_torch.utils.profiler import trace
    from koifish_tpu_torch.utils.xprof import op_profile, format_profile
    with trace("tr"):
        step(...)
    print(format_profile(op_profile("tr", "CUDA")))
"""
from __future__ import annotations

import collections
import glob
import json
import os
from typing import Dict, List, NamedTuple

#: the trace categories of each device (``device_substr``, any case)
_CATEGORIES = {"cuda": ("kernel", "gpu_memcpy", "gpu_memset"),
               "cpu": ("cpu_op",)}


class OpTime(NamedTuple):
    name: str
    total_ms: float
    count: int


def op_profile(log_dir: str, device_substr: str = "CUDA",
               top: int = 30) -> List[OpTime]:
    """Aggregate per-op time from the newest capture under ``log_dir``:
    events of the device ``device_substr`` names ("CUDA": the kernels,
    copies and memsets the card ran; "CPU": the host's operators, for
    captures without a card, as in the tests), summed by name, largest
    first."""
    files = sorted(glob.glob(os.path.join(log_dir, "**", "*.json"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no trace capture under {log_dir}")
    cats = _CATEGORIES.get(device_substr.lower())
    if cats is None:
        raise ValueError(f"device_substr={device_substr!r}: one of "
                         f"{sorted(_CATEGORIES)} (any case)")
    with open(files[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    tot: Dict[str, float] = collections.Counter()
    cnt: Dict[str, int] = collections.Counter()
    for ev in events:
        if ev.get("ph") != "X" or str(ev.get("cat", "")).lower() not in cats:
            continue
        name = ev.get("name", "?")
        tot[name] += float(ev.get("dur", 0.0)) / 1e3       # us -> ms
        cnt[name] += 1
    rows = [OpTime(n, t, cnt[n]) for n, t in tot.items()]
    rows.sort(key=lambda r: -r.total_ms)
    return rows[:top]


def format_profile(rows: List[OpTime], width: int = 100) -> str:
    total = sum(r.total_ms for r in rows)
    out = [f"{'ms':>10} {'%':>6} {'count':>7}  op"]
    for r in rows:
        pct = 100.0 * r.total_ms / total if total else 0.0
        out.append(f"{r.total_ms:10.3f} {pct:6.1f} {r.count:7d}  "
                   f"{r.name[:width]}")
    return "\n".join(out)
