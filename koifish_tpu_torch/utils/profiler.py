"""Phase timers (the JAX package's ``utils/profiler.py``) — the analog of
the reference's global ``SUM`` profiler (per-phase timers tQKV_forw/tFFN/
tPreLogits/…, src/Utils/GST_util.hpp:178-198, printed per chat turn / train
step).

The host timers cover the coarse phases the host can see (data, step,
prefill, decode, sample); ``trace()`` captures a device profile with
``torch.profiler`` (CPU and CUDA activities) and writes it as a Chrome
trace under its directory, which ``utils/xprof.op_profile`` reads. Host
timers around CUDA work time what the host waits for: synchronize inside
the phase where the device time is wanted.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict


class Phase:
    DATA = "data"
    STEP = "step"
    PREFILL = "prefill"
    DECODE = "decode"
    SAMPLE = "sample"
    QUANT = "quant"
    CKPT = "ckpt"
    EVAL = "eval"


class PhaseTimers:
    def __init__(self) -> None:
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def report(self) -> str:
        parts = []
        for name in sorted(self.total, key=self.total.get, reverse=True):
            t, c = self.total[name], self.count[name]
            parts.append(f"{name}={t:.2f}s({c}x,{t / max(c, 1) * 1e3:.1f}ms)")
        return " ".join(parts)

    def reset(self) -> None:
        self.total.clear()
        self.count.clear()


_global = PhaseTimers()


def get_timers() -> PhaseTimers:
    return _global


@contextlib.contextmanager
def trace(log_dir: str = "koifish_trace"):
    """Capture a device-level profile around a region: ``torch.profiler``
    with CPU activity, and CUDA activity where a card is visible; the
    capture is written to ``log_dir/trace_<ns>.json`` (Chrome trace
    format) when the region ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{time.time_ns()}.json"))
