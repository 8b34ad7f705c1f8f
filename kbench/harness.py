"""What every driver shares: the run's settings, the result it hands back,
the comparison against a cell's limits, and the look at the device."""
from __future__ import annotations

import dataclasses
import os
import statistics
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class RunContext:
    config: dict           # the configuration's file
    traffic: dict          # the traffic mix's file
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    t0: float              # the host clock at the process's start
    out_dir: str           # this cell's directory in the checkout
    device: str = "cuda"
    # also compute the control (the reference one precision lower) after
    # the reference: for the control's own runs, never the benchmark's
    control: bool = False


@dataclasses.dataclass
class Result:
    attempted: int
    failed: int
    e2e: Dict[str, float]                 # end-to-end metric -> value
    layer: Dict[str, object]              # what the per-layer readers read
    checks: List[Tuple[str, float, float]]  # (name, value, limit)
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    errors: List[str] = dataclasses.field(default_factory=list)

    @property
    def correct(self) -> bool:
        return not self.errors and all(v <= lim for _, v, lim in self.checks)


def rel_gap(prog: Sequence[float], ref: Sequence[float],
            keep: Optional[Sequence[bool]] = None) -> float:
    """The worst leaf's |program - reference|, over the larger of that
    leaf's reference value and the median leaf's."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median([ref[i] for i in idx])
    return max(abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx)


def median_gap(prog: Sequence[float], ref: Sequence[float],
               keep: Optional[Sequence[bool]] = None) -> float:
    """The median leaf's |program - reference|, each leaf's gap over the
    larger of its reference value and the median leaf's: steady where a
    few small leaves' changes are a handful of rounding events."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median([ref[i] for i in idx])
    return statistics.median(
        abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx)


def moving(ref_grad: Sequence[float], frac: float = 1e-3) -> List[bool]:
    """Leaves whose reference gradient is not nought to rounding: at least
    ``frac`` of the median leaf's (a key's bias under softmax is not)."""
    med = statistics.median(ref_grad)
    return [g >= frac * med for g in ref_grad]


def check(name: str, value: float, limits: Dict[str, float]
          ) -> Tuple[str, float, float]:
    return (name, float(value), float(limits[name]))


def power_limit_w() -> Optional[float]:
    """The card's power limit (nvidia-smi), or None where it cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_dir(root: str, workload: str) -> str:
    d = os.path.join(root, "kbench_runs", workload)
    os.makedirs(d, exist_ok=True)
    return d
