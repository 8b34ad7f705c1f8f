"""PyTorch port vs the JAX package: ``utils/logging``, ``utils/profiler``
and ``utils/xprof``. The phase timers' report is the JAX package's on the
same timings; the logger is configured as the JAX package's; a
``torch.profiler`` capture through ``utils.profiler.trace`` on the CPU is
ranked by ``op_profile`` as ``tests/test_xprof.py`` ranks a JAX capture."""
import logging
import os

import torch

from koifish_tpu.utils import logging as jlogging
from koifish_tpu.utils import profiler as jprofiler

from koifish_tpu_torch.utils import logging as tlogging
from koifish_tpu_torch.utils import profiler as tprofiler
from koifish_tpu_torch.utils.xprof import OpTime, format_profile, op_profile

from torch_helpers import torch_threads


def test_phase_timers_report_matches_jax():
    """The same phase timings give the JAX package's report string, phases
    by total time, with counts and means; ``Phase`` names and
    ``get_timers`` are the JAX package's."""
    timings = {"step": (3.25, 4), "data": (0.5, 4), "eval": (1.125, 1),
               "ckpt": (0.0, 0)}
    jt, tt = jprofiler.PhaseTimers(), tprofiler.PhaseTimers()
    for obj in (jt, tt):
        for name, (t, c) in timings.items():
            obj.total[name], obj.count[name] = t, c
    assert tt.report() == jt.report()
    assert tt.report().startswith("step=3.25s(4x,812.5ms) eval=1.12s")
    tt.reset()
    assert tt.report() == ""
    with tt.phase(tprofiler.Phase.STEP):
        pass
    assert tt.count["step"] == 1 and tt.total["step"] >= 0.0
    names = [n for n in vars(jprofiler.Phase) if not n.startswith("_")]
    assert [getattr(tprofiler.Phase, n) for n in names] == \
        [getattr(jprofiler.Phase, n) for n in names]
    assert isinstance(tprofiler.get_timers(), tprofiler.PhaseTimers)
    assert tprofiler.get_timers() is tprofiler.get_timers()


def test_logger_matches_jax():
    """``get_logger`` hands out ``koifish`` loggers with one stderr handler
    in the JAX package's format; ``set_level`` sets their level by name.
    Both packages configure the one ``koifish`` logger, so the test reads
    the port's handler after the port's call."""
    log = tlogging.get_logger("koifish.test")
    assert log.name == "koifish.test"
    root = logging.getLogger("koifish")
    assert root.propagate is False
    fmts = {h.formatter._fmt for h in root.handlers}
    assert tlogging._FMT == jlogging._FMT and tlogging._FMT in fmts
    before = root.level
    try:
        tlogging.set_level("debug")
        assert root.level == logging.DEBUG
        jlogging.set_level("warning")
        assert root.level == logging.WARNING
    finally:
        root.setLevel(before)


def test_op_profile_cpu_capture(tmp_path):
    """A capture of a matmul through ``trace`` on the CPU: ``op_profile``
    ranks the host's operators by time with their counts (the CPU device,
    as tests/test_xprof.py reads its capture), ``format_profile`` prints
    the JAX package's table, and the newest capture is the one read."""
    with torch_threads(1):
        x = torch.ones((256, 256))
        torch.mm(x, x)
        with tprofiler.trace(str(tmp_path / "old")):
            torch.add(x, 1)
        with tprofiler.trace(str(tmp_path / "old")):
            for _ in range(3):
                torch.mm(x, x) + 1
    rows = op_profile(str(tmp_path / "old"), device_substr="CPU")
    assert rows and rows[0].total_ms > 0
    assert all(isinstance(r, OpTime) for r in rows)
    assert [r.total_ms for r in rows] == sorted(
        (r.total_ms for r in rows), reverse=True)
    by = {r.name: r for r in rows}
    assert by["aten::mm"].count == 3
    txt = format_profile(rows)
    assert txt.splitlines()[0] == f"{'ms':>10} {'%':>6} {'count':>7}  op"
    assert "mm" in txt.lower()
    assert len(os.listdir(tmp_path / "old")) == 2
    assert op_profile(str(tmp_path / "old"), "CUDA") == []
