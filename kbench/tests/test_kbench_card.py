"""On the card, at each cell's own size: on three seeds the program is
correct, the control (the reference one precision below the
configuration's, in the program's place) fails at least one of the cell's
limits, and each planted fault the cell can have comes out not correct.
Run on the H100: ``python3 -m pytest kbench/tests -m card``."""
import pytest

from kbench import control, manifest

SEEDS = (1000000007, 2147483659, 3999999979)
CELLS = {"gpt2-774m.pretrain": ("half", 2.0),
         "qwen3-0.6b.pretrain": ("half", 2.0),
         "qwen3-0.6b.docqa": ("token", 45.0)}


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100")
    from koifish_tpu_torch.ops.kernels import _build
    _build.build()


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_where_the_program_passes(cell):
    _card()
    limits = manifest.limits_file(cell)
    for seed in SEEDS:
        out = control.readings(cell, seed, CELLS[cell][1])
        assert out["correct"], (seed, out["program"], out["errors"])
        ctl = out["control"]
        assert any(ctl[k] > limits[k] for k in ctl if k in limits), \
            (seed, ctl, limits)


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_planted_fault_is_not_correct(cell):
    _card()
    fault, seconds = CELLS[cell]
    out = control.readings(cell, SEEDS[0], seconds, fault)
    assert not out["correct"], out["program"]
