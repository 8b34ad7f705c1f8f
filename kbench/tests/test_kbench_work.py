"""``kbench/work.py``'s counts against hand counts of both configurations
(parameter totals as the model cards publish them)."""
import json
from pathlib import Path

import pytest

from kbench import work

CFG = Path(__file__).resolve().parents[1] / "configs"


def shapes(name):
    return work.Shapes.from_config(json.loads((CFG / f"{name}.json")
                                              .read_text()))


def test_parameter_totals():
    # GPT-2 large: 774,030,080 with V 50,257; the padded 47 rows add 60,160
    assert shapes("gpt2-774m").n_params() == 774_030_080 + 47 * 1280
    # Qwen3-0.6B: 0.6B, 0.44B of them outside the tied embedding
    q = shapes("qwen3-0.6b")
    assert q.n_params() == 596_049_920
    assert q.n_params() - 151936 * 1024 - 1024 == 440_466_432


def test_gpt2_train_step_by_hand():
    sh = shapes("gpt2-774m")
    N = 16 * 1024
    rec = {"int8_matmul": True, "int8_min_kn": 4194304, "moment_bytes": 2}
    w = work.train_step(sh, 16, 1024, rec)
    # fc and proj (6,553,600 each) and the head (64,389,120) run int8
    # forward; q, k, v, o (1,638,400 each) stay bf16
    int8_w = 36 * 2 * 6_553_600 + 50304 * 1280
    bf16_w = 36 * 4 * 1_638_400
    attn = 36 * 16 * 2 * 2 * (1024 * 1025 / 2) * 1280
    assert w.int8_ops == pytest.approx(2 * N * int8_w)
    assert w.bf16_flops == pytest.approx(
        6 * N * bf16_w + 4 * N * int8_w + 3 * attn)
    assert w.nbytes == pytest.approx(12 * sh.n_params())   # bf16 p, m, v
    pk = work.peaks("NVIDIA H100 80GB HBM3")
    assert w.least_s(pk) == pytest.approx(
        w.bf16_flops / 989e12 + w.int8_ops / 1979e12)


def test_qwen3_train_step_by_hand():
    sh = shapes("qwen3-0.6b")
    N = 8 * 1024
    rec = {"int8_matmul": False, "moment_bytes": 4}
    w = work.train_step(sh, 8, 1024, rec)
    mats = 28 * (1024 * 2048 * 2 + 1024 * 1024 * 2 + 3 * 1024 * 3072) + \
        1024 * 151936
    attn = 28 * 8 * 2 * 2 * (1024 * 1025 / 2) * 2048
    assert w.int8_ops == 0
    assert w.bf16_flops == pytest.approx(6 * N * mats + 3 * attn)
    assert w.nbytes == pytest.approx(2 * (2 + 8) * sh.n_params())


def test_int8_routing_follows_the_gate():
    sh = shapes("gpt2-774m")
    on = work.train_step(sh, 1, 1024, {"int8_matmul": True,
                                       "int8_min_kn": 1, "moment_bytes": 2})
    off = work.train_step(sh, 1, 1024, {"int8_matmul": False,
                                        "moment_bytes": 2})
    assert on.bf16_flops + on.int8_ops == pytest.approx(off.bf16_flops)
    assert on.int8_ops > 0 and off.int8_ops == 0


def test_serving_calls_by_hand():
    sh = shapes("qwen3-0.6b")
    lin = 1024 * 2048 * 2 + 1024 * 1024 * 2 + 3 * 1024 * 3072
    p = work.prefill(sh, 8000)
    assert p.bf16_flops == pytest.approx(
        2 * 8000 * lin * 28 + 2 * 1024 * 151936
        + 28 * 2 * 2 * (8000 * 8001 / 2) * 16 * 128)
    wbytes = 28 * lin * (0.5 + 4 / 128) + 2 * 1024 * 151936 + \
        2 * 28 * (2 * 1024 + 2 * 128)
    kv_row = 28 * 8 * 2 * (128 + 4)
    assert p.nbytes == pytest.approx(wbytes + 2 * 8000 * 1024 + 8000 * kv_row)
    d = work.decode_step(sh, [100, 9000])
    assert d.bf16_flops == pytest.approx(
        2 * (2 * lin * 28 + 2 * 1024 * 151936)
        + 28 * 2 * 2 * (100 + 9000) * 16 * 128)
    assert d.nbytes == pytest.approx(wbytes + 9100 * kv_row + 2 * 2 * 1024)
    pk = work.peaks("NVIDIA H100 80GB HBM3")
    # decode over long caches is bound by its bytes, a long prefill by ops
    assert d.least_s(pk) == pytest.approx(d.nbytes / 3.35e12)
    assert p.least_s(pk) == pytest.approx(p.bf16_flops / 989e12)
    tot = work.serve_least(sh, [8000], [[100, 9000], []], pk)
    assert tot["least_s"] == pytest.approx(p.least_s(pk) + d.least_s(pk))
    assert tot["ops_s"] == pytest.approx(p.ops_s(pk) + d.ops_s(pk))


def test_peaks_by_device_name():
    assert work.peaks("NVIDIA H100 80GB HBM3") == (989e12, 1979e12, 3.35e12)
    assert work.peaks("NVIDIA H100 PCIe")[0] == 756e12
    assert work.peaks("cpu") is None
