"""Each driver on the CPU at a tiny width through the port's plain paths,
held to its cell's limits: a sound run comes out correct, and each fault
the cell can have, planted underneath the run, comes out not correct."""
import pytest

from kbench import control, manifest
from kbench.tests import tiny

TRAIN = {"gpt2-774m.pretrain": tiny.gpt2_config,
         "qwen3-0.6b.pretrain": tiny.qwen3_config}


def _run(cell, config, traffic, fault=None, seconds=0.3, seed=11):
    return control.readings(cell, seed, seconds, fault, device="cpu",
                            config=config, traffic=traffic,
                            limits=tiny.LIMITS.get(cell))


@pytest.mark.parametrize("cell", sorted(TRAIN))
def test_train_driver_sound_run_is_correct(cell):
    out = _run(cell, TRAIN[cell](), tiny.train_mix())
    assert out["errors"] == []
    assert out["correct"], out["program"]
    assert out["e2e"]["train_tok_s"] > 0 and out["e2e"]["setup_s"] > 0
    # the control, one precision lower, reads further from the reference
    assert out["control"]["grad_gap"] > 3 * out["program"]["grad_gap"]


@pytest.mark.parametrize("fault", ["half", "unchanged"])
@pytest.mark.parametrize("cell", sorted(TRAIN))
def test_train_driver_fault_is_not_correct(cell, fault):
    out = _run(cell, TRAIN[cell](), tiny.train_mix(), fault=fault)
    assert not out["correct"], out["program"]


def test_batcher_driver_sound_run_is_correct():
    out = _run("qwen3-0.6b.docqa", tiny.qwen3_config(), tiny.serve_mix(),
               seconds=2.0)
    assert out["errors"] == []
    assert out["correct"], out["program"]
    assert out["checked"]["requests"] == 3
    assert out["e2e"]["serve_tok_s"] > 0 and out["e2e"]["ttft_p90_ms"] > 0
    # the control, one precision lower, reads further from the reference
    # (at this width by about 2x; at the cell's own size by 4.7x or more)
    assert out["control"]["logit_gap"] > 1.5 * out["program"]["logit_gap"]


def test_batcher_driver_altered_token_is_not_correct():
    out = _run("qwen3-0.6b.docqa", tiny.qwen3_config(), tiny.serve_mix(),
               fault="token", seconds=2.0)
    assert not out["correct"], out["program"]


def test_train_window_longer_than_the_shard_runs_on():
    # a shard of as many batches as the checked steps take: every step of
    # the window runs in a later pass
    mix = tiny.train_mix()
    n = mix["checked_steps"]
    # (n + 1)·B·T + 1 tokens give TokenDataset n batches a pass
    mix["shard_tokens"] = (n + 1) * mix["batch"] * mix["seq_len"] + 1
    out = _run("qwen3-0.6b.pretrain", tiny.qwen3_config(), mix, seconds=3.0)
    assert out["errors"] == [] and out["correct"], out["program"]
    assert out["attempted"] >= 1


@pytest.mark.parametrize("kind,key", [("train", "think_s"),
                                      ("batcher", "think_s"),
                                      ("batcher", "token_ids")])
def test_drivers_refuse_a_mix_key_they_do_not_read(kind, key):
    mix = tiny.train_mix() if kind == "train" else tiny.serve_mix()
    mix[key] = 0.5
    cell = "qwen3-0.6b.pretrain" if kind == "train" else "qwen3-0.6b.docqa"
    with pytest.raises(ValueError, match=key):
        _run(cell, tiny.qwen3_config(), mix)


def test_planted_faults_are_removed():
    import koifish_tpu_torch.serve.engine as eng
    import koifish_tpu_torch.train.trainer as tr
    before = (eng.sample_logits, tr.make_train_step)
    with control.plant("token"), pytest.raises(RuntimeError):
        raise RuntimeError("inside")
    with control.plant("half"):
        assert tr.make_train_step is not before[1]
    assert (eng.sample_logits, tr.make_train_step) == before


def test_limits_files_hold_every_compared_number():
    for cell in ("gpt2-774m.pretrain", "qwen3-0.6b.pretrain"):
        assert set(manifest.limits_file(cell)) == {"loss_gap", "grad_gap",
                                                   "change_gap"}
    assert set(manifest.limits_file("qwen3-0.6b.docqa")) == {
        "logit_gap", "served_below_topk"}
