"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it resolving to its file under ``kbench/``."""
import json
import re

import pytest

from kbench import manifest, work

BENCH = manifest.load()
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head_dim|"
                   r"_dim$|_rank$|n_embd|n_inner|experts_per_tok|"
                   r"expansion)")


def test_manifest_validates():
    assert manifest.validate(BENCH) == []


def test_command_and_paths():
    assert BENCH["command"] == ["python3", "kbench/run.py"]
    assert BENCH["paths"] == ["kbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_text_fields():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert manifest.NAME_RE.match(m["name"])
        assert manifest.UNIT_RE.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for it in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(it["why"]) <= 200 and "\n" not in it["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_and_reports(cell):
    w, cfg, mix, limits = manifest.cell_parts(cell, BENCH)
    assert cfg["name"] == w["config"]
    assert manifest.driver(mix["driver"]).run
    assert limits and all(v > 0 for v in limits.values())
    e2e = {m["name"] for m in manifest.metrics_of(BENCH, "end_to_end", cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = manifest.metrics_of(BENCH, "per_layer", cell)
    assert layer
    for m in layer:          # what a per-layer metric moves, the cell reports
        assert m["moves"] in e2e
        assert manifest.reader(m["name"]).read


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_readers_return_nothing_without_readings(metric):
    r = manifest.reader(metric)
    assert r.read({"layer": {}, "peaks": None}) is None
    assert r.read({"layer": {}, "peaks": work.peaks("NVIDIA H100")}) is None


def test_roofline_and_peak_shares_are_bounded():
    pk = work.peaks("NVIDIA H100 80GB HBM3")
    w = work.Work(bf16_flops=989e12, int8_ops=0.0, nbytes=1.0)
    lay = {"steps": 1, "window_s": 2.0, "step_work": w,
           "trace": {"busy_s": 4.0, "window_s": 5.0, "steps": 2}}
    run = {"layer": lay, "peaks": pk}
    assert manifest.reader("mfu.train").read(run) == pytest.approx(50.0)
    assert manifest.reader("kernel_roofline.train").read(run) == \
        pytest.approx(50.0)
    assert manifest.reader("idle_share.train").read(run) == \
        pytest.approx(20.0)


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_configs_cut_no_width(cfg):
    c = manifest.config_entry(BENCH, cfg)
    f = manifest.config_file(BENCH, cfg)
    assert f["reduced"] == c["reduced"] and f["source"] == c["source"]
    assert not any(WIDTH.search(k) for k in c["reduced"])
    src = f["source_config"]
    sh = work.Shapes.from_config(f)
    hidden = src.get("hidden_size", src.get("n_embd"))
    assert sh.E == hidden
    assert sh.L == src.get("num_hidden_layers", src.get("n_layer"))
    assert sh.Hq == src.get("num_attention_heads", src.get("n_head"))


def test_validate_catches_faults():
    bad = json.loads(json.dumps(BENCH))
    bad["per_layer"][0]["moves"] = "serve_tok_s"
    bad["workloads"][0]["traffic"] = "no-such-mix"
    bad["end_to_end"][1]["bound"] = 0.5
    errs = manifest.validate(bad)
    assert any("moves" in e or "does not report" in e for e in errs)
    assert any("traffic" in e for e in errs)
    assert any("bound" in e for e in errs)
