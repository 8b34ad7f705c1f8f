"""What the harness loads: after a tiny CPU run of every driver no loaded
module's top-level name is ``jax``, ``jaxlib``, ``flax`` or
``koifish_tpu`` (``koifish_tpu_torch`` is the program), and the plain
reference imports nothing of the program."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

KBENCH = Path(__file__).resolve().parents[1]
ROOT = KBENCH.parent

SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from kbench import control, run
from kbench.tests import tiny
for cell, cfg, mix, s in (
        ("gpt2-774m.pretrain", tiny.gpt2_config(), tiny.train_mix(), 0.2),
        ("qwen3-0.6b.pretrain", tiny.qwen3_config(), tiny.train_mix(), 0.2),
        ("qwen3-0.6b.docqa", tiny.qwen3_config(), tiny.serve_mix(), 1.0)):
    control.readings(cell, 3, s, device="cpu", config=cfg, traffic=mix)
print(json.dumps({{"forbidden": run.forbidden_loaded(),
                  "port": "koifish_tpu_torch" in sys.modules}}))
"""


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_jax_after_a_run():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"forbidden": [], "port": True}


def test_top_level_names_are_compared_whole():
    from kbench import run
    saved = dict(sys.modules)
    try:
        sys.modules.pop("koifish_tpu", None)
        assert "koifish_tpu" not in run.forbidden_loaded()
        sys.modules["koifish_tpu.config"] = sys.modules["json"]
        assert run.forbidden_loaded() == ["koifish_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_reference_imports_nothing_of_the_program():
    for path in (KBENCH / "reference").glob("*.py"):
        for name in _imports(path):
            assert name not in ("koifish_tpu_torch", "koifish_tpu", "jax",
                                "jaxlib", "flax"), (path, name)


def test_harness_imports_no_jax():
    for path in KBENCH.rglob("*.py"):
        for name in _imports(path):
            assert name not in ("koifish_tpu", "jax", "jaxlib", "flax"), \
                (path, name)


def test_run_fails_without_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and kbench/, a run exits
    with another code than 0 and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(KBENCH, tmp_path / "kbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "kbench/run.py", "--workload", "gpt2-774m.pretrain",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0
    assert "correct" not in out.stdout
