"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's file is ``configs/<config>.json``, the mix's
``traffic/<traffic>.json``, the mix names its driver kind
(``drivers/<kind>.py``), a per-layer metric's reader is
``metrics/<metric>.py`` and a cell's correctness limits are
``limits/<workload>.json``. Nothing here lists cells, mixes or metrics:
a later change adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def read_json(rel: str) -> dict:
    with open(ROOT / rel) as f:
        return json.load(f)


def config_file(bench: dict, name: str) -> dict:
    return read_json(config_entry(bench, name)["file"])


def traffic_file(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits_file(workload_name: str) -> Dict[str, float]:
    with open(HERE / "limits" / f"{workload_name}.json") as f:
        return json.load(f)["limits"]


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str) -> ModuleType:
    return _module(HERE / "drivers" / f"{kind}.py", f"kbench_driver_{kind}")


def reader(metric: str) -> ModuleType:
    """The reader of a per-layer metric: ``metrics/<metric>.py`` (a name
    may hold dots, so the file is loaded by path)."""
    return _module(HERE / "metrics" / f"{metric}.py",
                   "kbench_metric_" + metric.replace(".", "_"))


def metrics_of(bench: dict, section: str, workload_name: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    listing it under ``workloads``, or listing no ``workloads``."""
    return [m for m in bench[section]
            if workload_name in m.get("workloads", [workload_name])]


def validate(bench: dict) -> List[str]:
    """What in ``bench`` breaks the benchmark's contract (empty: nothing).
    Checks the shapes and names of entries and that every name resolves
    to its file; the bounds' sizes are measured, not checked here."""
    errs: List[str] = []
    if set(bench) != TOP_KEYS:
        errs.append(f"top-level keys {sorted(bench)}")
    cmd = bench.get("command", [])
    if not (1 <= len(cmd) <= 32) or any(
            not (1 <= len(w) <= 200) or "\n" in w or "\t" in w for w in cmd):
        errs.append("command")
    for p in bench.get("paths", []):
        if not PATH_RE.match(p) or p.startswith("/") or ".." in p.split("/"):
            errs.append(f"path {p!r}")
    rs = bench.get("run_seconds")
    if not isinstance(rs, int) or not 1 <= rs <= 51:
        errs.append("run_seconds")

    def names(items, what):
        seen = set()
        for it in items:
            n = it.get("name", "")
            if not NAME_RE.match(n):
                errs.append(f"{what} name {n!r}")
            if n in seen:
                errs.append(f"duplicate {what} {n!r}")
            seen.add(n)
        return seen

    cfgs = names(bench.get("configs", []), "config")
    cells = names(bench.get("workloads", []), "workload")
    names(bench.get("end_to_end", []) + bench.get("per_layer", []), "metric")
    for c in bench.get("configs", []):
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            errs.append(f"config {c.get('name')} keys {sorted(c)}")
        if not any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in bench.get("paths", [])):
            errs.append(f"config file {c['file']} outside paths")
        if not (ROOT / c["file"]).exists():
            errs.append(f"config file {c['file']} missing")
        if not (1 <= len(c.get("why", "")) <= 200) or \
                not (1 <= len(c.get("source", "")) <= 200):
            errs.append(f"config {c['name']} why or source")
        if len(c.get("reduced", [])) > 16 or any(
                not NAME_RE.match(k) for k in c.get("reduced", [])):
            errs.append(f"config {c['name']} reduced")
    pairs = set()
    used = set()
    for w in bench.get("workloads", []):
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            errs.append(f"workload {w.get('name')} keys {sorted(w)}")
        if w.get("config") not in cfgs:
            errs.append(f"workload {w['name']} config {w.get('config')}")
        used.add(w.get("config"))
        if not NAME_RE.match(w.get("traffic", "")):
            errs.append(f"workload {w['name']} traffic name")
        if not (HERE / "traffic" / f"{w['traffic']}.json").exists():
            errs.append(f"workload {w['name']}: no traffic file")
        else:
            kind = traffic_file(w["traffic"]).get("driver", "")
            if not (HERE / "drivers" / f"{kind}.py").exists():
                errs.append(f"workload {w['name']}: no driver {kind!r}")
        if not (HERE / "limits" / f"{w['name']}.json").exists():
            errs.append(f"workload {w['name']}: no limits file")
        if w.get("chips") not in (1, 4):
            errs.append(f"workload {w['name']} chips")
        if not (1 <= len(w.get("why", "")) <= 200) or "\n" in w["why"]:
            errs.append(f"workload {w['name']} why")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            errs.append(f"workload {w['name']}: pair {pair} twice")
        pairs.add(pair)
    if cfgs - used:
        errs.append(f"configs used by no cell: {sorted(cfgs - used)}")
    e2e = {m["name"]: m for m in bench.get("end_to_end", [])}
    if "setup_s" not in e2e:
        errs.append("no setup_s")
    for m in bench.get("end_to_end", []):
        extra = set(m) - {"name", "unit", "better", "bound", "source",
                          "workloads"}
        if extra or m.get("source") not in ("host_clock", "device_trace"):
            errs.append(f"end_to_end {m['name']} keys or source")
        b = m.get("bound")
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            errs.append(f"end_to_end {m['name']} bound {b}")
    for m in bench.get("end_to_end", []) + bench.get("per_layer", []):
        if not UNIT_RE.match(m.get("unit", "")):
            errs.append(f"metric {m['name']} unit")
        if m.get("better") not in ("lower", "higher"):
            errs.append(f"metric {m['name']} better")
        if m.get("source") not in SOURCES:
            errs.append(f"metric {m['name']} source")
        for w in m.get("workloads", []):
            if w not in cells:
                errs.append(f"metric {m['name']} lists unknown cell {w}")
    for m in bench.get("per_layer", []):
        extra = set(m) - {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if extra:
            errs.append(f"per_layer {m['name']} keys {sorted(extra)}")
        if m.get("moves") not in e2e:
            errs.append(f"per_layer {m['name']} moves {m.get('moves')}")
        if not (HERE / "metrics" / f"{m['name']}.py").exists():
            errs.append(f"per_layer {m['name']}: no reader")
        for w in m.get("workloads", list(cells)):
            if w not in [c["name"] for c in bench["workloads"]]:
                continue
            if m.get("moves") in e2e and w not in e2e[m["moves"]].get(
                    "workloads", [w]):
                errs.append(f"per_layer {m['name']}: cell {w} does not "
                            f"report {m['moves']}")
    for w in bench.get("workloads", []):
        n = w["name"]
        if len(metrics_of(bench, "end_to_end", n)) < 2:
            errs.append(f"cell {n} reports no end-to-end metric but setup_s")
        if not metrics_of(bench, "per_layer", n):
            errs.append(f"cell {n} reports no per-layer metric")
    return errs


def cell_parts(workload_name: str, bench: Optional[dict] = None):
    """(cell, configuration file, traffic mix, limits) of a cell."""
    bench = bench if bench is not None else load()
    cell = workload(bench, workload_name)
    return (cell, config_file(bench, cell["config"]),
            traffic_file(cell["traffic"]), limits_file(cell["name"]))
