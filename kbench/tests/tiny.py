"""Tiny configurations and mixes of the cells' shapes, for runs of the
drivers on the CPU through the port's plain paths."""
from __future__ import annotations

import copy
import json
import time
from pathlib import Path

from kbench import harness

HERE = Path(__file__).resolve().parents[1]


def _load(rel: str) -> dict:
    with open(HERE / rel) as f:
        return json.load(f)


def gpt2_config() -> dict:
    c = _load("configs/gpt2-774m.json")
    m = c["koifish"]["model"]
    m["vocab_size"] = 384
    m["parameter"].update(Layer=2, max_pos_embeddings=1024)
    m["parameter"]["transformer"] = {"Ctx": 32, "Embed": 64, "Head": 4,
                                     "Ffn": 256}
    c["koifish"]["train"]["optimizatioin"]["int8_min_kn"] = 8192
    c["recipe"]["int8_min_kn"] = 8192
    c["data"]["vocab"] = 300
    return c


def qwen3_config() -> dict:
    c = _load("configs/qwen3-0.6b.json")
    m = c["koifish"]["model"]
    m["vocab_size"] = 512
    m["parameter"].update(Layer=2, max_pos_embeddings=4096)
    m["parameter"]["transformer"] = {"Ctx": 32, "Embed": 128, "Ffn": 256,
                                     "Head": 4, "KVHead": 2, "head_dim": 32}
    c["data"]["vocab"] = 512
    return c


#: limits for the tiny widths where a cell's own (set at its size) do not
#: hold there; the tiny Qwen3 step reads loss gaps up to ~4e-5
LIMITS = {"qwen3-0.6b.pretrain": {"loss_gap": 1.5e-4, "grad_gap": 5.5e-3,
                                  "change_gap": 0.02}}


def train_mix(batch: int = 4) -> dict:
    t = copy.deepcopy(_load("traffic/pretrain-b16-t1024.json"))
    t.update(batch=batch, seq_len=32, shard_tokens=32 * 1024,
             reference_rows=2)
    return t


def serve_mix() -> dict:
    t = copy.deepcopy(_load("traffic/docqa-c48.json"))
    t["clients"] = 6
    t["prompt"] = {"dist": "lognormal", "median": 40, "sigma": 0.6,
                   "min": 20, "max": 100}
    t["output"] = {"dist": "uniform", "min": 4, "max": 8}
    t["engine"].update(slots=4, cache_size=128, decode_chunk=2)
    t["checked_requests"] = 3
    return t


def context(config, traffic, limits, seconds=2.0, trace=False, seed=7,
            out_dir="/tmp") -> harness.RunContext:
    return harness.RunContext(
        config=config, traffic=traffic, limits=limits,
        seed=seed, seconds=seconds, trace=trace, t0=time.perf_counter(),
        out_dir=out_dir, device="cpu")
