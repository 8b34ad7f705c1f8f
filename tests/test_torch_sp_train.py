"""PyTorch port vs the JAX package: sequence-parallel training.

A train step with an ``SPPolicy`` over virtual CPU ranks runs the model's
causal attention as the plain ring (``parallel/ring_attention.py``); its
loss curve is held to the port's own at ``sp=None`` and to JAX's
``make_train_step(sp=SPPolicy)`` on 2 of the test run's virtual CPU
devices, and ``koifish --sp 2`` to ``--sp 1``. Each tolerance is stated
with the value measured beside it (on this CPU)."""
import csv
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import TrainCard as JTrainCard
from koifish_tpu.ops.tracectx import SPPolicy as JSPPolicy
from koifish_tpu.train import trainer as jtrainer

from koifish_tpu_torch.cli import koifish
from koifish_tpu_torch.config import ModelCard, TrainCard
from koifish_tpu_torch.data import MAGIC_QWEN3, write_shard
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.models import init_params
from koifish_tpu_torch.ops import attention as tattn
from koifish_tpu_torch.ops.tracectx import SPPolicy, sp_scope
from koifish_tpu_torch.parallel import make_mesh
from koifish_tpu_torch.parallel import ring_attention as tring
from koifish_tpu_torch.train import trainer as ttrainer
from koifish_tpu_torch.utils.tree import leaves

from torch_helpers import jax_tree_to_numpy, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


# the tiny card of tests/test_sharding.py:168-171
CARD = dict(vocab_size=128, n_layer=2, n_embd=64, n_head=4, n_kv_head=2,
            head_dim=16, n_ffn=128, n_ctx=64, max_pos=64)
TCARD = dict(batch=4, lr=0.01, warmup=3, seed=42, remat=False,
             stochastic_round=False)


def _batches(steps=4, seed=0):
    """tests/test_sharding.py's batches: 4 rows of (s + t) % 64, s drawn
    per row, as [1, 4, 65] int32."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        s = rng.integers(0, 64, (4, 1))
        out.append(((s + np.arange(65)[None]) % 64)[None].astype(np.int32))
    return out


def _counting_ring(monkeypatch):
    """Count the plain ring's calls (the SP branch of causal_attention)."""
    calls = []
    real = tring.ring_attention_sharded

    def counted(*a, **k):
        fn = real(*a, **k)

        def run(q, kk, v):
            calls.append(tuple(q.shape))
            return fn(q, kk, v)
        return run
    monkeypatch.setattr(tring, "ring_attention_sharded", counted)
    return calls


def test_sp_train_step_matches_sp_none_and_jax(monkeypatch):
    """4 AdamW steps, SR off, from the JAX init: the port with an SPPolicy
    over 2 virtual CPU ranks against the port at ``sp=None`` within 1 %
    relative (JAX's own bound for its sp step; measured 6.4e-5: the sp run's
    attention is f32, the other's the flash kernel's plain version) and
    against JAX's ``make_train_step(sp=SPPolicy)`` on 2 CPU devices within
    1e-2 absolute (the port's loss-curve tolerance; measured 1.3e-4). Each
    layer's attention goes through the ring in the sp run."""
    jcard = JModelCard.from_arch("QWEN3", **CARD)
    card = ModelCard.from_arch("QWEN3", **CARD)
    data = _batches()
    jstate = jtrainer.init_train_state(jcard, JTrainCard(**TCARD))
    init = jax_tree_to_numpy(jstate.params)
    jstep = jtrainer.make_train_step(
        jcard, JTrainCard(**TCARD), total_steps=10,
        sp=JSPPolicy("sp", Mesh(np.array(jax.devices()[:2]), ("sp",))))
    jl = []
    for b in data:
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(b)})
        jl.append(float(m["loss"]))

    calls = _counting_ring(monkeypatch)

    def port(sp):
        tcard = TrainCard(**TCARD)
        state = ttrainer.init_train_state(
            card, tcard, params=params_from_numpy(init, device="cpu"))
        step = ttrainer.make_train_step(card, tcard, total_steps=10, sp=sp)
        out = []
        for b in data:
            state, m = step(state, {"tokens": torch.from_numpy(b).long()})
            out.append(float(m["loss"]))
        return np.array(out)

    base = port(None)
    assert calls == []
    sp = port(SPPolicy("sp", make_mesh({"sp": 2}, devices="cpu")))
    assert len(calls) == 4 * card.n_layer and calls[0] == (4, 64, 4, 16)
    assert sp[-1] < sp[0]
    assert np.max(np.abs(sp - base) / base) < 0.01, sp - base
    assert np.abs(sp - np.array(jl)).max() <= 1e-2, sp - np.array(jl)


def test_sp_branch_conditions(monkeypatch):
    """Under an SPPolicy only the full-sequence causal self-attention with
    no mask and no window, and T a multiple of the ranks, takes the ring
    (JAX ops/attention.py:59-66); the ring's output matches the plain
    attention's within 1e-5 on f32 inputs (measured 2.4e-7)."""
    calls = _counting_ring(monkeypatch)
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 12, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16)))
    ref = tattn.causal_attention(q, k, v, backend="ref")
    pol = SPPolicy("sp", make_mesh({"dp": 1, "sp": 3}, devices="cpu"))
    with sp_scope(pol):
        out = tattn.causal_attention(q, k, v)
        assert calls == [(2, 12, 4, 16)]
        assert float((out - ref).abs().max()) < 1e-5
        tattn.causal_attention(q, k, v, window=4)
        tattn.causal_attention(q, k, v, mask=torch.ones(12, 12).bool())
        tattn.causal_attention(q, k, v, backend="ref")
        tattn.causal_attention(q[:, :10], k[:, :10], v[:, :10])   # 10 % 3
        tattn.causal_attention(q[:, :6], k, v)                    # tq != tk
    assert len(calls) == 1


def test_remat_recompute_reenters_the_sp_policy(monkeypatch):
    """A remat block's recompute runs where the backward runs, which for a
    CUDA backward is autograd's own thread, outside the step's scope: the
    block captures the SP policy at the forward and re-enters it. Run the
    backward from another thread here: the recompute takes the ring again
    (two ring calls a layer) and the grads equal those without remat bit
    for bit."""
    card = ModelCard.from_arch("QWEN3", **CARD)
    params = init_params(card, device="cpu", seed=3)
    for p in leaves(params):
        p.requires_grad_(True)
    tok = torch.from_numpy(_batches(1)[0][0]).long()
    pol = SPPolicy("sp", make_mesh({"sp": 2}, devices="cpu"))
    calls = _counting_ring(monkeypatch)

    def grads(remat):
        with sp_scope(pol):
            loss, _ = ttrainer.compute_loss(card, params, tok, remat=remat)
        out = {}

        def back():
            out["g"] = torch.autograd.grad(loss, leaves(params))
        t = threading.Thread(target=back)
        t.start()
        t.join()
        return out["g"]

    plain = grads(False)
    assert len(calls) == card.n_layer
    re = grads(True)
    assert len(calls) == card.n_layer * 3        # + forward and recompute
    for a, b in zip(plain, re):
        assert torch.equal(a, b)


def test_koifish_sp_cli(tmp_path, capsys):
    """tests/test_cli.py:449-479 through the port: ``--sp 2`` prints the
    mesh line with sp=2, its loss CSV falls, and its curve stays within
    1 % relative of ``--sp 1``'s (measured 4.6e-3 at step 7: both runs
    draw the same init, batches and SR seeds, and stochastic rounding
    carries the attentions' different roundings into the weights)."""
    seq = (np.arange(30000) % 64).astype(np.uint32)
    write_shard(str(tmp_path / "s_train.bin"), seq, MAGIC_QWEN3, 300)
    cfg = {
        "model": {"arch": "QWEN3", "vocab_size": 512,
                  "parameter": {"Layer": 2,
                                "transformer": {"Ctx": 64, "Embed": 128,
                                                "Ffn": 256, "Head": 8,
                                                "KVHead": 4, "head_dim": 16}}},
        "train": {"batch": 4, "learning-rate": 0.01, "warmup": 3,
                  "dump-every": 5, "remat": False},
        "datasets": {"train": {"glob": str(tmp_path / "s_train.bin")}},
        "debug": {"most_iter": 8},
        "seed": 42,
    }
    cfgp = str(tmp_path / "s.json")
    with open(cfgp, "w") as f:
        json.dump(cfg, f)
    curves = {}
    for sp in ("1", "2"):
        d = tmp_path / f"sp{sp}"
        capsys.readouterr()
        assert koifish.main([cfgp, "--device", "cpu", "--out-dir", str(d),
                             "--sp", sp]) == 0
        out = capsys.readouterr().out
        with open(d / "koifish_loss.csv") as f:
            curves[sp] = np.array([float(r["loss"])
                                   for r in csv.DictReader(f)])
        if sp == "2":
            assert "[koifish] mesh dp=1 tp=1 sp=2 on 1 device(s)" in out
        else:
            assert "mesh" not in out
    a, b = curves["1"], curves["2"]
    assert len(b) == 8 and b[-1] < b[0]
    assert np.max(np.abs(b - a) / a) < 0.01, b - a
    assert os.path.exists(tmp_path / "sp2" / "koifish_loss.csv")
