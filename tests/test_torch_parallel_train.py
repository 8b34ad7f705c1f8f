"""PyTorch port vs the JAX package: data parallelism, FSDP and tensor
parallelism in training, on process meshes of 2 and 4 gloo ranks on the CPU.

The ranks are processes started by ``parallel/multihost.spawn`` running
``tests/torch_dist_helpers.py`` (torch only); the JAX package's step runs
here, on one device (its sharded step computes the same numbers,
tests/test_sharding.py:53). Curves use the port's loss-curve tolerance of
``tests/test_torch_train.py`` (1e-2 absolute); the overlapped gradient
reduction is held to the one after the backward bit for bit; a sharded
state's checkpoint is the one-rank file byte for byte. Each tolerance is
stated with the value measured beside it (on this CPU)."""
import csv
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import TrainCard as JTrainCard
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.train import trainer as jtrainer

from koifish_tpu_torch.config import ModelCard, TrainCard
from koifish_tpu_torch.io import save_train_state
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.parallel.multihost import spawn
from koifish_tpu_torch.train import trainer as ttrainer

import torch_dist_helpers as dh
from torch_helpers import jax_tree_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = dict(vocab_size=512, n_layer=2, n_embd=128, n_head=8, n_kv_head=4,
            head_dim=16, n_ffn=256, n_ctx=64, max_pos=128)
TCARD = dict(batch=8, lr=1e-3, warmup=0, optimizer="adamw", remat=False,
             stochastic_round=False)
CURVE_TOL = 1e-2       # tests/test_torch_train.py's loss-curve tolerance


def _batches(n=3, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (1, 8, 33)).astype(np.int32)
            for _ in range(n)]


def _masks(n=3):
    """SFT-like masks whose counts differ between the two dp halves: rows
    0-3 count most tokens, rows 4-7 few (a mean of per-rank means is then
    not the global mean)."""
    out = []
    for a in range(n):
        m = np.zeros((1, 8, 33), bool)
        for b in range(8):
            m[0, b, : (30 - 3 * b + a if b < 4 else 3 + b)] = True
        out.append(m)
    return out


def _jax_curve(jcard, init_tree, batches, masks=None, **tcard):
    tc = JTrainCard(**dict(TCARD, **tcard))
    jstep = jtrainer.make_train_step(jcard, tc, total_steps=10)
    st = jtrainer.init_train_state(jcard, tc)
    st = st.__class__(params=jax.tree_util.tree_map(jnp.asarray, init_tree),
                      opt=st.opt, rng=st.rng)
    out = []
    for a, b in enumerate(batches):
        batch = {"tokens": jnp.asarray(b)}
        if masks is not None:
            batch["loss_mask"] = jnp.asarray(masks[a])
        st, m = jstep(st, batch)
        out.append(float(m["loss"]))
    return np.array(out)


def _cfg(tmp_path, steps=4):
    from koifish_tpu_torch.data import MAGIC_QWEN3, write_shard
    seq = (np.arange(30000) % 64).astype(np.uint32)
    write_shard(str(tmp_path / "p_train_0.bin"), seq, MAGIC_QWEN3, 300)
    cfg = {
        "model": {"arch": "QWEN3", "vocab_size": 300,
                  "parameter": {"Layer": 2,
                                "transformer": {"Ctx": 32, "Embed": 64,
                                                "Ffn": 128, "Head": 4,
                                                "KVHead": 2, "head_dim": 16}}},
        "train": {"batch": 8, "learning-rate": 0.01, "dump-every": 1,
                  "warmup": 3, "optimizatioin": {"method": "adamw",
                                                 "stochastic_round": False}},
        "datasets": {"train": {"glob": str(tmp_path / "p_train_*.bin"),
                               "name": "pattern"}},
        "debug": {"most_iter": steps},
        "seed": 42,
    }
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def jax_side():
    jcard = JModelCard.from_arch("QWEN3", **CARD)
    init = jax_tree_to_numpy(j_init_params(jcard, jax.random.PRNGKey(0)))
    batches, masks = _batches(), _masks()
    return dict(init=init, batches=batches, masks=masks,
                curve=_jax_curve(jcard, init, batches),
                masked=_jax_curve(jcard, init, batches, masks),
                muon=_jax_curve(jcard, init, batches, optimizer="muon"))


def _inp(tmp_path, jax_side, **extra):
    inp = dict(arch="QWEN3", card=CARD, tcard=TCARD, init=jax_side["init"],
               batches=jax_side["batches"], masks=jax_side["masks"], **extra)
    path = str(tmp_path / "inp.pt")
    torch.save(inp, path)
    return path


def test_dp_fsdp_overlap_checkpoint_cli(tmp_path, jax_side):
    """Two dp ranks (one spawn): the gradients summed by collectives
    started from the backward's hooks equal ``GradReducer.reduce`` after
    the backward bit for bit, over several all-reduce (and, under FSDP,
    reduce-scatter) buckets; the dp curve trains JAX's within 1e-2
    (measured 1.8e-4), as
    does FSDP's (1.8e-4); with masks whose counts differ between the ranks
    the loss is the global masked mean (JAX's curve within 1e-2, measured
    2.2e-4; the first step's within 1e-4); rank 0's checkpoint of the
    gathered FSDP state is the one-rank file byte for byte; and ``koifish
    --dp 2 --fsdp`` through the CLI's main trains the one-rank curve
    within 1e-2."""
    cfg = _cfg(tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    spawn(dh.dp_worker, 2, (_inp(tmp_path, jax_side, cfg=cfg), str(out)),
          device="cpu", threads=1, init_dir=str(tmp_path))
    r0, r1 = dh.load_results(str(out), 2)
    for r in (r0, r1):
        for name in ("reducer", "reducer_fsdp"):
            hooked, after, n_buckets, fsdp_leaves = r[name]
            assert n_buckets > 2 and len(hooked) == len(after)
            assert bool(fsdp_leaves) == (name == "reducer_fsdp")
            for a, b in zip(hooked, after):
                assert np.array_equal(a, b)
    for r in (r0, r1):                       # both ranks report one loss
        assert r["overlap"][0] == r0["overlap"][0]
    for name, ref in (("overlap", "curve"), ("fsdp", "curve"),
                      ("masked", "masked"), ("masked_fsdp", "masked")):
        gap = np.abs(np.array(r0[name][0]) - jax_side[ref]).max()
        print(name, "gap to JAX", gap)
        assert gap <= CURVE_TOL, (name, gap)
    assert abs(r0["masked"][0][0] - jax_side["masked"][0]) <= 1e-4
    # the one-rank file
    card, tcard = ModelCard.from_arch("QWEN3", **CARD), TrainCard(**TCARD)
    st = ttrainer.init_train_state(
        card, tcard, params=params_from_numpy(jax_side["init"],
                                              device="cpu"))
    save_train_state(str(tmp_path / "one.safetensors"), st, card,
                     extra_meta={"iter": 0})
    assert (tmp_path / "one.safetensors").read_bytes() == \
        (out / "sharded.safetensors").read_bytes()
    # the CLI against its one-rank run
    from koifish_tpu_torch.cli import koifish
    res = {}
    koifish.main([cfg, "--device", "cpu", "--out-dir", str(tmp_path)], res)
    gap = np.abs(np.array(r0["cli"]) - np.array(res["infos"].losses)).max()
    print("koifish --dp 2 --fsdp vs one rank", gap)
    assert r0["cli"] == r1["cli"] and gap <= CURVE_TOL


def test_dp_tp_four_ranks(tmp_path, jax_side):
    """Four ranks, dp 2 x tp 2 (one spawn): FSDP over dp with the tensor-
    parallel layers trains JAX's curve within 1e-2 (measured 9.0e-5), with
    Muon too (its leaves orthogonalized whole from every rank's shard),
    and the hooked FSDP reduction equals ``GradReducer.reduce`` after the
    backward bit for bit."""
    out = tmp_path / "out"
    out.mkdir()
    spawn(dh.dp_tp_worker, 4, (_inp(tmp_path, jax_side), str(out)),
          device="cpu", threads=1, init_dir=str(tmp_path))
    res = dh.load_results(str(out), 4)
    assert sorted(r["coords"] for r in res) == [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]
    r0 = res[0]
    for name, ref in (("fsdp", "curve"), ("overlap", "curve"),
                      ("muon", "muon")):
        gap = np.abs(np.array(r0[name][0]) - jax_side[ref]).max()
        print(name, "gap to JAX", gap)
        assert gap <= CURVE_TOL
    for r in res:
        hooked, after, n_buckets, fsdp_leaves = r["reducer"]
        assert n_buckets > 2 and fsdp_leaves
        for a, b in zip(hooked, after):
            assert np.array_equal(a, b)
    for r in res:
        assert r["fsdp"][0] == r0["fsdp"][0]


def test_koifish_dp2_through_the_launcher(tmp_path):
    """``koifish --dp 2`` as two launcher processes (the multi-host form,
    rendezvous through a file): each rank feeds its own rows of the batch
    and both ranks report the same loss; rank 0 alone writes the curve."""
    cfg = _cfg(tmp_path, steps=3)
    init = "file://" + str(tmp_path / "rendezvous")
    procs = []
    for host in range(2):
        cmd = [sys.executable, "-m", "koifish_tpu_torch.parallel.multihost",
               "--init-method", init, "--num-hosts", "2", "--host-id",
               str(host), "--", sys.executable, "-m",
               "koifish_tpu_torch.cli.koifish", cfg, "--device", "cpu",
               "--dp", "2", "--out-dir", str(tmp_path / f"host{host}")]
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    assert "rank 0/2: batch rows 0:4 of 8" in outs[0][0]
    assert "rank 1/2: batch rows 4:8 of 8" in outs[1][0]
    assert "backend gloo (ranks on the CPU)" in outs[0][0]
    with open(tmp_path / "host0" / "koifish_loss.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3
    assert not (tmp_path / "host1" / "koifish_loss.csv").exists()
    last = [ln for ln in outs[1][0].splitlines() if "rank 1/2 done" in ln]
    assert last and float(last[0].split()[-1]) == pytest.approx(
        float(rows[-1]["loss"]), rel=1e-5)
