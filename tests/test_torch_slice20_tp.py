"""Slice 20 of the port: the Fuyou swarm on a process mesh (C3) and
speculative decoding under ``bubble --tp 2`` (C1), on one spawned group of
2 gloo ranks on the CPU (``tests/torch_dist_slice20.slice20_worker``).

- C3: each rank keeps its branches and velocities as shards and takes
  every draw at the whole leaf's shape, so after three rotations the
  gathered swarm equals the one-rank swarm bit for bit under dp 2 (FSDP
  shards) and tp 2; drawing at the shard's shape (planted) does not.
  ``koifish --dp 2`` and ``--tp 2`` with ``model.fuyou`` train the one-rank
  CLI's curve and the JAX CLI's on the same mesh.
- C1: ``bubble --tp 2 --draft-hf`` gives the JAX ``speculative_generate``'s
  greedy tokens on a tp-2 mesh, and at temperature 0.8 the port's one-rank
  speculative tokens for the same seed; a rank seeded otherwise
  (planted) is caught on both ranks before the ranks part.

The gates are ``tests/test_torch_slice20.py``'s, each gap printed beside
its gate and each control refused. The swarm trains at lr 2e-3, as gama
does there: a rotation puts a branch under moments made on another, and at
lr 1e-2 tp 2's last-bit gradient differences then part it from one rank by
1.5e-3 in loss by step 2 (1.8e-4 at 2e-3)."""
import re

import jax.numpy as jnp
import numpy as np

from koifish_tpu.config import SamplerCard as JSamplerCard
from koifish_tpu.io import hf_loader as jhf
from koifish_tpu.parallel.mesh import make_mesh as j_make_mesh
from koifish_tpu.parallel.sharding import shard_cache as j_shard_cache
from koifish_tpu.parallel.sharding import shard_params as j_shard_params
from koifish_tpu.serve import cache_for as j_cache_for
from koifish_tpu.serve.speculative import \
    speculative_generate as j_speculative_generate

from koifish_tpu_torch.cli import bubble
from koifish_tpu_torch.parallel import ProcessMesh

import torch_dist_slice20 as ds
from test_torch_slice20 import (GNORM_RTOL, JAX_CURVE_TOL, LOSS_RTOL,
                                TRANSFORMER, _pp_run, abs_gap, config, gate,
                                hf_dir, jax_cli, port_cli, rel_gap,
                                run_ranks)
from torch_helpers import torch_threads

FUYOU = {"branch": 2, "switch": 1, "method": "pso"}
NEW = 12


def _swarm_job(axes, **kw):
    run = _pp_run()
    return dict(kind="swarm", axes=axes, arch=run["arch"], card=run["card"],
                init=run["init"], **kw)


def _bubble_argv(hf, temperature, csv):
    return ["--hf", hf, "--draft-hf", hf, "--prompts",
            "hello world, tell me something long enough", "--max-new",
            str(NEW), "--temperature", str(temperature), "--ctx", "128",
            "--device", "cpu", "--csv", csv]


def _jax_speculative(hf, ids, eos):
    """JAX's ``speculative_generate`` with the target's params and cache
    sharded over a tp-2 mesh, greedy, the same folder as its draft."""
    jcard, jp = jhf.load_hf_model(hf)
    mesh = j_make_mesh({"tp": 2})
    size = max(128, len(ids) + NEW) + 4
    tc = j_shard_cache(j_cache_for(jcard, 1, size), mesh)
    dc = j_cache_for(jcard, 1, size)
    toks, stats = j_speculative_generate(
        jcard, j_shard_params(jp, mesh), jcard, jp,
        jnp.asarray([ids], jnp.int32), tc, dc, k=4, max_new_tokens=NEW,
        eos_id=eos, sampler=JSamplerCard(temperature=0.0))
    return np.asarray(toks)[0].tolist(), stats


def test_fuyou_and_speculative_on_a_mesh(tmp_path, capsys):
    hf = hf_dir(tmp_path)
    model = {"arch": "QWEN3", "vocab_size": 300, "fuyou": FUYOU,
             "parameter": {"Layer": 4, "transformer": TRANSFORMER}}
    fy = config(tmp_path, "fy", lr=2e-3, model=model)
    fy0 = config(tmp_path, "fy0", lr=0.0, model=model)
    j_fy = {ax: jax_cli(capsys, tmp_path, [fy, "--hf", hf, f"--{ax}", "2"],
                        f"fy_{ax}") for ax in ("dp", "tp")}
    csv = str(tmp_path / "chat.csv")
    jobs = {
        "swarm_dp": _swarm_job({"dp": 2}, fsdp=True),
        "swarm_tp": _swarm_job({"tp": 2}),
        "swarm_tp_shard_draws": _swarm_job({"tp": 2},
                                           fault="fuyou_shard_draws"),
        "fy_dp": dict(kind="cli", argv=[fy, "--hf", hf, "--dp", "2"]),
        "fy_tp": dict(kind="cli", argv=[fy, "--hf", hf, "--tp", "2"]),
        "spec": dict(kind="bubble", argv=_bubble_argv(hf, 0, csv)
                     + ["--tp", "2"]),
        "spec_t": dict(kind="bubble", argv=_bubble_argv(hf, 0.8, csv)
                       + ["--tp", "2"]),
        "spec_seed": dict(kind="bubble", argv=_bubble_argv(hf, 0.8, csv)
                          + ["--tp", "2"], fault="spec_seed"),
    }
    r0, r1 = run_ranks(tmp_path, jobs)

    # C3: the swarm, gathered, is the one-rank swarm bit for bit
    one = ds._swarm(ProcessMesh({}, "cpu"), jobs["swarm_tp"])
    for name in ("swarm_dp", "swarm_tp"):
        for got in (r0[name], r1[name]):
            assert all(np.array_equal(a, b) for ta, tb in zip(got, one)
                       for a, b in zip(ta, tb)), name
    moved = sum(int((a != b).sum()) for ta, tb in zip(
        r0["swarm_tp_shard_draws"], one) for a, b in zip(ta, tb))
    print("C3 swarm: dp 2 (FSDP) and tp 2 bit for bit; shard-shape draws "
          "(planted) move", moved, "entries")
    assert moved > 0
    one_fy = port_cli([fy, "--hf", hf], "fy", tmp_path)
    ctl = port_cli([fy0, "--hf", hf], "fy0", tmp_path)
    for ax in ("dp", "tp"):
        got = r0[f"fy_{ax}"]
        assert got[:2] == r1[f"fy_{ax}"][:2]
        gate(f"C3 fuyou --{ax} 2 losses vs one rank",
             rel_gap(got[0], one_fy[0]), LOSS_RTOL,
             rel_gap(ctl[0], one_fy[0]))
        gate(f"C3 fuyou --{ax} 2 grad norms vs one rank",
             rel_gap(got[1], one_fy[1]), GNORM_RTOL)
        gate(f"C3 fuyou --{ax} 2 losses vs the JAX CLI",
             abs_gap(got[0], j_fy[ax][0]), JAX_CURVE_TOL,
             abs_gap(ctl[0], j_fy[ax][0]))

    # C1: greedy tokens are JAX's on a tp-2 mesh; sampled ones the port's
    # one-rank run's for the same seed
    ((ids, toks, stats),) = r0["spec"]
    assert r1["spec"] == r0["spec"] and r1["spec_t"] == r0["spec_t"]
    from koifish_tpu_torch.data import BPETokenizer
    eos = BPETokenizer.from_file(hf).token_id("<|im_end|>")
    jtoks, jstats = _jax_speculative(hf, ids, eos)
    print("C1 greedy: port tp-2", toks, "JAX tp-2", jtoks, "rounds",
          stats["rounds"], jstats["rounds"])
    assert toks == jtoks and stats["accept_rate"] > 0.5
    with torch_threads(1):
        turns = []
        assert bubble.main(_bubble_argv(hf, 0.8, csv), turns=turns) == 0
    print("C1 sampled (T 0.8): port tp-2", r0["spec_t"][0][1], "one rank",
          turns[0]["tokens"])
    assert r0["spec_t"][0][1] == turns[0]["tokens"]
    for r in (r0, r1):
        assert r["spec_seed"][0] == "raised" and re.search(
            r"rank\(s\) \[1\] of the group took other tokens",
            r["spec_seed"][1])
