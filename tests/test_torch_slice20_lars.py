"""Slice 20 of the port: LARS on a sharded state (C4), ``koifish --dp 2
--tp 2 --fsdp`` on one spawned group of 4 gloo ranks on the CPU
(``tests/torch_dist_slice20.slice20_worker``).

``lars_trust_ratio`` takes ‖w‖ and ‖g‖ of the whole leaf: each shard's
squares summed over the axes the leaf is cut on (tp, and dp under FSDP),
one all-reduce an axis. The run trains the one-rank CLI's curve and the
JAX CLI's on the same mesh (4 virtual devices); after one step its first
moments, (1 - β1)·ratio·g, are the one-rank run's. A shard-local norm
(planted) moves them past the gate. ``lars_ratio`` is 50 so that the
ratio is not capped: at 0.5 every leaf's ratio is the cap and any norm
gives it.

The gates are ``tests/test_torch_slice20.py``'s, each gap printed beside
its gate and each control refused."""
from test_torch_slice20 import (GNORM_RTOL, JAX_CURVE_TOL, JAX_GNORM_RTOL,
                                LOSS_RTOL, MOMENT_RTOL, abs_gap, config,
                                gate, hf_dir, jax_cli, moment_gap, port_cli,
                                rel_gap, run_ranks)

MESH = ["--dp", "2", "--tp", "2", "--fsdp"]


def test_lars_on_a_sharded_state(tmp_path, capsys):
    hf = hf_dir(tmp_path)
    opt = {"method": "adamw", "stochastic_round": False, "lars_ratio": 50.0}
    cfg = config(tmp_path, "lars", train={"optimizatioin": opt})
    cfg0 = config(tmp_path, "lars0", lr=0.0, train={"optimizatioin": opt})
    cfg1 = config(tmp_path, "lars1", steps=1, train={"optimizatioin": opt})
    want = jax_cli(capsys, tmp_path, [cfg, "--hf", hf] + MESH, "lars")
    res = run_ranks(tmp_path, {
        "lars": dict(kind="cli", argv=[cfg, "--hf", hf] + MESH),
        "lars1": dict(kind="cli", argv=[cfg1, "--hf", hf] + MESH),
        "lars1_local": dict(kind="cli", argv=[cfg1, "--hf", hf] + MESH,
                            fault="lars_local")}, world=4)
    r0 = res[0]
    for r in res[1:]:
        assert r["lars"][:2] == r0["lars"][:2]
    one = port_cli([cfg, "--hf", hf], "lars", tmp_path)
    ctl = port_cli([cfg0, "--hf", hf], "lars0", tmp_path)
    gate("C4 LARS dp2 tp2 fsdp losses vs one rank",
         rel_gap(r0["lars"][0], one[0]), LOSS_RTOL, rel_gap(ctl[0], one[0]))
    gate("C4 LARS grad norms vs one rank", rel_gap(r0["lars"][1], one[1]),
         GNORM_RTOL)
    one1 = port_cli([cfg1, "--hf", hf], "lars1", tmp_path)
    gate("C4 LARS first moments after a step vs one rank",
         moment_gap(r0["lars1"][2], one1[2]), MOMENT_RTOL,
         moment_gap(r0["lars1_local"][2], one1[2]))
    gate("C4 LARS losses vs the JAX --dp 2 --tp 2 --fsdp CLI",
         abs_gap(r0["lars"][0], want[0]), JAX_CURVE_TOL,
         abs_gap(ctl[0], want[0]))
    gate("C4 LARS grad norms vs the JAX CLI",
         rel_gap(r0["lars"][1], want[1]), JAX_GNORM_RTOL)
