"""Slice 20 of the port against the JAX package and against the port's own
one-rank runs, on process meshes of 2 gloo ranks on the CPU (one spawn,
``tests/torch_dist_slice20.slice20_worker``):

- F1: the pipeline's stochastic rounding hashes every stage leaf by its
  index in the whole [L, ...] stack, so with SR on (and no clipping) a
  ``--pp 2`` run's params and step-1 loss equal the one-rank pipeline's
  bit for bit; the stage-local index (the parent's layout, planted) does
  not;
- F2: LoRA adapters and LLAMA_VAE on a mesh of dp·tp·sp > 1 ranks, where
  the JAX package's ``shard_params`` raises AttributeError, are refused
  with NotImplementedError; under ``--pp`` LoRA trains as the JAX pipeline
  loop trains it (every leaf, every token: JAX's curve);
- C2: ``koifish --dp 2 --fsdp`` over a gama quantizer card (codes and
  scales sharded with their weight, gathered for the step);
- C4 under ``--pp 2``: LARS takes one ratio per layer of each stacked
  stage leaf and none on its norms (since slice 21; the whole-stack ratio
  of slice 20, planted, is the control).

Gates: against the port's one-rank run, losses within 1e-3 relative and
grad norms within 1e-2 relative (``chip_smoke.py``'s PAR_LOSS_RTOL and
PAR_GNORM_RTOL), the tree of first moments (which carry LARS's ratio)
within 1e-2 in norm; against the JAX CLI, losses within
``tests/test_torch_cli_train.py``'s 1e-2 absolute (the two packages round
bf16 at other points) and grad norms within
``tests/test_torch_parallel_zoo.py``'s 2e-2 relative. Gama trains at lr
2e-3: at 1e-2 Adam's normalised step turns last-bit gradient differences
of near-zero scale gradients into whole steps, and the JAX CLI's own
one-device, ``--dp 2`` and ``--dp 2 --fsdp`` runs then part by 8 % in grad
norm by step 2 (8.242, 8.095, 7.593; 6.931, 6.938, 6.916 at 2e-3). Each
comparison runs a control that the gate must refuse: a learning rate of
0, or a planted fault. Each gap is printed beside its gate."""
import copy
import json
import re

import jax
import numpy as np
import pytest
import torch

from koifish_tpu.cli import koifish as jkoifish
from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.parallel.mesh import make_mesh as j_make_mesh
from koifish_tpu.parallel.sharding import shard_params as j_shard_params
from koifish_tpu.train import lora as jlora

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.data import MAGIC_QWEN3, write_shard
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.parallel import ProcessMesh
from koifish_tpu_torch.parallel import sharding as tsh
from koifish_tpu_torch.parallel.multihost import spawn

import torch_dist_helpers as dh
import torch_dist_slice20 as ds
from helpers import make_hf_qwen3_dir
from torch_helpers import jax_tree_to_numpy, torch_threads

LOSS_RTOL = 1e-3       # chip_smoke.py's PAR_LOSS_RTOL, PAR_GNORM_RTOL
GNORM_RTOL = 1e-2
MOMENT_RTOL = 1e-2
JAX_CURVE_TOL = 1e-2   # tests/test_torch_cli_train.py's port-vs-JAX CLI curves
JAX_GNORM_RTOL = 2e-2  # tests/test_torch_parallel_zoo.py's port-vs-JAX norms
HF_CARD = dict(vocab_size=300, n_layer=4, n_embd=64, n_head=4, n_kv_head=2,
               head_dim=16, n_ffn=128, n_ctx=64, max_pos=256)
TRANSFORMER = {"Ctx": 32, "Embed": 64, "Ffn": 128, "Head": 4, "KVHead": 2,
               "head_dim": 16}
PP_CARD = dict(vocab_size=256, n_layer=4, n_embd=64, n_head=4, n_kv_head=2,
               head_dim=16, n_ffn=128, n_ctx=16, max_pos=32,
               tie_embeddings=False)
PP_TCARD = dict(batch=8, lr=1e-2, warmup=0, stochastic_round=True,
                grad_clip=1e9)


def abs_gap(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def rel_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.abs(want)).max())


def moment_gap(got, want) -> float:
    """‖Δm‖ / ‖m‖ over the whole tree of first moments."""
    d = sum(float(np.sum((np.asarray(a, np.float64) - b) ** 2))
            for a, b in zip(got, want))
    n = sum(float(np.sum(np.asarray(b, np.float64) ** 2)) for b in want)
    return (d / n) ** 0.5


def gate(label, gap, tol, control=None):
    """Print the gap beside its gate; a control's gap must exceed it."""
    print(f"{label}: gap {gap:.3e} (gate {tol:g})"
          + ("" if control is None else f", control {control:.3e}"))
    assert gap <= tol, (label, gap, tol)
    if control is not None:
        assert control > tol, (label, "control not refused", control)


# ---------------------------------------------------------------------------
# CLI inputs shared with tests/test_torch_slice20_tp.py and _lars.py
# ---------------------------------------------------------------------------

def hf_dir(tmp_path, **card):
    d = tmp_path / "hf"
    d.mkdir(exist_ok=True)
    make_hf_qwen3_dir(d, JModelCard.from_arch("QWEN3", **dict(HF_CARD,
                                                              **card)))
    return str(d)


def shard_glob(tmp_path):
    write_shard(str(tmp_path / "p_train_0.bin"),
                (np.arange(30000) % 64).astype(np.uint32), MAGIC_QWEN3, 300)
    return str(tmp_path / "p_train_*.bin")


def config(tmp_path, name, steps=3, lr=0.01, **over):
    """A QWEN3 config over a pattern shard (the weights come from ``--hf``),
    SR off, a log line a step."""
    cfg = {"model": {"arch": "QWEN3", "vocab_size": 300,
                     "parameter": {"Layer": HF_CARD["n_layer"],
                                   "transformer": TRANSFORMER}},
           "train": {"batch": 8, "learning-rate": lr, "dump-every": 1,
                     "warmup": 0,
                     "optimizatioin": {"method": "adamw",
                                       "stochastic_round": False}},
           "datasets": {"train": {"glob": shard_glob(tmp_path),
                                  "name": "pattern"}},
           "debug": {"most_iter": steps}, "seed": 42}
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            cfg[k] = dict(cfg[k], **v)
        else:
            cfg[k] = v
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def jax_cli(capsys, tmp_path, argv, tag):
    """The JAX CLI's (losses, grad norms) from its log lines."""
    d = tmp_path / f"jax_{tag}"
    d.mkdir()
    capsys.readouterr()
    assert jkoifish.main(list(argv) + ["--out-dir", str(d)]) == 0
    out = capsys.readouterr().out
    rows = re.findall(r"^\[(\d+)\] loss=([\d.]+)(?: lr=\S+ gnorm=([\d.]+))?",
                      out, re.M)
    return ([float(r[1]) for r in rows],
            [float(r[2]) for r in rows if r[2]])


def port_cli(argv, tag, tmp_path, fault=None):
    """The port's one-rank CLI: (losses, grad norms, first moments)."""
    with torch_threads(1):
        losses, gnorms, r = ds._cli(argv, str(tmp_path / f"port_{tag}"),
                                    fault)
    return losses, gnorms, ds._moments(r)


def run_ranks(tmp_path, jobs, world=2):
    """``jobs`` on one spawned group of ``world`` ranks: every rank's
    results, rank 0 first."""
    path = str(tmp_path / "inp.pt")
    torch.save({"world": world, "jobs": jobs}, path)
    out = tmp_path / "out"
    out.mkdir()
    spawn(ds.slice20_worker, world, (path, str(out)), device="cpu",
          threads=1, init_dir=str(tmp_path))
    return dh.load_results(str(out), world)


def _pp_run(**tcard):
    rng = np.random.default_rng(20)
    jcard = JModelCard.from_arch("QWEN3", **PP_CARD)
    return dict(arch="QWEN3", card=PP_CARD, tcard=dict(PP_TCARD, **tcard),
                init=jax_tree_to_numpy(j_init_params(
                    jcard, jax.random.PRNGKey(3))),
                batches=[rng.integers(0, 256, (8, 17)) for _ in range(2)])


def _lora_cfg(tmp_path, hf, lr=0.01):
    jp = str(tmp_path / "chat.jsonl")
    with open(jp, "w") as f:
        for i in range(32):
            f.write(json.dumps({"messages": [
                {"role": "user", "content": f"hello {i}"},
                {"role": "assistant", "content": "hello hello hello"}]})
                + "\n")
    cfg = {"sft": {"hf-card": hf, "method": "lora"},
           "model": {"arch": "QWEN3"},
           "train": {"batch": 4, "learning-rate": lr, "warmup": 0,
                     "dump-every": 1, "epoch": 1,
                     "optimizatioin": {"stochastic_round": False}},
           "datasets": {"train": {"glob": jp, "type": "OAI_message"}},
           "debug": {"most_iter": 3}, "seed": 42}
    path = str(tmp_path / f"sft_{lr}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _gama_quantizer():
    return {"self_attn": {"bits": 4}, "mlp": {"bits": 4}, "group_size": 32,
            "train_target": "gama"}


def test_slice20_pp_and_fsdp_gama(tmp_path, capsys, monkeypatch):
    """One 2-rank group runs F1, C4 under ``--pp 2``, LoRA under ``--pp
    2``, the F2 refusal through the CLI, and C2; each is held to its
    one-rank or JAX reference beside its control."""
    hf = hf_dir(tmp_path)
    sr, lars = _pp_run(), _pp_run(stochastic_round=False, lars_ratio=50.0)
    gama = config(tmp_path, "gama", lr=2e-3, quantizer=_gama_quantizer())
    gama0 = config(tmp_path, "gama0", lr=0.0, quantizer=_gama_quantizer())
    sft = _lora_cfg(tmp_path, hf)
    sft0 = _lora_cfg(tmp_path, hf, lr=0.0)

    # the JAX side: the LoRA pipeline (adapters captured for the port),
    # the gama FSDP run on 2 virtual devices
    seen = {}
    j_add = jlora.add_lora

    def jax_add_lora(*a, **k):
        out = j_add(*a, **k)
        seen["lora"] = jax_tree_to_numpy(out)
        return out
    monkeypatch.setattr(jlora, "add_lora", jax_add_lora)
    j_lora = jax_cli(capsys, tmp_path, [sft, "--pp", "2"], "lora")
    lora = seen["lora"]
    j_gama = jax_cli(capsys, tmp_path, [gama, "--hf", hf, "--dp", "2",
                                        "--fsdp"], "gama")

    jobs = {
        "sr": dict(sr, kind="pp_step"),
        "sr_local": dict(sr, kind="pp_step", fault="pp_stage_index"),
        "lars": dict(lars, kind="pp_step"),
        "lars_whole": dict(lars, kind="pp_step", fault="lars_whole_stack"),
        "lora_pp": dict(kind="cli", argv=[sft, "--pp", "2"], lora=lora),
        "lora_pp0": dict(kind="cli", argv=[sft0, "--pp", "2"], lora=lora),
        "lora_dp": dict(kind="cli_raises", argv=[sft, "--dp", "2"],
                        lora=lora),
        "gama": dict(kind="cli", argv=[gama, "--hf", hf, "--dp", "2",
                                       "--fsdp"]),
    }
    r0, r1 = run_ranks(tmp_path, jobs)
    for name in jobs:
        if name != "lora_dp":
            assert r0[name][:2] == r1[name][:2], name   # one curve a group

    # F1: with SR on, every param after two rounded updates and the step-1
    # loss are the one-rank pipeline's bit for bit (grad_clip off, so the
    # clip scale is 1 exactly); the grad norm sums the stages' squares in
    # another order (measured 6.1e-7 relative, gate 1e-5). The stage-local
    # index moves the rounding.
    one = ds._pp_step(ProcessMesh({"pp": 1}, "cpu"), sr)
    print("F1 pp-2 vs one rank: step-1 loss", r0["sr"][0][1], one[0][1],
          "grad norm", r0["sr"][1][1], one[1][1])
    assert r0["sr"][0] == one[0]
    assert all(np.array_equal(a, b) for a, b in zip(r0["sr"][3], one[3]))
    gate("F1 pp-2 SR grad norms", rel_gap(r0["sr"][1], one[1]), 1e-5)
    moved = sum(int((a != b).sum()) for a, b in zip(r0["sr_local"][3],
                                                     one[3]))
    print("F1 stage-local index (planted): params differing", moved)
    assert moved > 0 and r0["sr_local"][0][1] != one[0][1]

    # C4 under pp: each layer's norms, against the one-rank pipeline
    one = ds._pp_step(ProcessMesh({"pp": 1}, "cpu"), lars)
    gate("C4 pp-2 LARS losses", rel_gap(r0["lars"][0], one[0]), LOSS_RTOL)
    gate("C4 pp-2 LARS grad norms", rel_gap(r0["lars"][1], one[1]),
         GNORM_RTOL)
    gate("C4 pp-2 LARS first moments", moment_gap(r0["lars"][2], one[2]),
         MOMENT_RTOL, moment_gap(r0["lars_whole"][2], one[2]))

    # F2: under --pp the JAX pipeline loop trains LoRA (every leaf, every
    # token); on a dp mesh its shard_params raises, the port refuses
    gate("LoRA pp-2 losses vs the JAX pipeline CLI",
         abs_gap(r0["lora_pp"][0], j_lora[0]), JAX_CURVE_TOL,
         abs_gap(r0["lora_pp0"][0], j_lora[0]))
    for r in (r0, r1):
        assert r["lora_dp"] and "LoRA adapters on a process mesh" in \
            r["lora_dp"] and "AttributeError" in r["lora_dp"]

    # C2: FSDP over gama, against one rank and the JAX CLI
    one = port_cli([gama, "--hf", hf], "gama", tmp_path)
    ctl = port_cli([gama0, "--hf", hf], "gama0", tmp_path)
    gate("C2 gama --dp 2 --fsdp losses vs one rank",
         rel_gap(r0["gama"][0], one[0]), LOSS_RTOL, rel_gap(ctl[0], one[0]))
    gate("C2 gama grad norms vs one rank", rel_gap(r0["gama"][1], one[1]),
         GNORM_RTOL)
    gate("C2 gama losses vs the JAX --dp 2 --fsdp CLI",
         abs_gap(r0["gama"][0], j_gama[0]), JAX_CURVE_TOL,
         abs_gap(ctl[0], j_gama[0]))
    gate("C2 gama grad norms vs the JAX CLI",
         rel_gap(r0["gama"][1], j_gama[1]), JAX_GNORM_RTOL)


def _with_lora(params):
    out = copy.copy(params)
    out["layers"] = [dict(lp, q_lora={"a": np.zeros((64, 4), np.float32),
                                      "b": np.zeros((4, 64), np.float32)})
                     for lp in params["layers"]]
    return out


@pytest.mark.parametrize("case", ["lora_dp", "lora_tp", "lora_sp",
                                  "llama_vae_dp"])
def test_mesh_refusals_mirror_jax_failures(case):
    """On every mesh the JAX CLI shards (dp·tp·sp > 1), its
    ``shard_params`` raises AttributeError on LoRA's adapter dicts and on
    LLAMA_VAE's ``evae`` params; the port's ``shard_train_state`` refuses
    the same trees with NotImplementedError, naming that failure."""
    from koifish_tpu_torch.models import init_params
    axes = {"lora_dp": {"dp": 2, "tp": 1}, "lora_tp": {"dp": 1, "tp": 2},
            "lora_sp": {"dp": 1, "tp": 1, "sp": 2},
            "llama_vae_dp": {"dp": 2, "tp": 1}}[case]
    if case == "llama_vae_dp":
        kw = dict(PP_CARD, token_embeds=(24,))
        jp = j_init_params(JModelCard.from_arch("LLAMA_VAE", **kw),
                           jax.random.PRNGKey(0))
        params = init_params(ModelCard.from_arch("LLAMA_VAE", **kw),
                             device="cpu")
        what = "LLAMA_VAE"
    else:
        jcard = JModelCard.from_arch("QWEN3", **PP_CARD)
        jp = _with_lora(j_init_params(jcard, jax.random.PRNGKey(0)))
        params = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
        what = "LoRA adapters"
    with pytest.raises(AttributeError, match="'dict' object has no "
                       "attribute 'shape'"):
        j_shard_params(jp, j_make_mesh(axes))
    n = int(np.prod(list(axes.values())))
    with pytest.raises(NotImplementedError, match=f"{what} on a process "
                       f"mesh of {n} ranks.*AttributeError"):
        tsh.check_mesh_params(params, n)
    tsh.check_mesh_params(params, 1)       # one rank: nothing is sharded
