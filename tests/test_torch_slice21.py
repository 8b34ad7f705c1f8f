"""Slice 21 of the port: two repairs, each held against the one-rank step
or the JAX package.

- F1: under ``--pp`` LARS takes one trust ratio per layer of a stacked
  stage leaf (its norms over dims 1..) and none on a stacked norm or bias,
  as the one-rank step takes one per layer matrix. The ratios equal the
  unstacked step's within 1e-6 relative; two ``--pp 2`` steps on gloo
  ranks match two unstacked one-rank steps (losses 1e-3 relative, grad
  norms 1e-2, each layer's first moment 1e-3 relative: AdamW's update
  m/√v nearly cancels a ratio, its first moment carries it), and the
  parent's whole-stack ratio, planted, fails the moment gate.
- F2: the zoo through ``bubble``, on one rank and under ``--tp 2``. The
  JAX package's ``bubble`` loads a card only through its Llama and GPT2
  tensor mappings: an MLA or MAMBA HF folder, and a ``.kun`` of GUPPY or
  of the GAU/BROWN hybrids, fail there at load; the port refuses each at
  load, naming the JAX error. SALMON's and LLAMA_VAE's ``.kun`` load (the
  loader drops LLAMA_VAE's ``evae`` stack, so it serves as a plain
  decoder) and serve in both packages; the port's greedy tokens equal the
  JAX package's, on one rank and under ``--tp 2`` (gloo ranks).
"""
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from koifish_tpu.cli import bubble as jbubble
from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.io.kun import write_kun as j_write_kun
from koifish_tpu.io.safetensors import write_safetensors as j_write_st
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu import serve as jserve

from koifish_tpu_torch.cli import bubble
from koifish_tpu_torch.config import ModelCard, TrainCard
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.parallel import pipeline as tpipeline
from koifish_tpu_torch.parallel.multihost import spawn
from koifish_tpu_torch.train import init_train_state, make_train_step
from koifish_tpu_torch.train import optimizer as topt
from koifish_tpu_torch.train import trainer as ttrainer
from koifish_tpu_torch.train.trainer import compute_loss
from koifish_tpu_torch.utils.tree import (flatten_with_path, leaves,
                                          unflatten_like)

import torch_dist_helpers as dh
import torch_dist_slice21 as d21
from helpers import byte_level_tokenizer_json
from torch_helpers import jax_tree_to_numpy, torch_threads

# ---------------------------------------------------------------------------
# F1: the pipeline's LARS, one ratio a layer
# ---------------------------------------------------------------------------

PP_CARD = dict(vocab_size=256, n_layer=2, n_embd=64, n_head=4, n_kv_head=2,
               head_dim=16, n_ffn=128, n_ctx=16, max_pos=32,
               tie_embeddings=False)
LARS = 0.5
# SR off, no weight decay (the pipeline decays its stacked norms: a
# mirrored quirk of the JAX package, not this repair), no clipping (the
# clip reads the global norm, whose f32 sum order differs)
PP_TCARD = dict(batch=8, lr=1e-2, warmup=0, stochastic_round=False,
                weight_decay=0.0, lars_ratio=LARS, grad_clip=1e9)
N_MICRO = 4
# the ratio test's cap: above every ||w|| / ||g|| of the tiny card (at 0.5
# every matrix's ratio is the cap, the same per layer as per stack)
RATIO_LARS = 1e4
RATIO_RTOL = 1e-6
LOSS_RTOL = 1e-3      # chip_smoke.py's PAR_LOSS_RTOL, PAR_GNORM_RTOL
GNORM_RTOL = 1e-2
# slice 20's C4 moment gate, here per leaf and layer (the one-rank step's
# gradients cast to the params' dtype, as the pipeline hands them to the
# optimizer); the whole-stack ratio moves the norms' moments by ~0.5
MOMENT_RTOL = 1e-3


class StageMesh:
    """Stage ``p`` of a ``pp`` axis of ``P`` in one process: what
    ``pipeline._pp_layout`` reads of a mesh. No group: a stacked leaf's
    layers lie whole on their stage, so its ratios need no collective."""

    world_group = None

    def __init__(self, P: int, p: int):
        self.shape, self.coords = {"pp": P}, {"pp": p}

    def size(self, axis):
        return self.shape.get(axis, 1)

    def index(self, axis):
        return self.coords.get(axis, 0)

    def group(self, axis):
        return None


def _init():
    jcard = JModelCard.from_arch("QWEN3", **PP_CARD)
    return jax_tree_to_numpy(j_init_params(jcard, jax.random.PRNGKey(21)))


def _batches(n=2):
    rng = np.random.default_rng(21)
    return [rng.integers(0, 256, (8, 17)) for _ in range(n)]


def _ratios(monkeypatch, params, grads, dist=None):
    """{leaf index: ratio} of the LARS ratios ``apply_updates`` takes on
    ``grads`` (lr 0, on copies)."""
    got = {}
    real = topt._lars_ratios

    def rec(*a):
        out = real(*a)
        got.update(out)
        return out
    monkeypatch.setattr(topt, "_lars_ratios", rec)
    params = unflatten_like(params, [x.detach().clone()
                                     for x in leaves(params)])
    opt = topt.init_opt_state(params, "adamw")
    topt.apply_updates(params, grads, opt, optimizer="adamw", lr=0.0,
                       weight_decay=0.0, grad_clip=1e9, lars_ratio=RATIO_LARS,
                       dist=dist)
    monkeypatch.setattr(topt, "_lars_ratios", real)
    return got


def test_pipeline_lars_takes_one_ratio_a_layer(monkeypatch):
    """The ratios ``apply_updates`` takes over the ``--pp 2`` stages and
    over the one-rank pipeline equal the one-rank unstacked step's, layer
    by layer, within 1e-6 relative; no ratio is taken on a norm or bias.
    (The parent took one ratio over each whole [L, ...] stack, 0.00200 for
    both layers' q where one rank takes 0.00251 and 0.00104, and one on
    the stacked ln1.)"""
    card = ModelCard.from_arch("QWEN3", **PP_CARD)
    params = params_from_numpy(_init(), device="cpu")
    flat = leaves(params)
    for x in flat:
        x.requires_grad_(x.is_floating_point())
    tokens = torch.from_numpy(_batches(1)[0]).long()
    with torch_threads(1):
        loss, _ = compute_loss(card, params, tokens)
        grads = unflatten_like(params, list(torch.autograd.grad(loss,
                                                                flat)))
        one = {d21.path_key(flatten_with_path(params)[i][0]): float(r)
               for i, r in _ratios(monkeypatch, params, grads).items()}
    print("one rank:", {k: round(v, 6) for k, v in one.items()})
    assert not [k for k in one if k.split("/")[-1] in ("ln1", "ln2", "qn",
                                                        "kn")]
    for P in (1, 2):
        per = PP_CARD["n_layer"] // P
        for p in range(P):
            sl, ot = tpipeline.stack_for_pipeline(params, P, stage=p)
            gsl, gother = tpipeline.stack_for_pipeline(grads, P, stage=p)
            lay = tpipeline._pp_layout(StageMesh(P, p), sl, ot)
            tree = {"stages": sl, "other": ot}
            paths = [p_ for p_, _ in flatten_with_path(tree)]
            with torch_threads(1):
                rs = _ratios(monkeypatch, tree, {"stages": gsl,
                                                 "other": gother}, lay)
            seen = {}
            for i, r in rs.items():
                path = paths[i]
                if path[0] == "other":
                    seen[d21.path_key(path[1:])] = float(r)
                    continue
                r = r.reshape(-1)
                assert r.numel() == per, (P, path, tuple(r.shape))
                for j in range(per):
                    seen[f"layers/{p * per + j}/{path[1]}"] = float(r[j])
            want = {k: v for k, v in one.items()
                    if not k.startswith("layers/")
                    or int(k.split("/")[1]) // per == p}
            print(f"pp {P} stage {p}:", {k: round(v, 6)
                                         for k, v in seen.items()})
            assert set(seen) == set(want), (P, p, sorted(set(seen)
                                                         ^ set(want)))
            for k, v in want.items():
                assert abs(seen[k] - v) <= RATIO_RTOL * abs(v), (P, p, k,
                                                                 seen[k], v)


def _one_rank_steps(run, monkeypatch):
    """The unstacked one-rank train step on ``run``'s batches, each split
    into N_MICRO accumulated micro-batches as the pipeline splits it, its
    averaged f32 gradients cast to the params' dtype before the update as
    the pipeline casts them (``pipeline._finish``): (losses, grad norms,
    {path: first moment})."""
    real = ttrainer.apply_updates

    def cast(params, grads, *a, **kw):
        grads = unflatten_like(grads, [
            g.to(p.dtype) if g.shape == p.shape else g
            for g, p in zip(leaves(grads), leaves(params))])
        return real(params, grads, *a, **kw)
    monkeypatch.setattr(ttrainer, "apply_updates", cast)
    card = ModelCard.from_arch(run["arch"], **run["card"])
    tcard = TrainCard(**run["tcard"])
    state = init_train_state(card, tcard, params=params_from_numpy(
        run["init"], device="cpu"), device="cpu")
    step = make_train_step(card, tcard, total_steps=10)
    losses, gnorms = [], []
    for b in run["batches"]:
        toks = torch.from_numpy(b).long().reshape(N_MICRO, -1, b.shape[1])
        state, m = step(state, {"tokens": toks})
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    monkeypatch.setattr(ttrainer, "apply_updates", real)
    return losses, gnorms, {d21.path_key(p): x.detach().float().numpy()
                            for p, x in flatten_with_path(state.opt.m)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.abs(want)).max())


def moment_gap(pp_m, one_m) -> float:
    """The largest ‖Δm‖/‖m‖ over every leaf of the one-rank step, a
    stacked leaf's layer l read at [l] of its whole [L, ...] moment."""
    worst = 0.0
    for key, want in one_m.items():
        parts = key.split("/")
        got = (pp_m["stages/" + parts[2]][int(parts[1])]
               if parts[0] == "layers" else pp_m["other/" + key])
        want = np.asarray(want, np.float64)
        d = np.linalg.norm(np.asarray(got, np.float64) - want)
        worst = max(worst, d / max(np.linalg.norm(want), 1e-30))
    return float(worst)


# ---------------------------------------------------------------------------
# F2: the zoo through bubble
# ---------------------------------------------------------------------------

VOCAB = 300          # the byte-level tokenizer's 264 ids fit
TR = {"Ctx": 32, "Embed": 64, "Head": 4, "KVHead": 4, "head_dim": 16,
      "Ffn": 128}
ZOO = ("mla", "mamba", "guppy", "salmon", "llama_vae", "gau_brown_qwen3",
       "gau_brown_gpt2")
SERVED = ("salmon", "llama_vae")
NEW = 6
_LL = {"ln1": "input_layernorm.weight",
       "ln2": "post_attention_layernorm.weight",
       "qn": "self_attn.q_norm.weight", "kn": "self_attn.k_norm.weight",
       "q_b": "self_attn.q_proj.bias", "k_b": "self_attn.k_proj.bias",
       "v_b": "self_attn.v_proj.bias"}
_LL_T = {"q": "self_attn.q_proj.weight", "k": "self_attn.k_proj.weight",
         "v": "self_attn.v_proj.weight", "o": "self_attn.o_proj.weight",
         "gate": "mlp.gate_proj.weight", "up": "mlp.up_proj.weight",
         "down": "mlp.down_proj.weight"}
_GPT2 = {"ln1": "ln_1.weight", "ln1_b": "ln_1.bias", "ln2": "ln_2.weight",
         "ln2_b": "ln_2.bias", "o": "attn.c_proj.weight",
         "o_b": "attn.c_proj.bias", "fc": "mlp.c_fc.weight",
         "fc_b": "mlp.c_fc.bias", "proj": "mlp.c_proj.weight",
         "proj_b": "mlp.c_proj.bias"}


def _model_json(name):
    """The reference-style ``model`` section of a zoo card (2 layers; the
    hybrids 3: a QKV layer, a GAU layer, a BROWN FFN layer)."""
    if name.startswith("gau_brown"):
        arch, kv = ("QWEN3", 2) if name.endswith("qwen3") else ("GPT2", 4)
        return {"arch": arch, "vocab_size": VOCAB,
                "parameter": {"Layer": 3, "max_pos_embeddings": 256,
                              "transformer": dict(TR, KVHead=kv)},
                "backbone": {
                    "embed_tokens": {"Embedding": []},
                    "a *1": {"self_attn": {"QKV": []}, "mlp": {"FFN": []}},
                    "g *1": {"GAU": []},
                    "b *1": {"self_attn": {"BROWN": []},
                             "mlp": {"FFN": []}},
                    "norm": {"Normal": []}, "output": {"CLASIFY": []}}}
    par = {"Layer": 2, "max_pos_embeddings": 256, "transformer": dict(TR)}
    if name == "llama_vae":
        par["token_embeds"] = [24]
    return {"arch": name.upper(), "vocab_size": VOCAB, "parameter": par}


def _bf16(a):
    return np.asarray(a).astype(ml_dtypes.bfloat16)


def _kun_tensors(p, arch):
    """A param tree under the names a ``.kun`` carries: the Llama (or
    GPT2) names where the layer has them, the zoo's own leaves under
    their tree paths."""
    out = {}
    if arch == "GPT2":
        out.update({"wte.weight": p["wte"], "wpe.weight": p["wpe"],
                    "ln_f.weight": p["ln_f"], "ln_f.bias": p["ln_f_b"]})
        for i, lp in enumerate(p["layers"]):
            pre = f"h.{i}."
            if "q" in lp:
                out[pre + "attn.c_attn.weight"] = np.concatenate(
                    [lp["q"], lp["k"], lp["v"]], 1)
                out[pre + "attn.c_attn.bias"] = np.concatenate(
                    [lp["q_b"], lp["k_b"], lp["v_b"]])
            for k, w in lp.items():
                if k not in ("q", "k", "v", "q_b", "k_b", "v_b"):
                    out[pre + _GPT2.get(k, k)] = w
        return {k: _bf16(v) for k, v in out.items()}
    out.update({"model.embed_tokens.weight": p["wte"],
                "model.norm.weight": p["ln_f"]})
    if "head" in p:
        out["lm_head.weight"] = p["head"].T
    for i, lp in enumerate(p["layers"]):
        for k, w in lp.items():
            name = _LL.get(k) or _LL_T.get(k) or k
            out[f"model.layers.{i}.{name}"] = w.T if k in _LL_T else w

    def flat(pre, t):
        for k, v in (enumerate(t) if isinstance(t, list) else t.items()):
            if isinstance(v, (list, dict)):
                flat(f"{pre}{k}.", v)
            else:
                out[f"{pre}{k}"] = v
    if "evae" in p:
        flat("evae.", p["evae"])
    return {k: _bf16(v) for k, v in out.items()}


def _hf_folder(d, name):
    """An HF folder as the model's own checkpoint names it: DeepSeek-V2's
    MLA (``q_proj``, ``kv_a_proj_with_mqa``, ``kv_a_layernorm``,
    ``kv_b_proj``) or Mamba's (``backbone.*``), seeded."""
    rng = np.random.default_rng(21)
    E = 64

    def w(*shape):
        return _bf16(rng.standard_normal(shape, dtype=np.float32) * 0.05)
    one = _bf16(np.ones(E))
    if name == "mla":
        H, cfg = 4, {"model_type": "deepseek_v2", "num_attention_heads": 4,
                     "num_key_value_heads": 4, "intermediate_size": 128,
                     "q_lora_rank": None, "kv_lora_rank": 32,
                     "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                     "v_head_dim": 16, "tie_word_embeddings": False,
                     "n_routed_experts": 4, "moe_intermediate_size": 32}
        t = {"model.embed_tokens.weight": w(VOCAB, E),
             "model.norm.weight": one, "lm_head.weight": w(VOCAB, E)}
        for i in range(2):
            pre = f"model.layers.{i}."
            t.update({
                pre + "input_layernorm.weight": one,
                pre + "post_attention_layernorm.weight": one,
                pre + "self_attn.q_proj.weight": w(H * 24, E),
                pre + "self_attn.kv_a_proj_with_mqa.weight": w(40, E),
                pre + "self_attn.kv_a_layernorm.weight": _bf16(np.ones(32)),
                pre + "self_attn.kv_b_proj.weight": w(H * 32, 32),
                pre + "self_attn.o_proj.weight": w(E, H * 16),
                pre + "mlp.gate_proj.weight": w(128, E),
                pre + "mlp.up_proj.weight": w(128, E),
                pre + "mlp.down_proj.weight": w(E, 128)})
    else:
        Ei, N, R = 128, 16, 4
        cfg = {"model_type": "mamba", "state_size": N, "expand": 2,
               "conv_kernel": 4, "time_step_rank": R,
               "intermediate_size": Ei, "tie_word_embeddings": True}
        t = {"backbone.embeddings.weight": w(VOCAB, E),
             "backbone.norm_f.weight": one}
        for i in range(2):
            pre = f"backbone.layers.{i}."
            t.update({
                pre + "norm.weight": one,
                pre + "mixer.in_proj.weight": w(2 * Ei, E),
                pre + "mixer.conv1d.weight": w(Ei, 1, 4),
                pre + "mixer.conv1d.bias": w(Ei),
                pre + "mixer.x_proj.weight": w(R + 2 * N, Ei),
                pre + "mixer.dt_proj.weight": w(Ei, R),
                pre + "mixer.dt_proj.bias": w(Ei),
                pre + "mixer.A_log": w(Ei, N), pre + "mixer.D": w(Ei),
                pre + "mixer.out_proj.weight": w(E, Ei)})
    j_write_st(os.path.join(d, "model.safetensors"), t)
    cfg.update({"vocab_size": VOCAB, "num_hidden_layers": 2,
                "hidden_size": E, "max_position_embeddings": 256})
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    return d


def zoo_input(d, name) -> str:
    """The card ``name`` as a user hands it to ``bubble``: an HF folder
    where ``ModelCard.from_hf`` parses its config (MLA, MAMBA), else a
    ``.kun`` written with the JAX package's ``write_kun`` under the card's
    config, its weights the JAX init's; a tokenizer.json beside it."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(byte_level_tokenizer_json(), f)
    if name in ("mla", "mamba"):
        return _hf_folder(d, name)
    mj = _model_json(name)
    jcard = JModelCard.from_json(mj)
    p = jax_tree_to_numpy(j_init_params(jcard, jax.random.PRNGKey(21)))
    path = os.path.join(d, "model.kun")
    j_write_kun(path, {"model": mj}, _kun_tensors(p, jcard.arch))
    return path


def _argv(path, tp):
    return (["--hf", path, "--prompts", "hello", "--max-new", str(NEW),
             "--temperature", "0", "--ctx", "64", "--device", "cpu",
             "--csv", ""] + (["--tp", str(tp)] if tp > 1 else []))


def _jax_bubble(monkeypatch, path, tp):
    """The JAX ``bubble``'s greedy tokens (its ``generate``, imported in
    ``main`` from ``koifish_tpu.serve``, wrapped), or its exception."""
    got = []
    real = jserve.generate

    def spy(*a, **kw):
        toks, cache = real(*a, **kw)
        got.append(np.asarray(toks)[0].tolist())
        return toks, cache
    monkeypatch.setattr(jserve, "generate", spy)
    try:
        jbubble.main(_argv(path, tp))
    except Exception as e:     # the JAX package's own failure, shown
        return type(e).__name__, str(e)
    finally:
        monkeypatch.setattr(jserve, "generate", real)
    return got


# ---------------------------------------------------------------------------
# one spawn of 2 gloo ranks for F1's pipeline steps and F2's --tp 2 serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice21")
    run = dict(arch="QWEN3", card=PP_CARD, tcard=PP_TCARD, init=_init(),
               batches=_batches(), n_micro=N_MICRO)
    jobs = {"lars": dict(run, kind="pp_lars"),
            "lars_lr0": dict(run, kind="pp_lars",
                             tcard=dict(PP_TCARD, lr=0.0)),
            "lars_whole": dict(run, kind="pp_lars",
                               fault="lars_whole_stack")}
    paths = {}
    for name in ZOO:
        paths[name] = zoo_input(str(root / name), name)
        jobs[f"{name}_tp2"] = dict(kind="bubble",
                                   argv=_argv(paths[name], 2))
    inp = str(root / "inp.pt")
    torch.save({"world": 2, "jobs": jobs}, inp)
    out = root / "out"
    out.mkdir()
    spawn(d21.slice21_worker, 2, (inp, str(out)), device="cpu", threads=1,
          init_dir=str(root))
    return run, paths, dh.load_results(str(out), 2)


def test_pp2_lars_steps_match_the_unstacked_step(ranks, monkeypatch):
    """Two ``--pp 2`` steps (1F1B, 4 micro-batches, lars_ratio 0.5, SR off,
    no weight decay, an untied head) against two unstacked one-rank steps
    over the same 4 accumulated micro-batches: losses within 1e-3
    relative, grad norms within 1e-2, every layer's first moment within
    1e-3 relative in norm (the one-rank gradients cast to the params'
    dtype, as the pipeline's). The same run at learning rate 0 fails the loss
    gate, and the parent's whole-stack ratio, planted, the moment gate
    (the losses cannot see it: AdamW's m/√v cancels a ratio but for
    eps)."""
    run, _, (r0, r1) = ranks
    assert r0["lars"][:2] == r1["lars"][:2]
    with torch_threads(1):
        one = _one_rank_steps(run, monkeypatch)
    gaps = (_rel(r0["lars"][0], one[0]), _rel(r0["lars"][1], one[1]),
            moment_gap(r0["lars"][2], one[2]))
    ctl = moment_gap(r0["lars_whole"][2], one[2])
    lr0 = _rel(r0["lars_lr0"][0], one[0])
    print(f"pp-2 vs the unstacked step: losses {gaps[0]:.3e} (gate "
          f"{LOSS_RTOL:g}; learning rate 0: {lr0:.3e}), grad norms "
          f"{gaps[1]:.3e} ({GNORM_RTOL:g}), first moments {gaps[2]:.3e} "
          f"({MOMENT_RTOL:g}; the whole-stack ratio, planted: {ctl:.3e})")
    assert gaps[0] <= LOSS_RTOL < lr0 and gaps[1] <= GNORM_RTOL
    assert gaps[2] <= MOMENT_RTOL < ctl


@pytest.mark.parametrize("tp", [1, 2], ids=["one_rank", "tp2"])
@pytest.mark.parametrize("name", ZOO)
def test_bubble_zoo_mirrors_jax(name, tp, monkeypatch, ranks):
    """The JAX ``bubble`` on the card's input (on its 8 virtual CPU
    devices for ``--tp 2``), then the port's (``--tp 2`` on 2 gloo ranks).
    Where the JAX package fails at load (a KeyError or TypeError of its
    Llama/GPT2 mapping), the port raises NotImplementedError at load,
    naming that error; where it serves (SALMON, LLAMA_VAE), the port's
    greedy tokens equal its."""
    _, paths, (r0, r1) = ranks
    want = _jax_bubble(monkeypatch, paths[name], tp)
    print(f"JAX bubble {name} tp {tp}: {want}")
    if tp == 1:
        turns = []
        try:
            with torch_threads(1):
                bubble.main(_argv(paths[name], tp), turns=turns)
            got = [t["tokens"] for t in turns]
        except NotImplementedError as e:
            got = ("raised", str(e))
    else:
        assert r0[f"{name}_tp2"] == r1[f"{name}_tp2"]
        got = r0[f"{name}_tp2"]
        if got[0] != "raised":
            got = [toks for _, toks in got]
    print(f"port bubble {name} tp {tp}: {got}")
    if name not in SERVED:
        err, msg = want
        assert err in ("KeyError", "TypeError"), want
        assert got[0] == "raised", got
        assert err in got[1] and "the port refuses it" in got[1]
        if err == "KeyError":
            assert msg in got[1]
        return
    assert len(want) == 1 and len(want[0]) == NEW, want
    assert got == want
