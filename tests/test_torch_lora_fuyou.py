"""The port's LoRA adapters, SFT trainable masks and Fuyou swarm against the
JAX package's, on the CPU at tiny sizes.

Masks are equal trees; merged weights agree within one bf16 ulp (the f32
a·b product sums in another order); an 8-step LoRA SFT loss curve from the
same adapters (JAX's, carried over with numpy), SR off, stays within 1e-2
of JAX's, the existing ``test_loss_curve_matches_jax`` tolerance (measured
<= 2.2e-3 there, 3.1e-3 here), with the base weights bit for bit unchanged; the PSO and
GA steps given JAX's draws agree within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import SFTCard as JSFTCard
from koifish_tpu.config import TrainCard as JTrainCard
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.train import fuyou as jfuyou
from koifish_tpu.train import lora as jlora
from koifish_tpu.train import trainer as jtrainer

from koifish_tpu_torch.config import ModelCard, SFTCard, TrainCard
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.models import init_params, model_forward
from koifish_tpu_torch.train import fuyou as tfuyou
from koifish_tpu_torch.train import lora as tlora
from koifish_tpu_torch.train import trainer as ttrainer
from koifish_tpu_torch.utils.tree import leaves

from torch_helpers import f32, jax_tree_to_numpy, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


TINY = dict(vocab_size=256, n_layer=2, n_embd=128, n_head=2, n_kv_head=1,
            head_dim=64, n_ffn=256, n_ctx=32, max_pos=64)
METHODS = ("full", "lora", "bitfit", "onlyattention", "only_head", "gama")


def _jax_lora_params(targets=("wq", "wk", "wv", "wo"), rank=8):
    jcard = JModelCard.from_arch("QWEN3", **TINY)
    sft = JSFTCard(method="lora", lora_rank=rank, lora_targets=targets)
    return jcard, jlora.add_lora(j_init_params(jcard, jax.random.PRNGKey(0)),
                                 sft, jax.random.PRNGKey(1))


def _jax_leaf_flags(jmask):
    return [bool(x) for x in jax.tree_util.tree_leaves(jmask)]


@pytest.mark.parametrize("method", METHODS)
def test_trainable_mask_matches_jax(method):
    """The same tree of flags for every method, adapters included."""
    _, jp = _jax_lora_params(("wq", "wv", "wup"))
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    jm = jlora.trainable_mask(jp, method)
    tm = tlora.trainable_mask(tp, method)
    assert leaves(tm) == _jax_leaf_flags(jm)
    assert jax.tree_util.tree_structure(jm) == \
        jax.tree_util.tree_structure(tm)


def test_add_lora_targets_and_init():
    """Adapters beside the SFTCard's targets only, a ~ N(0,1)·(α/r)/sqrt(in)
    in bf16, b zero; the same keys as the JAX package adds."""
    card = ModelCard.from_arch("QWEN3", **TINY)
    sft = SFTCard(method="lora", lora_rank=16, lora_alpha=32)
    gen = torch.Generator().manual_seed(0)
    p = tlora.add_lora(init_params(card, device="cpu", seed=0), sft, gen)
    _, jp = _jax_lora_params(("wq", "wk", "wv", "wo"), rank=16)
    for lp, jlp in zip(p["layers"], jp["layers"]):
        assert sorted(lp) == sorted(jlp)
        for k in ("q", "k", "v", "o"):
            a, b = lp[k + "_lora"]["a"], lp[k + "_lora"]["b"]
            assert a.dtype == b.dtype == torch.bfloat16
            assert a.shape == (lp[k].shape[0], 16) and not b.any()
            want = 32 / 16 / lp[k].shape[0] ** 0.5
            assert abs(float(a.float().std()) / want - 1) < 0.1


def test_merge_lora_matches_jax():
    _, jp = _jax_lora_params(("wq", "wo", "wgate", "wdown"))
    jp = jax.tree_util.tree_map(lambda x: x, jp)
    for lp in jp["layers"]:        # b non-zero, as after training
        for k in [k for k in lp if k.endswith("_lora")]:
            lp[k] = dict(lp[k], b=jnp.asarray(
                np.random.default_rng(len(k)).standard_normal(
                    lp[k]["b"].shape) * 0.05, jnp.bfloat16))
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    jm, tm = jlora.merge_lora(jp), tlora.merge_lora(tp)
    assert sorted(tm["layers"][0]) == sorted(jm["layers"][0])
    assert not any(k.endswith("_lora") for k in tm["layers"][1])
    for a, b in zip(jax.tree_util.tree_leaves(jm), leaves(tm)):
        a, b = f32(a), f32(b)
        np.testing.assert_allclose(b, a, rtol=2 ** -8, atol=1e-6)


def _sft_batches(n, B, T, vocab, seed=0):
    """SFT-like batches: "+1 mod vocab" rows from random starts, a loss
    mask over each row's tail."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        start = rng.integers(0, vocab, (1, B, 1))
        toks = ((start + np.arange(T + 1)) % vocab).astype(np.int32)
        mask = np.zeros((1, B, T + 1), bool)
        for b in range(B):
            mask[0, b, int(rng.integers(T // 4, T // 2)):] = True
        out.append((toks, mask))
    return out


def test_lora_sft_loss_curve_matches_jax():
    """8 AdamW steps of LoRA SFT (rank 8 on q/k/v/o), SR off, from the same
    base and adapters: the loss curves agree within 1e-2, the base weights
    stay bit for bit, the adapters move (tests/test_sft_qat.py:109)."""
    steps, B, T = 8, 4, 32
    jcard, jp = _jax_lora_params()
    card = ModelCard.from_arch("QWEN3", **TINY)
    tkw = dict(batch=B, lr=2e-2, warmup=2, stochastic_round=False,
               dump_every=0)
    data = _sft_batches(4, B, T, 256)
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    tmask = tlora.trainable_mask(tp, "lora")
    jstate = jtrainer.init_train_state(jcard, JTrainCard(**tkw), params=jp)
    jstate, jinfo = jtrainer.train_loop(
        jcard, JTrainCard(**tkw), jstate,
        iter([{"tokens": jnp.asarray(data[i % 4][0]),
               "loss_mask": jnp.asarray(data[i % 4][1])}
              for i in range(steps)]),
        total_steps=steps, log_fn=None,
        trainable=jlora.trainable_mask(jp, "lora"))
    base = {k: v.clone() for k, v in tp["layers"][0].items()
            if not k.endswith("_lora")}
    tcard = TrainCard(**tkw)
    state = ttrainer.init_train_state(card, tcard, params=tp)
    state, tinfo = ttrainer.train_loop(
        card, tcard, state,
        iter([{"tokens": torch.from_numpy(data[i % 4][0]).long(),
               "loss_mask": torch.from_numpy(data[i % 4][1])}
              for i in range(steps)]),
        total_steps=steps, log_fn=None,
        trainable=tmask)
    jl, tl = np.array(jinfo.losses), np.array(tinfo.losses)
    assert len(tl) == steps and tl[-1] < tl[0] - 0.1
    assert np.abs(tl - jl).max() <= 1e-2, np.abs(tl - jl).max()
    lp = state.params["layers"][0]
    for k, v in base.items():
        assert torch.equal(lp[k].view(torch.int16) if v.dtype ==
                           torch.bfloat16 else lp[k],
                           v.view(torch.int16) if v.dtype ==
                           torch.bfloat16 else v), k
        assert not lp[k].requires_grad        # the step froze it
    assert lp["q_lora"]["b"].abs().max() > 0
    # the merged model computes the adapted forward
    toks = torch.from_numpy(data[0][0][0, :, :-1]).long()
    with torch.no_grad():
        l1 = model_forward(card, state.params, toks)
        l2 = model_forward(card, tlora.merge_lora(state.params), toks)
    np.testing.assert_allclose(f32(l1), f32(l2), rtol=3e-2, atol=3e-2)


def test_bitfit_mask():
    """tests/test_sft_qat.py:136 on the port."""
    card = ModelCard.from_arch("QWEN3", **TINY)
    mask = tlora.trainable_mask(init_params(card, device="cpu"), "bitfit")
    assert mask["layers"][0]["ln1"] is True
    assert mask["layers"][0]["q"] is False
    assert mask["ln_f"] is True


# ---------------------------------------------------------------------------
# Fuyou
# ---------------------------------------------------------------------------

def _pair(seed):
    """(JAX branch, port branch): 2 layers of a tiny model."""
    jcard = JModelCard.from_arch("QWEN3", **TINY)
    jb = j_init_params(jcard, jax.random.PRNGKey(seed))["layers"]
    return jb, params_from_numpy(jax_tree_to_numpy({"l": jb}),
                                 device="cpu")["l"]


def _jax_pso_draws(key, branch):
    lv = jax.tree_util.tree_leaves(branch)
    keys = jax.random.split(key, len(lv))
    return [torch.from_numpy(np.array(jax.random.uniform(k, x.shape)))
            for k, x in zip(keys, lv)]


def _jax_ga_draws(key, branch):
    lv = jax.tree_util.tree_leaves(branch)
    keys = jax.random.split(key, 2 * len(lv))
    return [(torch.from_numpy(np.array(jax.random.uniform(
                keys[2 * i], x.shape))),
             torch.from_numpy(np.array(jax.random.normal(
                 keys[2 * i + 1], x.shape))))
            for i, x in enumerate(lv)]


def _assert_tree_close(jt, tt, tol=1e-6):
    jl, tl = jax.tree_util.tree_leaves(jt), leaves(tt)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert f32(a).shape == f32(b).shape
        assert np.abs(f32(a) - f32(b)).max() <= tol


def test_fuyou_pso_and_ga_steps_match_jax_draws():
    jx, tx = _pair(0)
    jbest, tbest = _pair(1)
    jv = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.random.default_rng(x.size).standard_normal(
            x.shape) * 1e-3, jnp.float32), jx)
    tv = params_from_numpy(jax_tree_to_numpy({"v": jv}), device="cpu")["v"]
    key = jax.random.PRNGKey(7)
    jnx, jnv = jfuyou._pso_step(jx, jbest, jv, key=key, inertia=0.7,
                                social=0.02)
    tnx, tnv = tfuyou._pso_step(tx, tbest, tv, _jax_pso_draws(key, jx),
                                inertia=0.7, social=0.02)
    _assert_tree_close(jnv, tnv)
    _assert_tree_close(jnx, tnx)
    jg = jfuyou._ga_step(jx, jbest, key=key, crossover=0.6, mutation=1e-3)
    tg = tfuyou._ga_step(tx, tbest, _jax_ga_draws(key, jx), crossover=0.6,
                         mutation=1e-3)
    _assert_tree_close(jg, tg)


def test_fuyou_rotate_matches_jax(monkeypatch):
    """Four rotations over a 3-branch pso_ga swarm with set losses: the
    same active branch, best branch, scores and branch weights, the port fed
    JAX's draws (tests/test_sft_qat.py:145)."""
    jcard = JModelCard.from_arch("QWEN3", **TINY)
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    jcfg = jfuyou.FuyouConfig(branches=3, switch=5, method="pso_ga",
                              mutation=1e-4, layer_lo=1)
    tcfg = tfuyou.FuyouConfig(branches=3, switch=5, method="pso_ga",
                              mutation=1e-4, layer_lo=1)
    jfy, tfy = jfuyou.Fuyou(jcfg, jp), tfuyou.Fuyou(tcfg, tp)
    jp, tp = jfy.inject(jp), tfy.inject(tp)
    keys = {}

    def pso(branch, gen):      # JAX's _exploit: key, k1, k2 a branch
        keys["key"], k1, keys["k2"] = jax.random.split(keys["key"], 3)
        return _jax_pso_draws(k1, branch)

    monkeypatch.setattr(tfuyou, "pso_draws", pso)
    monkeypatch.setattr(tfuyou, "ga_draws",
                        lambda branch, gen: _jax_ga_draws(keys["k2"], branch))
    rng = np.random.default_rng(3)
    for r, loss in enumerate((3.0, 2.5, 2.8, 2.4)):
        # the active branch drifts between rotations, as training moves it
        noise = rng.standard_normal(jp["layers"][1]["q"].shape) * 1e-2
        jp["layers"][1]["q"] = (jp["layers"][1]["q"].astype(jnp.float32)
                                + noise).astype(jnp.bfloat16)
        tp["layers"][1]["q"] = torch.from_numpy(
            np.asarray(jp["layers"][1]["q"], np.float32)).to(torch.bfloat16)
        k = jax.random.PRNGKey(100 + r)
        keys["key"] = k
        jp = jfy.rotate(jp, loss, k)
        tp = tfy.rotate(tp, loss, torch.Generator())
        assert (tfy.cur, tfy.best) == (jfy.cur, jfy.best)
        np.testing.assert_array_equal(tfy.scores, jfy.scores)
        for jb, tb in zip(jfy.branches, tfy.branches):
            _assert_tree_close(jb, tb)
        _assert_tree_close(jp, tp)
    assert tfy.best == 3 % 3 and np.isfinite(tfy.scores).all()


def test_fuyou_config_from_json_and_generator_draws():
    j = {"branch": 3, "switch": 8, "method": "ga", "crossover": 0.5,
         "mutation": 0.01, "social": 2}
    assert tfuyou.FuyouConfig.from_json(j).__dict__ == \
        jfuyou.FuyouConfig.from_json(j).__dict__
    _, tx = _pair(0)
    gen = torch.Generator().manual_seed(0)
    r = tfuyou.pso_draws(tx, gen)
    u_n = tfuyou.ga_draws(tx, gen)
    assert [t.shape for t in r] == [x.shape for x in leaves(tx)]
    assert all(0 <= float(t.min()) and float(t.max()) < 1 for t in r)
    assert all(abs(float(n.std()) - 1) < 0.2 for _, n in u_n if n.numel() > 64)
