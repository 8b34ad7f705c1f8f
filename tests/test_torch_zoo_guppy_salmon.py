"""PyTorch port vs the JAX package: Guppy (``models/guppy.py``) and Salmon
(``models/salmon.py``), with the threefry draws they share
(``utils/prng.py``).

Tiny cards (2 layers, E 64), weights from JAX inits carried across with
``params_from_numpy``, inputs from numpy seeds, one intra-op torch thread;
JAX on the CPU, the port with ``device="cpu"``.

Exact: every key, bit word, uniform and randint draw (the port's numpy
threefry against ``jax.random``, eager and jitted), so Guppy's evaluation
sample and a training step's rows and Salmon's t and masks are JAX's.
Tolerances: bf16 FFN outputs within 2^-6 of the largest entry (two bf16
ulps); logits 2e-2 (``torch_helpers.LOGIT_TOL``); the diffusion loss 1e-3
(an f32 sum of bf16-logit CEs; measured 1.2e-5); loss curves 1e-2 (the
port's curve tests' bound); greedy tokens as ``assert_greedy_agrees``
holds them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import SamplerCard as JSamplerCard
from koifish_tpu.config import TrainCard as JTrainCard
from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.models import guppy as jguppy
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.models import salmon as jsalmon
from koifish_tpu.serve import engine as jengine
from koifish_tpu.serve.kvcache import cache_for as j_cache_for
from koifish_tpu.serve.layered import decode_step_layered as j_decode_layered
from koifish_tpu.serve.stacked import stack_layers as j_stack_layers
from koifish_tpu.train.trainer import init_train_state as j_init_state
from koifish_tpu.train.trainer import make_train_step as j_make_step
from koifish_tpu.train.trainer import train_loop as j_train_loop

from koifish_tpu_torch.config import ModelCard, SamplerCard, TrainCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.io.convert import (params_from_numpy,
                                          train_state_from_numpy)
from koifish_tpu_torch.models import guppy as tguppy
from koifish_tpu_torch.models import salmon as tsalmon
from koifish_tpu_torch.models.transformer import init_params, model_forward
from koifish_tpu_torch.serve import (cache_for, decode_step_layered, generate,
                                     prefill, stack_layers)
from koifish_tpu_torch.train import trainer as ttrainer
from koifish_tpu_torch.utils import prng

from torch_helpers import (LOGIT_TOL, assert_greedy_agrees, bf16_pair, f32,
                           jax_train_state_to_numpy, jax_tree_to_numpy,
                           top2_margin, torch_threads, zoo_cli_losses)

CARD = dict(vocab_size=64, n_layer=2, n_embd=64, n_head=4, n_kv_head=4,
            head_dim=16, n_ffn=96, n_ctx=32, max_pos=64)
FFN_TOL = 2.0 ** -6
LOSS_TOL = 1e-3
CURVE_TOL = 1e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


def _key_data(k):
    return np.asarray(jax.random.key_data(k) if jnp.issubdtype(
        k.dtype, jax.dtypes.prng_key) else k)


# ---------------------------------------------------------------------------
# the threefry draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 42, 2 ** 33 + 5])
def test_prng_draws_match_jax(seed):
    """Keys, split, fold_in, random bits, uniform (eager and jitted: both
    scale and shift in one FMA) and randint (spans a power of two and not;
    odd sizes), bit for bit."""
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(_key_data(jk), tk)
    np.testing.assert_array_equal(_key_data(jax.random.split(jk, 7)),
                                  prng.split(tk, 7))
    np.testing.assert_array_equal(_key_data(jax.random.fold_in(jk, 12345)),
                                  prng.fold_in(tk, 12345))
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, (5, 7), jnp.uint32)),
        prng.random_bits(tk, (5, 7)))
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (3, 333))), prng.uniform(tk,
                                                                   (3, 333)))
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (9, 1), minval=1e-3, maxval=1.0)),
        prng.uniform(tk, (9, 1), 1e-3, 1.0))
    jit_u = jax.jit(lambda k: jax.random.uniform(k, (4096, 1), minval=1e-3,
                                                 maxval=1.0))
    np.testing.assert_array_equal(np.asarray(jit_u(jk)),
                                  prng.uniform(tk, (4096, 1), 1e-3, 1.0))
    for lo, hi, n in ((0, 64, 96), (0, 300, 1001), (0, 151936, 3072),
                      (5, 17, 7), (0, 2 ** 31 - 1, 33)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(jk, (n,), lo, hi, jnp.int32)),
            prng.randint(tk, (n,), lo, hi), err_msg=str((lo, hi)))


@pytest.mark.parametrize("dims", [(2, 96, 64), (28, 3072, 151936)],
                         ids=["tiny", "qwen3_0.6b"])
def test_guppy_eval_sample_is_jaxs_bit_for_bit(dims):
    """The evaluation sample (``rng=None``) and a step's sample equal the
    JAX package's, at the tiny card and at Qwen3-0.6B's (28 x 3072 of
    151,936)."""
    L, Fn, V = dims
    jcard = JModelCard.from_arch("GUPPY", **dict(CARD, n_layer=L, n_ffn=Fn,
                                                 vocab_size=V))
    card = ModelCard.from_arch("GUPPY", **dict(CARD, n_layer=L, n_ffn=Fn,
                                               vocab_size=V))
    want = np.asarray(jguppy.sample_ids(jcard, None))
    got = tguppy.sample_ids(card)
    assert got.shape == (L, Fn) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    jk = jax.random.fold_in(jax.random.PRNGKey(42), 3)
    np.testing.assert_array_equal(
        tguppy.sample_ids(card, _key_data(jk)),
        np.asarray(jguppy.sample_ids(jcard, jk)))
    np.testing.assert_array_equal(
        ttrainer.step_key(42, 5),
        _key_data(jax.random.fold_in(
            jax.random.split(jax.random.split(jax.random.split(
                jax.random.split(jax.random.split(
                    jax.random.PRNGKey(42))[0])[0])[0])[0])[0], 5)))


# ---------------------------------------------------------------------------
# Guppy
# ---------------------------------------------------------------------------

def _guppy_models():
    jcard = JModelCard.from_arch("GUPPY", **CARD)
    card = ModelCard.from_arch("GUPPY", **CARD)
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    return jcard, card, jp, params_from_numpy(jax_tree_to_numpy(jp),
                                              device="cpu")


def test_guppy_ffn_and_inject_rows_match_jax():
    """``inject_rows`` on per-layer and layer-stacked params gives JAX's
    rows (a gather: bit for bit), ``guppy_ffn`` its outputs, and the
    injected model its logits; ``init_params`` builds JAX's leaves."""
    jcard, card, jp, tp = _guppy_models()
    own = init_params(card, device="cpu")
    assert [sorted(lp) for lp in own["layers"]] == \
        [sorted(lp) for lp in jp["layers"]]
    assert own["layers"][0]["guppy_gain"].shape == ()
    assert tp["layers"][0]["guppy_gain"].shape == ()
    samps = np.asarray(jguppy.sample_ids(jcard, jax.random.PRNGKey(9)))
    jinj = jguppy.inject_rows(jcard, jp, jnp.asarray(samps))
    tinj = tguppy.inject_rows(card, tp, samps)
    for jl, tl in zip(jinj["layers"], tinj["layers"]):
        assert torch.equal(tl["guppy_rows"],
                           params_from_numpy(np.asarray(jl["guppy_rows"]),
                                             device="cpu"))
    jst = jguppy.inject_rows(jcard, j_stack_layers(jp), None)
    tst = tguppy.inject_rows(card, stack_layers(tp), None)
    np.testing.assert_array_equal(f32(tst["layers"]["guppy_rows"]),
                                  f32(jst["layers"]["guppy_rows"]))
    assert tguppy.inject_rows(card, tinj, None) is tinj      # no-op
    lp_j = dict(jinj["layers"][1], guppy_gain=jnp.asarray(1.5, jnp.bfloat16))
    lp_t = dict(tinj["layers"][1], guppy_gain=torch.tensor(
        1.5, dtype=torch.bfloat16))
    jx, tx = bf16_pair(np.random.default_rng(2).standard_normal(
        (2, 8, 64)).astype(np.float32))
    jy = f32(jguppy.guppy_ffn(lp_j, jx))
    ty = f32(tguppy.guppy_ffn(lp_t, tx))
    assert np.abs(ty - jy).max() <= FFN_TOL * np.abs(jy).max()
    toks = np.random.default_rng(3).integers(0, 64, (2, 12)).astype(np.int32)
    jl = f32(jax.jit(lambda p, t: jax_model_forward(jcard, p, t))(
        jp, jnp.asarray(toks)))
    tl = f32(model_forward(card, tp, torch.from_numpy(toks).long()))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_TOL)


def jax_model_forward(jcard, p, t, **kw):
    from koifish_tpu.models import model_forward as j_model_forward
    return j_model_forward(jcard, p, t, **kw)


_j_prefill = jax.jit(jengine.prefill, static_argnames=("card", "fresh"))
_j_step = jax.jit(j_decode_layered, static_argnames=("card", "streaming"))


@pytest.mark.parametrize("fmt", ["int8"])
def test_guppy_serving_matches_jax(fmt):
    """``generate`` on the evaluation sample through per-layer params,
    layer-stacked ``decode_params`` and a layered cache: the JAX package's
    greedy tokens (up to its first near-tie) in each; the prefill's and
    each teacher-forced decode step's logits within 2e-2."""
    jcard, card, jp, tp = _guppy_models()
    B, P, new = 2, 6, 8
    prompt = np.random.default_rng(6).integers(0, 64, (B, P)).astype(
        np.int32)
    jc = j_cache_for(jcard, B, 32, fmt=JQFormat(fmt), layered=True)
    jtoks, _ = jengine.generate(jcard, jp, jnp.asarray(prompt), jc,
                                sampler=JSamplerCard(temperature=0.0),
                                max_new_tokens=new, decode_chunk=4)
    jtoks = np.asarray(jtoks)
    jc = j_cache_for(jcard, B, 32, fmt=JQFormat(fmt), layered=True)
    jl, jc = _j_prefill(jcard, jp, jnp.asarray(prompt), jc, fresh=True)
    margins, jlogits = [top2_margin(jl)], [f32(jl)]
    for i in range(new - 1):
        jl, jc = _j_step(jcard, jp, jnp.asarray(jtoks[:, i]), jc,
                         streaming=True)
        margins.append(top2_margin(jl))
        jlogits.append(f32(jl))
    sparams = stack_layers(tp)
    for path in ("list", "stacked", "layered"):
        c = cache_for(card, B, 32, fmt=QFormat(fmt),
                      layered=path == "layered", device="cpu")
        toks, _ = generate(card, tp, torch.from_numpy(prompt), c,
                           sampler=SamplerCard(temperature=0.0),
                           max_new_tokens=new, decode_chunk=4,
                           decode_params=sparams if path == "stacked"
                           else None, device="cpu")
        assert_greedy_agrees(toks, jtoks, margins)
        c = cache_for(card, B, 32, fmt=QFormat(fmt), layered=True,
                      device="cpu")
        params = sparams if path == "stacked" else tp
        tl, c = prefill(card, params if path != "stacked" else tp,
                        torch.from_numpy(prompt), c, fresh=True, device="cpu")
        np.testing.assert_allclose(f32(tl), jlogits[0], atol=LOGIT_TOL)
        for i in range(new - 1):
            tl, c = decode_step_layered(card, params,
                                        torch.from_numpy(jtoks[:, i].copy()),
                                        c)
            np.testing.assert_allclose(f32(tl), jlogits[i + 1],
                                       atol=LOGIT_TOL, err_msg=path)


# ---------------------------------------------------------------------------
# Salmon
# ---------------------------------------------------------------------------

def _salmon_models():
    jcard = JModelCard.from_arch("SALMON", **dict(CARD, vocab_size=128))
    card = ModelCard.from_arch("SALMON", **dict(CARD, vocab_size=128))
    jp = j_init_params(jcard, jax.random.PRNGKey(1))
    return jcard, card, jp, params_from_numpy(jax_tree_to_numpy(jp),
                                              device="cpu")


def test_diffusion_loss_matches_jax():
    """Given JAX's t and mask (drawn as its ``diffusion_loss`` draws them)
    the port's loss and per-position CE equal the JAX package's within
    1e-3, with and without an SFT ``loss_mask``; the port's own draws
    from the key are JAX's bit for bit (``diffusion_draws``), so its loss
    from the key alone agrees as well."""
    jcard, card, jp, tp = _salmon_models()
    B, T = 4, 16
    tokens = np.random.default_rng(5).integers(0, 127, (B, T)).astype(
        np.int32)
    key = jax.random.PRNGKey(11)
    k_t, k_m = jax.random.split(key)
    jt = np.array(jax.random.uniform(k_t, (B, 1), minval=1e-3, maxval=1.0))
    jm = np.asarray(jax.random.uniform(k_m, (B, T))) < jt
    t_n, m_n = tsalmon.diffusion_draws(_key_data(key), B, T)
    np.testing.assert_array_equal(t_n, jt)
    np.testing.assert_array_equal(m_n, jm)
    lmask = np.ones((B, T), bool)
    lmask[:, :5] = False
    jloss_fn = jax.jit(lambda p, x, k, lm: jsalmon.diffusion_loss(
        jcard, p, x, k, loss_mask=lm))
    for lm in (None, lmask):
        jloss, jper = jloss_fn(jp, jnp.asarray(tokens), key,
                               None if lm is None else jnp.asarray(lm))
        tlm = None if lm is None else torch.from_numpy(lm)
        tloss, tper = tsalmon.diffusion_loss(
            card, tp, torch.from_numpy(tokens).long(),
            t=torch.from_numpy(jt), masked=torch.from_numpy(jm),
            loss_mask=tlm)
        assert abs(float(tloss) - float(jloss)) < LOSS_TOL
        np.testing.assert_allclose(f32(tper), f32(jper), rtol=0,
                                   atol=10 * LOSS_TOL)
        own, _ = tsalmon.diffusion_loss(card, tp,
                                        torch.from_numpy(tokens).long(),
                                        _key_data(key), loss_mask=tlm)
        assert float(own) == float(tloss)


def test_diffusion_generate_matches_jax():
    """Greedy ``diffusion_generate`` (4 denoise steps, a 5-token
    prompt, total 16) on a briefly trained Salmon: the JAX package's
    tokens, and no mask left."""
    jcard, card, _, _ = _salmon_models()
    tkw = dict(batch=8, lr=1e-2, warmup=2, stochastic_round=False)
    jstate = j_init_state(jcard, JTrainCard(**tkw))
    step = j_make_step(jcard, JTrainCard(**tkw), total_steps=20)
    rng = np.random.default_rng(8)
    for _ in range(12):
        s = rng.integers(0, 64, (8, 1))
        jstate, _ = step(jstate, {"tokens": jnp.asarray(
            ((s + np.arange(17)[None]) % 64)[None].astype(np.int32))})
    tp = params_from_numpy(jax_tree_to_numpy(jstate.params), device="cpu")
    prompt = ((np.arange(5)[None] + np.array([[20], [3]])) % 64).astype(
        np.int32)
    for steps in (4,):
        jout = np.asarray(jsalmon.diffusion_generate(
            jcard, jstate.params, jnp.asarray(prompt), total_len=16,
            key=jax.random.PRNGKey(3), steps=steps))
        tout = tsalmon.diffusion_generate(card, tp, torch.from_numpy(prompt),
                                          total_len=16, steps=steps)
        assert tout.shape == (2, 16) and tout.dtype == torch.int32
        assert int((tout == tsalmon.mask_id(card)).sum()) == 0
        np.testing.assert_array_equal(tout.numpy(), jout, err_msg=str(steps))


# ---------------------------------------------------------------------------
# training and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,accum", [("GUPPY", 1), ("SALMON", 1),
                                        ("GUPPY", 2)])
def test_zoo_draws_train_like_jax(arch, accum):
    """5 steps of ``train_loop`` (SR off) from the same state: each step's
    rows (GUPPY) or t and masks (SALMON) are the JAX step key's, so the
    loss curve is JAX's within 1e-2; with 2 micro-batches too (each draws
    under fold_in(step key, micro))."""
    kw = dict(CARD, vocab_size=128 if arch == "SALMON" else 64)
    jcard = JModelCard.from_arch(arch, **kw)
    card = ModelCard.from_arch(arch, **kw)
    tkw = dict(batch=4, lr=1e-2, warmup=2, stochastic_round=False)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, 64, (accum, 4, 17)).astype(np.int32)
               for _ in range(5)]
    jstate = j_init_state(jcard, JTrainCard(**tkw))
    tstate = train_state_from_numpy(jax_train_state_to_numpy(jstate),
                                    device="cpu")
    _, jinfo = j_train_loop(jcard, JTrainCard(**tkw), jstate,
                            [{"tokens": jnp.asarray(b)} for b in batches],
                            total_steps=5, log_fn=None)
    _, tinfo = ttrainer.train_loop(card, TrainCard(**tkw), tstate,
                                   [{"tokens": torch.from_numpy(b).long()}
                                    for b in batches], total_steps=5,
                                   log_fn=None)
    np.testing.assert_allclose(tinfo.losses, jinfo.losses, rtol=0,
                               atol=CURVE_TOL)


@pytest.mark.parametrize("arch", ["GUPPY", "SALMON"])
def test_koifish_guppy_salmon_cli_matches_jax(arch, tmp_path, monkeypatch):
    """``koifish`` on tiny GUPPY and SALMON configs
    (``tests/test_cli.py:482-520``'s shape; SALMON through the reference's
    arch string "SCORE"), the port from the JAX init: the loss curve
    within 1e-2 of the JAX CLI's."""
    jl, tl, res = zoo_cli_losses(tmp_path, monkeypatch,
                                 "SCORE" if arch == "SALMON" else arch)
    assert res["card"].arch == arch
    assert len(tl) == len(jl) == 6
    np.testing.assert_allclose(tl, jl, rtol=0, atol=CURVE_TOL)
