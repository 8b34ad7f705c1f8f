"""PyTorch port vs the JAX package: GAU (``models/gau.py``) and BROWN
(``models/brown.py``) layers, alone and in hybrid backbones, their
training, and their refusal to serve.

Tiny cards (E 64, 4 heads of 16), weights from JAX inits carried across
with ``params_from_numpy``, inputs from numpy seeds, one intra-op torch
thread; JAX on the CPU, the port with ``device="cpu"``. Both layers take
the plain attention in both packages (GAU's value width F/H differs from
the head dim; BROWN's attention is a learned table).

Tolerances: the blocks' bf16 outputs within 2^-6 of the largest entry (two
bf16 ulps), their gradients within 2 % of each leaf's largest entry;
logits 2e-2 (``torch_helpers.LOGIT_TOL``); loss curves 1e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import SamplerCard as JSamplerCard
from koifish_tpu.config import TrainCard as JTrainCard
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.models import model_forward as j_model_forward
from koifish_tpu.models.brown import brown_attn as j_brown_attn
from koifish_tpu.models.brown import init_brown_layer as j_init_brown
from koifish_tpu.models.gau import gau_block as j_gau_block
from koifish_tpu.models.gau import init_gau_layer as j_init_gau
from koifish_tpu.ops.rope import rope_freqs as j_rope_freqs
from koifish_tpu.serve import engine as jengine
from koifish_tpu.serve.kvcache import init_cache as j_init_cache
from koifish_tpu.train.trainer import init_train_state as j_init_state
from koifish_tpu.train.trainer import train_loop as j_train_loop

from koifish_tpu_torch.config import ModelCard, SamplerCard, TrainCard
from koifish_tpu_torch.io.convert import (params_from_numpy,
                                          train_state_from_numpy)
from koifish_tpu_torch.models import brown as tbrown
from koifish_tpu_torch.models import gau as tgau
from koifish_tpu_torch.models.transformer import init_params, model_forward
from koifish_tpu_torch.ops.rope import rope_freqs
from koifish_tpu_torch.serve import engine as tengine
from koifish_tpu_torch.serve.kvcache import init_cache
from koifish_tpu_torch.train.trainer import train_loop
from koifish_tpu_torch.utils import kernel_log

from torch_helpers import (LOGIT_TOL, bf16_pair, f32,
                           jax_train_state_to_numpy, jax_tree_to_numpy,
                           torch_threads)

BLOCK_TOL = 2.0 ** -6
GRAD_TOL = 2e-2
CURVE_TOL = 1e-2
_TR = {"Ctx": 16, "Embed": 64, "Head": 4, "head_dim": 16, "Ffn": 128}


def _hybrid(arch, kv_head):
    """A 3-layer card: QKV FFN, GAU, BROWN FFN (``models/backbone.py``'s
    syntax; GPT2: learned positions, LayerNorm, GELU; QWEN3: rope, RMSNorm,
    SwiGLU, QK norm (BROWN layers skip it, as they skip the QKV bias))."""
    return {
        "arch": arch, "vocab_size": 128,
        "parameter": {"Layer": 3, "max_pos_embeddings": 32,
                      "transformer": dict(_TR, KVHead=kv_head)},
        "backbone": {
            "embed_tokens": {"Embedding": []},
            "a *1": {"self_attn": {"QKV": []}, "mlp": {"FFN": []}},
            "g *1": {"GAU": []},
            "b *1": {"self_attn": {"BROWN": []}, "mlp": {"FFN": []}},
            "norm": {"Normal": []}, "output": {"CLASIFY": []}}}


HYBRIDS = {"gpt2": _hybrid("GPT2", 4), "qwen3": _hybrid("QWEN3", 2)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("kind", ["gau", "brown"])
@pytest.mark.parametrize("name", ["gpt2", "qwen3"])
def test_block_matches_jax(kind, name):
    """``gau_block`` / ``brown_attn`` on the same bf16 input and the JAX
    init's layer (rope tables where the card ropes): the output and the
    gradients of every leaf and of x."""
    jcard = JModelCard.from_json(HYBRIDS[name])
    card = ModelCard.from_json(HYBRIDS[name])
    init, jblock, tblock = {
        "gau": (j_init_gau, j_gau_block, tgau.gau_block),
        "brown": (j_init_brown, j_brown_attn, tbrown.brown_attn)}[kind]
    E = card.n_embd
    jlp = dict(init(jcard, jax.random.PRNGKey(3)),
               ln1=jnp.ones((E,), jnp.bfloat16) * 1.25)
    if card.norm == "layernorm":
        jlp["ln1_b"] = jnp.full((E,), 0.1, jnp.bfloat16)
    tlp = params_from_numpy(jax_tree_to_numpy(jlp), device="cpu")
    T = 12
    jcos = jsin = tcos = tsin = None
    if card.pos_embed == "rope":
        jcos, jsin = j_rope_freqs(card.head_dim, card.max_pos,
                                  card.rope_theta)
        tcos, tsin = rope_freqs(card.head_dim, card.max_pos, card.rope_theta)
    rng = np.random.default_rng(4)
    jx, tx = bf16_pair(rng.standard_normal((2, T, E)).astype(np.float32))
    cot = rng.standard_normal((2, T, E)).astype(np.float32)

    def jloss(lp, x):
        out = jblock(jcard, lp, x, jcos, jsin, jnp.arange(T))
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), (jg_lp, jg_x) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jlp, jx)
    for t in tlp.values():
        t.requires_grad_(True)
    tx.requires_grad_(True)
    out = tblock(card, tlp, tx, tcos, tsin, torch.arange(T))
    assert out.dtype == torch.bfloat16 and out.shape == tx.shape
    assert _rel(f32(out), f32(jout)) < BLOCK_TOL
    grads = torch.autograd.grad((out.float() * torch.from_numpy(cot)).sum(),
                                list(tlp.values()) + [tx])
    for (leaf, _), g in zip(list(tlp.items()) + [("x", None)], grads):
        jg = jg_x if leaf == "x" else jg_lp[leaf]
        assert _rel(f32(g), f32(jg)) < GRAD_TOL, leaf


def _models(name):
    jcard = JModelCard.from_json(HYBRIDS[name])
    card = ModelCard.from_json(HYBRIDS[name])
    jp = j_init_params(jcard, jax.random.PRNGKey(5))
    return jcard, card, jp, params_from_numpy(jax_tree_to_numpy(jp),
                                              device="cpu")


@pytest.mark.parametrize("name", ["gpt2", "qwen3"])
def test_hybrid_model_matches_jax(name):
    """``init_params`` builds the JAX package's leaves layer by layer (GAU:
    ln1 and its five; BROWN: its table and projection, no QKV bias or QK
    norm, the FFN kept); the logits agree. Two ``flash_attention``
    fallbacks are logged: the QKV layer's
    (head dim 16 is no kernel head dim) and the GAU layer's (value width
    F/H = 32 against the head dim); the BROWN layer computes no
    attention."""
    jcard, card, jp, tp = _models(name)
    assert card.gau_layers == (1,) and card.brown_layers == (2,)
    own = init_params(card, device="cpu")
    for ol, jl in zip(own["layers"], jp["layers"]):
        assert sorted(ol) == sorted(jl)
        for k in ol:
            assert tuple(ol[k].shape) == tuple(jl[k].shape), k
            assert ol[k].dtype == tp["layers"][0]["ln1"].dtype or \
                k == "brown_w", k
    assert own["layers"][2]["brown_w"].dtype == torch.float32
    toks = np.random.default_rng(6).integers(0, 128, (2, 12)).astype(
        np.int32)
    jl = f32(jax.jit(lambda p, t: j_model_forward(jcard, p, t))(
        jp, jnp.asarray(toks)))
    kernel_log.reset_launches()
    tl = f32(model_forward(card, tp, torch.from_numpy(toks).long()))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_TOL)
    assert kernel_log.fallbacks() == {"flash_attention": 2}


@pytest.mark.parametrize("name", ["gpt2", "qwen3"])
def test_hybrid_trains_like_jax(name):
    """5 steps of ``train_loop`` (SR off) on the hybrid card: the loss
    curve within 1e-2 of the JAX package's (the BROWN layer's unused
    ``o_b`` takes a zero gradient in both)."""
    jcard, card, _, _ = _models(name)
    tkw = dict(batch=4, lr=1e-2, warmup=2, stochastic_round=False)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, 128, (1, 4, 17)).astype(np.int32)
               for _ in range(5)]
    jstate = j_init_state(jcard, JTrainCard(**tkw))
    tstate = train_state_from_numpy(jax_train_state_to_numpy(jstate),
                                    device="cpu")
    _, jinfo = j_train_loop(jcard, JTrainCard(**tkw), jstate,
                            [{"tokens": jnp.asarray(b)} for b in batches],
                            total_steps=5, log_fn=None)
    _, tinfo = train_loop(card, TrainCard(**tkw), tstate,
                          [{"tokens": torch.from_numpy(b).long()}
                           for b in batches], total_steps=5, log_fn=None)
    np.testing.assert_allclose(tinfo.losses, jinfo.losses, rtol=0,
                               atol=CURVE_TOL)


def _raised(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("layers", ["gau", "brown"])
def test_serving_gau_or_brown_raises_like_jax(layers):
    """``prefill`` and ``generate`` of a card with GAU (or BROWN) layers
    raise the JAX package's exception type with its message."""
    jcard, card, jp, tp = _models("qwen3")
    drop = "brown_layers" if layers == "gau" else "gau_layers"
    jcard = dataclasses.replace(jcard, **{drop: ()})
    card = dataclasses.replace(card, **{drop: ()})
    prompt = np.zeros((1, 4), np.int32)
    jc = j_init_cache(jcard.n_layer, 1, 16, jcard.n_kv_head, jcard.head_dim)
    tc = init_cache(card.n_layer, 1, 16, card.n_kv_head, card.head_dim,
                    device="cpu")
    for jfn, tfn in (
            (lambda: jengine.prefill(jcard, jp, jnp.asarray(prompt), jc),
             lambda: tengine.prefill(card, tp, torch.from_numpy(prompt), tc,
                                     device="cpu")),
            (lambda: jengine.generate(jcard, jp, jnp.asarray(prompt), jc,
                                      sampler=JSamplerCard(temperature=0.0),
                                      max_new_tokens=2),
             lambda: tengine.generate(card, tp, torch.from_numpy(prompt), tc,
                                      sampler=SamplerCard(temperature=0.0),
                                      max_new_tokens=2, device="cpu"))):
        jr, tr = _raised(jfn), _raised(tfn)
        assert jr is not None and jr[0] == "NotImplementedError"
        assert tr == jr
