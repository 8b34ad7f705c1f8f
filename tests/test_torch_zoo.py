"""PyTorch port vs the JAX package: the backbone parser and the MoE half of
the model zoo (``models/backbone.py``, ``models/moe.py`` and the MoE layers
of the decoder, its serving paths and its training).

Tiny cards, inputs and weights from seeds (JAX inits carried across with
``params_from_numpy``), one intra-op torch thread. The JAX side runs on the
CPU; the port with ``device="cpu"``, its kernels' plain versions."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import QuantCard as JQuantCard
from koifish_tpu.config import SamplerCard as JSamplerCard
from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.models import backbone as jbb
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.models import model_forward as j_model_forward
from koifish_tpu.models.moe import init_moe_layer as j_init_moe
from koifish_tpu.models.moe import moe_ffn as j_moe_ffn
from koifish_tpu.quant.apply import quantize_params as j_quantize_params
from koifish_tpu.serve import engine as jengine
from koifish_tpu.serve.batching import ContinuousBatcher as JBatcher
from koifish_tpu.serve.batching import Request as JRequest
from koifish_tpu.serve.kvcache import cache_for as j_cache_for
from koifish_tpu.serve.layered import decode_step_layered as j_decode_layered
from koifish_tpu.serve.stacked import stack_layers as j_stack_layers

from koifish_tpu_torch.config import ModelCard, QuantCard, SamplerCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.models import backbone as tbb
from koifish_tpu_torch.models import moe as tmoe
from koifish_tpu_torch.models.transformer import init_params, model_forward
from koifish_tpu_torch.quant.apply import quantize_params
from koifish_tpu_torch.quant.qtensor import QTensor
from koifish_tpu_torch.serve import (ContinuousBatcher, Request, cache_for,
                                     decode_step, decode_step_layered,
                                     generate, prefill, stack_layers)

from torch_helpers import (INT4_RULES, assert_greedy_agrees, bf16_pair, f32,
                           jax_tree_to_numpy, top2_margin, torch_threads)

# ---------------------------------------------------------------------------
# the backbone layouts of tests/test_backbone.py
# ---------------------------------------------------------------------------

STD = {
    "embed_tokens": {"Embedding": []},
    "layer": {"self_attn": {"QKV": []}, "mlp": {"FFN": []},
              "# gattn": {"GAU": []}},
    "norm": {"Normal": []},
    "output": {"CLASIFY": []},
}
STAR = {
    "embed_tokens": {"Embedding": []},
    "blk *2": {"self_attn": {"QKV": []}, "mlp": {"FFN": []}},
    "norm": {"Normal": []},
    "output": {"CLASIFY": []},
}
HYBRID = {
    "embed_tokens": {"Embedding": []},
    "dense_a *1": {"self_attn": {"QKV": []}, "mlp": {"FFN": []}},
    "sparse_a *1": {"self_attn": {"QKV": []}, "mlp": {"MOE": []}},
    "dense_b *1": {"self_attn": {"QKV": []}, "mlp": {"FFN": []}},
    "sparse_b *1": {"self_attn": {"QKV": []}, "mlp": {"MOE": []}},
    "norm": {"Normal": []},
    "output": {"CLASIFY": []},
}
ALL_MOE = {
    "embed_tokens": {"Embedding": []},
    "layer": {"self_attn": {"QKV": []}, "mlp": {"MOE": []}},
    "norm": {"Normal": []},
    "output": {"CLASIFY": []},
}
_TRANSFORMER = {"Ctx": 32, "Embed": 64, "Head": 4, "KVHead": 2,
                "head_dim": 16, "Ffn": 128}
HYBRID_JM = {
    "arch": "QWEN3_MOE", "vocab_size": 128,
    "parameter": {"Layer": 4, "num_experts": 4, "num_experts_per_tok": 2,
                  "moe_intermediate_size": 64, "max_pos_embeddings": 64,
                  "transformer": _TRANSFORMER},
    "backbone": HYBRID,
}
GAU_JM = {
    "arch": "QWEN3", "vocab_size": 128,
    "parameter": {"Layer": 3, "max_pos_embeddings": 64,
                  "transformer": _TRANSFORMER},
    "backbone": {
        "embed_tokens": {"Embedding": []},
        "blk0": {"self_attn": {"QKV": []}, "mlp": {"FFN": []}},
        "gattn": {"GAU": []},
        "blk2": {"self_attn": {"QKV": []}, "mlp": {"FFN": []}},
        "norm": {"Normal": []}, "output": {"CLASIFY": []}},
}
BROWN_JM = {
    "arch": "QWEN3", "vocab_size": 128,
    "parameter": {"Layer": 3, "max_pos_embeddings": 64,
                  "transformer": dict(_TRANSFORMER, KVHead=4)},
    "backbone": {
        "embed_tokens": {"Embedding": []},
        "blk0": {"self_attn": {"QKV": []}, "mlp": {"FFN": []}},
        "blk1": {"self_attn": {"BROWN": []}, "mlp": {"FFN": []}},
        "blk2": {"self_attn": {"QKV": []}, "mlp": {"FFN": []}},
        "norm": {"Normal": []}, "output": {"CLASIFY": []}},
}
BAD = {
    "gau_then_ffn": {
        "embed_tokens": {"Embedding": []},
        "layer": {"gattn": {"GAU": []}, "mlp": {"FFN": []}},
        "norm": {"Normal": []}, "output": {"CLASIFY": []}},
    "two_qkv": {
        "embed_tokens": {"Embedding": []},
        "layer": {"a": {"QKV": []}, "b": {"QKV": []}, "mlp": {"FFN": []}},
        "norm": {"Normal": []}, "output": {"CLASIFY": []}},
    "unknown_type": {"x": {"Wormhole": []}},
    "not_a_list": {"embed_tokens": {"Embedding": 3}},
}
QWEN3_2L = {"arch": "QWEN3", "vocab_size": 128,
            "parameter": {"Layer": 2, "transformer": _TRANSFORMER}}


def _raises(fn, *a):
    """(exception type, message) of ``fn(*a)``, or None."""
    try:
        fn(*a)
    except Exception as e:          # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)
    return None


def _card_fields(card):
    return {f.name: getattr(card, f.name) for f in dataclasses.fields(card)}


@pytest.mark.parametrize("name,bb,n_layer", [
    ("std", STD, 3), ("star", STAR, 2), ("hybrid", HYBRID, 4),
    ("all_moe", ALL_MOE, 2), ("gau", GAU_JM["backbone"], 3),
    ("brown", BROWN_JM["backbone"], 3)]
    + [(f"bad_{k}", v, 2) for k, v in BAD.items()])
def test_backbone_matches_jax(name, bb, n_layer):
    """flatten, validate and the three index helpers give the JAX package's
    results, or raise its error with its message."""
    for fn in ("flatten_backbone", "validate_backbone", "moe_layer_indices",
               "gau_layer_indices", "brown_layer_indices"):
        jr = _raises(getattr(jbb, fn), bb, n_layer)
        tr = _raises(getattr(tbb, fn), bb, n_layer)
        assert jr == tr, (fn, jr, tr)
        if jr is None:
            assert getattr(jbb, fn)(bb, n_layer) == \
                getattr(tbb, fn)(bb, n_layer), fn
    if name == "std":
        types = [t for _, t in tbb.flatten_backbone(STD, 3)]
        assert types == ["EMBED"] + ["QKV", "FFN"] * 3 + ["NORMAL", "CLASIFY"]
    if name.startswith("bad"):
        assert issubclass(tbb.BackboneError, ValueError)
        with pytest.raises(tbb.BackboneError):
            tbb.validate_backbone(bb, n_layer)


@pytest.mark.parametrize("name,jm", [
    ("std", dict(QWEN3_2L, backbone=STD)),
    ("hybrid", HYBRID_JM),
    ("all_moe", dict(HYBRID_JM, backbone=ALL_MOE,
                     parameter=dict(HYBRID_JM["parameter"], Layer=2))),
    ("gau", GAU_JM), ("brown", BROWN_JM),
    ("bad_layout", dict(QWEN3_2L, backbone=BAD["two_qkv"])),
    ("moe_without_experts", dict(HYBRID_JM, parameter={
        "Layer": 4, "max_pos_embeddings": 64, "transformer": _TRANSFORMER})),
    ("all_moe_without_experts", dict(QWEN3_2L, backbone=ALL_MOE))])
def test_from_json_backbone_matches_jax(name, jm):
    """``ModelCard.from_json`` returns the JAX package's card (every field)
    or raises ``BackboneError`` with its message."""
    jr = _raises(JModelCard.from_json, jm)
    tr = _raises(ModelCard.from_json, jm)
    assert jr == tr
    if jr is not None:
        assert tr[0] == "BackboneError"
        return
    assert _card_fields(JModelCard.from_json(jm)) == \
        _card_fields(ModelCard.from_json(jm))


@pytest.mark.parametrize("jm", [GAU_JM, BROWN_JM], ids=["gau", "brown"])
def test_gau_and_brown_models_name_the_zoo(jm):
    """GAU and BROWN cards parse (as in JAX) and, since their layers are
    ported, build the JAX package's leaves and run forward; serving one
    raises ``NotImplementedError`` naming the zoo module, as the JAX
    package's ``prefill`` does (``tests/test_torch_zoo_gau_brown.py``
    holds them to JAX)."""
    card = ModelCard.from_json(jm)
    assert card.gau_layers or card.brown_layers
    with torch_threads(1):
        params = init_params(card, device="cpu")
        jparams = j_init_params(JModelCard.from_json(jm),
                                jax.random.PRNGKey(0))
        assert [sorted(lp) for lp in params["layers"]] == \
            [sorted(lp) for lp in jparams["layers"]]
        logits = model_forward(card, params,
                               torch.zeros((1, 4), dtype=torch.long))
        assert logits.shape == (1, 4, card.vocab_size)
        assert bool(torch.isfinite(logits).all())
        cache = cache_for(card, 1, 16, device="cpu")
        name = "gau" if card.gau_layers else "brown"
        with pytest.raises(NotImplementedError,
                           match=f"models/{name}.py"):
            prefill(card, params, torch.zeros((1, 4), dtype=torch.long),
                    cache, fresh=True, device="cpu")


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

FFN_CARD = dict(vocab_size=128, n_layer=2, n_embd=64, n_head=4, n_kv_head=2,
                head_dim=16, n_ffn=128, n_ctx=32, max_pos=64, n_experts=8,
                n_experts_active=2, moe_ffn=96)
# the port's f32 products of bf16 values are exact; only the order of
# their sums differs from XLA's, so the outputs agree within one bf16 ulp
# of their largest entry (measured: equal)
MOE_ULPS = 1
ROUTE_TIE = 1e-3


def _jax_routes(jcard, jlp, jx, cf):
    """The JAX moe_ffn's routing, step by step (models/moe.py:30-46)."""
    S = jx.shape[0] * jx.shape[1]
    x2 = jx.reshape(S, -1)
    logits = jnp.dot(x2, jlp["router"].astype(x2.dtype),
                     preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, gi = jax.lax.top_k(probs, jcard.n_experts_active)
    C = max(int(S * jcard.n_experts_active * cf / jcard.n_experts), 4)
    flat_i = gi.reshape(-1)
    onehot = jax.nn.one_hot(flat_i, jcard.n_experts, dtype=jnp.int32)
    slot = ((jnp.cumsum(onehot, axis=0) - 1) * onehot).sum(-1)
    return np.asarray(probs), np.asarray(gi), np.asarray(slot < C), C


@pytest.mark.parametrize("cf", [8.0, 1.25], ids=["huge_capacity", "default"])
def test_moe_ffn_matches_jax(cf):
    """The routes are the JAX package's (bar true near-ties: the k-th and
    (k+1)-th probabilities within 1e-3, reported), the capacity drops the
    same assignments, and the outputs of equally routed tokens agree within
    one bf16 ulp of the largest entry."""
    jcard = JModelCard.from_arch("QWEN3_MOE", **FFN_CARD)
    card = ModelCard.from_arch("QWEN3_MOE", **FFN_CARD)
    jlp = j_init_moe(jcard, jax.random.PRNGKey(0))
    tlp = params_from_numpy(jax_tree_to_numpy(jlp), device="cpu")
    x = np.random.default_rng(1).standard_normal((4, 16, 64)
                                                 ).astype(np.float32)
    jx, tx = bf16_pair(x)
    probs, jgi, jkeep, C = _jax_routes(jcard, jlp, jx, cf)
    with torch_threads(1):
        r = tmoe.route(card, tlp["router"], tx.reshape(-1, 64), cf)
        out = f32(tmoe.moe_ffn(card, tlp, tx, capacity_factor=cf))
    jout = f32(j_moe_ffn(jcard, jlp, jx, capacity_factor=cf))
    k = card.n_experts_active
    tgi = r.expert.reshape(-1, k).numpy()
    assert r.capacity == C
    srt = -np.sort(-probs, axis=-1)
    differ = [t for t in range(len(tgi)) if set(tgi[t]) != set(jgi[t])]
    for t in differ:
        gap = srt[t, k - 1] - srt[t, k]
        print(f"token {t}: routes differ at a near-tie, gap {gap:.2e}")
        assert gap < ROUTE_TIE
    same = [t for t in range(len(tgi)) if t not in differ]
    if not differ:
        assert np.array_equal(r.keep.numpy(), jkeep)
    assert (cf == 1.25) == (not jkeep.all())   # the default drops some
    tol = MOE_ULPS * 2.0 ** -8 * np.abs(jout).max()
    rows = lambda a: a.reshape(-1, 64)[same]
    np.testing.assert_allclose(rows(out), rows(jout), rtol=0, atol=tol)


def test_moe_capacity_drops_at_decode():
    """A known quirk of the reference, held in the port: at decode (T 1)
    the capacity is its floor of 4 for B <= 51 with k 8 over 128 experts,
    so an expert chosen by more than 4 lanes drops the rest."""
    card = ModelCard.from_arch("QWEN3_MOE", **dict(
        FFN_CARD, n_experts=128, n_experts_active=8))
    assert [tmoe.capacity(card, b) for b in (1, 8, 51, 52)] == [4, 4, 4, 4]
    assert tmoe.capacity(card, 64) == 5
    # lane t's 8 experts: expert 3 first, then 7 of its own
    router = torch.zeros((64, 128), dtype=torch.bfloat16)
    router[:, 3] = 10.0
    for t in range(8):
        router[t, 8 + 7 * t: 15 + 7 * t] = 5.0
    x = torch.eye(64, dtype=torch.bfloat16)[:8]
    r = tmoe.route(card, router, x)
    assert r.expert.reshape(8, 8)[:, 0].tolist() == [3] * 8
    dropped = (~r.keep).reshape(8, 8)
    assert dropped[:, 0].tolist() == [False] * 4 + [True] * 4
    assert int(dropped.sum()) == 4           # lanes 4-7 lose expert 3


# ---------------------------------------------------------------------------
# MoE models: forward, serving paths, batcher, quantize, train
# ---------------------------------------------------------------------------

MOE_CARD = dict(vocab_size=256, n_layer=2, n_embd=128, n_head=2,
                n_kv_head=1, head_dim=64, n_ffn=256, n_ctx=64, max_pos=128,
                n_experts=4, n_experts_active=2, moe_ffn=64)
LOGIT_TOL = 5e-2


@functools.lru_cache(maxsize=None)
def _bf16_models(kind):
    """(JAX card, port card, JAX bf16 params): "moe" is a 2-layer all-MoE
    card, "hybrid" HYBRID_JM's 4 layers, dense and MoE by turns."""
    if kind == "moe":
        jcard = JModelCard.from_arch("QWEN3_MOE", **MOE_CARD)
        card = ModelCard.from_arch("QWEN3_MOE", **MOE_CARD)
        return jcard, card, j_init_params(jcard, jax.random.PRNGKey(3))
    jcard, card = (JModelCard.from_json(HYBRID_JM),
                   ModelCard.from_json(HYBRID_JM))
    return jcard, card, j_init_params(jcard, jax.random.PRNGKey(4))


@functools.lru_cache(maxsize=None)
def _moe_models(kind):
    """(JAX card, port card, JAX params, port params): the "moe" card with
    INT4 attention, the "hybrid" card bf16 (``_bf16_models``)."""
    jcard, card, jp = _bf16_models(kind)
    if kind == "moe":
        jp = j_quantize_params(jp, JQuantCard.from_json(INT4_RULES), jcard)
    return jcard, card, jp, params_from_numpy(jax_tree_to_numpy(jp),
                                              device="cpu")


def _prompt(card, B, T, seed):
    return np.random.default_rng(seed).integers(
        0, card.vocab_size, (B, T)).astype(np.int32)


@pytest.mark.parametrize("kind", ["moe", "hybrid"])
def test_moe_forward_matches_jax(kind):
    """``init_params`` builds the JAX package's layers (router and expert
    stacks where it does), and ``model_forward``'s logits agree."""
    jcard, card, jp, tp = _moe_models(kind)
    with torch_threads(1):
        own = init_params(card, device="cpu")
    for jl, ol, tl in zip(jp["layers"], own["layers"], tp["layers"]):
        assert sorted(jl) == sorted(ol) == sorted(tl)
        if "router" in ol:
            assert ol["egate"].shape == (card.n_experts, card.n_embd,
                                         card.moe_ffn)
            assert ol["edown"].shape == (card.n_experts, card.moe_ffn,
                                         card.n_embd)
    if kind == "hybrid":
        assert ["router" in lp for lp in own["layers"]] == \
            [False, True, False, True]
    toks = _prompt(card, 2, 12, seed=5)
    jl = f32(jax.jit(lambda p, t: j_model_forward(jcard, p, t))(
        jp, jnp.asarray(toks)))
    with torch_threads(1):
        tl = f32(model_forward(card, tp, torch.from_numpy(toks).long()))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_TOL)


_j_step = jax.jit(j_decode_layered, static_argnames=("card", "streaming"))
_j_prefill = jax.jit(jengine.prefill, static_argnames=("card", "fresh"))


@pytest.mark.parametrize("kind,fmt", [("moe", "int8"), ("hybrid", "bf16")])
def test_moe_serving_matches_jax(kind, fmt):
    """Prefill and 8 greedy decode steps: the JAX package's ``generate``
    tokens, equal in the port's ``generate`` (layered cache) up to the
    first JAX near-tie (``assert_greedy_agrees``, which compares at least
    half of them); every step's
    logits within 5e-2 teacher-forced on the JAX tokens through the port's
    list, stacked and layered decode paths."""
    jcard, card, jp, tp = _moe_models(kind)
    B, P, new = 2, 6, 8
    prompt = _prompt(card, B, P, seed=6)
    jc = j_cache_for(jcard, B, 32, fmt=JQFormat(fmt), layered=True)
    jtoks, _ = jengine.generate(jcard, jp, jnp.asarray(prompt), jc,
                                sampler=JSamplerCard(temperature=0.0),
                                max_new_tokens=new, decode_chunk=4)
    jtoks = np.asarray(jtoks)
    with torch_threads(1):
        tc = cache_for(card, B, 32, fmt=QFormat(fmt), layered=True,
                       device="cpu")
        ttoks, _ = generate(card, tp, torch.from_numpy(prompt), tc,
                            sampler=SamplerCard(temperature=0.0),
                            max_new_tokens=new, decode_chunk=4, device="cpu")

    # teacher-forced logits: JAX's layered step vs the port's three paths
    jc = j_cache_for(jcard, B, 32, fmt=JQFormat(fmt), layered=True)
    jl, jc = _j_prefill(jcard, jp, jnp.asarray(prompt), jc, fresh=True)
    # a hybrid card's layers differ: neither package stacks them
    stacked = stack_layers(tp)
    assert (stacked is None) == (kind == "hybrid") == \
        (j_stack_layers(jp) is None)
    paths = ("list", "layered") + (("stacked",) if stacked else ())
    with torch_threads(1):
        caches = {}
        for path in paths:
            c = cache_for(card, B, 32, fmt=QFormat(fmt),
                          layered=path == "layered", device="cpu")
            tl, caches[path] = prefill(card, tp, torch.from_numpy(prompt), c,
                                       fresh=True, device="cpu")
            np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL)
        margins = [top2_margin(jl)]
        for i in range(new - 1):
            tok = jtoks[:, i]
            jl, jc = _j_step(jcard, jp, jnp.asarray(tok), jc, streaming=True)
            margins.append(top2_margin(jl))
            t = torch.from_numpy(tok.copy())
            outs = {}
            outs["list"], caches["list"] = decode_step(
                card, tp, t, caches["list"])
            if stacked:
                outs["stacked"], caches["stacked"] = decode_step(
                    card, stacked, t, caches["stacked"])
            outs["layered"], caches["layered"] = decode_step_layered(
                card, tp, t, caches["layered"])
            for path, tl in outs.items():
                np.testing.assert_allclose(f32(tl), f32(jl), rtol=0,
                                           atol=LOGIT_TOL, err_msg=path)
    assert_greedy_agrees(ttoks, jtoks, margins)


def test_moe_batcher_matches_jax():
    """Both packages' ContinuousBatcher over the all-MoE card at
    temperature 0: every request's tokens are equal (MoE layers route the
    whole pool's lanes together, in both)."""
    jcard, card, jp, tp = _moe_models("moe")
    reqs = [([5, 6, 7], 8), ([9, 10, 11, 12], 6), ([40] * 20, 7),
            ([3, 1], 5)]
    jb = JBatcher(jcard, jp, n_slots=2, cache_size=64,
                  kv_fmt=JQFormat("int8"),
                  sampler=JSamplerCard(temperature=0.0), decode_chunk=4)
    with torch_threads(1):
        tb = ContinuousBatcher(card, tp, n_slots=2, cache_size=64,
                               kv_fmt=QFormat.INT8,
                               sampler=SamplerCard(temperature=0.0),
                               decode_chunk=4, device="cpu")
        for i, (p, n) in enumerate(reqs):
            jb.submit(JRequest(rid=i, prompt=list(p), max_new=n))
            tb.submit(Request(rid=i, prompt=list(p), max_new=n))
        jres, tres = jb.run(), tb.run()
    assert sorted(tres) == sorted(jres) == list(range(len(reqs)))
    for i, (_, n) in enumerate(reqs):
        assert tres[i].tokens == jres[i].tokens, i
        assert len(tres[i].tokens) == n


def test_moe_stack_layers_matches_jax():
    """The stacked form of an all-MoE model holds the JAX package's
    [L, ...] leaves (3-D expert stacks become [L, Ne, ...])."""
    jcard, card, jp, tp = _moe_models("moe")
    js = j_stack_layers(jp)
    ts = stack_layers(tp)
    assert ts["layers"]["egate"].shape == tuple(js["layers"]["egate"].shape)
    conv = params_from_numpy(jax_tree_to_numpy(js), device="cpu")
    for key in ("router", "egate", "eup", "edown"):
        assert torch.equal(conv["layers"][key], ts["layers"][key])


@pytest.mark.parametrize("kind", ["moe", "hybrid"])
def test_quantize_params_leaves_what_jax_leaves(kind):
    """``quantize_params`` with INT4 self_attn/mlp rules quantizes the
    leaves the JAX package quantizes: only 2-D weights whose path matches
    a rule. The 3-D expert stacks and the router stay bf16, bit for bit."""
    jcard, card, jp = _bf16_models(kind)
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    rules = dict(INT4_RULES, group_size=32)
    jq = j_quantize_params(jp, JQuantCard.from_json(rules), jcard)
    with torch_threads(1):
        tq = quantize_params(tp, QuantCard.from_json(rules), card,
                             device="cpu")
    from koifish_tpu.quant.qtensor import QTensor as JQTensor
    for jl, tl, bl in zip(jq["layers"], tq["layers"], tp["layers"]):
        assert {k for k, v in jl.items() if isinstance(v, JQTensor)} == \
            {k for k, v in tl.items() if isinstance(v, QTensor)}
        for key in ("router", "egate", "eup", "edown"):
            if key in bl:
                assert tl[key] is bl[key]
    assert any(isinstance(v, QTensor) for v in tq["layers"][0].values())


# the bf16 loss curves of tests/test_torch_train.py agree within 1e-2
CURVE_TOL = 1e-2


def test_moe_trains_like_jax():
    """5 steps of ``train_loop`` (SR off) on the all-MoE card: the loss
    curve is the JAX package's within the bf16 curves' 1e-2."""
    from koifish_tpu.config import TrainCard as JTrainCard
    from koifish_tpu.train.trainer import init_train_state as j_init_state
    from koifish_tpu.train.trainer import train_loop as j_train_loop

    from koifish_tpu_torch.config import TrainCard
    from koifish_tpu_torch.io.convert import train_state_from_numpy
    from koifish_tpu_torch.train.trainer import train_loop
    from torch_helpers import jax_train_state_to_numpy

    card_kw = dict(MOE_CARD, vocab_size=64)
    jcard = JModelCard.from_arch("QWEN3_MOE", **card_kw)
    card = ModelCard.from_arch("QWEN3_MOE", **card_kw)
    tkw = dict(batch=4, lr=1e-2, warmup=2, stochastic_round=False)
    jt, tt = JTrainCard(**tkw), TrainCard(**tkw)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, 64, (1, 4, 17)).astype(np.int32)
               for _ in range(5)]
    jstate = j_init_state(jcard, jt)
    tstate = train_state_from_numpy(jax_train_state_to_numpy(jstate),
                                    device="cpu")
    _, jinfo = j_train_loop(jcard, jt, jstate,
                            [{"tokens": jnp.asarray(b)} for b in batches],
                            total_steps=5)
    with torch_threads(1):
        _, tinfo = train_loop(card, tt, tstate,
                              [{"tokens": torch.from_numpy(b).long()}
                               for b in batches], total_steps=5)
    assert len(tinfo.losses) == len(jinfo.losses) == 5
    np.testing.assert_allclose(tinfo.losses, jinfo.losses, rtol=0,
                               atol=CURVE_TOL)
