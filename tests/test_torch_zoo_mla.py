"""PyTorch port vs the JAX package: Multi-head Latent Attention
(``models/mla.py``, the MLA branches of the decoder and its serving paths,
and ``serve/mla_cache.py``'s latent-cache decode).

A tiny DeepSeek-style card at the real head split (qk_nope 128, qk_rope
64, v 128: d 192 against dv 128), weights from a JAX init carried across
with ``params_from_numpy``, INT4 RTN g128 where the rules match, one
intra-op torch thread; the port runs its kernels' plain versions."""
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
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.models import model_forward as j_model_forward
from koifish_tpu.models.mla import mla_qkv as j_mla_qkv
from koifish_tpu.quant.apply import quantize_params as j_quantize_params
from koifish_tpu.quant.qtensor import QTensor as JQTensor
from koifish_tpu.serve import engine as jengine
from koifish_tpu.serve import mla_cache as jmla
from koifish_tpu.serve.kvcache import cache_for as j_cache_for
from koifish_tpu.serve.layered import decode_step_layered as j_decode_layered

from koifish_tpu_torch.config import ModelCard, QuantCard, SamplerCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.models import mla as tmla
from koifish_tpu_torch.models.transformer import init_params, model_forward
from koifish_tpu_torch.quant.apply import quantize_params
from koifish_tpu_torch.quant.qtensor import QTensor
from koifish_tpu_torch.serve import (cache_for, decode_step,
                                     decode_step_layered, generate, prefill,
                                     stack_layers)
from koifish_tpu_torch.serve import mla_cache as tmla_cache
from koifish_tpu_torch.utils import kernel_log

from torch_helpers import (INT4_RULES, assert_greedy_agrees, bf16_pair, f32,
                           jax_tree_to_numpy, top2_margin, torch_threads)

MLA = dict(vocab_size=256, n_layer=2, n_embd=128, n_head=2, n_kv_head=2,
           n_ffn=256, n_ctx=64, max_pos=128)
MLA_DIMS = dict(attn="mla", q_lora_rank=32, kv_lora_rank=64,
                qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                head_dim=192)
LOGIT_TOL = 5e-2
# tests/test_models.py::test_mla_latent_cache_matches_standard's bound
LATENT_TOL = 2e-2


def _cards(q_lora=32):
    dims = dict(MLA_DIMS, q_lora_rank=q_lora)
    jcard = dataclasses.replace(JModelCard.from_arch("DEEPSEEK", **MLA),
                                **dims)
    card = dataclasses.replace(ModelCard.from_arch("DEEPSEEK", **MLA),
                               **dims)
    return jcard, card


@functools.lru_cache(maxsize=None)
def _models(quant=True):
    jcard, card = _cards()
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    if quant:
        jp = j_quantize_params(jp, JQuantCard.from_json(INT4_RULES), jcard)
    return jcard, card, jp, params_from_numpy(jax_tree_to_numpy(jp),
                                              device="cpu")


def _prompt(B, T, seed):
    return np.random.default_rng(seed).integers(
        0, MLA["vocab_size"], (B, T)).astype(np.int32)


def test_mla_qkv_matches_jax():
    """q, k [B, T, H, 192] and v [B, T, H, 128] of one layer agree with
    the JAX package's (bf16: 2 ulps of the largest entry), the rope table
    built once for the card and device."""
    jcard, card, jp, tp = _models(quant=False)
    x = np.random.default_rng(2).standard_normal((2, 7, 128)
                                                 ).astype(np.float32)
    jx, tx = bf16_pair(x)
    pos = np.arange(7, dtype=np.int32)
    jq = jax.jit(j_mla_qkv, static_argnums=0)(jcard, jp["layers"][0], jx,
                                              jnp.asarray(pos))
    with torch_threads(1):
        tq = tmla.mla_qkv(card, tp["layers"][0], tx, torch.arange(7))
    for j, t, d in zip(jq, tq, (192, 192, 128)):
        assert t.shape == (2, 7, 2, d)
        np.testing.assert_allclose(f32(t), f32(j), rtol=0,
                                   atol=2 * 2.0 ** -8 * np.abs(f32(j)).max())
    assert tmla.mla_rope(card, "cpu") is tmla.mla_rope(card, "cpu")


@pytest.mark.parametrize("q_lora", [32, 0], ids=["q_lora", "direct_q"])
def test_mla_forward_matches_jax(q_lora):
    """``init_params`` builds the JAX package's MLA layers, and
    ``model_forward``'s logits agree within 5e-2; the prefill's attention
    (dv != d) logs a flash_attention fallback, as in the JAX package."""
    jcard, card = _cards(q_lora)
    jp = j_init_params(jcard, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    with torch_threads(1):
        own = init_params(card, device="cpu")
    for jl, ol in zip(jp["layers"], own["layers"]):
        assert sorted(jl) == sorted(ol)
        assert all(tuple(jl[k].shape) == tuple(ol[k].shape) for k in jl)
    toks = _prompt(2, 10, seed=3)
    jl = f32(jax.jit(lambda p, t: j_model_forward(jcard, p, t))(
        jp, jnp.asarray(toks)))
    kernel_log.reset_launches()
    with torch_threads(1):
        tl = f32(model_forward(card, tp, torch.from_numpy(toks).long()))
    assert kernel_log.fallbacks().get("flash_attention") == card.n_layer
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_TOL)


_j_step = jax.jit(j_decode_layered, static_argnames=("card", "streaming"))
_j_prefill = jax.jit(jengine.prefill, static_argnames=("card", "fresh"))


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_mla_serving_matches_jax(fmt):
    """MLA through ``generate`` with a BF16 or INT8 cache of 192-wide keys
    and 128-wide values: 8 greedy tokens equal to the JAX package's up to
    its first near-tie (``assert_greedy_agrees``, at least half compared:
    the INT8 run meets a bf16 tie at step 3), and every step's logits within
    5e-2 teacher-forced on
    the JAX tokens
    through the list, stacked and layered decode paths (the INT8 cache
    takes row 7's fused write-and-attend at d 192, dv 128)."""
    jcard, card, jp, tp = _models()
    B, P, new = 2, 6, 8
    prompt = _prompt(B, P, seed=4)
    jc = j_cache_for(jcard, B, 32, fmt=JQFormat(fmt), layered=True)
    jtoks, _ = jengine.generate(jcard, jp, jnp.asarray(prompt), jc,
                                sampler=JSamplerCard(temperature=0.0),
                                max_new_tokens=new, decode_chunk=4)
    jtoks = np.asarray(jtoks)
    with torch_threads(1):
        tc = cache_for(card, B, 32, fmt=QFormat(fmt), layered=True,
                       device="cpu")
        assert tc.k[0].shape[-1] == 192
        assert tc.v[0].shape[-1] == 128
        ttoks, _ = generate(card, tp, torch.from_numpy(prompt), tc,
                            sampler=SamplerCard(temperature=0.0),
                            max_new_tokens=new, decode_chunk=4, device="cpu")

    jc = j_cache_for(jcard, B, 32, fmt=JQFormat(fmt), layered=True)
    jl, jc = _j_prefill(jcard, jp, jnp.asarray(prompt), jc, fresh=True)
    stacked = stack_layers(tp)
    with torch_threads(1):
        caches = {}
        for path in ("list", "stacked", "layered"):
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
            outs["list"], caches["list"] = decode_step(card, tp, t,
                                                       caches["list"])
            outs["stacked"], caches["stacked"] = decode_step(
                card, stacked, t, caches["stacked"])
            outs["layered"], caches["layered"] = decode_step_layered(
                card, tp, t, caches["layered"])
            for path, tl in outs.items():
                np.testing.assert_allclose(f32(tl), f32(jl), rtol=0,
                                           atol=LOGIT_TOL, err_msg=path)
    assert_greedy_agrees(ttoks, jtoks, margins)


def test_mla_latent_cache_matches_jax_and_the_standard_path():
    """``mla_prefill`` and three ``mla_decode_step``s: the logits within
    5e-2 of the JAX package's latent path, and within 2e-2 of the port's
    standard (materialised K/V) path, as the JAX package holds its own;
    the latent cache is smaller per token."""
    jcard, card, jp, tp = _models()
    B, P = 2, 6
    prompt = _prompt(B, P, seed=5)
    j_prefill = jax.jit(jmla.mla_prefill, static_argnums=0)
    j_step = jax.jit(jmla.mla_decode_step, static_argnums=0)
    jc = jmla.mla_cache_for(jcard, B, 32)
    jl, jc = j_prefill(jcard, jp, jnp.asarray(prompt), jc)
    with torch_threads(1):
        tc = tmla_cache.mla_cache_for(card, B, 32, device="cpu")
        tl, tc = tmla_cache.mla_prefill(card, tp, torch.from_numpy(prompt),
                                        tc)
        sc = cache_for(card, B, 32, device="cpu")
        sl, sc = prefill(card, tp, torch.from_numpy(prompt), sc,
                         device="cpu")
    assert int(tc.pos[0]) == P
    np.testing.assert_allclose(f32(tl), f32(jl), rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(f32(tl), f32(sl), rtol=0, atol=LATENT_TOL)
    np.testing.assert_allclose(f32(tc.c_kv[:, :, :P]),
                               f32(jc.c_kv[:, :, :P]), rtol=0, atol=3e-2)
    per_tok = tc.c_kv.shape[-1] + tc.k_rope.shape[-1]
    assert per_tok == 64 + 64 < card.n_kv_head * (192 + 128)
    for t in range(3):
        tok = np.full((B,), 9 + t, np.int32)
        jl, jc = j_step(jcard, jp, jnp.asarray(tok), jc)
        with torch_threads(1):
            tl, tc = tmla_cache.mla_decode_step(card, tp,
                                                torch.from_numpy(tok), tc)
            sl, sc = decode_step(card, tp, torch.from_numpy(tok), sc)
        np.testing.assert_allclose(f32(tl), f32(jl), rtol=0, atol=LOGIT_TOL)
        np.testing.assert_allclose(f32(tl), f32(sl), rtol=0,
                                   atol=LATENT_TOL)
    assert int(tc.pos[0]) == P + 3


def test_quantize_params_leaves_mla_projections():
    """With INT4 self_attn/mlp rules the JAX package quantizes ``o`` and
    the dense FFN of an MLA layer and leaves ``wq*`` and ``wkv_*`` (no
    rule path matches them); the port quantizes the same leaves."""
    jcard, card, jp, tp = _models(quant=False)
    jq = j_quantize_params(jp, JQuantCard.from_json(INT4_RULES), jcard)
    with torch_threads(1):
        tq = quantize_params(tp, QuantCard.from_json(INT4_RULES), card,
                             device="cpu")
    for jl, tl in zip(jq["layers"], tq["layers"]):
        quant = {k for k, v in jl.items() if isinstance(v, JQTensor)}
        assert quant == {k for k, v in tl.items() if isinstance(v, QTensor)}
        assert quant == {"o", "gate", "up", "down"}


def test_mla_trains_like_jax():
    """5 steps of ``train_loop`` (SR off) on the direct-q MLA card: the
    loss curve is the JAX package's within the bf16 curves' 1e-2."""
    from koifish_tpu.config import TrainCard as JTrainCard
    from koifish_tpu.train.trainer import init_train_state as j_init_state
    from koifish_tpu.train.trainer import train_loop as j_train_loop

    from koifish_tpu_torch.config import TrainCard
    from koifish_tpu_torch.io.convert import train_state_from_numpy
    from koifish_tpu_torch.train.trainer import train_loop
    from torch_helpers import jax_train_state_to_numpy

    jcard, card = _cards(q_lora=0)
    jcard = dataclasses.replace(jcard, vocab_size=64)
    card = dataclasses.replace(card, vocab_size=64)
    tkw = dict(batch=4, lr=1e-2, warmup=2, stochastic_round=False)
    jt, tt = JTrainCard(**tkw), TrainCard(**tkw)
    rng = np.random.default_rng(8)
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
    np.testing.assert_allclose(tinfo.losses, jinfo.losses, rtol=0, atol=1e-2)


def test_from_hf_reads_deepseek_v2_lite_as_jax_does():
    """A known quirk of the reference, held in the port: ``from_hf`` reads
    ``num_experts``, which DeepSeek's config.json does not have (it names
    its experts ``n_routed_experts``), so DeepSeek-V2-Lite's card has MLA
    attention and a dense 10944-wide FFN on every layer, in both packages
    (chip_smoke.py's DEEPSEEK_V2_LITE holds the published values)."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    hf = chip_smoke.DEEPSEEK_V2_LITE
    jcard, card = JModelCard.from_hf(hf), ModelCard.from_hf(hf)
    fields = [f.name for f in dataclasses.fields(card)]
    assert {f: getattr(card, f) for f in fields} == \
        {f: getattr(jcard, f) for f in fields}
    assert (card.attn, card.n_experts, card.n_ffn, card.head_dim,
            card.n_kv_head, card.q_lora_rank) == ("mla", 0, 10944, 192, 16, 0)
    assert hf["n_routed_experts"] == 64
