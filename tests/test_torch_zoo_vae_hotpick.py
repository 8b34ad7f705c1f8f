"""PyTorch port vs the JAX package: EmbedVAE and the LLAMA_VAE arch
(``models/embed_vae.py``), HotPick (``models/hotpick.py``), and the new
leaves' carriage across (``io/convert.py``).

Tiny cards, weights from JAX inits carried across with
``params_from_numpy``, inputs from numpy seeds, one intra-op torch thread;
JAX on the CPU, the port with ``device="cpu"``.

Exact: ``pick_hot``'s kept neurons and the picked QTensors' codes and
scales (the JAX package's energies fed to both: the eager requantization
is byte for byte); every leaf's bytes through ``params_from_numpy``.
Tolerances: the VAE's f32 outputs and losses within 1e-5 relative (f32
matmuls summed in another order), its bf16 ones within 2^-6 of the largest
entry; ``train_embed_vae``'s curve within 1e-4 relative (an f32 Adam-like
update; XLA fuses its multiply-adds); activation energies within 1e-2 of
the largest (bf16 activations); logits 2e-2; loss curves 1e-2; greedy
tokens as ``assert_greedy_agrees`` holds them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import QuantCard as JQuantCard
from koifish_tpu.config import SamplerCard as JSamplerCard
from koifish_tpu.config import TrainCard as JTrainCard
from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.models import embed_vae as jvae
from koifish_tpu.models import hotpick as jhot
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.models import model_forward as j_model_forward
from koifish_tpu.quant.apply import quantize_params as j_quantize_params
from koifish_tpu.quant.qtensor import QTensor as JQTensor
from koifish_tpu.serve import engine as jengine
from koifish_tpu.serve.kvcache import cache_for as j_cache_for
from koifish_tpu.serve.layered import decode_step_layered as j_decode_layered
from koifish_tpu.train.trainer import init_train_state as j_init_state
from koifish_tpu.train.trainer import train_loop as j_train_loop

from koifish_tpu_torch.config import ModelCard, SamplerCard, TrainCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.io.convert import (params_from_numpy,
                                          train_state_from_numpy)
from koifish_tpu_torch.models import embed_vae as tvae
from koifish_tpu_torch.models import hotpick as thot
from koifish_tpu_torch.models.transformer import init_params, model_forward
from koifish_tpu_torch.quant.qtensor import QTensor
from koifish_tpu_torch.serve import cache_for, generate
from koifish_tpu_torch.train.trainer import train_loop
from koifish_tpu_torch.utils.tree import leaves

from torch_helpers import (LOGIT_TOL, assert_greedy_agrees, bf16_pair, f32,
                           jax_train_state_to_numpy, jax_tree_to_numpy,
                           top2_margin, torch_threads, zoo_cli_losses)

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -6
VAE_CURVE_TOL = 1e-4
ENERGY_TOL = 1e-2
CURVE_TOL = 1e-2
TINY = dict(vocab_size=128, n_layer=2, n_embd=64, n_head=4, n_kv_head=2,
            head_dim=16, n_ctx=32, max_pos=64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# EmbedVAE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embed_vae_blocks_match_jax(dtype):
    """``encode``, ``decode`` and ``reconstruction_loss`` of a two-level
    VAE (64 -> 32 -> 16) on the JAX init, f32 and bf16 (the LLAMA_VAE
    arch's dtype); ``init_embed_vae`` builds the JAX shapes."""
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jv = jvae.init_embed_vae(jax.random.PRNGKey(2), [64, 32, 16], dtype=jdt)
    tv = params_from_numpy(jax_tree_to_numpy(jv), device="cpu")
    own = tvae.init_embed_vae(torch.Generator().manual_seed(0), [64, 32, 16])
    assert [[tuple(x.shape) for x in layer.values()] for layer in
            own["enc"] + own["dec"]] == \
        [[x.shape for x in layer.values()] for layer in jv["enc"] + jv["dec"]]
    x = np.random.default_rng(3).standard_normal((40, 64)).astype(np.float32)
    jx, tx = (jnp.asarray(x), torch.from_numpy(x)) if dtype == "f32" \
        else bf16_pair(x)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    jz, tz = jvae.encode(jv, jx), tvae.encode(tv, tx)
    assert _rel(f32(tz), f32(jz)) < tol
    assert _rel(f32(tvae.decode(tv, tz)), f32(jvae.decode(jv, jz))) < tol
    assert _rel(f32(tvae.reconstruction_loss(tv, tx)),
                f32(jvae.reconstruction_loss(jv, jx))) < tol
    if dtype == "f32":
        assert _rel(f32(tvae.compress_embeddings(tx, tv)),
                    f32(jvae.compress_embeddings(jx, jv))) < tol


def test_train_embed_vae_matches_jax():
    """20 steps of ``train_embed_vae`` (batch 64 of a [256, 64] table): the
    same rows a step (the key's ``randint``), the same initial VAE (the
    JAX package's, drawn from the same key), the loss curve and the trained
    VAE within 1e-4 relative."""
    wte = np.random.default_rng(4).standard_normal((256, 64)).astype(
        np.float32)
    key = jax.random.PRNGKey(6)
    jv, jl = jvae.train_embed_vae(jnp.asarray(wte), [64, 24], steps=20,
                                  lr=3e-3, batch=64, key=key)
    init = params_from_numpy(jax_tree_to_numpy(
        jvae.init_embed_vae(key, [64, 24])), device="cpu")
    tv, tl = tvae.train_embed_vae(torch.from_numpy(wte), [64, 24], steps=20,
                                  lr=3e-3, batch=64,
                                  key=np.asarray(jax.random.key_data(key)
                                                 if jnp.issubdtype(
                                                     key.dtype,
                                                     jax.dtypes.prng_key)
                                                 else key), vae=init)
    assert len(tl) == len(jl) == 20 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=VAE_CURVE_TOL)
    for tx, jx in zip(leaves(tv), jax.tree_util.tree_leaves(jv)):
        assert _rel(f32(tx), f32(jx)) < VAE_CURVE_TOL


def _vae_models():
    kw = dict(TINY, n_kv_head=4, n_ffn=128, token_embeds=(24,))
    jcard = JModelCard.from_arch("LLAMA_VAE", **kw)
    card = ModelCard.from_arch("LLAMA_VAE", **kw)
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    return jcard, card, jp, params_from_numpy(jax_tree_to_numpy(jp),
                                              device="cpu")


def test_llama_vae_model_matches_jax_and_trains_like_it():
    """LLAMA_VAE: ``init_params`` builds the ``evae`` stack (bf16, E -> 24
    -> E) and JAX's leaves; the logits agree; 5 steps of ``train_loop``
    (SR off) give the JAX package's curve within 1e-2."""
    jcard, card, jp, tp = _vae_models()
    own = init_params(card, device="cpu")
    assert own["evae"]["enc"][0]["w"].shape == (64, 24)
    assert own["evae"]["enc"][0]["w"].dtype == torch.bfloat16
    assert sorted(own) == sorted(jp)
    toks = np.random.default_rng(5).integers(0, 128, (2, 12)).astype(
        np.int32)
    jl = f32(jax.jit(lambda p, t: j_model_forward(jcard, p, t))(
        jp, jnp.asarray(toks)))
    tl = f32(model_forward(card, tp, torch.from_numpy(toks).long()))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_TOL)
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


def test_koifish_llama_vae_cli_matches_jax(tmp_path, monkeypatch):
    """``koifish`` on a tiny LLAMA_VAE config (``token_embeds [24]``, as
    ``tests/test_cli.py:482-520``), the port from the JAX init: the loss
    curve within 1e-2 of the JAX CLI's, and falling."""
    jl, tl, res = zoo_cli_losses(tmp_path, monkeypatch, "LLAMA_VAE",
                                 {"token_embeds": [24]})
    assert res["card"].token_embeds == (24,)
    assert "evae" in res["state"].params
    assert len(tl) == len(jl) == 6
    np.testing.assert_allclose(tl, jl, rtol=0, atol=CURVE_TOL)
    assert tl[-1] < tl[0]


# ---------------------------------------------------------------------------
# HotPick
# ---------------------------------------------------------------------------

HOT_CASES = {   # (arch, quantizer card or None); n_ffn 512, keep 0.5 -> 256
    "qwen3_int4_g128": ("QWEN3", {"self_attn": {"bits": 4},
                                  "mlp": {"bits": 4}, "group_size": 128}),
    "qwen3_int8_g32": ("QWEN3", {"mlp": {"bits": 8}, "group_size": 32}),
    "gpt2_bf16": ("GPT2", None),
}


def _hot_models(case):
    arch, qc = HOT_CASES[case]
    kw = dict(TINY, n_ffn=512)
    jcard, card = JModelCard.from_arch(arch, **kw), ModelCard.from_arch(
        arch, **kw)
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    if qc is not None:
        jp = j_quantize_params(jp, JQuantCard.from_json(qc), jcard)
    return jcard, card, jp, params_from_numpy(jax_tree_to_numpy(jp),
                                              device="cpu")


def _calib(B=4, T=16):
    return np.random.default_rng(1).integers(0, 128, (B, T)).astype(
        np.int32)


@pytest.mark.parametrize("case", list(HOT_CASES))
def test_pick_hot_matches_jax_byte_for_byte(case):
    """``ffn_activation_energy`` within 1e-2 of the JAX package's; then,
    both fed JAX's energies, ``pick_hot`` keeps the same 256 neurons in
    the same order and its picked weights equal JAX's: quantized gate/up
    (fc) columns sliced, the requantized down (proj) rows' codes and
    scales byte for byte, bf16 slices bit for bit; the picked model's
    logits agree."""
    jcard, card, jp, tp = _hot_models(case)
    calib = _calib()
    je = jax.jit(lambda p, t: jhot.ffn_activation_energy(jcard, p, t))(
        jp, jnp.asarray(calib))
    te = thot.ffn_activation_energy(card, tp, torch.from_numpy(calib).long())
    assert len(te) == card.n_layer and te[0].shape == (512,)
    for a, b in zip(te, je):
        assert _rel(f32(a), f32(b)) < ENERGY_TOL
    jcard2, jp2 = jhot.pick_hot(jcard, jp, je, keep=0.5)
    card2, tp2 = thot.pick_hot(
        card, tp, [torch.from_numpy(np.array(e)) for e in je], keep=0.5)
    assert card2.n_ffn == jcard2.n_ffn == 256
    for jl, tl in zip(jp2["layers"], tp2["layers"]):
        assert sorted(jl) == sorted(tl)
        for k in jl:
            j, t = jl[k], tl[k]
            if isinstance(j, JQTensor):
                assert isinstance(t, QTensor) and t.shape == j.shape, k
                assert (t.fmt.value, t.group) == (j.fmt.value, j.group), k
                for f in ("codes", "scales", "zeros"):
                    jf = getattr(j, f)
                    if jf is None:
                        assert getattr(t, f) is None
                        continue
                    np.testing.assert_array_equal(
                        getattr(t, f).numpy().view(np.uint8),
                        np.asarray(jf).view(np.uint8), err_msg=f"{k}.{f}")
            else:
                np.testing.assert_array_equal(f32(t), f32(j), err_msg=k)
    toks = _calib(2, 12)
    jlg = f32(jax.jit(lambda p, t: j_model_forward(jcard2, p, t))(
        jp2, jnp.asarray(toks)))
    tlg = f32(model_forward(card2, tp2, torch.from_numpy(toks).long()))
    np.testing.assert_allclose(tlg, jlg, rtol=0, atol=LOGIT_TOL)


_j_prefill = jax.jit(jengine.prefill, static_argnames=("card", "fresh"))
_j_step = jax.jit(j_decode_layered, static_argnames=("card", "streaming"))


def test_picked_model_serves_like_jax():
    """The INT4 g128 picked model (down K 256) through ``generate`` with an
    INT8 layered cache: the JAX package's greedy tokens up to its first
    near-tie."""
    jcard, card, jp, tp = _hot_models("qwen3_int4_g128")
    je = jax.jit(lambda p, t: jhot.ffn_activation_energy(jcard, p, t))(
        jp, jnp.asarray(_calib()))
    jcard, jp = jhot.pick_hot(jcard, jp, je, keep=0.5)
    card, tp = thot.pick_hot(
        card, tp, [torch.from_numpy(np.array(e)) for e in je], keep=0.5)
    B, P, new = 2, 6, 8
    prompt = _calib(B, P)
    jc = j_cache_for(jcard, B, 32, fmt=JQFormat.INT8, layered=True)
    jtoks, _ = jengine.generate(jcard, jp, jnp.asarray(prompt), jc,
                                sampler=JSamplerCard(temperature=0.0),
                                max_new_tokens=new, decode_chunk=4)
    jtoks = np.asarray(jtoks)
    jc = j_cache_for(jcard, B, 32, fmt=JQFormat.INT8, layered=True)
    jl, jc = _j_prefill(jcard, jp, jnp.asarray(prompt), jc, fresh=True)
    margins = [top2_margin(jl)]
    for i in range(new - 1):
        jl, jc = _j_step(jcard, jp, jnp.asarray(jtoks[:, i]), jc,
                         streaming=True)
        margins.append(top2_margin(jl))
    tc = cache_for(card, B, 32, fmt=QFormat.INT8, layered=True, device="cpu")
    ttoks, _ = generate(card, tp, torch.from_numpy(prompt), tc,
                        sampler=SamplerCard(temperature=0.0),
                        max_new_tokens=new, decode_chunk=4, device="cpu")
    assert_greedy_agrees(ttoks, jtoks, margins)


# ---------------------------------------------------------------------------
# io/convert: the zoo's leaves
# ---------------------------------------------------------------------------

CONVERT_CARDS = {
    "mamba": ("MAMBA", {}), "guppy": ("GUPPY", {}),
    "llama_vae": ("LLAMA_VAE", dict(token_embeds=(24, 12))),
}


@pytest.mark.parametrize("name", list(CONVERT_CARDS))
def test_convert_carries_zoo_leaves_bit_for_bit(name):
    """``params_from_numpy`` carries every leaf of a MAMBA card (in_proj,
    conv_w/conv_b, x_proj, dt_proj, the f32 dt_bias, A_log and Dd,
    out_proj), a GUPPY card (its 0-d bf16 ``guppy_gain`` stays 0-d) and a
    LLAMA_VAE card (``evae``'s enc/dec lists of dicts) with its shape,
    dtype and bytes; the GAU/BROWN leaves in ``test_torch_zoo_gau_brown``'s
    hybrid cards likewise (upU, upV, down, gau_q, gau_k, the f32 brown_w,
    brown_proj)."""
    arch, extra = CONVERT_CARDS[name]
    jcard = JModelCard.from_arch(arch, **dict(TINY, n_ffn=96, **extra))
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    if name == "guppy":
        jp["layers"][0]["guppy_gain"] = jnp.asarray(1.5, jnp.bfloat16)
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = leaves(tp)
    assert len(jl) == len(tl)
    for (path, j), t in zip(jl, tl):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == (
            "bfloat16" if j.dtype.name == "bfloat16" else j.dtype.name), path
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy(), j.view(np.int16) if j.dtype.name == "bfloat16"
            else j, err_msg=str(path))
    if name == "guppy":
        assert float(tp["layers"][0]["guppy_gain"]) == 1.5
