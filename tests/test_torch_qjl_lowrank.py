"""The QJL KV cache and low-rank compression in the port against the JAX
package's ``ops/qjl.py``, ``serve`` QJL paths and ``quant/lowrank.py``, on
the CPU at tiny sizes.

The projection is JAX's ``jax.random.normal`` draw made without JAX: its
uint32 bits and uniforms exactly, its normals within 4 f32 ulps. The key
encoding, scores and decode attention take JAX's projection in both
packages; the cache, the decode step and ``generate`` run each package's
own. Inputs are made with numpy from seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import SamplerCard as JSamplerCard
from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.ops import qjl as jqjl
from koifish_tpu.quant import lowrank as jlr
from koifish_tpu.serve import engine as jengine
from koifish_tpu.serve import generate as j_generate
from koifish_tpu.serve import init_cache as j_init_cache
from koifish_tpu.serve.layered import decode_step_layered as j_decode_layered

from koifish_tpu_torch.config import SamplerCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.io.convert import cache_from_numpy
from koifish_tpu_torch.ops import qjl as tqjl
from koifish_tpu_torch.quant import lowrank as tlr
from koifish_tpu_torch.serve import engine as tengine
from koifish_tpu_torch.serve import generate as t_generate
from koifish_tpu_torch.serve import init_cache as t_init_cache
from koifish_tpu_torch.serve import kvcache as tkvc
from koifish_tpu_torch.serve.layered import decode_step_layered

from torch_helpers import (LOGIT_TOL, f32, jax_cache_to_numpy, tiny_models,
                           tiny_prompt, torch_threads)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    ai, bi = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
              for x in (a, b))
    return int(np.abs(ai - bi).max())


@pytest.mark.parametrize("d,m,seed", [(128, 256, 20260713),
                                      (16, 32, 20260713), (64, 512, 7),
                                      (32, 64, 3000000000)])
def test_projection_is_jax_draw(d, m, seed):
    """threefry bits and the uniforms bit for bit; the normals within 4
    f32 ulps of ``jax.random.normal`` (XLA's CPU ``log1p`` in ``erf_inv``
    rounds differently; measured 3 ulps at most)."""
    key = jax.random.PRNGKey(seed)
    jb = np.asarray(jax.random.bits(key, (d, m), jnp.uint32))
    assert np.array_equal(tqjl.jax_random_bits(seed, (d, m)), jb)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    ju = np.asarray(jax.random.uniform(key, (d, m), jnp.float32, lo, 1.0))
    assert np.array_equal(tqjl.jax_uniform(seed, (d, m)), ju)
    jp = np.asarray(jqjl.qjl_projection(d, m, seed))
    tp = tqjl.qjl_projection(d, m, seed)
    assert tp.dtype == torch.float32 and tuple(tp.shape) == (d, m)
    assert _ulps(tp.numpy(), jp) <= 4


def _proj(d, m, seed=20260713):
    """JAX's projection as (jax array, CPU tensor): fed to both packages."""
    jp = jqjl.qjl_projection(d, m, seed)
    return jp, torch.from_numpy(np.asarray(jp).copy())


def test_encode_and_unpack_match_jax():
    """Packed sign bits of the same keys under the same projection equal
    JAX's, except where the projection is within rounding of 0 (none for
    these keys); norms within 1e-6 relative; unpack bit for bit."""
    d, m = 64, 128
    jp, tp = _proj(d, m)
    k = np.random.default_rng(3).standard_normal((2, 3, 17, d)).astype(
        np.float32)
    jpk, jn = jqjl.qjl_encode_keys(jnp.asarray(k), jp)
    tpk, tn = tqjl.qjl_encode_keys(torch.from_numpy(k), tp)
    kp = k @ np.asarray(jp)
    near0 = np.abs(kp) < 1e-5 * np.abs(kp).max()
    diff = np.unpackbits(np.asarray(jpk) ^ tpk.numpy(), axis=-1,
                         bitorder="little").astype(bool)
    assert not (diff & ~near0).any()
    assert tpk.dtype == torch.uint8 and tuple(tpk.shape) == (2, 3, 17, m // 8)
    assert np.abs(tn.numpy() - np.asarray(jn)).max() <= 1e-6 * np.abs(
        np.asarray(jn)).max()
    assert np.array_equal(tqjl.qjl_unpack_signs(tpk).numpy(),
                          np.asarray(jqjl.qjl_unpack_signs(jnp.asarray(
                              tpk.numpy()))))


def _attn_inputs(seed, B=2, Hq=4, Hkv=2, S=40, D=64):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Hq, D)) * 0.3).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    mask = np.arange(S)[None, :] < np.array([S, S - 13])[:, None]
    return q, k, v, mask


def test_scores_and_decode_attention_match_jax():
    """``qjl_scores`` and ``qjl_decode_attention`` on the same packed keys,
    norms, bf16 values and mask: scores 1e-5 of the largest (measured
    1.8e-7), the bf16 output 1e-3 of the largest entry (measured 1.6e-6)."""
    d, m = 64, 128
    jp, tp = _proj(d, m)
    q, k, v, mask = _attn_inputs(4, D=d)
    jpk, jn = jqjl.qjl_encode_keys(jnp.asarray(k), jp)
    pk, nrm = torch.from_numpy(np.asarray(jpk)), torch.from_numpy(
        np.asarray(jn).copy())
    js = np.asarray(jqjl.qjl_scores(jnp.asarray(q), jpk, jn, jp))
    ts = tqjl.qjl_scores(torch.from_numpy(q), pk, nrm, tp).numpy()
    assert np.abs(ts - js).max() <= 1e-5 * np.abs(js).max()
    jq = jnp.asarray(q, jnp.bfloat16)
    jv = jnp.asarray(v, jnp.bfloat16)
    ja = jqjl.qjl_decode_attention(jq, jpk, jn, jv, jnp.asarray(mask), jp,
                                   d ** -0.5)
    ta = tqjl.qjl_decode_attention(
        torch.from_numpy(np.asarray(jq.astype(jnp.float32))).bfloat16(), pk,
        nrm, torch.from_numpy(np.asarray(jv.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(mask), tp, d ** -0.5)
    assert ta.dtype == torch.bfloat16
    ref = np.asarray(ja, np.float32)
    assert np.abs(f32(ta) - ref).max() <= 1e-3 * np.abs(ref).max()


def test_qjl_cache_buffers_match_jax():
    """``init_cache(..., QFormat.QJL)``: the JAX package's shapes and dtypes
    (sketch m/8 bytes, INT8 values, f32 norms and scales); the port's
    ``read_layer`` refuses QJL keys as JAX's does."""
    jc = j_init_cache(2, 3, 16, 2, 32, fmt=JQFormat.QJL)
    tc = t_init_cache(2, 3, 16, 2, 32, fmt=QFormat.QJL, device="cpu")
    for f in ("k", "v", "k_scale", "v_scale", "pos"):
        a, b = getattr(jc, f), getattr(tc, f)
        assert tuple(b.shape) == a.shape, f
        assert str(b.dtype).replace("torch.", "") == str(a.dtype), f
    with pytest.raises(ValueError, match="sign sketches"):
        tkvc.read_layer(tc, 0)


def test_qjl_cache_end_to_end_matches_jax():
    """The port's counterpart of tests/test_qjl.py:65 on the tiny INT4
    model: a fresh prefill into a QJL cache against the JAX cache: the
    keys' sketch bits (bf16 keys an ulp apart flip a bit whose projection
    is near 0: at most 5e-3 of them, measured 6.5e-4), their norms (1e-2
    of the largest, measured 1.3e-3) and the V codes (one code, measured
    1); then one decode step's logits within LOGIT_TOL of JAX's (measured
    1.4e-2); its distribution stays within 0.4 of the BF16 cache's, as the
    JAX test asks (measured 1.4e-3)."""
    jcard, card, jp, tp = tiny_models()
    prompt = tiny_prompt(2, 9, seed=5)

    def run_jax(fmt):
        c = j_init_cache(jcard.n_layer, 2, 32, jcard.n_kv_head,
                         jcard.head_dim, fmt=fmt)
        _, c = jengine.jit_prefill(jcard, jp, jnp.asarray(prompt[:, :-1]),
                                   c, fresh=True)
        out, c = jax.jit(jengine.decode_step, static_argnames=(
            "card", "streaming"))(jcard, jp, jnp.asarray(prompt[:, -1]), c)
        return out, c

    def run_port(fmt):
        c = t_init_cache(card.n_layer, 2, 32, card.n_kv_head, card.head_dim,
                         fmt=fmt, device="cpu")
        _, c = tengine.prefill(card, tp, torch.from_numpy(
            prompt[:, :-1]).long(), c, fresh=True, device="cpu")
        out, c = tengine.decode_step(card, tp, torch.from_numpy(
            prompt[:, -1]).long(), c)
        return out, c

    jl, jc = run_jax(JQFormat.QJL)
    tl, tc = run_port(QFormat.QJL)
    n = 9
    kbits = np.unpackbits(np.asarray(jc.k)[:, :, :, :n] ^ tc.k[
        :, :, :, :n].numpy(), axis=-1)
    assert kbits.mean() <= 5e-3, kbits.mean()
    assert np.abs(tc.k_scale[..., :n].numpy() - np.asarray(
        jc.k_scale)[..., :n]).max() <= 1e-2 * np.abs(np.asarray(
            jc.k_scale)).max()
    assert np.abs(tc.v[..., :n, :].numpy().astype(np.int32) - np.asarray(
        jc.v)[..., :n, :].astype(np.int32)).max() <= 1
    assert np.abs(f32(tl) - f32(jl)).max() <= LOGIT_TOL
    ref, _ = run_port(QFormat.BF16)
    pf, pq = torch.softmax(ref, -1), torch.softmax(tl, -1)
    assert float((pf - pq).abs().max()) < 0.4


def test_qjl_cache_continues_across_packages():
    """A layered QJL cache filled by the JAX prefill, carried across with
    ``cache_from_numpy``, decodes in the port like in the JAX package
    (within LOGIT_TOL, measured 4.0e-3): the layouts and the projection
    agree."""
    jcard, card, jp, tp = tiny_models()
    prompt = tiny_prompt(3, 20, seed=7)
    from koifish_tpu.serve import cache_for as j_cache_for
    jc = j_cache_for(jcard, 3, 32, fmt=JQFormat.QJL, layered=True)
    _, jc = jengine.jit_prefill(jcard, jp, jnp.asarray(prompt), jc,
                                fresh=True)
    tc = cache_from_numpy(jax_cache_to_numpy(jc), device="cpu")
    assert tc.fmt is QFormat.QJL and int(tc.pos[0]) == 20
    tok = prompt[:, -1]
    jl, _ = jax.jit(j_decode_layered, static_argnames=("card", "streaming"))(
        jcard, jp, jnp.asarray(tok), jc, streaming=False)
    tl, _ = decode_step_layered(card, tp, torch.tensor(tok), tc,
                                streaming=False)
    assert np.abs(f32(tl) - f32(jl)).max() <= LOGIT_TOL


def test_qjl_generate_layered_path_matches_jax():
    """The port's counterpart of tests/test_qjl.py:91: greedy ``generate``
    (decode_chunk 3, the layered decode) on a QJL cache, 6 new tokens for
    2 prompts: the tokens equal JAX's (a bf16 ulp apart a greedy choice
    may flip: at least 11 of 12 agree, measured 12)."""
    jcard, card, jp, tp = tiny_models()
    prompt = tiny_prompt(2, 6, seed=11)
    jcache = j_init_cache(jcard.n_layer, 2, 32, jcard.n_kv_head,
                          jcard.head_dim, fmt=JQFormat.QJL)
    jt, _ = j_generate(jcard, jp, jnp.asarray(prompt), jcache,
                       JSamplerCard(temperature=0.0), max_new_tokens=6,
                       decode_chunk=3)
    tcache = t_init_cache(card.n_layer, 2, 32, card.n_kv_head, card.head_dim,
                          fmt=QFormat.QJL, device="cpu")
    tt, _ = t_generate(card, tp, torch.from_numpy(prompt), tcache,
                       SamplerCard(temperature=0.0), max_new_tokens=6,
                       decode_chunk=3, device="cpu")
    jt = np.asarray(jt)
    assert tt.shape == jt.shape == (2, 6)
    assert (tt.numpy() == jt).sum() >= 11


@pytest.mark.parametrize("case", ["planted", "rank", "full"])
def test_lowrank_matches_jax(case):
    """``svd_compress`` and ``lowrank_error`` on the same f32 weights: the
    chosen rank equal, the reconstructions A·B within 2^-7 of the largest
    entry of W (bf16 factors; singular vectors are defined up to sign, so
    the factors are not compared; measured 9.1e-4), the errors within
    1e-4 (measured 2.1e-6)."""
    rng = np.random.default_rng(len(case))
    if case == "planted":
        w = (rng.standard_normal((256, 16)) @ rng.standard_normal((16, 128))
             + 1e-3 * rng.standard_normal((256, 128))).astype(np.float32)
        kw = dict(energy=0.99)
    else:
        w = rng.standard_normal((128, 64)).astype(np.float32)
        kw = dict(rank=32 if case == "rank" else 64)
    ja, jb = jlr.svd_compress(jnp.asarray(w), **kw)
    ta, tb = tlr.svd_compress(torch.from_numpy(w), **kw)
    assert ta.dtype == tb.dtype == torch.bfloat16
    assert tuple(ta.shape) == ja.shape and tuple(tb.shape) == jb.shape
    jrec = np.asarray(ja, np.float32) @ np.asarray(jb, np.float32)
    trec = f32(ta) @ f32(tb)
    assert np.abs(trec - jrec).max() <= 2.0 ** -7 * np.abs(w).max()
    je = jlr.lowrank_error(jnp.asarray(w), ja, jb)
    te = tlr.lowrank_error(torch.from_numpy(w), ta, tb)
    assert abs(te - je) <= 1e-4
    if case == "planted":
        assert ta.shape[1] <= 24 and te < 0.05
