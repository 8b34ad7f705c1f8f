"""PyTorch port vs the JAX package: weight and KV quantization.

Packed codes must be byte-identical and f32 scales equal, so a quantized
weight or cache made by one package loads in the other."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import QuantCard as JQuantCard
from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.quant.apply import quantize_params as j_quantize_params
from koifish_tpu.quant.packing import unpack_codes as j_unpack
from koifish_tpu.quant.qtensor import QTensor as JQTensor
from koifish_tpu.quant.rtn import quantize as j_quantize
from koifish_tpu.quant.rtn import quantize_jit as j_quantize_jit
from koifish_tpu.serve.kvcache import _quant_kv as j_quant_kv

from koifish_tpu_torch.config import ModelCard, QuantCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.quant import QTensor, quantize, quantize_params
from koifish_tpu_torch.quant.packing import pack_codes, unpack_codes
from koifish_tpu_torch.quant.rtn import quantize_jit
from koifish_tpu_torch.serve.kvcache import _quant_kv

from torch_helpers import INT4_RULES, TINY_QWEN3, jax_tree_to_numpy

ALL_FORMATS = ["int8", "int4", "nf4", "int3", "nf3", "int2", "ternary",
               "binary"]


@pytest.mark.parametrize("entry", ["eager", "jit"])
@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_quantize_matches_jax(fmt, entry):
    """Same f32 weights in -> the same packed bytes and scales out, for the
    eager ``quantize`` and the compiled ``quantize_jit`` (which multiplies by
    the reciprocal of each constant divisor, as XLA compiles it). Exact
    equality: both sides do the same IEEE f32 ops elementwise; only the
    mean-|w| scale of TERNARY/BINARY is a reduction whose order may differ,
    so its scale gets an f32 relative tolerance of 1e-6."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((256, 96)) * 0.02).astype(np.float32)
    jfn, tfn = ((j_quantize, quantize) if entry == "eager"
                else (j_quantize_jit, quantize_jit))
    jq = jfn(jnp.asarray(w), JQFormat(fmt), group=128)
    tq = tfn(torch.from_numpy(w), QFormat(fmt), group=128)
    assert tq.codes.dtype == (torch.int8 if fmt == "int8" else torch.uint8)
    np.testing.assert_array_equal(np.asarray(jq.codes), tq.codes.numpy())
    if fmt in ("ternary", "binary"):
        np.testing.assert_allclose(np.asarray(jq.scales), tq.scales.numpy(),
                                   rtol=1e-6)
    else:
        np.testing.assert_array_equal(np.asarray(jq.scales),
                                      tq.scales.numpy())
    assert tq.shape == tuple(jq.shape) and tq.group == jq.group


def test_rtn_rounds_half_away_from_zero():
    """Exact .5 ties: weights round half AWAY from zero (rtn.py:24-27), where
    torch.round would go to even. absmax 7 makes the INT4 scale exactly 1."""
    col = np.zeros(128, np.float32)
    col[:8] = [7.0, 2.5, -2.5, 0.5, -0.5, 1.5, -3.5, 4.5]
    w = np.stack([col, -col], axis=1)                      # [128, 2]
    tq = quantize(torch.from_numpy(w), QFormat.INT4, group=128)
    jq = j_quantize(jnp.asarray(w), JQFormat.INT4, group=128)
    np.testing.assert_array_equal(np.asarray(jq.codes), tq.codes.numpy())
    assert float(tq.scales[0, 0]) == 1.0
    vals = unpack_codes(tq.codes, QFormat.INT4, 128).to(torch.int32) - 8
    assert vals[:8, 0].tolist() == [7, 3, -3, 1, -1, 2, -4, 5]
    assert vals[:8, 1].tolist() == [-7, -3, 3, -1, 1, -2, 4, -5]
    assert torch.round(torch.tensor([2.5, 0.5])).tolist() == [2.0, 0.0]


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_kv_quant_matches_jax_half_to_even(fmt):
    """KV quantization rounds half to EVEN (jnp.round, kvcache.py:122): the
    ties below land on 2, 0, -2 and the packed bytes equal JAX's."""
    qmax = 127.0 if fmt == "int8" else 7.0
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2, 64)).astype(np.float32)
    x[0, 0, :] = 0.0
    x[0, 0, :5] = [qmax, 2.5, 0.5, -2.5, -qmax]       # scale exactly 1
    jq, js = j_quant_kv(jnp.asarray(x), JQFormat(fmt))
    tq, ts = _quant_kv(torch.from_numpy(x), QFormat(fmt))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    if fmt == "int8":
        assert tq[0, 0, :5].tolist() == [127, 2, 0, -2, -127]


@pytest.mark.parametrize("fmt", ["int4", "int2", "binary"])
def test_pack_unpack_roundtrip_matches_jax(fmt):
    """Group-local block-split packing: byte row r of a group holds rows r,
    r + 128/cpb, ... — bytes equal JAX's, and unpack inverts pack."""
    rng = np.random.default_rng(2)
    f = QFormat(fmt)
    raw = rng.integers(0, 1 << f.pack_bits, size=(256, 8)).astype(np.uint8)
    from koifish_tpu.quant.packing import pack_codes as j_pack
    jp = np.asarray(j_pack(jnp.asarray(raw), JQFormat(fmt)))
    tp = pack_codes(torch.from_numpy(raw), f)
    np.testing.assert_array_equal(jp, tp.numpy())
    np.testing.assert_array_equal(unpack_codes(tp, f, 256).numpy(), raw)
    np.testing.assert_array_equal(
        np.asarray(j_unpack(jnp.asarray(jp), JQFormat(fmt), 256)), raw)


@pytest.mark.parametrize("rules", [
    INT4_RULES,
    {"self_attn": {"bits": 8}, "mlp": {"bits": 4, "quant_method": "RTNf"},
     "embed_tokens": {"bits": 4}, "group_size": 128},
])
def test_quantize_params_path_rules_match_jax(rules):
    """quantize_params picks the same leaves by HF-style path and gives them
    byte-identical codes (bf16 weights carried across as uint16 views)."""
    import jax
    jcard = JModelCard.from_arch("QWEN3", **TINY_QWEN3)
    card = ModelCard.from_arch("QWEN3", **TINY_QWEN3)
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    jqp = j_quantize_params(jp, JQuantCard.from_json(rules), jcard)
    tqp = quantize_params(tp, QuantCard.from_json(rules), card,
                          device="cpu")

    def pairs():
        yield "wte", jqp["wte"], tqp["wte"]
        for li, (jl, tl) in enumerate(zip(jqp["layers"], tqp["layers"])):
            assert sorted(jl) == sorted(tl)
            for key in jl:
                yield f"layers[{li}].{key}", jl[key], tl[key]

    n_quant = 0
    for name, j, t in pairs():
        assert isinstance(j, JQTensor) == isinstance(t, QTensor), name
        if isinstance(t, QTensor):
            n_quant += 1
            assert t.fmt.value == j.fmt.value, name
            np.testing.assert_array_equal(np.asarray(j.codes),
                                          t.codes.numpy(), err_msg=name)
            np.testing.assert_array_equal(np.asarray(j.scales),
                                          t.scales.numpy(), err_msg=name)
        else:
            np.testing.assert_array_equal(
                np.asarray(j, np.float32), t.to(torch.float32).numpy(),
                err_msg=name)
    assert n_quant == 2 * 7 + ("embed_tokens" in rules)


def test_dequantize_matches_jax():
    """QTensor.dequantize: same bf16 values as the JAX oracle."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((256, 64)) * 0.05).astype(np.float32)
    for fmt in ("int4", "nf4", "ternary"):
        jd = np.asarray(j_quantize(jnp.asarray(w), JQFormat(fmt))
                        .dequantize(jnp.float32))
        td = quantize(torch.from_numpy(w), QFormat(fmt)).dequantize(
            torch.float32).numpy()
        # f32 code x f32 scale, one product each: bit-equal except where the
        # TERNARY mean scale differs by an ulp (rtol 1e-6)
        np.testing.assert_allclose(td, jd, rtol=1e-6, atol=0)
