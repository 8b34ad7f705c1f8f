"""PyTorch port vs the JAX package: the learned-codebook and Sinkhorn
quantizers (``quant/cluster.py``) and ``quantize_params`` with their rules.

Weights are made with numpy from a seed and handed to both packages. At or
below the k-means subsample (65536 elements) both fit on the same values,
so the books agree to f32 rounding (the two sum the Lloyd updates in
another order: measured <= 3e-6 on books of O(1-6)) and the codes agree
but for values on a midpoint. Above it the port draws its subsample from a
``torch.Generator`` (ROADMAP queue 3), so only the reconstruction error is
compared. MINI fits 16 entries to each row; on bf16 model weights (rows of
64-256 values, many equal) a one-ulp different quantile start can send a
row's Lloyd run to another local optimum (1-2 rows of 128-256 in the tiny
card's matrices), so there the rows' books are compared by share."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import QuantCard as JQuantCard
from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.quant import cluster as jcl
from koifish_tpu.quant.apply import quantize_params as j_quantize_params
from koifish_tpu.quant.qtensor import QTensor as JQTensor

from koifish_tpu_torch.config import ModelCard, QuantCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.quant import QTensor, quantize_params
from koifish_tpu_torch.quant import cluster as tcl

from torch_helpers import TINY_QWEN3, jax_tree_to_numpy

BOOK_TOL = 1e-5          # books: f32 sums in another order
CODES_EQUAL = 0.999      # codes: a value on a book midpoint may go either way
ROWS_EQUAL = 0.98        # MINI on bf16 weights: rows in another optimum


def _weight(shape, seed):
    """Heavy-tailed columns, as test_pallas.py's codebook case builds."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * (1 + 5 * rng.random(shape))).astype(np.float32)


def _codes_equal(j, t) -> float:
    return float((np.asarray(j.codes) == t.codes.numpy()).mean())


@pytest.mark.parametrize("method", ["kmeans", "mini"])
@pytest.mark.parametrize("bits", [3, 4])
def test_codebook_quantizers_match_jax(method, bits):
    """256 x 128 = 32768 elements (no subsample): same books and codes."""
    w = _weight((256, 128), seed=bits)
    jq = getattr(jcl, f"quantize_{method}")(jnp.asarray(w), bits=bits)
    tq = getattr(tcl, f"quantize_{method}")(torch.from_numpy(w), bits=bits)
    assert tq.fmt.value == jq.fmt.value
    assert tuple(tq.codebook.shape) == tuple(jq.codebook.shape)
    assert np.abs(np.asarray(jq.codebook) - tq.codebook.numpy()).max() \
        <= BOOK_TOL
    np.testing.assert_array_equal(np.asarray(jq.scales), tq.scales.numpy())
    assert _codes_equal(jq, tq) >= CODES_EQUAL


def test_sinkhorn_matches_jax():
    """Row/column factors and folded scales to f32 rounding (std in another
    summation order), the same INT4 codes."""
    w = _weight((256, 64), seed=7)
    jq = jcl.quantize_sinkhorn(jnp.asarray(w), JQFormat.INT4)
    tq = tcl.quantize_sinkhorn(torch.from_numpy(w), QFormat.INT4)
    np.testing.assert_allclose(tq.row_scale.numpy(), np.asarray(jq.row_scale),
                               rtol=1e-5)
    np.testing.assert_allclose(tq.scales.numpy(), np.asarray(jq.scales),
                               rtol=1e-5)
    assert _codes_equal(jq, tq) >= CODES_EQUAL


@pytest.mark.parametrize("bits", [3, 4])
def test_kmeans_above_the_subsample_reconstructs_as_well(bits):
    """1024 x 128 = 131072 elements: the two packages fit on different
    65536-element subsamples; the port's relative reconstruction error is
    within 5 % of the JAX package's (measured within 0.4 %)."""
    w = _weight((1024, 128), seed=10 + bits)
    jq = jcl.quantize_kmeans(jnp.asarray(w), bits=bits)
    tq = tcl.quantize_kmeans(torch.from_numpy(w), bits=bits)
    rel = lambda d: np.linalg.norm(d - w) / np.linalg.norm(w)
    j_err = rel(np.asarray(jq.dequantize(jnp.float32)))
    t_err = rel(tq.dequantize(torch.float32).numpy())
    assert t_err <= 1.05 * j_err, (t_err, j_err)


@pytest.mark.parametrize("method", ["KMEANS", "MINI", "SNQ"])
def test_quantize_params_cluster_rules_match_jax(method):
    """quantize_params dispatches the cluster methods by rule, on the same
    leaves, with the same books, scales and codes."""
    rules = {"self_attn": {"bits": 4, "quant_method": method},
             "mlp": {"bits": 4, "quant_method": method}, "group_size": 128}
    jcard = JModelCard.from_arch("QWEN3", **TINY_QWEN3)
    card = ModelCard.from_arch("QWEN3", **TINY_QWEN3)
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    jqp = j_quantize_params(jp, JQuantCard.from_json(rules), jcard)
    tqp = quantize_params(tp, QuantCard.from_json(rules), card, device="cpu")
    n = 0
    for jl, tl in zip(jqp["layers"], tqp["layers"]):
        for key, j in jl.items():
            t = tl[key]
            assert isinstance(j, JQTensor) == isinstance(t, QTensor), key
            if not isinstance(t, QTensor):
                continue
            n += 1
            assert t.fmt.value == j.fmt.value, key
            per_row = t.codebook is not None and t.codebook.dim() == 2
            assert _codes_equal(j, t) >= (ROWS_EQUAL if per_row
                                          else CODES_EQUAL), key
            np.testing.assert_allclose(t.scales.numpy(), np.asarray(j.scales),
                                       rtol=1e-5, err_msg=key)
            for f in ("codebook", "row_scale"):
                jf, tf = getattr(j, f), getattr(t, f)
                assert (jf is None) == (tf is None), (key, f)
                if tf is None:
                    continue
                d = np.abs(np.asarray(jf) - tf.numpy())
                tol = BOOK_TOL * max(1.0, float(np.abs(jf).max()))
                if d.ndim == 2:       # per-row books: most rows agree
                    assert (d.max(axis=1) <= tol).mean() >= ROWS_EQUAL, key
                else:
                    assert d.max() <= tol, (key, f)
    for li, (jl, tl) in enumerate(zip(jqp["layers"], tqp["layers"])):
        for key, j in jl.items():
            if not isinstance(j, JQTensor):
                continue
            # the same reconstruction error, to 1 %
            w = np.asarray(jp["layers"][li][key], np.float32)
            rel = lambda d: np.linalg.norm(d - w) / np.linalg.norm(w)
            j_err = rel(np.asarray(j.dequantize(jnp.float32)))
            t_err = rel(tl[key].dequantize(torch.float32).numpy())
            assert abs(t_err - j_err) <= 1e-2 * j_err, (key, t_err, j_err)
    assert n == 2 * 7
