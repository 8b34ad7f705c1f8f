"""The gradient of the port's quantized matmul against the JAX package's.

``ops/kernels/matmul.py::qmatmul`` goes through ``QMatmul`` under autograd:
dx = dy·deq(w)ᵀ, the gradient of the dequantize-and-dot path the JAX
package differentiates (``koifish_tpu/ops/matmul.py``). Inputs are made
with numpy from a seed and handed to both packages. The guards that keep a
CUDA product from losing its gradient silently are checked on the "meta"
device, which takes the CUDA branch of each wrapper without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.ops.matmul import qmatmul as j_qmatmul
from koifish_tpu.quant import cluster as jcl
from koifish_tpu.quant.rtn import quantize as j_quantize

from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.io.convert import qtensor_from_numpy
from koifish_tpu_torch.ops import matmul as tmm
from koifish_tpu_torch.ops.kernels import matmul as km
from koifish_tpu_torch.ops.kernels import qmv_int8 as kq8
from koifish_tpu_torch.quant.rtn import quantize

from torch_helpers import bf16_pair, f32, jax_tree_to_numpy

K, N, M = 256, 64, 24


def _weights(kind: str, seed: int):
    """(JAX QTensor, the same QTensor in the port) from numpy weights: an
    RTN format by name, or a k-means / MINI book on an NF4 layout."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    if kind in ("kmeans", "mini"):
        q = jcl.quantize_kmeans if kind == "kmeans" else jcl.quantize_mini
        jw = q(jnp.asarray(w), bits=4)
        return jw, qtensor_from_numpy(jax_tree_to_numpy(jw), "cpu")
    return (j_quantize(jnp.asarray(w), JQFormat(kind), group=128),
            quantize(torch.from_numpy(w), QFormat(kind), group=128))


KINDS = [f.value for f in km.FORMATS] + ["kmeans", "mini"]


@pytest.mark.parametrize("kind", KINDS)
def test_qmatmul_dx_matches_jax(kind):
    """dx through the port's Function equals jax.vjp of the JAX package's
    ``qmatmul`` on the same bf16 x, dy and codes. Both take one bf16 product
    of dy and the dequantized bf16 weight with f32 accumulation; only the
    summation order differs before the bf16 rounding — tolerance 1 bf16
    ulp of the largest entry."""
    jw, tw = _weights(kind, seed=len(kind))
    assert km.takes(tw)
    rng = np.random.default_rng(7)
    jx, tx = bf16_pair(rng.standard_normal((M, K)).astype(np.float32))
    jdy, tdy = bf16_pair(rng.standard_normal((M, N)).astype(np.float32))

    _, vjp = jax.vjp(lambda a: j_qmatmul(a, jw), jx)
    (jdx,) = vjp(jdy)

    x = tx.clone().requires_grad_(True)
    y = km.qmatmul(x, tw)
    assert y.grad_fn is not None and type(y.grad_fn).__name__.startswith(
        "QMatmul")
    y.backward(tdy)
    ref, got = f32(jdx), f32(x.grad)
    assert got.shape == ref.shape == (M, K)
    assert np.abs(got - ref).max() <= 2.0 ** -7 * np.abs(ref).max()


def test_model_path_carries_the_gradient_to_x():
    """``ops/matmul.qmatmul`` (the model's entry) keeps the graph through a
    kernel-covered QTensor: a 3-d x gets the JAX package's gradient."""
    jw, tw = _weights("int4", seed=3)
    rng = np.random.default_rng(8)
    jx, tx = bf16_pair(rng.standard_normal((2, 5, K)).astype(np.float32))
    jdy, tdy = bf16_pair(rng.standard_normal((2, 5, N)).astype(np.float32))
    (jdx,) = jax.vjp(lambda a: j_qmatmul(a, jw), jx)[1](jdy)
    x = tx.clone().requires_grad_(True)
    tmm.qmatmul(x, tw).backward(tdy)
    ref = f32(jdx)
    assert np.abs(f32(x.grad) - ref).max() <= 2.0 ** -7 * np.abs(ref).max()


def test_no_grad_and_frozen_x_skip_the_function():
    """Without a gradient to carry, the product is the plain forward: no
    graph node, the same values as under autograd."""
    _, tw = _weights("nf4", seed=4)
    x = torch.randn((3, K)).to(torch.bfloat16)
    y0 = km.qmatmul(x, tw)
    assert y0.grad_fn is None
    with torch.no_grad():
        y1 = km.qmatmul(x.clone().requires_grad_(True), tw)
    assert y1.grad_fn is None
    y2 = km.qmatmul(x.clone().requires_grad_(True), tw)
    torch.testing.assert_close(y2.detach(), y0, rtol=0, atol=0)


def test_scale_gradient_on_the_cpu_goes_through_the_plain_version():
    """On the CPU a scale that requires a gradient keeps the plain
    version's autograd (x and scales both get one)."""
    _, tw = _weights("int4", seed=5)
    tw.scales.requires_grad_(True)
    x = torch.randn((4, K)).to(torch.bfloat16).requires_grad_(True)
    y = km.qmatmul(x, tw)
    y.float().sum().backward()
    assert x.grad is not None and tw.scales.grad is not None
    assert float(tw.scales.grad.abs().sum()) > 0


def _meta(t):
    return None if t is None else t.to("meta")


@pytest.mark.parametrize("which", ["scales", "codebook"])
def test_cuda_branch_raises_for_a_weight_gradient(which, monkeypatch):
    """Off the CPU (the "meta" device takes the card's branch) scales or a
    book that require a gradient (gama training) take ``QMatmul``: its
    forward is the kernel's (whose checks raise here, on no CUDA device),
    and with the kernel replaced by a recorder the backward gives the
    weight a gradient of its own shape, on its device."""
    _, tw = _weights("kmeans" if which == "codebook" else "int4", seed=6)
    import dataclasses
    mw = dataclasses.replace(tw, codes=_meta(tw.codes),
                             scales=_meta(tw.scales),
                             codebook=_meta(tw.codebook))
    getattr(mw, which).requires_grad_(True)
    x = torch.empty((40, K), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="lies on meta"):
        km.qmatmul(x, mw)
    calls = []
    monkeypatch.setattr(km, "_forward", lambda a, w, out_dtype: (
        calls.append(tuple(a.shape)), torch.empty(
            (a.shape[0], w.out_features), dtype=out_dtype,
            device=a.device))[1])
    y = km.qmatmul(x, mw)
    assert calls == [(40, K)] and type(y.grad_fn).__name__.startswith(
        "QMatmul")
    y.backward(torch.empty_like(y))
    g = getattr(mw, which).grad
    assert g is not None and g.shape == getattr(mw, which).shape
    assert g.device.type == "meta"


def test_cuda_branch_goes_through_the_function():
    """Off the CPU with x requiring a gradient the Function is entered and
    the kernel's checks run (here: the tensor is on no CUDA device)."""
    _, tw = _weights("int4", seed=7)
    x = torch.empty((40, K), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    with pytest.raises(ValueError, match="lies on meta"):
        km.qmatmul(x, tw)


def test_qmv_int8_raises_for_x_that_requires_a_gradient():
    """Row 5 rounds the activations inside the kernel and has no gradient:
    off the CPU an x that requires one raises and names the "dot" flavour;
    under no_grad the kernel's own checks run."""
    codes = torch.zeros((K, N), dtype=torch.int8, device="meta")
    scales = torch.zeros((K // 128, N), device="meta")
    x = torch.empty((4, K), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    with pytest.raises(NotImplementedError, match='INT8_GEMV = "dot"'):
        kq8.qmv_int8(x, codes, scales)
    with torch.no_grad(), pytest.raises(ValueError, match="lies on meta"):
        kq8.qmv_int8(x, codes, scales)
