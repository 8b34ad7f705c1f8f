"""PyTorch port vs the JAX package's Pallas kernels (interpret mode on CPU).

Each port kernel's plain version — what its CUDA kernel computes, and what
the port runs on a CPU tensor — is held against the Pallas kernel it
replaces, run in the interpreter as tests/test_pallas.py runs it, at shapes
the Pallas kernel accepts; shapes the JAX package never sends to Pallas are
held against its plain path. Inputs come from numpy with a fixed seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.ops.pallas import decode_attn as pda
from koifish_tpu.ops.pallas import flash as pfl
from koifish_tpu.ops.pallas import matmul as pmm
from koifish_tpu.quant.rtn import quantize as j_quantize
from koifish_tpu.serve.kvcache import _quant_kv as j_quant_kv

from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.ops.attention import causal_attention
from koifish_tpu_torch.ops.kernels import decode_attn as kd
from koifish_tpu_torch.ops.kernels import flash as kf
from koifish_tpu_torch.ops.kernels import matmul as km
from koifish_tpu_torch.ops.matmul import qmatmul
from koifish_tpu_torch.quant.rtn import quantize

from torch_helpers import bf16_pair, f32


@pytest.fixture
def interpret():
    """Pallas kernels eligible + interpreted; reset afterwards."""
    for mod in (pfl, pmm, pda):
        mod.set_interpret(True)
    try:
        yield
    finally:
        for mod in (pfl, pmm, pda):
            mod.set_interpret(False)


def _weights(K, N, fmt, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    return (j_quantize(jnp.asarray(w), JQFormat(fmt), group=128),
            quantize(torch.from_numpy(w), QFormat(fmt), group=128))


@pytest.mark.parametrize("fmt", ["int4", "int8"])
@pytest.mark.parametrize("m", [8, 256])
def test_qmatmul_matches_pallas(interpret, fmt, m):
    """m = 8 reaches _qmv (GEMV), m = 256 reaches _qmm (GEMM), k = 1024.
    Both sides sum exact bf16 code products per group in f32 and scale the
    partial sums; only the f32 summation order differs before the final
    bf16 rounding — tolerance: 1 bf16 ulp of the largest output."""
    K, N = 1024, 256
    jw, tw = _weights(K, N, fmt, seed=1)
    xa = np.random.default_rng(2).standard_normal((m, K)).astype(np.float32)
    jx, tx = bf16_pair(xa)
    ref = f32(pmm.qmatmul_pallas_or_ref(jx, jw, jnp.bfloat16))
    out = f32(qmatmul(tx, tw))
    assert out.shape == ref.shape == (m, N)
    tol = 2.0 ** -7 * np.abs(ref).max()
    assert np.abs(out - ref).max() <= tol, np.abs(out - ref).max()


@pytest.mark.parametrize("fmt", ["int4", "nf4", "ternary"])
def test_qmatmul_odd_m_matches_jax_plain_path(fmt):
    """m = 40 and K = 384 are shapes the JAX package never sends to Pallas
    (the 32 < m < 64 dead zone, K % 1024): it dequantizes to bf16 and takes
    one dot. The port's kernel math scales partial sums instead of rounded
    weights — tolerance 2 % of the largest output for that bf16 rounding."""
    K, N, m = 384, 128, 40
    jw, tw = _weights(K, N, fmt, seed=3)
    xa = np.random.default_rng(4).standard_normal((m, K)).astype(np.float32)
    jx, tx = bf16_pair(xa)
    ref = f32(pmm.qmatmul_pallas_or_ref(jx, jw, jnp.float32))
    out = f32(qmatmul(tx, tw, out_dtype=torch.float32))
    assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()


def test_qmatmul_all_formats_plain_vs_dequant():
    """Every format the kernel takes: the plain kernel math against the
    dequantize-then-matmul oracle (2 % of the largest output, bf16 weight
    rounding in the oracle)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((9, 256)).astype(np.float32)
                         ).to(torch.bfloat16)
    for fmt in km.FORMATS:
        w = quantize(torch.from_numpy(
            (rng.standard_normal((256, 64)) * 0.02).astype(np.float32)), fmt)
        y = km.qmatmul_plain(x, w.codes, w.scales, w.fmt).float()
        ref = x.float() @ w.dequantize(torch.bfloat16).float()
        err = float((y - ref).abs().max())
        assert err <= 2e-2 * float(ref.abs().max()), (fmt, err)


def _qkv(B, T, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [bf16_pair(rng.standard_normal((B, T, H, D)).astype(np.float32))
            for H in (Hq, Hkv, Hkv)]


# o is bf16 (values O(1)): the Pallas kernels and the plain version round p
# to bf16 against a max that may differ by tile, so allow a few bf16 ulps;
# lse is f32 end to end
TOL_O, TOL_LSE = 2e-2, 2e-4


@pytest.mark.parametrize("T,D,window", [(256, 64, 0), (256, 128, 0),
                                        (256, 64, 100), (384, 64, 0),
                                        (384, 128, 160)])
def test_flash_fwd_matches_pallas_cols(interpret, T, D, window):
    """Column layout [B, T, H·D] (_flash_cols_fwd_call): T = 256 takes the
    single-tile kernel, T = 384 the multi-tile online softmax; GQA g = 2."""
    B, Hq, Hkv = 1, 4, 2
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, T, Hq, Hkv, D, seed=T + D)
    sc = 1.0 / D ** 0.5
    jo, jl = pfl._flash_cols_fwd_call(
        jq.reshape(B, T, Hq * D), jk.reshape(B, T, -1), jv.reshape(B, T, -1),
        hq=Hq, scale=sc, window=window)
    to, tl = kf.flash_attention_fwd(tq, tk, tv, scale=sc, window=window)
    jl = f32(jl)                                  # [B, G, T, hb] -> [B, Hq, T]
    jl = jl.transpose(0, 1, 3, 2).reshape(B, Hq, T)
    assert np.abs(f32(to).reshape(B, T, -1) - f32(jo)).max() <= TOL_O
    assert np.abs(f32(tl) - jl).max() <= TOL_LSE


@pytest.mark.parametrize("T,window", [(256, 0), (384, 96)])
def test_flash_fwd_matches_pallas_head_major(interpret, T, window):
    """Head-major [B·H, T, D] (_flash_fwd_call): the port takes the same
    storage as a strided [B, T, H, D] view, with no transpose copy."""
    B, Hq, Hkv, D = 2, 4, 2, 64
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal((B, H, T, D)).astype(np.float32)
            for H in (Hq, Hkv, Hkv)]
    (jq, tq), (jk, tk), (jv, tv) = [bf16_pair(a) for a in arrs]
    sc = 1.0 / D ** 0.5
    jo, jl = pfl._flash_fwd_call(jq.reshape(B * Hq, T, D),
                                 jk.reshape(B * Hkv, T, D),
                                 jv.reshape(B * Hkv, T, D),
                                 g=Hq // Hkv, scale=sc, window=window)
    to, tl = kf.flash_attention_fwd(tq.transpose(1, 2), tk.transpose(1, 2),
                                    tv.transpose(1, 2), scale=sc,
                                    window=window)
    jo = f32(jo).reshape(B, Hq, T, D)
    assert np.abs(f32(to).transpose(0, 2, 1, 3) - jo).max() <= TOL_O
    assert np.abs(f32(tl) - f32(jl).reshape(B, Hq, T)).max() <= TOL_LSE


def test_causal_attention_dispatch_matches_ref_path():
    """causal_attention's flash dispatch (mask None, causal) agrees with the
    port's plain masked path and ragged T works (no T % 128 gate)."""
    B, T, Hq, Hkv, D = 2, 37, 4, 1, 64
    (_, tq), (_, tk), (_, tv) = _qkv(B, T, Hq, Hkv, D, seed=9)
    a = causal_attention(tq, tk, tv, window=10)
    b = causal_attention(tq, tk, tv, window=10, backend="ref")
    assert float((a.float() - b.float()).abs().max()) <= TOL_O


def _quant_cache(B, Hkv, S, D, fmt, seed):
    x = np.random.default_rng(seed).standard_normal((B, Hkv, S, D)
                                                    ).astype(np.float32)
    jc, js = j_quant_kv(jnp.asarray(x), JQFormat(fmt))
    tc, ts = (torch.from_numpy(np.array(a)) for a in (jc, js))
    return jc, js, tc, ts


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("D,Hq", [(64, 4), (128, 8)])
def test_decode_attention_matches_pallas(interpret, fmt, D, Hq):
    """_decode_kernel_call via decode_attention_quant_or_none, ragged
    lengths. bf16 output; p·v_scale is rounded to bf16 in both, against a
    max that may differ by tile — tolerance 1e-2 absolute on O(1) values."""
    B, Hkv, S = 3, 2, 256
    jkc, jks, tkc, tks = _quant_cache(B, Hkv, S, D, fmt, seed=D)
    jvc, jvs, tvc, tvs = _quant_cache(B, Hkv, S, D, fmt, seed=D + 1)
    qa = np.random.default_rng(11).standard_normal((B, Hq, D)
                                                   ).astype(np.float32)
    jq, tq = bf16_pair(qa)
    lengths = np.array([1, 100, 256], np.int32)
    sc = 1.0 / D ** 0.5
    ref = pda.decode_attention_quant_or_none(jq, jkc, jvc, jks, jvs,
                                             jnp.asarray(lengths), sc)
    assert ref is not None
    out = kd.decode_attention_quant(tq, tkc, tvc, tks, tvs,
                                    torch.from_numpy(lengths), sc)
    assert out.dtype == torch.bfloat16 and out.shape == (B, Hq, D)
    assert np.abs(f32(out) - f32(ref)).max() <= 1e-2


def test_wrappers_refuse_cuda_shapes_they_do_not_take():
    """A CPU tensor takes the plain version; a shape the kernel does not
    take raises naming the shape (checked before any launch)."""
    q = torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 96"):
        kf._check(q, q[:, :, :1], q[:, :, :1], 0)
    w = quantize(torch.zeros((256, 6)), QFormat.INT4)
    with pytest.raises(ValueError, match="N % 4"):
        km._check(torch.zeros((2, 256), dtype=torch.bfloat16), w)
    assert km._plan(32, 1024, 1024) == (32, 1, 8)      # decode: split K
    assert km._plan(4096, 1024, 1024) == (64, 8, 1)    # prefill: no split
