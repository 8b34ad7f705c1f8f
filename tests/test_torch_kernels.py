"""PyTorch port vs the JAX package's Pallas kernels (interpret mode on CPU).

Each port kernel's plain version — what its CUDA kernel computes, and what
the port runs on a CPU tensor — is held against the Pallas kernel it
replaces, run in the interpreter as tests/test_pallas.py runs it, at shapes
the Pallas kernel accepts; shapes the JAX package never sends to Pallas are
held against its plain path. Inputs come from numpy with a fixed seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.ops import cross_entropy as jce
from koifish_tpu.ops.pallas import decode_attn as pda
from koifish_tpu.ops.pallas import flash as pfl
from koifish_tpu.ops.pallas import fused_ce as pfce
from koifish_tpu.ops.pallas import matmul as pmm
from koifish_tpu.ops.pallas import slotwrite as psw
from koifish_tpu.quant import cluster as jcl
from koifish_tpu.quant.rtn import quantize as j_quantize
from koifish_tpu.serve.kvcache import _quant_kv as j_quant_kv

from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.ops import cross_entropy as tce
from koifish_tpu_torch.ops.attention import causal_attention
from koifish_tpu_torch.ops.kernels import decode_attn as kd
from koifish_tpu_torch.ops.kernels import flash as kf
from koifish_tpu_torch.ops.kernels import fused_ce as kc
from koifish_tpu_torch.ops.kernels import matmul as km
from koifish_tpu_torch.ops.kernels import qmv_int8 as kq8
from koifish_tpu_torch.ops.kernels.quantize import quantize_plain
from koifish_tpu_torch.ops.kernels import slotwrite as ksw
from koifish_tpu_torch.ops import matmul as tmm
from koifish_tpu_torch.ops.matmul import qmatmul
from koifish_tpu_torch.quant.rtn import quantize

from koifish_tpu_torch.io.convert import qtensor_from_numpy

from torch_helpers import bf16_pair, f32, jax_tree_to_numpy


@pytest.fixture
def interpret():
    """Pallas kernels eligible + interpreted; reset afterwards."""
    for mod in (pfl, pmm, pda, pfce, psw):
        mod.set_interpret(True)
    try:
        yield
    finally:
        for mod in (pfl, pmm, pda, pfce, psw):
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


@pytest.mark.parametrize("m", [4, 40])
def test_qmatmul_f32_out_is_the_unrounded_sum(m):
    """The f32 output (a row-parallel shard's partial under tensor
    parallelism) is the sum the bf16 output rounds: rounding it gives the
    bf16 result bit for bit, and the two K halves' f32 outputs added match
    the whole product's f32 sum to f32 precision (1e-5 of the largest)."""
    K, N = 512, 128
    _, tw = _weights(K, N, "int4", seed=31)
    xa = np.random.default_rng(32).standard_normal((m, K)).astype(np.float32)
    _, tx = bf16_pair(xa)
    y32 = km.qmatmul(tx, tw, torch.float32)
    assert y32.dtype == torch.float32
    assert torch.equal(y32.to(torch.bfloat16), km.qmatmul(tx, tw))
    halves = [quantize(tw.dequantize(torch.float32)[h * 256:(h + 1) * 256],
                       QFormat.INT4, group=128) for h in (0, 1)]
    parts = [km.qmatmul(tx[:, h * 256:(h + 1) * 256], halves[h],
                        torch.float32) for h in (0, 1)]
    whole = km.qmatmul(tx, quantize(tw.dequantize(torch.float32),
                                    QFormat.INT4, group=128), torch.float32)
    err = float((parts[0] + parts[1] - whole).abs().max())
    assert err <= 1e-5 * float(whole.abs().max()), err


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



@jax.jit
def _j_q8(xg):
    """The Pallas kernel's activation quantizer (matmul.py:287-289), as XLA
    compiles it in interpret mode."""
    sx = jnp.max(jnp.abs(xg), axis=1, keepdims=True) / 127.0
    sx = jnp.maximum(sx, 1e-12)
    return jnp.clip(jnp.round(xg / sx), -127, 127).astype(jnp.int8), sx


@pytest.mark.parametrize("m,K,N", [(1, 1024, 256), (5, 1024, 512),
                                   (32, 3072, 256), (17, 256, 128)])
def test_qmv_int8_matches_pallas(interpret, m, K, N):
    """Row 5: qmv_int8_plain against the interpreted Pallas qmv_int8_mxu.
    The activation codes and scales equal the kernel's quantizer bit for
    bit (XLA multiplies by f32(1/127) and divides by sx); the int32 group
    sums are exact, and the f32 epilogue may round an output to the other
    neighbouring bf16 value: tolerance 1 bf16 ulp of each entry, and at most
    0.5 % of the entries differ at all."""
    jw, tw = _weights(K, N, "int8", seed=11)
    rng = np.random.default_rng(12)
    xa = (rng.standard_normal((m, K)) * rng.uniform(0.1, 4, (m, 1))
          ).astype(np.float32)
    jx, tx = bf16_pair(xa)
    for g in range(K // 128):
        xg = tx[:, g * 128:(g + 1) * 128]
        q, sx = quantize_plain(xg, 1, "jit")
        jq, jsx = _j_q8(jnp.asarray(xg.float().numpy()))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    bm = max(8, -(-m // 8) * 8)     # the JAX dispatch pads rows to 8
    jxp = jnp.pad(jx, ((0, bm - m), (0, 0)))
    ref = f32(pmm.qmv_int8_mxu(jxp, jw.codes, jw.scales, group=128,
                               k=K))[:m]
    out = f32(kq8.qmv_int8(tx, tw.codes, tw.scales))
    assert out.shape == (m, N)
    np.testing.assert_allclose(out, ref, rtol=2.0 ** -7, atol=1e-6)
    assert (out != ref).mean() <= 5e-3
    # the kernel's K split order (chip_smoke.py holds the kernel to it):
    # the same codes, f32 sums in another order
    gps, splits = kq8._plan(m, K, N)
    split = f32(kq8.qmv_int8_plain(tx, tw.codes, tw.scales, gps=gps))
    np.testing.assert_allclose(split, ref, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("flavour", ["mxu", "dot"])
def test_int8_gemv_dispatch_follows_the_flavour(interpret, monkeypatch,
                                                flavour):
    """``qmatmul`` sends an INT8 QTensor at m <= 32 to row 5 under
    ``"mxu"`` and to the row-4 GEMV under ``"dot"`` (read at each call);
    m > 32 and INT4 always take rows 3/4. Under each flavour the output
    agrees with the JAX dispatch under the same flavour."""
    calls = []
    real_q8, real_km = kq8.qmv_int8, km.qmatmul
    monkeypatch.setattr(kq8, "qmv_int8",
                        lambda *a: calls.append("row5") or real_q8(*a))
    monkeypatch.setattr(km, "qmatmul",
                        lambda *a: calls.append("rows34") or real_km(*a))
    monkeypatch.setattr(tmm, "INT8_GEMV", flavour)
    monkeypatch.setattr(pmm, "_INT8_GEMV", flavour)
    K, N = 1024, 256
    jw, tw = _weights(K, N, "int8", seed=13)
    rng = np.random.default_rng(14)
    for m, want in ((5, "row5" if flavour == "mxu" else "rows34"),
                    (32, "row5" if flavour == "mxu" else "rows34"),
                    (40, "rows34")):
        jx, tx = bf16_pair(rng.standard_normal((m, K)).astype(np.float32))
        calls.clear()
        out = f32(qmatmul(tx, tw))
        assert calls == [want], (m, calls)
        if m <= 32:
            ref = f32(pmm.qmatmul_pallas_or_ref(jx, jw, jnp.bfloat16))
            assert np.abs(out - ref).max() <= 2.0 ** -7 * np.abs(ref).max()
    _, w4 = _weights(K, N, "int4", seed=15)
    calls.clear()
    qmatmul(torch.zeros((3, K), dtype=torch.bfloat16), w4)
    assert calls == ["rows34"]


def test_qmv_int8_refuses_what_it_does_not_take():
    codes = torch.zeros((256, 64), dtype=torch.int8)
    scales = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="x \\[1..32, K\\]"):
        kq8._check(torch.zeros((33, 256), dtype=torch.bfloat16), codes, scales)
    with pytest.raises(ValueError, match="lies on cpu"):
        kq8._check(torch.zeros((2, 256), dtype=torch.bfloat16), codes, scales)
    assert kq8._plan(1, 1024, 1024) == (1, 8)     # decode: split K
    assert kq8._plan(32, 3072, 1024) == (3, 8)    # one cluster: <= 8 splits
    assert kq8._plan(5, 1024, 3072) == (1, 8)
    assert kq8.takes(quantize(torch.zeros((256, 8)), QFormat.INT8))
    assert not kq8.takes(quantize(torch.zeros((256, 8)), QFormat.INT4))

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


# bf16 gradients of O(1-5): the Pallas kernels and the plain backward sum
# the same products in other orders (and the twopass kernels in other
# tiles), and a p or ds entry may round to the neighbouring bf16 value:
# 1 % of the largest entry (measured <= 0.21 %, in the twopass cases)
TOL_GRAD_REL = 1e-2


def _flash_grads_pair(B, T, Hq, Hkv, D, window, seed):
    """(JAX grads through flash_attention_or_none, port grads through
    FlashAttention) of sum(o · dO), same bf16 inputs."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, T, Hq, Hkv, D, seed)
    jdo, tdo = bf16_pair(np.random.default_rng(seed + 1).standard_normal(
        (B, T, Hq, D)).astype(np.float32))
    sc = 1.0 / D ** 0.5

    def jloss(q, k, v):
        out = pfl.flash_attention_or_none(q, k, v, scale=sc, window=window)
        assert out is not None
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    ts = [t.requires_grad_(True) for t in (tq, tk, tv)]
    o = kf.FlashAttention.apply(*ts, sc, window)
    tg = torch.autograd.grad(o, ts, tdo)
    return jg, tg


def _assert_grads_close(jg, tg):
    for name, j, t in zip("qkv", jg, tg):
        assert t.dtype == torch.bfloat16 and t.shape == j.shape
        ref = f32(j)
        err = np.abs(f32(t) - ref).max()
        assert err <= TOL_GRAD_REL * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("B,Hq,Hkv,D,window", [
    (1, 4, 2, 64, 0),      # column layout, single tile (_bwd_cols_fused)
    (2, 4, 2, 128, 48),    # the same with a window
    (1, 4, 2, 64, 48),
    (2, 3, 1, 64, 0),      # head-major single tile (_bwd_fused)
])
def test_flash_bwd_matches_pallas(interpret, B, Hq, Hkv, D, window):
    """FlashAttention's backward (the plain version on the CPU) against
    jax.grad through the Pallas kernels at T = 128, GQA g = 2 or 3."""
    _assert_grads_close(*_flash_grads_pair(B, 128, Hq, Hkv, D, window,
                                           seed=10 + D + window))


@pytest.mark.parametrize("Hq,Hkv,window", [(4, 2, 0), (3, 1, 96)])
def test_flash_bwd_matches_pallas_twopass(interpret, monkeypatch, Hq, Hkv,
                                          window):
    """T = 256 with the Pallas tiles cut to 128: the dK/dV sweep + dQ sweep
    kernels run (_bwd_cols_twopass for g = 2, _bwd_twopass head-major for
    g = 3). B = 3 keeps these traces apart from other tests' shapes."""
    monkeypatch.setattr(pfl, "BQ", 128)
    monkeypatch.setattr(pfl, "BK", 128)
    assert pfl._tiles(256) == (128, 128)
    _assert_grads_close(*_flash_grads_pair(3, 256, Hq, Hkv, 64, window,
                                           seed=30 + window))


def _ce_inputs(E, masked, seed, B=2, T=128, V=2304):
    rng = np.random.default_rng(seed)
    jh, th = bf16_pair(rng.standard_normal((B, T, E)).astype(np.float32))
    jw, tw = bf16_pair((rng.standard_normal((E, V)) * 0.05).astype(np.float32))
    tgt = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = ((rng.random((B, T)) > 0.3).astype(np.float32) if masked
            else None)
    return jh, th, jw, tw, tgt, mask


def _ce_port(th, tw, tgt, mask, tied, **kw):
    """Port loss, per-token loss and (dhidden, dhead) — the head given as
    [E, V] storage or as the wte.T view of [V, E] storage."""
    h = th.clone().requires_grad_(True)
    w_store = (tw.T.contiguous() if tied else tw.clone()).requires_grad_(True)
    w = w_store.T if tied else w_store
    loss, per_tok = tce.fused_ce_loss(
        h, w, torch.from_numpy(tgt),
        None if mask is None else torch.from_numpy(mask), **kw)
    dh, dw = torch.autograd.grad(loss, (h, w_store))
    return loss, per_tok, dh, (dw.T if tied else dw)


def _ce_close(port, ref, rel=1e-2):
    loss, per_tok, dh, dw = port
    jloss, jtok, jdh, jdw = ref
    assert abs(float(loss.detach()) - float(jloss)) \
        <= 1e-5 * abs(float(jloss))
    assert np.abs(f32(per_tok) - f32(jtok)).max() <= 1e-4
    for t, j in ((dh, jdh), (dw, jdw)):
        err = np.abs(f32(t) - f32(j)).max()
        assert err <= rel * np.abs(f32(j)).max(), err


@pytest.mark.parametrize("E,masked,tied", [(64, False, True),
                                           (128, True, False),
                                           (128, False, True)])
def test_fused_ce_matches_pallas(interpret, E, masked, tied):
    """fused_ce_fwd/dx/dw (plain, through FusedCE) against the Pallas
    kernels in interpret mode at m = 256, V = 2304 (a ragged 256-wide tail
    of the 1024 tile). lse/gold f32 (1e-5 relative on the loss, measured
    ~1e-7); dx, dw bf16 (1 % of the largest entry, measured <= 0.24 %)."""
    jh, th, jw, tw, tgt, mask = _ce_inputs(E, masked, seed=E)
    jm = None if mask is None else jnp.asarray(mask)

    def jfn(h, w):
        out = pfce.fused_ce_pallas_or_none(h, w, jnp.asarray(tgt), jm)
        assert out is not None
        return out[0], out[1]

    (jloss, jtok), jvjp = jax.vjp(jfn, jh, jw)
    jdh, jdw = jvjp((jnp.float32(1.0), jnp.zeros_like(jtok)))
    assert kc.takes(256, E, 2304)
    _ce_close(_ce_port(th, tw, tgt, mask, tied),
              (jloss, jtok, jdh, jdw))


@pytest.mark.parametrize("masked", [False, True])
def test_fused_ce_scan_matches_jax_scan(masked):
    """The chunk scan (use_pallas=False, chunk 1000 < V so the clamped tail
    chunk overlaps) against the JAX package's scan, and the kernel route
    against the scan. The scan's gradients come from autograd through the
    checkpointed chunks in f32, the kernel route's from bf16 dlogits: 2 %
    of the largest entry (port scan vs JAX scan measured 2e-5, kernel route
    vs scan <= 0.57 %)."""
    jh, th, jw, tw, tgt, mask = _ce_inputs(64, masked, seed=5)
    jm = None if mask is None else jnp.asarray(mask)

    def jfn(h, w):
        return jce.fused_ce_loss(h, w, jnp.asarray(tgt), jm, chunk=1000,
                                 use_pallas=False)

    (jloss, jtok), jvjp = jax.vjp(jfn, jh, jw)
    jdh, jdw = jvjp((jnp.float32(1.0), jnp.zeros_like(jtok)))
    scan = _ce_port(th, tw, tgt, mask, False, chunk=1000, use_pallas=False)
    _ce_close(scan, (jloss, jtok, jdh, jdw), rel=2e-2)
    kern = _ce_port(th, tw, tgt, mask, False)
    _ce_close(kern, tuple(t.detach() for t in scan), rel=2e-2)


@pytest.mark.parametrize("D,window,mask,dv,route", [
    (64, 0, False, None, True),
    (128, 7, False, None, True),
    (256, 0, False, None, True),
    (96, 0, False, None, False),     # head dim the kernels do not take
    (64, 0, True, None, False),      # explicit mask
    (64, 0, False, 32, False),       # dv != d
])
def test_causal_attention_grads_go_through_flash_function(D, window, mask,
                                                          dv, route):
    """On the kernel route causal_attention's output comes from
    FlashAttention (its grad_fn), the very Function the card runs; its
    gradients equal autograd through flash_attention_plain (1 % of the
    largest entry: the Function's plain backward rounds ds to bf16 where
    autograd does not, measured <= 0.4 %). Other shapes keep the plain,
    autograd-differentiated path."""
    B, T, Hq, Hkv = 2, 40, 4, 2
    rng = np.random.default_rng(D + window)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(torch.bfloat16).requires_grad_(True)

    q, k = t(B, T, Hq, D), t(B, T, Hkv, D)
    v = t(B, T, Hkv, dv or D)
    m = torch.ones((B, T, T), dtype=torch.bool) if mask else None
    out = causal_attention(q, k, v, mask=m, window=window)
    is_flash = type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert is_flash == route
    do = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32)
                          ).to(torch.bfloat16)
    got = torch.autograd.grad(out, (q, k, v), do)
    if not route:
        assert all(g is not None and torch.isfinite(g).all() for g in got)
        return
    o_ref, _ = kf.flash_attention_plain(q, k, v, scale=D ** -0.5,
                                        window=window)
    ref = torch.autograd.grad(o_ref, (q, k, v), do)
    for g, r in zip(got, ref):
        err = float((g.float() - r.float()).abs().max())
        assert err <= 1e-2 * float(r.float().abs().max()), err


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
    assert km._plan(32, 1024, 1024) == (32, 1, 8)      # decode: a cluster of 8
    assert km._plan(1, 3072, 1024) == (32, 3, 8)       # ... at most 8 splits
    assert km._plan(4096, 1024, 1024) == (128, 8, 1)   # prefill: no split
    # the backward kernels are CUDA-only entry points: a CPU tensor raises
    o = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="lies on cpu"):
        kf.flash_bwd_dkv(o, o[:, :, :1], o[:, :, :1], o, lse, o, scale=1.0)
    x = torch.zeros((4, 96), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="E=96"):
        kc._check(x, torch.zeros((96, 10), dtype=torch.bfloat16),
                  torch.zeros((4,), dtype=torch.int32))
    assert kc.takes(8, 1024, 100) and kc.takes(8, 2048, 100)
    assert not kc.takes(8, 8256, 100) and not kc.takes(8, 1000, 100)
    wte = torch.zeros((100, 64), dtype=torch.bfloat16)
    assert kc._w_strides(wte.T) == (1, 64)              # tied head in place


def _book_tensors(kind: str, K: int, N: int, seed: int):
    """A learned-codebook (or Sinkhorn) QTensor from the JAX quantizer and
    the same tensor in the port, from heavy-tailed numpy weights."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * (1 + 5 * rng.random((K, N)))
         ).astype(np.float32)
    jw = {"kmeans": lambda a: jcl.quantize_kmeans(a, bits=4),
          "kmeans3": lambda a: jcl.quantize_kmeans(a, bits=3),
          "mini": lambda a: jcl.quantize_mini(a, bits=4),
          "mini3": lambda a: jcl.quantize_mini(a, bits=3),
          "sinkhorn": lambda a: jcl.quantize_sinkhorn(a, JQFormat.INT4),
          }[kind](jnp.asarray(w))
    return jw, qtensor_from_numpy(jax_tree_to_numpy(jw), "cpu")


@pytest.mark.parametrize("kind", ["kmeans", "mini", "mini3"])
@pytest.mark.parametrize("m", [8, 256])
def test_book_matmul_matches_pallas(interpret, kind, m):
    """m = 8 reaches _qmv_book, m = 256 _qmm_book (K = 1024), with a
    per-tensor k-means book or per-row MINI books. Both decode bf16(book),
    sum exact bf16 products per group in f32 and scale the partial sums;
    only the f32 summation order differs before the final bf16 rounding —
    tolerance: 1 bf16 ulp of the largest output."""
    K, N = 1024, 128
    jw, tw = _book_tensors(kind, K, N, seed=m)
    assert km.takes(tw)
    xa = np.random.default_rng(m + 1).standard_normal((m, K)
                                                      ).astype(np.float32)
    jx, tx = bf16_pair(xa)
    ref = f32(pmm.qmatmul_pallas_or_ref(jx, jw, jnp.bfloat16))
    out = f32(qmatmul(tx, tw))
    plain = f32(km.qmatmul_book_plain(tx, tw.codes, tw.scales, tw.codebook,
                                      tw.fmt))
    np.testing.assert_array_equal(out, plain)
    assert out.shape == ref.shape == (m, N)
    assert np.abs(out - ref).max() <= 2.0 ** -7 * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["kmeans", "kmeans3", "mini", "sinkhorn"])
def test_book_qmatmul_matches_jax_model_path(kind):
    """The JAX model path (ops/matmul.qmatmul) dequantizes codebook tensors
    to bf16 and takes one dot; the port sends them to the book kernel,
    which scales f32 group partial sums (ROADMAP queue 3) — 2 % of the
    largest output. Sinkhorn row factors fold into the activations in both;
    m = 40 and K = 384 are off the JAX package's Pallas shapes."""
    from koifish_tpu.ops.matmul import qmatmul as j_qmatmul
    K, N, m = 384, 128, 40
    jw, tw = _book_tensors(kind, K, N, seed=21)
    xa = np.random.default_rng(22).standard_normal((m, K)).astype(np.float32)
    jx, tx = bf16_pair(xa)
    ref = f32(j_qmatmul(jx, jw, out_dtype=jnp.float32))
    out = f32(qmatmul(tx, tw, out_dtype=torch.float32))
    assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()


def _codes_np(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype in ("bfloat16", "float32"):
        return rng.standard_normal(shape).astype(np.float32)
    return rng.integers(0, 120, size=shape).astype(dtype)


def _pair(a: np.ndarray, dtype: str):
    """The same values for both packages in ``dtype``."""
    if dtype == "bfloat16":
        return bf16_pair(a)
    return jnp.asarray(a.astype(dtype)), torch.from_numpy(a.astype(dtype))


@pytest.mark.parametrize("dtype,dc", [("int8", 128), ("uint8", 64),
                                      ("bfloat16", 128), ("float32", 128)])
def test_slot_write_matches_pallas(interpret, dtype, dc):
    """slot_write (in place) and slot_write_plain against the Pallas slot
    writer in interpret mode, bit for bit, with tests/test_pallas.py's
    cases: slots straddling 32-row blocks and lanes at the same slot."""
    B, H, S = 4, 8, 128
    jbuf, tbuf = _pair(_codes_np((B, H, S, dc), dtype, 0), dtype)
    jval, tval = _pair(_codes_np((B, H, dc), dtype, 1), dtype)
    for slots in ([0, 31, 32, 127], [5, 5, 64, 99]):
        sl = np.asarray(slots, np.int32)
        want = psw.slot_write_or_none(jbuf, jval, jnp.asarray(sl))
        assert want is not None
        want = f32(want)
        plain = ksw.slot_write_plain(tbuf, tval, torch.from_numpy(sl))
        got = ksw.slot_write(tbuf.clone(), tval, torch.from_numpy(sl))
        np.testing.assert_array_equal(f32(plain), want)
        np.testing.assert_array_equal(f32(got), want)


def test_slot_write_scales_and_many_match_jax_ring_write():
    """The port's ring_write of [B, H, S] f32 scale buffers (the slot
    write's Dc = 1 case) against the JAX package's masked-select ring_write,
    and one launch of four buffers (a layer's K/V codes and scales) against
    four single writes."""
    from koifish_tpu.serve.kvcache import ring_write as j_ring_write
    from koifish_tpu_torch.serve.kvcache import ring_write
    B, H, S, D = 3, 2, 64, 16
    sl = np.asarray([0, 63, 63], np.int32)
    jsc, tsc = _pair(_codes_np((B, H, S), "float32", 2), "float32")
    jv, tv = _pair(_codes_np((B, H), "float32", 3), "float32")
    want = f32(j_ring_write(jsc, jv, jnp.asarray(sl)))
    np.testing.assert_array_equal(
        f32(ring_write(tsc.clone(), tv, torch.from_numpy(sl))), want)
    bufs = [torch.from_numpy(_codes_np((B, H, S, D), "int8", 4)),
            torch.from_numpy(_codes_np((B, H, S, D), "int8", 5)),
            tsc.clone(), tsc.clone() * 2]
    vals = [torch.from_numpy(_codes_np((B, H, D), "int8", 6)),
            torch.from_numpy(_codes_np((B, H, D), "int8", 7)), tv, tv * 3]
    wants = [ksw.slot_write_plain(b, v, torch.from_numpy(sl))
             for b, v in zip(bufs, vals)]
    ksw.slot_write_many(list(zip(bufs, vals)), torch.from_numpy(sl))
    for b, w in zip(bufs, wants):
        assert torch.equal(b, w)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_page_write_matches_pallas(interpret, dtype):
    """page_write (in place) and page_write_plain against the Pallas page
    writer in interpret mode and the JAX package's _page_write_ref, bit for
    bit, with tests/test_paged.py's case (distinct page ids, rows at both
    page edges)."""
    from koifish_tpu.serve.paged import PAGE, _page_write_ref
    H, NP, D, B = 4, 8, 64, 4
    jp_, tp_ = _pair(_codes_np((H, NP, PAGE, D), dtype, 8), dtype)
    jv, tv = _pair(_codes_np((B, H, D), dtype, 9), dtype)
    pids = np.asarray([0, 3, 5, 7], np.int32)
    rows = np.asarray([5, 0, 9, PAGE - 1], np.int32)
    want = psw.page_write_or_none(jp_, jv, jnp.asarray(pids),
                                  jnp.asarray(rows))
    assert want is not None
    want = f32(want)
    np.testing.assert_array_equal(
        f32(_page_write_ref(jp_, jv, jnp.asarray(pids), jnp.asarray(rows))),
        want)
    tpid, trow = torch.from_numpy(pids), torch.from_numpy(rows)
    np.testing.assert_array_equal(
        f32(ksw.page_write_plain(tp_, tv, tpid, trow)), want)
    np.testing.assert_array_equal(
        f32(ksw.page_write(tp_.clone(), tv, tpid, trow)), want)


def test_book_and_slot_wrappers_refuse_what_they_do_not_take():
    """The book kernel takes [2^bits] or [K, 2^bits] f32 books on NF4/NF3
    layouts at group 128; other codebook tensors keep the logged plain
    path. The slot-write checks run before any launch and name what they
    refuse."""
    import dataclasses
    from koifish_tpu_torch.quant.cluster import quantize_kmeans, quantize_mini
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (256, 8)).astype(np.float32))
    km_w, mini_w = quantize_kmeans(w), quantize_mini(w, bits=3)
    assert km.takes(km_w) and km.takes(mini_w)
    assert not km.takes(dataclasses.replace(km_w, codebook=torch.zeros(8)))
    assert not km.takes(dataclasses.replace(mini_w,
                                            codebook=torch.zeros((8, 8))))
    assert not km.takes(dataclasses.replace(km_w, group=64))
    assert not km.takes(dataclasses.replace(
        quantize(w, QFormat.INT4), codebook=torch.zeros(16)))
    buf = torch.zeros((2, 1, 8, 4), dtype=torch.int8)
    val = torch.zeros((2, 1, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="on the card"):
        ksw._check("slot_write", [(buf, val)],
                   (torch.zeros(2, dtype=torch.int32),), (2, 1))
