"""Host-side design of the Hopper int8 kernels of rows 11 and 5, checked on
the CPU.

Row 11, the per-tile int8 dgrad (``ops/kernels/qdgrad.py``), runs on the
card as a quantize pass (dy -> per-(row, 1024-column tile) codes and
scales) and a ``wgmma`` s8 GEMM over them: here its two plain stages are
held to the one-piece plain version bit for bit, and the wrapper's launches
and buffers are recorded on the "meta" device. Row 5, the int8 decode GEMV
(``ops/kernels/qmv_int8.py``), is one launch that splits K across the
blocks of one thread-block cluster: its plan, its launch and the plain
version's split order are held here, the split order against the
interpreted Pallas ``qmv_int8_mxu``. ``chip_smoke.py`` holds the kernels to
the plain versions on the card.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.ops import int8_train as ji8
from koifish_tpu.ops.pallas import matmul as pmm
from koifish_tpu.ops.pallas import qdgrad as pqd
from koifish_tpu.quant.rtn import quantize as j_quantize

from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.ops.kernels import qdgrad as kqd
from koifish_tpu_torch.ops.kernels import qmv_int8 as kq8
from koifish_tpu_torch.quant.rtn import quantize

from torch_helpers import bf16_pair, f32


@pytest.fixture
def interpret():
    """Pallas kernels eligible + interpreted; reset afterwards."""
    for mod in (pmm, pqd):
        mod.set_interpret(True)
    try:
        yield
    finally:
        for mod in (pmm, pqd):
            mod.set_interpret(False)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _dgrad_inputs(M, N, K, seed):
    """dy [M, N] bf16 with rows of very different sizes, and the forward's
    column codes and scales of w [K, N] (the jitted JAX quantizer's)."""
    rng = np.random.default_rng(seed)
    dy = (rng.standard_normal((M, N)) * rng.uniform(1e-4, 3.0, (M, 1))
          * rng.uniform(0.1, 2.0, (1, N))).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    jdy, tdy = bf16_pair(dy)
    jwq, jsw = jax.jit(ji8._colwise_q8)(jnp.asarray(w, jnp.bfloat16))
    return (jdy, jwq, jsw), (tdy, torch.from_numpy(np.asarray(jwq)),
                             torch.from_numpy(np.asarray(jsw)))


# ---------------------------------------------------------------------------
# row 11: the quantize pass and the GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M, N, K", [(256, 2048, 320), (100, 1024, 77),
                                     (33, 3072, 130)])
def test_dgrad_passes_equal_the_one_piece_plain(M, N, K):
    """The quantize pass followed by the int32 GEMM with the per-tile fused
    multiply-add gives dgrad_int8_tile_plain's bf16 bits exactly (the
    kernels' design computes the same function; test_qdgrad_matches_pallas
    holds that function to the interpreted Pallas kernel)."""
    _, (tdy, twq, tsw) = _dgrad_inputs(M, N, K, 21)
    q, sx = kqd.dgrad_quant_plain(tdy, tsw)
    assert q.dtype == torch.int8 and q.shape == (M, N)
    assert sx.dtype == torch.float32 and sx.shape == (M, N // kqd.BN)
    dx = kqd.dgrad_gemm_plain(q, twq, sx)
    ref = kqd.dgrad_int8_tile_plain(tdy, twq, tsw)
    assert dx.dtype == torch.bfloat16 and dx.shape == (M, K)
    np.testing.assert_array_equal(_bits(dx), _bits(ref))


def test_dgrad_quant_pass_is_the_jitted_row_quantizer_per_tile():
    """The pass's codes and scales are the jitted JAX row quantizer's on each
    1024-column tile of dy·sw, bit for bit: the codes and scales the Pallas
    kernel forms in VMEM."""
    (jdy, _, jsw), (tdy, _, tsw) = _dgrad_inputs(64, 2048, 64, 22)
    q, sx = kqd.dgrad_quant_plain(tdy, tsw)
    t = jdy.astype(jnp.float32) * jsw.reshape(1, -1)
    for j in range(2):
        jq, jsx = jax.jit(ji8._rowwise_q8)(t[:, j * 1024:(j + 1) * 1024])
        np.testing.assert_array_equal(q[:, j * 1024:(j + 1) * 1024].numpy(),
                                      np.asarray(jq))
        np.testing.assert_array_equal(sx[:, j:j + 1].numpy(),
                                      np.asarray(jsx).reshape(-1, 1))


def test_dgrad_passes_match_pallas(interpret):
    """The two plain stages against the Pallas _dgrad_call in interpret mode,
    within test_qdgrad_matches_pallas's tolerance (one bf16 ulp of the
    largest entry)."""
    (jdy, jwq, jsw), (tdy, twq, tsw) = _dgrad_inputs(256, 2048, 256, 23)
    jdx = pqd.dgrad_int8_tile_or_none(jdy, jwq, jsw)
    assert jdx is not None
    q, sx = kqd.dgrad_quant_plain(tdy, tsw)
    dx = kqd.dgrad_gemm_plain(q, twq, sx)
    err = np.abs(f32(dx) - f32(jdx)).max()
    assert err <= 2 ** -8 * np.abs(f32(jdx)).max(), err


def _recorder(monkeypatch, module, kernel):
    """Run a wrapper's card branch on the "meta" device with its kernels
    replaced by ``kernel(calls)``'s recorders: returns (calls, allocs)."""
    calls, allocs = [], []
    real_empty = torch.empty

    def empty(*a, **k):
        t = real_empty(*a, **k)
        allocs.append((tuple(t.shape), t.dtype))
        return t

    monkeypatch.setattr(module, "_kernel", lambda: kernel(calls))
    monkeypatch.setattr(module._build, "check", lambda lib, rc, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch, "empty", empty)
    return calls, allocs


@pytest.mark.parametrize("M, N, K", [(16384, 5120, 1280), (1000, 2048, 330),
                                     (5, 1024, 7)])
def test_dgrad_launches_the_pass_then_the_gemm(monkeypatch, M, N, K):
    """On a card tensor the wrapper launches the quantize pass, then the
    GEMM, and allocates exactly q [M, N] int8, sx [M, N/1024] f32 and dx
    [M, K] bf16; each launch counts once, under its own name."""
    dy = torch.empty((M, N), dtype=torch.bfloat16, device="meta")
    wq = torch.empty((K, N), dtype=torch.int8, device="meta")
    sw = torch.empty((N,), dtype=torch.float32, device="meta")

    def kernel(calls):
        rec = lambda name: lambda *a: calls.append((name,) + a) or 0  # noqa: E731
        return None, rec("quant"), rec("gemm")

    calls, allocs = _recorder(monkeypatch, kqd, kernel)
    before = dict(kqd.kernel_log.LAUNCHES)
    dx = kqd.dgrad_int8_tile(dy, wq, sw)
    assert dx.shape == (M, K) and dx.dtype == torch.bfloat16
    assert allocs == [((M, N), torch.int8), ((M, N // 1024), torch.float32),
                      ((M, K), torch.bfloat16)]
    assert [c[0] for c in calls] == ["quant", "gemm"]
    assert calls[0][-3:] == (M, N, 7) and len(calls[0]) == 1 + 4 + 3
    assert calls[1][-4:] == (M, N, K, 7) and len(calls[1]) == 1 + 4 + 4
    for name in (kqd.QUANT, kqd.COUNT):
        assert kqd.kernel_log.LAUNCHES.get(name, 0) == before.get(name, 0) + 1


@pytest.mark.parametrize("bad", ["dtype", "tile", "device"])
def test_dgrad_refuses_what_the_kernels_do_not_take(bad):
    """A card call with a wrong dtype, N off the 1024-column tile or inputs
    on two devices raises before any launch (no fallback)."""
    dy = torch.empty((8, 2048), dtype=torch.bfloat16, device="meta")
    wq = torch.empty((16, 2048), dtype=torch.int8, device="meta")
    sw = torch.empty((2048,), dtype=torch.float32, device="meta")
    if bad == "dtype":
        wq = wq.to(torch.float32)
    elif bad == "tile":
        dy, wq, sw = dy[:, :1000], wq[:, :1000], sw[:1000]
    else:
        sw = torch.zeros((2048,), dtype=torch.float32)
    with pytest.raises(ValueError, match="qdgrad"):
        kqd.dgrad_int8_tile(dy, wq, sw)


# ---------------------------------------------------------------------------
# row 5: the cluster plan and the one launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m, K, N", [
    (1, 128, 64), (1, 1024, 1024), (32, 1024, 2048), (32, 2048, 1024),
    (5, 1024, 3072), (32, 3072, 1024), (17, 384, 100), (1, 8192, 4096),
    (32, 12288, 1024),
])
def test_qmv_int8_plan_covers_k_once_in_one_cluster(m, K, N):
    """The splits are the blocks of one cluster (1-8), each takes a run of
    gps groups, the runs cover the K groups exactly once and none is
    empty; the plan is read from the shapes alone."""
    gps, splits = kq8._plan(m, K, N)
    ng = K // kq8.GROUP
    assert 1 <= splits <= kq8.GEMV_MAX_CLUSTER == 8
    runs = [range(r * gps, min(ng, (r + 1) * gps)) for r in range(splits)]
    assert all(len(r) >= 1 for r in runs)
    assert sorted(g for r in runs for g in r) == list(range(ng))
    assert kq8._plan(m, K, N) == (gps, splits)


def _meta_int8(K, N):
    w = quantize(torch.randn((K, N), generator=torch.Generator().manual_seed(0)),
                 QFormat.INT8, group=128)
    return w.codes.to("meta"), w.scales.to("meta")


@pytest.mark.parametrize("m, K, N", [(1, 1024, 1024), (5, 3072, 1024),
                                     (32, 1024, 3072), (17, 384, 100)])
def test_qmv_int8_launch_takes_no_workspace(monkeypatch, m, K, N):
    """One launch a call: its bf16 output is the only allocation (no f32
    workspace, no second pass), and the launch gets the plan's groups per
    split and cluster size and counts once."""
    codes, scales = _meta_int8(K, N)
    x = torch.empty((m, K), dtype=torch.bfloat16, device="meta")

    def kernel(calls):
        return None, lambda *a: calls.append(a) or 0

    calls, allocs = _recorder(monkeypatch, kq8, kernel)
    monkeypatch.setattr(kq8, "_check", lambda x2, c, s: None)
    before = kq8.kernel_log.LAUNCHES.get(kq8.NAME, 0)
    y = kq8.qmv_int8(x, codes, scales)
    gps, splits = kq8._plan(m, K, N)
    assert y.shape == (m, N) and y.dtype == torch.bfloat16
    assert allocs == [((m, N), torch.bfloat16)]
    assert len(calls) == 1 and len(calls[0]) == 4 + 5 + 1
    assert calls[0][4:] == (m, K, N, gps, splits, 7)
    assert kq8.kernel_log.LAUNCHES.get(kq8.NAME, 0) == before + 1


def _j_weights(K, N, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    return (j_quantize(jnp.asarray(w), JQFormat.INT8, group=128),
            quantize(torch.from_numpy(w), QFormat.INT8, group=128))


@pytest.mark.parametrize("m", [1, 5, 32])
def test_qmv_int8_split_order_matches_pallas(interpret, m):
    """qmv_int8_plain in the plan's split order (each split's chain from 0,
    the splits added in rank order: what the cluster computes) against the
    interpreted Pallas qmv_int8_mxu, within test_qmv_int8_matches_pallas's
    tolerance: one bf16 ulp of each entry, at most 0.5 % of the entries
    different at all."""
    K, N = 2048, 256
    jw, tw = _j_weights(K, N, 31)
    gps, splits = kq8._plan(m, K, N)
    assert splits > 1            # the split order is under test
    rng = np.random.default_rng(32 + m)
    xa = (rng.standard_normal((m, K)) * rng.uniform(0.1, 4, (m, 1))
          ).astype(np.float32)
    jx, tx = bf16_pair(xa)
    bm = max(8, -(-m // 8) * 8)     # the JAX dispatch pads rows to 8
    ref = f32(pmm.qmv_int8_mxu(jnp.pad(jx, ((0, bm - m), (0, 0))), jw.codes,
                               jw.scales, group=128, k=K))[:m]
    out = f32(kq8.qmv_int8_plain(tx, tw.codes, tw.scales, gps=gps))
    np.testing.assert_allclose(out, ref, rtol=2.0 ** -7, atol=1e-6)
    assert (out != ref).mean() <= 5e-3


def _jit_code(x, s):
    """The JIT rounding's code: rint(fl(x / s)), clipped."""
    return np.clip(np.rint((x / s).astype(np.float32)), -127, 127)


def _jit_code_by_reciprocal(x, s):
    """csrc/int8.cuh q8_code<JIT> in float32: rint(x·fl(1/s)), and the
    division only within 2^-14 of a rounding boundary."""
    r = (np.float32(1) / s).astype(np.float32)
    v = (x * r).astype(np.float32)
    c = np.rint(v)
    near = np.abs(v - c) > np.float32(0.5 - 2.0 ** -14)
    c[near] = np.rint((x[near] / s[near]).astype(np.float32))
    return np.clip(c, -127, 127)


def test_jit_code_by_reciprocal_is_the_division():
    """The kernels' division-light JIT code equals rint(x / s) on random
    lines and on values planted within a few ulps of every half-integer
    quotient (where a product by 1/s alone rounds the other way)."""
    rng = np.random.default_rng(41)
    a = rng.uniform(1e-6, 1e4, 20000).astype(np.float32)
    s = np.maximum(a * np.float32(1 / 127), np.float32(1e-12)).astype(np.float32)
    x = (rng.uniform(-1, 1, 20000) * a).astype(np.float32)
    np.testing.assert_array_equal(_jit_code_by_reciprocal(x, s),
                                  _jit_code(x, s))
    k = rng.integers(-127, 127, 20000).astype(np.float32) + np.float32(0.5)
    near = (k * s).astype(np.float32)
    for ulps in range(-3, 4):
        xn = np.nextafter(near, np.float32(np.inf) if ulps > 0 else
                          np.float32(-np.inf)) if ulps else near
        for _ in range(abs(ulps) - 1):
            xn = np.nextafter(xn, np.float32(np.inf) if ulps > 0 else
                              np.float32(-np.inf))
        np.testing.assert_array_equal(_jit_code_by_reciprocal(xn, s),
                                      _jit_code(xn, s))
