"""Host-side planning of the Hopper kernels, checked on the CPU.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
against their plain versions there). What the wrappers decide in Python is
checked here: the GEMM/GEMV launch plan of ``ops/kernels/matmul.py`` (the
GEMV splits K across the blocks of one thread-block cluster and takes no
workspace; the GEMM splits it across work items into an f32 workspace),
what the wrapper hands each launch, the library each shape loads, and the
checks of the flash backward's delta buffer.
"""
import dataclasses
import types

import pytest
import torch

from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.quant.cluster import quantize_kmeans
from koifish_tpu_torch.quant.rtn import quantize

from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.ops.kernels import flash as kf
from koifish_tpu_torch.ops.kernels import matmul as km


@pytest.mark.parametrize("m, K, N, want", [
    (32, 1024, 1024, (32, 1, 8)),       # decode GEMV: a cluster of 8 splits K
    (1, 3072, 1024, (32, 3, 8)),       # 16 tiles: 8 splits (the cluster's
                                        # most) of 3 groups
    (4096, 1024, 1024, (128, 8, 1)),    # prefill GEMM: 256 tiles, no split
    (4096, 3072, 1024, (128, 24, 1)),
    (128, 1024, 1024, (128, 1, 8)),     # a batcher bucket: 8 tiles, K split
    (512, 1024, 1024, (128, 2, 4)),     # 32 tiles: 4 splits of 2 groups
    (33, 256, 200, (128, 1, 2)),        # ragged m and N
    (4097, 1024, 520, (128, 8, 1)),     # 33 x 5 tiles fill the card
])
def test_qmatmul_plan(m, K, N, want):
    """(tile rows, groups per split, splits): the GEMM's 128 x 128 tiles aim
    at one block per SM (132), the GEMV's 32 x 64 tiles at two, with at
    most 8 splits (one cluster); every split takes at least one group and
    the splits cover K."""
    bm, gps, splits = km._plan(m, K, N)
    assert (bm, gps, splits) == want
    ng = K // km.GROUP
    assert 1 <= gps <= ng and (splits - 1) * gps < ng <= splits * gps
    assert bm == (32 if m <= km.GEMV_MAX_M else 128)
    assert km.TILES[bm] == ((32, 64) if bm == 32 else (128, 128))


@pytest.mark.parametrize("m, K, N", [
    (1, 128, 64), (1, 1024, 2048), (5, 3072, 1024), (8, 256, 132),
    (17, 2048, 1000), (32, 1024, 3072), (32, 12288, 1024), (1, 8192, 4096),
])
def test_gemv_plan_covers_k_once_in_one_cluster(m, K, N):
    """m <= 32: the splits are the blocks of one cluster (1-8), each takes
    a run of gps groups, the runs cover the K groups exactly once and none
    is empty."""
    bm, gps, splits = km._plan(m, K, N)
    ng = K // km.GROUP
    assert bm == 32 and 1 <= splits <= km.GEMV_MAX_CLUSTER
    runs = [range(r * gps, min(ng, (r + 1) * gps)) for r in range(splits)]
    assert all(len(r) >= 1 for r in runs)
    assert sorted(g for r in runs for g in r) == list(range(ng))


def _fake_launch(monkeypatch):
    """Run the wrapper's card branch on the "meta" device with the kernel
    replaced by a recorder: returns (launch argument tuples, allocations)."""
    calls, allocs = [], []
    real_empty = torch.empty

    def empty(*a, **k):
        t = real_empty(*a, **k)
        allocs.append((tuple(t.shape), t.dtype))
        return t

    def fn(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(km, "_check", lambda x2, w: None)
    monkeypatch.setattr(km, "_kernel", lambda bm: (None, fn, fn))
    monkeypatch.setattr(km._build, "check", lambda lib, rc, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch, "empty", empty)
    return calls, allocs


def _meta_weight(K, N, book=False):
    w = torch.randn((K, N), generator=torch.Generator().manual_seed(0))
    w = quantize_kmeans(w, bits=4) if book else quantize(w, QFormat.INT4)
    meta = lambda t: None if t is None else t.to("meta")   # noqa: E731
    return dataclasses.replace(w, codes=meta(w.codes), scales=meta(w.scales),
                               codebook=meta(w.codebook))


@pytest.mark.parametrize("m, K, N, book", [
    (1, 1024, 1024, False), (32, 3072, 1024, False), (5, 256, 132, False),
    (32, 1024, 2048, True), (32, 1536, 1024, False),
])
def test_gemv_launch_takes_no_workspace(monkeypatch, m, K, N, book):
    """The GEMV (m <= 32) is one launch that allocates its bf16 output and
    nothing else: no f32 workspace, no second pass; it gets the plan's
    groups per split and cluster size, and counts one launch."""
    w = _meta_weight(K, N, book)
    x = torch.empty((m, K), dtype=torch.bfloat16, device="meta")
    calls, allocs = _fake_launch(monkeypatch)
    before = dict(km.kernel_log.LAUNCHES)
    before_k = km.kernel_log.launches_by_k()
    y = km._forward(x, w)
    _, gps, splits = km._plan(m, K, N)
    assert y.shape == (m, N) and y.dtype == torch.bfloat16
    assert allocs == [((m, N), torch.bfloat16)]
    assert len(calls) == 1
    fmt = km.FORMATS[w.fmt]
    # f32_out 0 (a bf16 output); k-means: one book, per_row 0
    tail = (0, m, K, N, fmt, 0, gps, splits, 7) if book \
        else (0, m, K, N, fmt, gps, splits, 7)
    assert calls[0][-len(tail):] == tail
    assert len(calls[0]) == (5 if book else 4) + len(tail)
    name = km.BOOK_GEMV if book else km.GEMV
    assert km.kernel_log.LAUNCHES.get(name, 0) == before.get(name, 0) + 1
    # the launch is also counted under its K, and under no other K
    after_k = km.kernel_log.launches_by_k()
    assert {key: n - before_k.get(key, 0) for key, n in after_k.items()
            if n != before_k.get(key, 0)} == {(name, K): 1}


def test_gemm_launch_keeps_its_workspace(monkeypatch):
    """The GEMM (m > 32) still splits K across work items into an f32
    workspace [splits, m, N] when its tiles cannot fill the card, with a
    bf16 output or an f32 one."""
    w = _meta_weight(1024, 1024)
    x = torch.empty((128, 1024), dtype=torch.bfloat16, device="meta")
    calls, allocs = _fake_launch(monkeypatch)
    km._forward(x, w)
    assert allocs == [((128, 1024), torch.bfloat16),
                      ((8, 128, 1024), torch.float32)]
    assert calls[0][-7:] == (0, 128, 1024, 1024, km.FORMATS[QFormat.INT4],
                             1, 7)
    # an f32 output (a row-parallel partial) keeps the plan and the flag
    km._forward(x, w, torch.float32)
    assert allocs[2:] == [((128, 1024), torch.float32),
                          ((8, 128, 1024), torch.float32)]
    assert calls[1][-7:] == (1, 128, 1024, 1024, km.FORMATS[QFormat.INT4],
                             1, 7)


def test_gemm_and_gemv_build_from_their_own_sources():
    """The GEMM shape builds from csrc/qmm.cu, the GEMV from csrc/qmatmul.cu,
    each into its own library (one nvcc each, built in parallel), and a
    shared header's edit changes both digests."""
    assert _build.SOURCES[km.NAME] == "qmatmul.cu"
    assert _build.SOURCES[km.GEMM_LIB] == "qmm.cu"
    assert (_build.CSRC / "qmm.cu").exists()
    assert (_build.CSRC / "sm90.cuh").exists()
    assert _build.lib_path("qmm") != _build.lib_path("qmatmul")


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad", [
    _meta(1, 2, 9, dtype=torch.float32),     # wrong T
    _meta(1, 2, 8, dtype=torch.bfloat16),    # wrong dtype
    _meta(1, 8, 2, dtype=torch.float32),     # transposed
])
def test_flash_bwd_refuses_a_delta_it_cannot_read(bad):
    """A delta handed to the backward wrappers must be a contiguous f32
    [B,Hq,T] beside q; anything else raises before a launch."""
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="delta"):
        kf._bwd_launch(1, q, q[:, :, :1], q[:, :, :1], q, lse, q, 1.0, 0,
                       delta=bad)
