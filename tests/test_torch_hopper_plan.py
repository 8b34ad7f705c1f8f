"""Host-side planning of the Hopper kernels, checked on the CPU.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
against their plain versions there). What the wrappers decide in Python is
checked here: the GEMM/GEMV launch plan of ``ops/kernels/matmul.py``, the
library each shape loads, and the checks of the flash backward's delta
buffer.
"""
import pytest
import torch

from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.ops.kernels import flash as kf
from koifish_tpu_torch.ops.kernels import matmul as km


@pytest.mark.parametrize("m, K, N, want", [
    (32, 1024, 1024, (32, 1, 8)),       # decode GEMV: K split 8 ways
    (1, 3072, 1024, (32, 2, 12)),      # 16 tiles: 12 splits of 2 groups
    (4096, 1024, 1024, (128, 8, 1)),    # prefill GEMM: 256 tiles, no split
    (4096, 3072, 1024, (128, 24, 1)),
    (128, 1024, 1024, (128, 1, 8)),     # a batcher bucket: 8 tiles, K split
    (512, 1024, 1024, (128, 2, 4)),     # 32 tiles: 4 splits of 2 groups
    (33, 256, 200, (128, 1, 2)),        # ragged m and N
    (4097, 1024, 520, (128, 8, 1)),     # 33 x 5 tiles fill the card
])
def test_qmatmul_plan(m, K, N, want):
    """(tile rows, groups per split, splits): the GEMM's 128 x 128 tiles aim
    at one block per SM (132), the GEMV's 32 x 64 tiles at two; every split
    takes at least one group and the splits cover K."""
    bm, gps, splits = km._plan(m, K, N)
    assert (bm, gps, splits) == want
    ng = K // km.GROUP
    assert 1 <= gps <= ng and (splits - 1) * gps < ng <= splits * gps
    assert bm == (32 if m <= km.GEMV_MAX_M else 128)
    assert km.TILES[bm] == ((32, 64) if bm == 32 else (128, 128))


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
