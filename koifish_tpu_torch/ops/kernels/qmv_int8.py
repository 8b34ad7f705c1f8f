"""Int8 decode GEMV with in-kernel activation quantization: the CUDA
kernel's wrapper and its plain version.

The kernel (``csrc/qmv_int8.cu``) replaces the JAX package's Pallas
``qmv_int8_mxu``/``_qmv_int8_kernel`` (``koifish_tpu/ops/pallas/matmul.py``,
row 5): for x [m <= 32, K] bf16, INT8 codes [K, N] and f32 scales
[K/128, N],

    y = Σ_g (q8(x_g) @ wq_g) · sx[:, g] · s[g, :]

with sx = max(max|x_g| · f32(1/127), 1e-12) per (row, 128-group) and q8 =
clip(rint(x_g / sx), ±127): the interpreted Pallas kernel's codes, bit for
bit (XLA turns its ``/ 127.0`` into a product with f32(1/127) and keeps the
division by sx). The int8 products are exact int32 sums; the f32 epilogue is
acc = fma(d·sx, s, acc), the form the interpreted kernel's bf16 outputs
agree with best.

The kernel is one launch a call: where the column tiles cannot fill the
card, K is split across the blocks of one thread-block cluster (at most
``GEMV_MAX_CLUSTER``, as the row-4 GEMV), which sum their partials in rank order in the launch, as
``qmv_int8_plain(gps=...)`` does. No workspace.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.ops.kernels.matmul import GEMV_MAX_CLUSTER
from koifish_tpu_torch.ops.kernels.quantize import int8_dot, quantize_plain
from koifish_tpu_torch.quant.qtensor import QTensor
from koifish_tpu_torch.utils import kernel_log

NAME = "qmv_int8"       # library and launch counter
GROUP = 128
MAX_M = 32
BN = 128                # output columns per block (csrc/qmv_int8.cu)
# enough blocks in flight to cover the card's 132 SMs twice
_TARGET_BLOCKS = 264

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load(NAME)
        fn = lib.koifish_qmv_int8
        # x codes scales out | m K N gps splits | stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def qmv_int8_plain(x2: torch.Tensor, codes: torch.Tensor,
                   scales: torch.Tensor, gps: Optional[int] = None
                   ) -> torch.Tensor:
    """x2 [m, K] bf16 against INT8 codes [K, N] and f32 scales [K/128, N]
    -> [m, N] bf16, group by group as the kernel computes it. The update
    acc = fma(d·sx, s, acc) is emulated in f64: the product of two f32s is
    exact there and the sum rounds once to f64, then to f32. ``gps`` sums
    the groups in the kernel's order for a K split of ``gps`` groups per
    block (each split's chain from 0, the splits' sums then added in
    order); ``None`` runs one chain over all groups, as the Pallas kernel
    does."""
    m, K = x2.shape
    ng = K // GROUP
    gps = gps or ng
    s = scales.to(torch.float32)
    y = None
    for g0 in range(0, ng, gps):
        acc = torch.zeros((m, codes.shape[1]), dtype=torch.float32,
                          device=x2.device)
        for g in range(g0, min(ng, g0 + gps)):
            q, sx = quantize_plain(x2[:, g * GROUP:(g + 1) * GROUP], 1, "jit")
            d = int8_dot(q, codes[g * GROUP:(g + 1) * GROUP]).to(torch.float32)
            t = (d * sx).to(torch.float64)
            acc = (t * s[g].to(torch.float64) + acc.to(torch.float64)
                   ).to(torch.float32)
        y = acc if y is None else y + acc
    return y.to(torch.bfloat16)


def takes(w: QTensor) -> bool:
    """INT8 codes with symmetric group-128 scales."""
    return (w.fmt is QFormat.INT8 and w.zeros is None and w.group == GROUP
            and w.codebook is None and w.row_scale is None)


def _plan(m: int, K: int, N: int):
    """(groups per split, splits): split K across the blocks of one cluster
    (at most ``GEMV_MAX_CLUSTER``) when the column tiles alone cannot fill
    the card; every split takes at least one group."""
    ng = K // GROUP
    tiles = -(-N // BN)
    splits = min(ng, GEMV_MAX_CLUSTER, max(1, -(-_TARGET_BLOCKS // tiles)))
    gps = -(-ng // splits)
    return gps, -(-ng // gps)


def _check(x2: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor):
    m, K = x2.shape
    N = codes.shape[-1]
    shape = f"x{tuple(x2.shape)} codes{tuple(codes.shape)}"
    if not (1 <= m <= MAX_M) or K % GROUP or N % 4 \
            or tuple(codes.shape) != (K, N):
        raise ValueError(f"qmv_int8: {shape}: need x [1..{MAX_M}, K] and "
                         f"codes [K, N] with K % {GROUP} == 0, N % 4 == 0")
    if tuple(scales.shape) != (K // GROUP, N):
        raise ValueError(f"qmv_int8: {shape}: need scales [{K // GROUP}, "
                         f"{N}], got {tuple(scales.shape)}")
    for name, t, dt in (("x", x2, torch.bfloat16), ("codes", codes,
                                                     torch.int8),
                        ("scales", scales, torch.float32)):
        if t.device != x2.device or t.device.type != "cuda":
            raise ValueError(f"qmv_int8: {name} lies on {t.device}, need "
                             f"the CUDA device of x ({x2.device})")
        if t.dtype != dt:
            raise ValueError(f"qmv_int8: {name} is {t.dtype}, need {dt}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"qmv_int8: {name} of {shape} must be "
                             f"contiguous and 16-byte aligned")


def qmv_int8(x2: torch.Tensor, codes: torch.Tensor,
             scales: torch.Tensor) -> torch.Tensor:
    """``x2 [m <= 32, K] bf16`` against INT8 codes [K, N] and f32 scales
    [K/128, N] -> [m, N] bf16. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if x2.device.type == "cpu":
        return qmv_int8_plain(x2, codes, scales)
    if torch.is_grad_enabled() and x2.requires_grad:
        raise NotImplementedError(
            f"qmv_int8: x{tuple(x2.shape)} requires a gradient, and the "
            f"kernel's in-kernel activation rounding has none (nor in the "
            f"JAX package); for a differentiable INT8 product set "
            f"koifish_tpu_torch.ops.matmul.INT8_GEMV = \"dot\"")
    _check(x2, codes, scales)
    m, K = x2.shape
    N = codes.shape[1]
    gps, splits = _plan(m, K, N)
    out = torch.empty((m, N), dtype=torch.bfloat16, device=x2.device)
    lib, fn = _kernel()
    rc = fn(x2.data_ptr(), codes.data_ptr(), scales.data_ptr(),
            out.data_ptr(), m, K, N, gps, splits,
            torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(lib, rc, f"qmv_int8 x{tuple(x2.shape)} N={N}")
    kernel_log.count(NAME)
    return out
