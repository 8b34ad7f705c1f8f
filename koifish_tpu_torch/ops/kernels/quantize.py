"""Absmax int8 quantization per row or per column: the CUDA kernel's
wrappers and plain versions, and the exact int8 product ``int8_dot``.

The kernel (``csrc/quantize.cu``) replaces the JAX package's Pallas
``rowquant`` and ``colquant`` (``koifish_tpu/ops/pallas/quantize.py``, row
12) and also performs the int8 training quantizers that the JAX package
leaves to XLA (``ops/int8_train.py::_rowwise_q8``/``_colwise_q8`` and the
fused CE's ``_q8_row`` and column quantizer). ``rounding`` picks the
convention (``csrc/int8.cuh``):

- ``"pallas"``: scale = max(a, 1e-12)·f32(1/127), code = rint(x·(127 /
  max(a, 1e-12))) — ``rowquant``/``colquant``;
- ``"jit"``: scale = max(a·f32(1/127), 1e-12), code = rint(x / scale) —
  the int8 training quantizers as the jitted JAX train step computes them
  (XLA turns the division by 127 into a product with its reciprocal);
- ``"eager"``: scale = max(a / 127, 1e-12), code = rint(x / scale) — the
  same functions run op by op.

Codes are clipped to [-127, 127] and round half to even. A tensor and its
transposed view are both taken as they lie in memory: the codes come out
in the input's storage order, so ``colquant(wte.T)`` quantizes the tied head
per vocabulary row in ``wte``'s own storage order, with no transposed copy.
"""
from __future__ import annotations

import ctypes

import torch

from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.utils import kernel_log

NAME = "quantize"
ROW, COL = "rowquant", "colquant"      # launch counters
ROUNDINGS = {"pallas": 0, "jit": 1, "eager": 2}
#: the int8 training quantizers' rounding: the jitted JAX train step's
TRAIN_ROUNDING = "jit"
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

_fns = None


def _kernels():
    global _fns
    if _fns is None:
        lib = _build.load(NAME)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sig = {
            # x q scale | R C | ldx ldq | dtype mode | stream
            "koifish_quant_rows": [P] * 3 + [I] * 2 + [L] * 2 + [I] * 2 + [P],
            # x q scale ws | R C | ldx ldq | dtype mode | stream
            "koifish_quant_cols": [P] * 4 + [I] * 2 + [L] * 2 + [I] * 2 + [P],
            "koifish_quant_cols_chunks": [I],
        }
        fns = {}
        for name, argtypes in sig.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        _fns = (lib, fns)
    return _fns


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def quantize_plain(x: torch.Tensor, dim: int, rounding: str = "pallas"):
    """(codes int8 with x's shape, f32 scales with ``dim`` kept as 1) of the
    absmax quantization of x's lines along ``dim`` (1: one scale per row, 0:
    one per column), in the ``rounding`` convention."""
    xf = x.to(torch.float32)
    a = xf.abs().amax(dim=dim, keepdim=True)
    if rounding == "pallas":
        am = a.clamp_min(1e-12)
        scale = am * torch.full_like(am, 1.0 / 127.0)     # · f32(1/127)
        # not ``127.0 / am``: a scalar over a tensor is reciprocal(am)·127
        v = xf * (torch.full_like(am, 127.0) / am)
    elif rounding in ("jit", "eager"):
        scale = (a * torch.full_like(a, 1.0 / 127.0) if rounding == "jit"
                 else a / 127.0).clamp_min(1e-12)
        v = xf / scale
    else:
        raise ValueError(f"quantize: rounding {rounding!r} is not one of "
                         f"{sorted(ROUNDINGS)}")
    return torch.round(v).clamp(-127, 127).to(torch.int8), scale


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int32 product a [m, k] · b [k, n] of int8 codes: the JAX
    package's ``_i8dot``, which XLA computes (no Pallas kernel). On the card
    ``torch._int_mm`` on row-major operands, whose cuBLASLt route needs
    m > 16 and k, n multiples of 8: other shapes are padded with zero codes,
    which add nothing."""
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out if (mp, np_) == (m, n) else out[:m, :n]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _storage(x: torch.Tensor):
    """(transposed, R, C, ld) of a 2-D x seen as R storage rows of C
    contiguous elements, ld apart: x itself (row-major, a column slice
    allowed) or x.T (x a transposed view)."""
    if x.dim() != 2:
        raise ValueError(f"quantize: x{tuple(x.shape)} must be 2-D")
    M, K = x.shape
    if x.stride(1) == 1 and (M == 1 or x.stride(0) >= K):
        return False, M, K, max(x.stride(0), K)
    if x.stride(0) == 1 and (K == 1 or x.stride(1) >= M):
        return True, K, M, max(x.stride(1), M)
    raise ValueError(f"quantize: x{tuple(x.shape)} strides {x.stride()}: "
                     f"need unit stride on one axis")


def quantize(x: torch.Tensor, dim: int, rounding: str = "pallas"):
    """The absmax int8 quantization of x's lines along ``dim`` — 1 per row
    (``rowquant``), 0 per column (``colquant``): (codes int8 with x's shape
    and storage order, f32 scales [M, 1] or [1, K]). A CPU tensor takes the
    plain version; on the card x is bf16 or f32 with a unit stride on one
    axis (row-major, a transposed view, or a slice of either)."""
    if x.device.type == "cpu":
        return quantize_plain(x, dim, rounding)
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantize: x is {x.dtype}, need bf16 or f32")
    if rounding not in ROUNDINGS:
        raise ValueError(f"quantize: rounding {rounding!r} is not one of "
                         f"{sorted(ROUNDINGS)}")
    transposed, R, C, ld = _storage(x)
    lib, fns = _kernels()
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    st = torch.cuda.current_stream(x.device).cuda_stream
    args = (R, C, ld, C, _DTYPES[x.dtype], ROUNDINGS[rounding], st)
    # a line along dim is a storage row when the storage is x for dim 1, or
    # x.T for dim 0; otherwise it is a storage column
    if (dim == 1) != transposed:
        vec = 8 if x.dtype == torch.bfloat16 else 4
        if C % vec or ld % vec or x.data_ptr() % 16:
            raise ValueError(f"quantize: x{tuple(x.shape)} rows of {C} "
                             f"elements: the row kernel needs a multiple of "
                             f"{vec} and 16-byte aligned rows")
        scale = torch.empty((R,), dtype=torch.float32, device=x.device)
        rc = fns["koifish_quant_rows"](x.data_ptr(), q.data_ptr(),
                                       scale.data_ptr(), *args)
    else:
        scale = torch.empty((C,), dtype=torch.float32, device=x.device)
        ws = torch.empty((fns["koifish_quant_cols_chunks"](R), C),
                         dtype=torch.float32, device=x.device)
        rc = fns["koifish_quant_cols"](x.data_ptr(), q.data_ptr(),
                                       scale.data_ptr(), ws.data_ptr(), *args)
    _build.check(lib, rc, f"quantize x{tuple(x.shape)} dim={dim}")
    kernel_log.count(ROW if dim == 1 else COL)
    q = q.T if transposed else q
    return q, (scale[:, None] if dim == 1 else scale[None, :])


def rowquant(x: torch.Tensor, rounding: str = "pallas"):
    """x [M, K] -> (codes int8 [M, K], scale f32 [M, 1])."""
    return quantize(x, 1, rounding)


def colquant(x: torch.Tensor, rounding: str = "pallas"):
    """x [M, K] -> (codes int8 [M, K], scale f32 [1, K])."""
    return quantize(x, 0, rounding)
