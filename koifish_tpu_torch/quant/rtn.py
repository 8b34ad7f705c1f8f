"""Round-to-nearest (RTN) and NormalFloat groupwise weight quantization.

The same math as the JAX package's ``quant/rtn.py``; packed codes and f32
scales come out byte-identical. Weights round **half away from zero**
(``_round_away``, the CUDA ``roundf`` the reference uses) — not
``torch.round``, which rounds half to even.

The JAX package has two entries with different bytes: eager ``quantize``
and the jitted ``quantize_jit`` that quantize-at-load (``quant/apply.py``)
calls. Compiled, XLA rewrites each division by a constant (``absmax / 7``)
into a multiplication by its f32 reciprocal, which moves some scales by an
ulp and some codes across a rounding edge. The port keeps both names with
the same results: ``quantize`` divides, ``quantize_jit`` multiplies by the
reciprocal.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from koifish_tpu_torch.dtypes import DEFAULT_GROUP, QFormat
from koifish_tpu_torch.quant.packing import pack_codes
from koifish_tpu_torch.quant.qtensor import QTensor, codebook_for


def _round_away(x: torch.Tensor) -> torch.Tensor:
    """round-half-away-from-zero."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _grouped(w: torch.Tensor, group: int) -> torch.Tensor:
    n_in = w.shape[0]
    if n_in % group:
        raise ValueError(f"in-features {n_in} not divisible by group {group}")
    return w.reshape(n_in // group, group, -1)


def quantize(w: torch.Tensor, fmt: QFormat, group: int = DEFAULT_GROUP,
             symmetric: bool = True, scale_dtype=torch.float32) -> QTensor:
    """Quantize weight ``w`` ([in, out]) to ``fmt`` with per-group scales
    (the JAX package's eager ``quantize``)."""
    return _quantize(w, fmt, group, symmetric, scale_dtype, compiled=False)


def quantize_jit(w: torch.Tensor, fmt: QFormat, group: int = DEFAULT_GROUP,
                 symmetric: bool = True) -> QTensor:
    """The quantize-at-load entry: the JAX package's compiled
    ``quantize_jit``, constant divisions taken as reciprocal products."""
    return _quantize(w, fmt, group, symmetric, torch.float32, compiled=True)


def _quantize(w, fmt, group, symmetric, scale_dtype, compiled):
    def div_const(x, c: float):
        if compiled:   # XLA: x / c -> x * f32(1 / c)
            return x * torch.tensor(1.0 / c, dtype=torch.float32)
        return x / c

    orig_shape = tuple(w.shape)
    w2 = w.reshape(w.shape[0], -1).to(torch.float32)
    g = _grouped(w2, group)                      # [G, group, out]

    if fmt in (QFormat.F8_E5M2, QFormat.F8_E4M3):
        fmax = float(torch.finfo(fmt.torch_dtype).max)
        absmax = torch.amax(torch.abs(g), dim=1)
        scale = torch.clamp(div_const(absmax, fmax), min=1e-12)
        codes = (g / scale[:, None, :]).to(fmt.torch_dtype)
        return QTensor(codes=codes.reshape(w2.shape),
                       scales=scale.to(scale_dtype), zeros=None,
                       fmt=fmt, shape=orig_shape, group=group)
    if fmt in (QFormat.NF4, QFormat.NF3):
        absmax = torch.amax(torch.abs(g), dim=1)     # [G, out]
        scale = torch.clamp(absmax, min=1e-12)
        book = codebook_for(fmt, w.device)
        mids = (book[1:] + book[:-1]) / 2.0
        normed = g / scale[:, None, :]
        raw = torch.searchsorted(mids, normed.reshape(-1)).reshape(g.shape)
        codes, zeros = raw.to(torch.uint8), None
    elif fmt is QFormat.BINARY:
        scale = torch.clamp(torch.mean(torch.abs(g), dim=1), min=1e-12)
        codes, zeros = (g >= 0).to(torch.uint8), None
    elif fmt is QFormat.TERNARY:
        scale = torch.clamp(torch.mean(torch.abs(g), dim=1), min=1e-12)
        q = torch.clamp(_round_away(g / scale[:, None, :]), -1, 1)
        codes, zeros = (q + 1).to(torch.uint8), None
    elif symmetric:
        bits = fmt.bits
        qmax = float((1 << (bits - 1)) - 1)
        absmax = torch.amax(torch.abs(g), dim=1)
        # INT2 has levels {-2,-1,0,1}: absmax/2 keeps ±1 populated
        divisor = 2.0 if fmt is QFormat.INT2 else qmax
        scale = torch.clamp(div_const(absmax, divisor), min=1e-12)
        q = torch.clamp(_round_away(g / scale[:, None, :]), -qmax - 1, qmax)
        if fmt is QFormat.INT8:
            codes, zeros = q.to(torch.int8), None
        else:
            bias = 1 << (bits - 1)
            codes, zeros = (q + bias).to(torch.uint8), None
    else:
        # asymmetric: scale=(max-min)/(2^b-1), zero offset stored per group
        bits = fmt.bits
        levels = float((1 << bits) - 1)
        lo = torch.amin(g, dim=1)
        hi = torch.amax(g, dim=1)
        scale = torch.clamp(div_const(hi - lo, levels), min=1e-12)
        q = torch.clamp(_round_away((g - lo[:, None, :]) / scale[:, None, :]),
                        0, levels)
        if fmt is QFormat.INT8:
            codes = (q - 128).to(torch.int8)
            lo = lo + 128.0 * scale
        else:
            codes = q.to(torch.uint8)
        zeros = lo.to(scale_dtype)

    flat = codes.reshape(w2.shape[0], w2.shape[1])
    packed = pack_codes(flat, fmt, group=group)
    return QTensor(
        codes=packed,
        scales=scale.to(scale_dtype),
        zeros=zeros,
        fmt=fmt,
        shape=orig_shape if len(orig_shape) == 2 else (w2.shape[0], w2.shape[1]),
        group=group,
    )


def quant_error(w: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Relative L2 dequantization error, an f32 scalar: the reference's
    quality probe (``T_errQ``, src/CLI_params.hpp:519; GeQuant.cpp:885)."""
    wf = w.to(torch.float32)
    wd = qt.dequantize(torch.float32).reshape(w.shape)
    return torch.linalg.norm(wf - wd) / torch.clamp(torch.linalg.norm(wf),
                                                     min=1e-12)


def quantize_best(w: torch.Tensor, fmts: Sequence[QFormat],
                  group: int = DEFAULT_GROUP) -> Tuple[QTensor, float]:
    """Sweep formats and keep the lowest-error one (the reference's
    ``LowBit_worker`` per-method sweep, GeQuant.cpp:830-905)."""
    best: Optional[QTensor] = None
    best_err = float("inf")
    for fmt in fmts:
        qt = quantize(w, fmt, group=group)
        err = float(quant_error(w, qt))
        if err < best_err:
            best, best_err = qt, err
    assert best is not None
    return best, best_err


def fake_quant(w: torch.Tensor, fmt: QFormat, group: int = DEFAULT_GROUP
               ) -> torch.Tensor:
    """quantize -> dequantize in the weight's dtype (the QAT forward; the
    JAX package's ``fake_quant``), in ``quantize_jit``'s rounding: the QAT
    forward runs inside the jitted JAX train step."""
    return quantize_jit(w, fmt, group=group).dequantize(w.dtype).reshape(
        w.shape)
