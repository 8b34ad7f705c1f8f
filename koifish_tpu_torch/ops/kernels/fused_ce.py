"""Fused classifier cross-entropy: the CUDA kernels' wrappers, their plain
versions and the autograd Function that joins them.

The kernels (``csrc/fused_ce.cuh``, built as ``fused_ce.cu`` and
``fused_ce_int8.cu``) replace both flavours of the JAX package's Pallas
kernels in ``koifish_tpu/ops/pallas/fused_ce.py``: ``_fwd_call``
(``fused_ce_fwd``: per-row lse and gold logit), ``_dx_call``
(``fused_ce_dx``) and ``_dw_call`` (``fused_ce_dw``), and with
``int8=True`` ``fused_ce_fwd_int8``, ``fused_ce_dx_int8`` and
``fused_ce_dw_int8``: logits = (xq·wq)_int32·sx·sw from the row-quantized
x and the column-quantized head, dx against bf16(wq·sw), dw from the bf16
x. Each recomputes its
logits tile from x [m, E] and the head w [E, V], so the [m, V] logits never
reach device memory. The head is read through its strides: an untied
``head`` [E, V] row-major, or the tied ``wte.T`` view of a row-major
[V, E] ``wte``, in place.

Rounding follows the Pallas kernels: logits in f32 (bf16 products, f32
sums); p = exp(logits − lse); dlogits = bf16((p − onehot)·wtok) with the
vocab tail masked; dx and dw accumulate in f32 and round to bf16 once.

``FusedCE`` has the contract of the Pallas ``_ce`` custom VJP
(``fused_ce.py:370-446``): ``(loss, per_tok) = FusedCE.apply(x, w, tgt,
mask, int8)``. On a CUDA tensor its forward and backward launch the
kernels; on a CPU tensor they run the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.ops.kernels import quantize as kq
from koifish_tpu_torch.ops.kernels.quantize import int8_dot
from koifish_tpu_torch.ops.tracectx import current_int8
from koifish_tpu_torch.utils import kernel_log

NAME_FWD, NAME_DX, NAME_DW = "fused_ce_fwd", "fused_ce_dx", "fused_ce_dw"
NAME_FWD8, NAME_DX8, NAME_DW8 = (n + "_int8" for n in (NAME_FWD, NAME_DX,
                                                       NAME_DW))
#: E the kernels take: a multiple of 64 up to 1280 (the forward keeps 64
#: x rows in shared memory; dx and dw split E into parts of <= 1024)
E_STEP, E_MAX = 64, 1280
_ROWS = 2048        # rows per chunk of the plain versions (bounds memory)

_fns = None
_fns8 = None


def _kernels8():
    global _fns8
    if _fns8 is None:
        lib = _build.load("fused_ce_int8")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sig = {
            # xq sx wq sw tgt | lse gold | ws | m E V | ldw | stream
            "koifish_fused_ce_int8_fwd": [P] * 8 + [I] * 3 + [L, P],
            # xq sx wq sw tgt lse wtok | dx | ws | m E V | ldw | stream
            "koifish_fused_ce_int8_dx": [P] * 9 + [I] * 3 + [L, P],
            # x xq sx wq sw tgt lse wtok | dw | m E V | ldw sde sdv | stream
            "koifish_fused_ce_int8_dw": [P] * 9 + [I] * 3 + [L] * 3 + [P],
            "koifish_fused_ce_int8_splits": [I, I, I],
        }
        fns = {}
        for name, argtypes in sig.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        _fns8 = (lib, fns)
    return _fns8


def _kernels():
    global _fns
    if _fns is None:
        lib = _build.load("fused_ce")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sig = {
            # x w tgt | lse gold | ws | m E V | swe swv | stream
            "koifish_fused_ce_fwd": [P] * 6 + [I] * 3 + [L] * 2 + [P],
            # x w tgt lse wtok | dx | ws | m E V | swe swv | stream
            "koifish_fused_ce_dx": [P] * 7 + [I] * 3 + [L] * 2 + [P],
            # x w tgt lse wtok | dw | m E V | swe swv | sde sdv | stream
            "koifish_fused_ce_dw": [P] * 6 + [I] * 3 + [L] * 4 + [P],
            # which (0 fwd, 1 dx) | m V
            "koifish_fused_ce_splits": [I, I, I],
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

def _logits(x, w):
    """f32 logits of bf16 operands: exact products, f32 sums."""
    return x.to(torch.float32) @ w.to(torch.float32)


def _dlogits(x, w, tgt, lse, wtok):
    """bf16((p − onehot)·wtok) for the rows of x, p = exp(logits − lse)."""
    p = torch.exp(_logits(x, w) - lse[:, None])
    rows = torch.arange(x.shape[0], device=x.device)
    p[rows, tgt.long()] -= 1.0
    return (p * wtok[:, None]).to(torch.bfloat16)


def fused_ce_fwd_plain(x: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor):
    """(lse [m], gold [m]) f32 of logits = x [m,E] · w [E,V]."""
    lse, gold = [], []
    for r in range(0, x.shape[0], _ROWS):
        lg = _logits(x[r:r + _ROWS], w)
        lse.append(torch.logsumexp(lg, dim=-1))
        gold.append(lg.gather(1, tgt[r:r + _ROWS].long()[:, None])[:, 0])
    return torch.cat(lse), torch.cat(gold)


def fused_ce_dx_plain(x, w, tgt, lse, wtok):
    """dx [m, E] bf16 = dlogits · wᵀ, summed in f32."""
    wf = w.to(torch.float32)
    out = [(_dlogits(x[r:r + _ROWS], w, tgt[r:r + _ROWS], lse[r:r + _ROWS],
                     wtok[r:r + _ROWS]).to(torch.float32) @ wf.T)
           for r in range(0, x.shape[0], _ROWS)]
    return torch.cat(out).to(torch.bfloat16)


def fused_ce_dw_plain(x, w, tgt, lse, wtok):
    """dw [E, V] bf16 = xᵀ · dlogits, summed in f32 over all rows."""
    acc = torch.zeros(w.shape, dtype=torch.float32, device=x.device)
    for r in range(0, x.shape[0], _ROWS):
        d = _dlogits(x[r:r + _ROWS], w, tgt[r:r + _ROWS], lse[r:r + _ROWS],
                     wtok[r:r + _ROWS])
        acc += x[r:r + _ROWS].to(torch.float32).T @ d.to(torch.float32)
    return acc.to(torch.bfloat16)


def _logits8(xq, sx, wq, sw):
    """f32 logits (xq·wq)_int32·sx·sw, as the Pallas ``_tile_logits``."""
    return (int8_dot(xq, wq).to(torch.float32) * sx.reshape(-1, 1)
            * sw.reshape(1, -1))


def _dlogits8(xq, sx, wq, sw, tgt, lse, wtok):
    p = torch.exp(_logits8(xq, sx, wq, sw) - lse[:, None])
    rows = torch.arange(xq.shape[0], device=xq.device)
    p[rows, tgt.long()] -= 1.0
    return (p * wtok[:, None]).to(torch.bfloat16)


def fused_ce_fwd_int8_plain(xq, sx, wq, sw, tgt):
    """(lse [m], gold [m]) f32 of the int8 logits."""
    lse, gold = [], []
    for r in range(0, xq.shape[0], _ROWS):
        lg = _logits8(xq[r:r + _ROWS], sx.reshape(-1)[r:r + _ROWS], wq, sw)
        lse.append(torch.logsumexp(lg, dim=-1))
        gold.append(lg.gather(1, tgt[r:r + _ROWS].long()[:, None])[:, 0])
    return torch.cat(lse), torch.cat(gold)


def fused_ce_dx_int8_plain(xq, sx, wq, sw, tgt, lse, wtok):
    """dx [m, E] bf16 = dlogits · bf16(wq·sw)ᵀ, summed in f32."""
    wd = (wq.to(torch.float32) * sw.reshape(1, -1)).to(torch.bfloat16)
    wf = wd.to(torch.float32)
    sxf = sx.reshape(-1)
    out = [(_dlogits8(xq[r:r + _ROWS], sxf[r:r + _ROWS], wq, sw,
                      tgt[r:r + _ROWS], lse[r:r + _ROWS], wtok[r:r + _ROWS]
                      ).to(torch.float32) @ wf.T)
           for r in range(0, xq.shape[0], _ROWS)]
    return torch.cat(out).to(torch.bfloat16)


def fused_ce_dw_int8_plain(x, xq, sx, wq, sw, tgt, lse, wtok):
    """dw [E, V] bf16 = xᵀ · dlogits with the bf16 x, summed in f32."""
    acc = torch.zeros(wq.shape, dtype=torch.float32, device=x.device)
    sxf = sx.reshape(-1)
    for r in range(0, x.shape[0], _ROWS):
        d = _dlogits8(xq[r:r + _ROWS], sxf[r:r + _ROWS], wq, sw,
                      tgt[r:r + _ROWS], lse[r:r + _ROWS], wtok[r:r + _ROWS])
        acc += x[r:r + _ROWS].to(torch.float32).T @ d.to(torch.float32)
    return acc.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def takes(m: int, e: int, v: int) -> bool:
    """Shapes the kernels take: E a multiple of 64 up to 1280, any m, V."""
    return m >= 1 and v >= 1 and e % E_STEP == 0 and E_STEP <= e <= E_MAX


def _w_strides(w: torch.Tensor):
    """(swe, swv) of a head view w [E, V] with a unit stride on E or V."""
    swe, swv = w.stride()
    if swe != 1 and swv != 1:
        raise ValueError(f"fused_ce: head strides {w.stride()}: need a unit "
                         f"stride on E ([V, E] storage) or on V ([E, V])")
    if (swe if swv == 1 else swv) % 8 or w.data_ptr() % 16:
        raise ValueError(f"fused_ce: head strides {w.stride()}: rows must be "
                         f"16-byte aligned")
    return swe, swv


def _check(x, w, tgt, cols=()):
    m, e = x.shape
    v = w.shape[1]
    if w.shape[0] != e or tgt.shape != (m,):
        raise ValueError(f"fused_ce: x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"tgt{tuple(tgt.shape)}: need x [m,E], w [E,V], "
                         f"tgt [m]")
    if not takes(m, e, v):
        raise ValueError(f"fused_ce: E={e}: the kernels take E a multiple "
                         f"of {E_STEP} up to {E_MAX}")
    for name, t, dt in (("x", x, torch.bfloat16), ("w", w, torch.bfloat16),
                        ("tgt", tgt, torch.int32)) + tuple(cols):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"fused_ce: {name} lies on {t.device}, need "
                             f"the CUDA device of x ({x.device})")
        if t.dtype != dt:
            raise ValueError(f"fused_ce: {name} is {t.dtype}, need {dt}")
        if name != "w" and not t.is_contiguous():
            raise ValueError(f"fused_ce: {name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("fused_ce: x must be 16-byte aligned")
    return m, e, v


def _workspace(fns, which: int, m: int, v: int, per_row: int, dev):
    """The f32 [splits, m, per_row] workspace of a vocab-split launch of the
    forward (which 0) or dx (which 1) kernel, or None with one split."""
    splits = fns["koifish_fused_ce_splits"](which, m, v)
    if splits <= 1:
        return None
    return torch.empty((splits, m, per_row), dtype=torch.float32, device=dev)


def fused_ce_fwd(x: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor):
    """(lse [m], gold [m]) f32 of the logits x [m,E] · w [E,V], never
    written. A CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return fused_ce_fwd_plain(x, w, tgt)
    m, e, v = _check(x, w, tgt)
    swe, swv = _w_strides(w)
    lib, fns = _kernels()
    lse = torch.empty((m,), dtype=torch.float32, device=x.device)
    gold = torch.empty_like(lse)
    ws = _workspace(fns, 0, m, v, 3, x.device)
    rc = fns["koifish_fused_ce_fwd"](
        x.data_ptr(), w.data_ptr(), tgt.data_ptr(), lse.data_ptr(),
        gold.data_ptr(), None if ws is None else ws.data_ptr(), m, e, v,
        swe, swv, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, f"fused_ce_fwd x{tuple(x.shape)} V={v}")
    kernel_log.count(NAME_FWD)
    return lse, gold


def _bwd_cols(lse, wtok):
    return (("lse", lse, torch.float32), ("wtok", wtok, torch.float32))


def fused_ce_dx(x, w, tgt, lse, wtok):
    """dx [m, E] bf16 = bf16((p − onehot)·wtok) · wᵀ with the logits
    recomputed. A CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return fused_ce_dx_plain(x, w, tgt, lse, wtok)
    m, e, v = _check(x, w, tgt, _bwd_cols(lse, wtok))
    swe, swv = _w_strides(w)
    lib, fns = _kernels()
    dx = torch.empty((m, e), dtype=torch.bfloat16, device=x.device)
    ws = _workspace(fns, 1, m, v, e, x.device)
    rc = fns["koifish_fused_ce_dx"](
        x.data_ptr(), w.data_ptr(), tgt.data_ptr(), lse.data_ptr(),
        wtok.data_ptr(), dx.data_ptr(), None if ws is None else ws.data_ptr(),
        m, e, v, swe, swv, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, f"fused_ce_dx x{tuple(x.shape)} V={v}")
    kernel_log.count(NAME_DX)
    return dx


def fused_ce_dw(x, w, tgt, lse, wtok):
    """dw [E, V] bf16 = xᵀ · bf16((p − onehot)·wtok), logits recomputed.
    For a head stored [V, E] (the tied ``wte.T`` view) dw is written into
    a [V, E] tensor and returned as its [E, V] view, so the tied ``wte``
    gets its gradient without a transposed copy. A CPU tensor takes the
    plain version."""
    if x.device.type == "cpu":
        return fused_ce_dw_plain(x, w, tgt, lse, wtok)
    m, e, v = _check(x, w, tgt, _bwd_cols(lse, wtok))
    swe, swv = _w_strides(w)
    lib, fns = _kernels()
    if swe == 1:                                   # [V, E] storage
        dw = torch.empty((v, e), dtype=torch.bfloat16, device=x.device).T
    else:
        dw = torch.empty((e, v), dtype=torch.bfloat16, device=x.device)
    rc = fns["koifish_fused_ce_dw"](
        x.data_ptr(), w.data_ptr(), tgt.data_ptr(), lse.data_ptr(),
        wtok.data_ptr(), dw.data_ptr(), m, e, v, swe, swv, *dw.stride(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, f"fused_ce_dw x{tuple(x.shape)} V={v}")
    kernel_log.count(NAME_DW)
    return dw


def _check8(xq, sx, wq, sw, tgt, cols=()):
    """(m, E, V, wq in [V, E] storage) of the int8 flavour's operands; an
    untied head's [E, V] codes are brought to [V, E] storage (a copy)."""
    m, e = xq.shape
    v = wq.shape[1]
    if wq.shape[0] != e or tgt.shape != (m,) or sx.numel() != m \
            or sw.numel() != v:
        raise ValueError(f"fused_ce_int8: xq{tuple(xq.shape)} "
                         f"sx{tuple(sx.shape)} wq{tuple(wq.shape)} "
                         f"sw{tuple(sw.shape)} tgt{tuple(tgt.shape)}: need "
                         f"xq [m,E], sx [m], wq [E,V], sw [V], tgt [m]")
    if not takes(m, e, v):
        raise ValueError(f"fused_ce_int8: E={e}: the kernels take E a "
                         f"multiple of {E_STEP} up to {E_MAX}")
    for name, t, dt in (("xq", xq, torch.int8), ("sx", sx, torch.float32),
                        ("wq", wq, torch.int8), ("sw", sw, torch.float32),
                        ("tgt", tgt, torch.int32)) + tuple(cols):
        if t.device != xq.device or t.device.type != "cuda":
            raise ValueError(f"fused_ce_int8: {name} lies on {t.device}, "
                             f"need the CUDA device of xq ({xq.device})")
        if t.dtype != dt:
            raise ValueError(f"fused_ce_int8: {name} is {t.dtype}, need {dt}")
        if name != "wq" and not t.is_contiguous():
            raise ValueError(f"fused_ce_int8: {name} must be contiguous")
    if wq.stride(0) != 1:
        wq = wq.T.contiguous().T
    if wq.stride(1) % 16 or wq.data_ptr() % 16 or xq.data_ptr() % 16:
        raise ValueError(f"fused_ce_int8: wq strides {wq.stride()}: rows "
                         f"must be 16-byte aligned")
    return m, e, v, wq


def _st(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_ce_fwd_int8(xq, sx, wq, sw, tgt):
    """(lse [m], gold [m]) f32 of the int8 logits (xq·wq)_int32·sx·sw,
    never written. xq [m, E] int8, sx [m, 1], wq [E, V] int8, sw [1, V]. A
    CPU tensor takes the plain version."""
    if xq.device.type == "cpu":
        return fused_ce_fwd_int8_plain(xq, sx, wq, sw, tgt)
    m, e, v, wq = _check8(xq, sx, wq, sw, tgt)
    lib, fns = _kernels8()
    lse = torch.empty((m,), dtype=torch.float32, device=xq.device)
    gold = torch.empty_like(lse)
    splits = fns["koifish_fused_ce_int8_splits"](0, m, v)
    ws = (torch.empty((splits, m, 3), dtype=torch.float32, device=xq.device)
          if splits > 1 else None)
    rc = fns["koifish_fused_ce_int8_fwd"](
        xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
        tgt.data_ptr(), lse.data_ptr(), gold.data_ptr(),
        None if ws is None else ws.data_ptr(), m, e, v, wq.stride(1), _st(xq))
    _build.check(lib, rc, f"fused_ce_fwd_int8 xq{tuple(xq.shape)} V={v}")
    kernel_log.count(NAME_FWD8)
    return lse, gold


def fused_ce_dx_int8(xq, sx, wq, sw, tgt, lse, wtok):
    """dx [m, E] bf16 = bf16((p − onehot)·wtok) · bf16(wq·sw)ᵀ, the int8
    logits recomputed. A CPU tensor takes the plain version."""
    if xq.device.type == "cpu":
        return fused_ce_dx_int8_plain(xq, sx, wq, sw, tgt, lse, wtok)
    m, e, v, wq = _check8(xq, sx, wq, sw, tgt, _bwd_cols(lse, wtok))
    lib, fns = _kernels8()
    dx = torch.empty((m, e), dtype=torch.bfloat16, device=xq.device)
    splits = fns["koifish_fused_ce_int8_splits"](1, m, v)
    ws = (torch.empty((splits, m, e), dtype=torch.float32, device=xq.device)
          if splits > 1 else None)
    rc = fns["koifish_fused_ce_int8_dx"](
        xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
        tgt.data_ptr(), lse.data_ptr(), wtok.data_ptr(), dx.data_ptr(),
        None if ws is None else ws.data_ptr(), m, e, v, wq.stride(1), _st(xq))
    _build.check(lib, rc, f"fused_ce_dx_int8 xq{tuple(xq.shape)} V={v}")
    kernel_log.count(NAME_DX8)
    return dx


def fused_ce_dw_int8(x, xq, sx, wq, sw, tgt, lse, wtok):
    """dw [E, V] bf16 = xᵀ · bf16((p − onehot)·wtok) with the bf16 x and
    the int8 logits recomputed, written into [V, E] storage (the tied
    ``wte``'s gradient, no transposed copy) and returned as its [E, V]
    view. A CPU tensor takes the plain version."""
    if xq.device.type == "cpu":
        return fused_ce_dw_int8_plain(x, xq, sx, wq, sw, tgt, lse, wtok)
    m, e, v, wq = _check8(xq, sx, wq, sw, tgt, _bwd_cols(lse, wtok)
                          + (("x", x, torch.bfloat16),))
    lib, fns = _kernels8()
    dw = torch.empty((v, e), dtype=torch.bfloat16, device=xq.device).T
    rc = fns["koifish_fused_ce_int8_dw"](
        x.data_ptr(), xq.data_ptr(), sx.data_ptr(), wq.data_ptr(),
        sw.data_ptr(), tgt.data_ptr(), lse.data_ptr(), wtok.data_ptr(),
        dw.data_ptr(), m, e, v, wq.stride(1), *dw.stride(), _st(xq))
    _build.check(lib, rc, f"fused_ce_dw_int8 xq{tuple(xq.shape)} V={v}")
    kernel_log.count(NAME_DW8)
    return dw


# ---------------------------------------------------------------------------
# differentiable wrapper
# ---------------------------------------------------------------------------

def _assemble(lse, gold, mask):
    per_tok = lse - gold
    denom = mask.sum().clamp_min(1.0)
    return (per_tok * mask).sum() / denom, per_tok


class FusedCE(torch.autograd.Function):
    """(loss, per_tok [m]) = FusedCE.apply(x [m,E] bf16, w [E,V] bf16,
    tgt [m] int32, mask [m] f32, int8). Saves x, w, tgt, mask and the [m]
    lse and, with ``int8``, the codes and scales of x (per row) and w (per
    column, in w's storage order), as the Pallas ``_ce_fwd`` does; the
    backward runs the dx and dw kernels of its flavour with
    wtok = mask/Σmask·g_loss + g_tok."""

    @staticmethod
    def forward(ctx, x, w, tgt, mask, int8=False):
        if int8:
            xq, sx = kq.rowquant(x, kq.TRAIN_ROUNDING)
            wq, sw = kq.colquant(w, kq.TRAIN_ROUNDING)
            lse, gold = fused_ce_fwd_int8(xq, sx, wq, sw, tgt)
            ctx.save_for_backward(x, w, tgt, mask, lse, xq, sx, wq, sw)
        else:
            lse, gold = fused_ce_fwd(x, w, tgt)
            ctx.save_for_backward(x, w, tgt, mask, lse)
        ctx.int8 = int8
        return _assemble(lse, gold, mask)

    @staticmethod
    def backward(ctx, g_loss, g_tok):
        x, w, tgt, mask, lse, *quant = ctx.saved_tensors
        wtok = mask / mask.sum().clamp_min(1.0) * g_loss
        if g_tok is not None:
            wtok = wtok + g_tok.to(torch.float32)
        wtok = wtok.to(torch.float32).contiguous()
        dx = dw = None
        if ctx.int8:
            xq, sx, wq, sw = quant
            sx, sw = sx.reshape(-1), sw.reshape(-1)
            if ctx.needs_input_grad[0]:
                dx = fused_ce_dx_int8(xq, sx, wq, sw, tgt, lse, wtok)
            if ctx.needs_input_grad[1]:
                dw = fused_ce_dw_int8(x, xq, sx, wq, sw, tgt, lse, wtok)
        else:
            if ctx.needs_input_grad[0]:
                dx = fused_ce_dx(x, w, tgt, lse, wtok)
            if ctx.needs_input_grad[1]:
                dw = fused_ce_dw(x, w, tgt, lse, wtok)
        return dx, dw, None, None, None


def fused_ce_kernel_or_none(hidden: torch.Tensor, head_w: torch.Tensor,
                            targets: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            int8: Optional[bool] = None):
    """(mean_loss, per_token [B, T]) through ``FusedCE``, or None when the
    shape is not one the kernels take (the caller runs the chunk scan) —
    the dispatch of the Pallas ``fused_ce_pallas_or_none``. ``int8``: the
    int8 flavour; None follows the ambient ``Int8Policy`` (its size gate on
    the [E, V] head)."""
    B, T, E = hidden.shape
    V = head_w.shape[-1]
    if not takes(B * T, E, V):
        kernel_log.fallback(
            "fused_ce", f"m={B * T} E={E} V={V}: the kernels take E a "
            f"multiple of {E_STEP} up to {E_MAX} -> torch chunk-scan CE")
        return None
    kernel_log.choice("fused_ce", f"m={B * T} E={E} V={V}")
    if int8 is None:
        pol = current_int8()
        int8 = pol is not None and pol.applies((E, V))
    m = B * T
    x = hidden.reshape(m, E).to(torch.bfloat16).contiguous()
    tgt = targets.reshape(m).to(torch.int32).contiguous()
    mk = (torch.ones((m,), dtype=torch.float32, device=x.device)
          if mask is None else mask.reshape(m).to(torch.float32))
    loss, per_tok = FusedCE.apply(x, head_w.to(torch.bfloat16), tgt, mk,
                                  bool(int8))
    return loss, per_tok.reshape(B, T)
