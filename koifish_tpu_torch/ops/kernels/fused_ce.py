"""Fused classifier cross-entropy: the CUDA kernels' wrappers, their plain
versions and the autograd Function that joins them.

The kernels (``csrc/fused_ce.cuh``, built as ``fused_ce.cu`` and
``fused_ce_int8.cu``) replace both flavours of the JAX package's Pallas
kernels in ``koifish_tpu/ops/pallas/fused_ce.py``: ``_fwd_call``
(``fused_ce_fwd``: per-row lse and gold logit), ``_dx_call`` and
``_dw_call`` (``fused_ce_bwd``: dx and dw together), and with ``int8=True``
``fused_ce_fwd_int8`` and ``fused_ce_bwd_int8``: logits =
(xq·wq)_int32·sx·sw from the row-quantized x and the column-quantized head,
dx against bf16(wq·sw), dw from the bf16 x. The head is read through its
strides: an untied ``head`` [E, V] row-major, or the tied ``wte.T`` view of
a row-major [V, E] ``wte``, in place.

The forward is one logits kernel whose epilogue folds each vocab tile into
a running logsumexp, so the [m, V] logits never reach device memory. The
backward walks the vocabulary in chunks (``chunk_plan``: a bf16 [m, Vc]
buffer of at most ``CHUNK_BYTES``): per chunk, the logits kernel writes the
chunk's dlogits into the buffer, then one GEMM kernel adds
dlogits_c·W_c into an f32 dx carried across the chunks in chunk order and
another writes dW_c. The logits are computed once for dx and dw together.

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
from typing import Optional, Sequence

import torch

from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.ops.kernels import quantize as kq
from koifish_tpu_torch.ops.kernels.quantize import int8_dot
from koifish_tpu_torch.ops.tracectx import current_int8
from koifish_tpu_torch.utils import kernel_log

NAME_FWD, NAME_DLOG, NAME_DX, NAME_DW = (
    "fused_ce_fwd", "fused_ce_dlogits", "fused_ce_dx", "fused_ce_dw")
NAME_FWD8, NAME_DLOG8, NAME_DX8, NAME_DW8 = (
    n + "_int8" for n in (NAME_FWD, NAME_DLOG, NAME_DX, NAME_DW))
#: E the kernels take: a multiple of 64 (their TMA boxes) up to 8192 (the
#: Pallas kernels' limit); E is the loop axis of every kernel
E_STEP, E_MAX = 64, 8192
#: the logits kernel's tile: rows x vocab columns
BM, BV = 128, 256
#: the backward's dlogits chunk buffer holds at most this many bytes
CHUNK_BYTES = 256 << 20
#: the backward's kernels, in their order within a chunk
BWD_KERNELS = ("dlogits", "dx", "dw")
_ROWS = 2048        # rows per chunk of the plain versions (bounds memory)

_fns = None
_fns8 = None


def _load(name, sig):
    lib = _build.load(name)
    fns = {}
    for fname, argtypes in sig.items():
        fn = getattr(lib, fname)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[fname] = fn
    return lib, fns


def _kernels():
    global _fns
    if _fns is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _fns = _load("fused_ce", {
            # x w tgt | lse gold | ws | m E V | swe swv | splits | stream
            "koifish_fused_ce_fwd": [P] * 6 + [I] * 3 + [L] * 2 + [I, P],
            # x w tgt lse wtok | buf ldb | m E V | swe swv | c0 vc splits | stream
            "koifish_fused_ce_dlogits": [P] * 6 + [L] + [I] * 3 + [L] * 2
            + [I] * 3 + [P],
            # buf ldb | w | dxf dx | m E V | swe swv | c0 vc first last | stream
            "koifish_fused_ce_dx": [P, L] + [P] * 3 + [I] * 3 + [L] * 2
            + [I] * 4 + [P],
            # buf ldb | x dw | m E V | c0 vc | sde sdv | stream
            "koifish_fused_ce_dw": [P, L, P, P] + [I] * 5 + [L] * 2 + [P],
        })
    return _fns


def _kernels8():
    global _fns8
    if _fns8 is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _fns8 = _load("fused_ce_int8", {
            # xq sx wq sw tgt | lse gold | ws | m E V | ldw | splits | stream
            "koifish_fused_ce_int8_fwd": [P] * 8 + [I] * 3 + [L, I, P],
            # xq sx wq sw tgt lse wtok | buf ldb | m E V | ldw | c0 vc splits
            "koifish_fused_ce_int8_dlogits": [P] * 8 + [L] + [I] * 3 + [L]
            + [I] * 3 + [P],
            # buf ldb | wq sw | dxf dx | m E V | ldw | c0 vc first last
            "koifish_fused_ce_int8_dx": [P, L] + [P] * 4 + [I] * 3 + [L]
            + [I] * 4 + [P],
            # buf ldb | x dw | m E V | c0 vc | sde sdv | stream
            "koifish_fused_ce_int8_dw": [P, L, P, P] + [I] * 5 + [L] * 2
            + [P],
        })
    return _fns8


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
# host plan
# ---------------------------------------------------------------------------

def takes(m: int, e: int, v: int) -> bool:
    """Shapes the kernels take: E a multiple of 64 up to 8192, any m, V."""
    return m >= 1 and v >= 1 and e % E_STEP == 0 and E_STEP <= e <= E_MAX


def vocab_tiles(v: int) -> int:
    return -(-v // BV)


def splits_for(m: int, n_tiles: int, sms: int) -> int:
    """Vocab splits of a logits launch: its work items are (128-row tile,
    run of vocab tiles) and its persistent blocks (one an SM) take items in
    turn, so the longest block walks ceil(items / sms) runs of tiles. The
    fewest splits within 5 % of the shortest such walk (each split costs a
    workspace row and a merge); every split takes at least one tile."""
    rt = -(-m // BM)
    cost = {}
    for s in range(1, min(n_tiles, 256) + 1):
        per = -(-n_tiles // s)
        if (s - 1) * per < n_tiles:        # else a split is empty
            cost[s] = -(-(rt * s) // sms) * per
    best = min(cost.values())
    return min(s for s, c in cost.items() if c <= 1.05 * best)


def chunk_plan(m: int, v: int):
    """(ldb, [(c0, vc), ...]): the backward's bf16 dlogits buffer [m, ldb]
    (ldb a multiple of the vocab tile, at most ``CHUNK_BYTES`` unless one
    tile's rows exceed it) and the vocab chunks it takes in turn, covering
    [0, v) once, in order."""
    ldb = max(BV, CHUNK_BYTES // (2 * m) // BV * BV)
    ldb = min(ldb, vocab_tiles(v) * BV)
    return ldb, [(c0, min(ldb, v - c0)) for c0 in range(0, v, ldb)]


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_launch(fn, lib, name, m, v, dev, args, tail, what):
    """lse, gold [m] f32 from one logits launch ``fn(*args, lse, gold, ws,
    *tail, splits, stream)``; a [splits, m, 3] workspace when the vocab is
    split."""
    splits = splits_for(m, vocab_tiles(v), _sm_count(dev))
    lse = torch.empty((m,), dtype=torch.float32, device=dev)
    gold = torch.empty_like(lse)
    ws = (torch.empty((splits, m, 3), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    rc = fn(*args, lse.data_ptr(), gold.data_ptr(), _ptr(ws), *tail, splits,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, what)
    kernel_log.count(name)
    return lse, gold


def fused_ce_fwd(x: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor):
    """(lse [m], gold [m]) f32 of the logits x [m,E] · w [E,V], never
    written. A CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return fused_ce_fwd_plain(x, w, tgt)
    m, e, v = _check(x, w, tgt)
    swe, swv = _w_strides(w)
    lib, fns = _kernels()
    return _fwd_launch(fns["koifish_fused_ce_fwd"], lib, NAME_FWD, m, v,
                       x.device, (x.data_ptr(), w.data_ptr(), tgt.data_ptr()),
                       (m, e, v, swe, swv),
                       f"fused_ce_fwd x{tuple(x.shape)} V={v}")


def _bwd_cols(lse, wtok):
    return (("lse", lse, torch.float32), ("wtok", wtok, torch.float32))


def _dw_out(head_ve: bool, e: int, v: int, dev):
    """dw [E, V] bf16 in the head's storage order: for a head stored [V, E]
    (the tied ``wte.T`` view) a [V, E] tensor's [E, V] view, so the tied
    ``wte`` gets its gradient without a transposed copy."""
    if head_ve:
        return torch.empty((v, e), dtype=torch.bfloat16, device=dev).T
    return torch.empty((e, v), dtype=torch.bfloat16, device=dev)


def _backward(m, e, v, dev, kernels, dlogits, dx_gemm, dw_gemm, buf=None):
    """The backward's launches, for each vocab chunk of ``chunk_plan`` in
    order: ``dlogits(buf, ldb, c0, vc, splits, stream)`` writes the chunk's
    dlogits into the buffer, then ``dx_gemm(buf, ldb, dxf, dx, c0, vc,
    first, last, stream)`` adds dlogits_c·W_c into the f32 dx carried across
    the chunks (the last chunk writes dx in bf16; no f32 dx with one chunk)
    and ``dw_gemm(buf, ldb, c0, vc, stream)`` writes dW_c. ``kernels``
    names the launches made; ``buf``: the buffer to use (else a new one).
    Returns dx (None without "dx")."""
    ldb, chunks = chunk_plan(m, v)
    sms = _sm_count(dev)
    st = torch.cuda.current_stream(dev).cuda_stream
    if buf is None:
        buf = torch.empty((m, ldb), dtype=torch.bfloat16, device=dev)
    elif buf.shape != (m, ldb) or buf.dtype != torch.bfloat16 \
            or buf.device != dev:
        raise ValueError(f"fused_ce: dlogits buffer {tuple(buf.shape)} "
                         f"{buf.dtype} on {buf.device}: need bf16 "
                         f"({m}, {ldb}) on {dev} (chunk_plan)")
    dx = dxf = None
    if "dx" in kernels:
        dx = torch.empty((m, e), dtype=torch.bfloat16, device=dev)
        if len(chunks) > 1:
            dxf = torch.empty((m, e), dtype=torch.float32, device=dev)
    for i, (c0, vc) in enumerate(chunks):
        if "dlogits" in kernels:
            dlogits(buf, ldb, c0, vc, splits_for(m, vocab_tiles(vc), sms), st)
        if "dx" in kernels:
            dx_gemm(buf, ldb, dxf, dx, c0, vc, int(i == 0),
                    int(i == len(chunks) - 1), st)
        if "dw" in kernels:
            dw_gemm(buf, ldb, c0, vc, st)
    return dx


def _launcher(lib, fn, name, what):
    """fn(*args) with its return code checked and its launch counted."""
    def run(*args):
        _build.check(lib, fn(*args), what)
        kernel_log.count(name)
    return run


def _kernels_for(need_dx: bool, need_dw: bool):
    return ("dlogits",) + ("dx",) * need_dx + ("dw",) * need_dw


def fused_ce_bwd(x, w, tgt, lse, wtok, need_dx: bool = True,
                 need_dw: bool = True):
    """(dx [m, E], dw [E, V]) bf16 of the CE through the logits x·w: dx =
    dlogits · wᵀ, dw = xᵀ · dlogits, dlogits = bf16((p − onehot)·wtok)
    computed once a vocab chunk for both; a gradient not needed is None. dw
    is written in the head's storage order (a [V, E] head's ``wte.T`` view
    gets a [V, E] tensor's view). A CPU tensor takes the plain versions."""
    if x.device.type == "cpu":
        return (fused_ce_dx_plain(x, w, tgt, lse, wtok) if need_dx else None,
                fused_ce_dw_plain(x, w, tgt, lse, wtok) if need_dw else None)
    return _bwd(x, w, tgt, lse, wtok, _kernels_for(need_dx, need_dw))


def _bwd(x, w, tgt, lse, wtok, kernels: Sequence[str] = BWD_KERNELS,
         buf: Optional[torch.Tensor] = None):
    """``fused_ce_bwd``'s launches on the card. ``kernels`` names them
    (``BWD_KERNELS`` or a part: without "dlogits" the GEMMs read the buffer
    as it is, to time them alone); ``buf``: the bf16 [m, ldb] chunk buffer
    of ``chunk_plan`` to use, which then holds the last chunk's dlogits
    (else a new one)."""
    m, e, v = _check(x, w, tgt, _bwd_cols(lse, wtok))
    swe, swv = _w_strides(w)
    lib, fns = _kernels()
    what = f"x{tuple(x.shape)} V={v}"
    run = {n: _launcher(lib, fns[f"koifish_{n}"], n, f"{n} {what}")
           for n in (NAME_DLOG, NAME_DX, NAME_DW)}
    dw = _dw_out(swe == 1, e, v, x.device) if "dw" in kernels else None
    xp, wp, tp = x.data_ptr(), w.data_ptr(), tgt.data_ptr()

    def dlogits(buf, ldb, c0, vc, splits, st):
        run[NAME_DLOG](xp, wp, tp, lse.data_ptr(), wtok.data_ptr(),
                       buf.data_ptr(), ldb, m, e, v, swe, swv, c0, vc, splits,
                       st)

    def dx_gemm(buf, ldb, dxf, dx, c0, vc, first, last, st):
        run[NAME_DX](buf.data_ptr(), ldb, wp, _ptr(dxf), dx.data_ptr(), m, e,
                     v, swe, swv, c0, vc, first, last, st)

    def dw_gemm(buf, ldb, c0, vc, st):
        run[NAME_DW](buf.data_ptr(), ldb, xp, dw.data_ptr(), m, e, v, c0, vc,
                     *dw.stride(), st)

    dx = _backward(m, e, v, x.device, kernels, dlogits, dx_gemm, dw_gemm,
                   buf)
    return dx, dw


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


def fused_ce_fwd_int8(xq, sx, wq, sw, tgt):
    """(lse [m], gold [m]) f32 of the int8 logits (xq·wq)_int32·sx·sw,
    never written. xq [m, E] int8, sx [m, 1], wq [E, V] int8, sw [1, V]. A
    CPU tensor takes the plain version."""
    if xq.device.type == "cpu":
        return fused_ce_fwd_int8_plain(xq, sx, wq, sw, tgt)
    m, e, v, wq = _check8(xq, sx, wq, sw, tgt)
    lib, fns = _kernels8()
    return _fwd_launch(fns["koifish_fused_ce_int8_fwd"], lib, NAME_FWD8, m, v,
                       xq.device, (xq.data_ptr(), sx.data_ptr(), wq.data_ptr(),
                                   sw.data_ptr(), tgt.data_ptr()),
                       (m, e, v, wq.stride(1)),
                       f"fused_ce_fwd_int8 xq{tuple(xq.shape)} V={v}")


def fused_ce_bwd_int8(x, xq, sx, wq, sw, tgt, lse, wtok, need_dx: bool = True,
                      need_dw: bool = True):
    """(dx [m, E], dw [E, V]) bf16 of the int8 CE: dlogits from the int8
    logits, dx = dlogits · bf16(wq·sw)ᵀ (the codes dequantized inside the
    GEMM), dw = xᵀ · dlogits with the bf16 x, written into [V, E] storage
    (the tied ``wte``'s gradient, no transposed copy) and returned as its
    [E, V] view; a gradient not needed is None. x is read only for dw. A
    CPU tensor takes the plain versions."""
    if xq.device.type == "cpu":
        return (fused_ce_dx_int8_plain(xq, sx, wq, sw, tgt, lse, wtok)
                if need_dx else None,
                fused_ce_dw_int8_plain(x, xq, sx, wq, sw, tgt, lse, wtok)
                if need_dw else None)
    return _bwd_int8(x, xq, sx, wq, sw, tgt, lse, wtok,
                     _kernels_for(need_dx, need_dw))


def _bwd_int8(x, xq, sx, wq, sw, tgt, lse, wtok,
              kernels: Sequence[str] = BWD_KERNELS,
              buf: Optional[torch.Tensor] = None):
    """``fused_ce_bwd_int8``'s launches on the card; ``kernels`` and ``buf``
    as ``_bwd``."""
    m, e, v, wq = _check8(xq, sx, wq, sw, tgt, _bwd_cols(lse, wtok)
                          + ((("x", x, torch.bfloat16),)
                             if "dw" in kernels else ()))
    lib, fns = _kernels8()
    what = f"xq{tuple(xq.shape)} V={v}"
    run = {n: _launcher(lib, fns["koifish_fused_ce_int8_" + n.split("_")[2]],
                        n, f"{n} {what}")
           for n in (NAME_DLOG8, NAME_DX8, NAME_DW8)}
    dw = _dw_out(True, e, v, xq.device) if "dw" in kernels else None
    ldw = wq.stride(1)

    def dlogits(buf, ldb, c0, vc, splits, st):
        run[NAME_DLOG8](xq.data_ptr(), sx.data_ptr(), wq.data_ptr(),
                        sw.data_ptr(), tgt.data_ptr(), lse.data_ptr(),
                        wtok.data_ptr(), buf.data_ptr(), ldb, m, e, v, ldw,
                        c0, vc, splits, st)

    def dx_gemm(buf, ldb, dxf, dx, c0, vc, first, last, st):
        run[NAME_DX8](buf.data_ptr(), ldb, wq.data_ptr(), sw.data_ptr(),
                      _ptr(dxf), dx.data_ptr(), m, e, v, ldw, c0, vc, first,
                      last, st)

    def dw_gemm(buf, ldb, c0, vc, st):
        run[NAME_DW8](buf.data_ptr(), ldb, x.data_ptr(), dw.data_ptr(), m, e,
                      v, c0, vc, *dw.stride(), st)

    dx = _backward(m, e, v, xq.device, kernels, dlogits, dx_gemm, dw_gemm,
                   buf)
    return dx, dw


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
    backward runs its flavour's backward launches for the inputs that need
    a gradient, with wtok = mask/Σmask·g_loss + g_tok."""

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
        need = ctx.needs_input_grad[:2]
        if ctx.int8:
            xq, sx, wq, sw = quant
            sx, sw = sx.reshape(-1), sw.reshape(-1)
            dx, dw = fused_ce_bwd_int8(x, xq, sx, wq, sw, tgt, lse, wtok,
                                       *need)
        else:
            dx, dw = fused_ce_bwd(x, w, tgt, lse, wtok, *need)
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
