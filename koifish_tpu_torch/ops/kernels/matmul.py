"""Dequant-fused GEMM / GEMV: the CUDA kernels' wrapper and plain version.

The kernels replace the JAX package's Pallas ``_qmm``/``_qmm_kernel`` (GEMM,
m > 32: ``csrc/qmm.cu``, warp-specialised wgmma) and ``_qmv``/``_qmv_kernel``
(GEMV, m <= 32: ``csrc/qmatmul.cu``, codes decoded straight into
``mma.sync`` fragments, K split across a thread-block cluster) in
``koifish_tpu/ops/pallas/matmul.py``:
packed codes are decoded in the kernel and the per-group scale multiplies
each group's partial product, ``y = Σ_g (x_g @ codes_g) · s_g`` with f32
accumulation. They take every symmetric format — INT8, INT4, NF4, INT3,
NF3, INT2, TERNARY, BINARY — at group size 128, any m >= 1, any K that is a
multiple of 128 and any N that is a multiple of 4.

Their book flavour replaces ``_qmv_book``/``_qmv_book_kernel`` (GEMV) and
``_qmm_book``/``_qmm_book_kernel`` (GEMM) of the same file: learned-codebook
tensors (k-means ``[2^bits]`` books, MINI ``[K, 2^bits]`` books, NF4/NF3 code
layouts) decode code c of row k to ``bf16(book[k, c])`` and otherwise share
the tiling, the ``_plan`` and the arithmetic. The per-tensor book is read
with a row stride of 0 instead of the JAX package's broadcast copy.

``qmatmul`` goes through the ``QMatmul`` autograd Function when x, the
scales or the book need a gradient: the gradient of the JAX package's
dequantize-and-dot path (dx = dy·deq(w)ᵀ; for gama training the scales'
and the book's, through ``dW = x2ᵀ·dy``), in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.quant.packing import unpack_codes
from koifish_tpu_torch.quant.qtensor import QTensor, code_values
from koifish_tpu_torch.utils import kernel_log

NAME = "qmatmul"
GEMV = "qmv"           # launch counter of the m <= 32 shape
GEMM = "qmm"           # launch counter of the m > 32 shape
BOOK_GEMV = "qmv_book"  # the same two shapes with a learned codebook
BOOK_GEMM = "qmm_book"
GEMV_MAX_M = 32
GROUP = 128
#: block tile (rows, columns) of each launch shape, keyed by its rows: the
#: GEMV's (csrc/qmatmul.cu) and the GEMM's (csrc/qmm.cu)
TILES = {32: (32, 64), 128: (128, 128)}
#: format -> the kernel's format id (csrc/qmatmul.cu)
FORMATS = {
    QFormat.INT8: 0, QFormat.INT4: 1, QFormat.NF4: 2, QFormat.INT3: 3,
    QFormat.NF3: 4, QFormat.INT2: 5, QFormat.TERNARY: 6, QFormat.BINARY: 7,
}
#: the code layouts a learned codebook rides
BOOK_FORMATS = (QFormat.NF4, QFormat.NF3)
GEMM_LIB = "qmm"
#: blocks in flight to aim for: the GEMV's 4-warp blocks cover the card's
#: 132 SMs twice, the GEMM's one 384-thread block a SM (its shared memory)
_TARGET_BLOCKS = {32: 264, 128: 132}
#: the most blocks of a thread-block cluster that split the GEMV's K
#: (the portable cluster size)
GEMV_MAX_CLUSTER = 8

_fn = {}


def _kernel(bm: int):
    """(library, plain entry, book entry) of the launch shape ``bm``."""
    if bm not in _fn:
        if bm == 32:
            # x codes scales out; f32_out m K N fmt gps splits; stream
            # (book: + the book pointer, and per_row after fmt)
            lib = _build.load(NAME)
            fn, book = lib.koifish_qmatmul, lib.koifish_qmatmul_book
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p])
            book.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                             + [ctypes.c_void_p])
        else:
            # x codes scales out work; f32_out m K N fmt gps; stream (book:
            # + the book pointer, and per_row after fmt)
            lib = _build.load(GEMM_LIB)
            fn, book = lib.koifish_qmm, lib.koifish_qmm_book
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
            book.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                             + [ctypes.c_void_p])
        fn.restype = book.restype = ctypes.c_int
        _fn[bm] = (lib, fn, book)
    return _fn[bm]


def _book_ok(w: QTensor) -> bool:
    """A learned book the kernel reads: f32-castable, [2^bits] or
    [K, 2^bits], on an NF4/NF3 code layout."""
    b = w.codebook
    nb = 1 << w.fmt.bits
    return (w.fmt in BOOK_FORMATS and b.shape[-1] == nb
            and (b.dim() == 1 or (b.dim() == 2 and b.shape[0] == w.shape[0])))


def takes(w: QTensor) -> bool:
    """Whether the kernel covers ``w``: symmetric codes at group 128, with
    the format's constant code values or a learned codebook."""
    return (w.fmt in FORMATS and w.zeros is None and w.group == GROUP
            and (w.codebook is None or _book_ok(w)))


def qmatmul_plain(x2: torch.Tensor, codes: torch.Tensor,
                  scales: torch.Tensor, fmt: QFormat, group: int = GROUP,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version: x2 [m, K] -> [m, N] bf16 (or the f32 sum),
    with the kernel's arithmetic — code values rounded to bf16 (exact for
    integer codes), one f32 product per group, the group scale on the
    partial sums."""
    m, K = x2.shape
    N = codes.shape[-1]
    ng = K // group
    raw = unpack_codes(codes, fmt, K, group) if fmt.is_sub_byte else codes
    wv = code_values(raw, fmt).to(torch.bfloat16).to(torch.float32)
    xg = x2.to(torch.bfloat16).to(torch.float32).reshape(m, ng, group)
    part = torch.einsum("mgk,gkn->mgn", xg, wv.reshape(ng, group, N))
    y = (part * scales.to(torch.float32)[None]).sum(dim=1)
    return y.to(out_dtype)


def qmatmul_book_plain(x2: torch.Tensor, codes: torch.Tensor,
                       scales: torch.Tensor, book: torch.Tensor, fmt: QFormat,
                       group: int = GROUP, out_dtype=torch.bfloat16
                       ) -> torch.Tensor:
    """Plain PyTorch version of the book flavour: x2 [m, K] -> [m, N] bf16
    (or the f32 sum).
    Code c of row k takes ``bf16(book[k, c])`` (``book[c]`` for a per-tensor
    book), then the arithmetic of ``qmatmul_plain``."""
    m, K = x2.shape
    N = codes.shape[-1]
    ng = K // group
    raw = unpack_codes(codes, fmt, K, group).long()
    bk = book.to(torch.float32)
    wv = bk[raw] if bk.dim() == 1 else torch.gather(bk, 1, raw)
    wv = wv.to(torch.bfloat16).to(torch.float32)
    xg = x2.to(torch.bfloat16).to(torch.float32).reshape(m, ng, group)
    part = torch.einsum("mgk,gkn->mgn", xg, wv.reshape(ng, group, N))
    y = (part * scales.to(torch.float32)[None]).sum(dim=1)
    return y.to(out_dtype)


def _plan(m: int, K: int, N: int):
    """(bm, groups per split, splits): split K across blocks when the
    output tiles alone cannot fill the card. The GEMV (bm 32) splits it
    across the blocks of one thread-block cluster, at most
    ``GEMV_MAX_CLUSTER``, which sum their partials in one launch; the GEMM
    (bm 128) across work items and an f32 workspace [splits, m, N]."""
    bm, bn = TILES[32 if m <= GEMV_MAX_M else 128]
    ng = K // GROUP
    tiles = -(-N // bn) * -(-m // bm)
    splits = min(ng, max(1, -(-_TARGET_BLOCKS[bm] // tiles)))
    if bm == 32:
        splits = min(splits, GEMV_MAX_CLUSTER)
    gps = -(-ng // splits)
    return bm, gps, -(-ng // gps)


def _check(x2: torch.Tensor, w: QTensor):
    m, K = x2.shape
    N = w.out_features
    shape = f"x{tuple(x2.shape)} w{tuple(w.shape)} {w.fmt.name}"
    if not takes(w):
        raise ValueError(f"qmatmul: {shape}: the kernel takes symmetric "
                         f"codes at group {GROUP} only, with a learned book "
                         f"[2^bits] or [K, 2^bits] on NF4/NF3 layouts")
    cpb = w.fmt.codes_per_byte if w.fmt.is_sub_byte else 1
    if w.shape[0] != K or K % GROUP or N % 4 or m < 1:
        raise ValueError(f"qmatmul: {shape}: need x [m>=1, K] with K = "
                         f"w.in_features, K % {GROUP} == 0, N % 4 == 0")
    if tuple(w.codes.shape) != (K // cpb, N) \
            or w.codes.dtype != w.fmt.torch_dtype:
        raise ValueError(f"qmatmul: {shape}: codes {tuple(w.codes.shape)} "
                         f"{w.codes.dtype} do not match the format")
    if tuple(w.scales.shape) != (K // GROUP, N) \
            or w.scales.dtype != torch.float32:
        raise ValueError(f"qmatmul: {shape}: need f32 scales "
                         f"[{K // GROUP}, {N}]")
    tensors = [("x", x2), ("codes", w.codes), ("scales", w.scales)]
    if w.codebook is not None:
        if w.codebook.dtype != torch.float32:
            raise ValueError(f"qmatmul: {shape}: need an f32 codebook")
        tensors.append(("codebook", w.codebook))
    for name, t in tensors:
        if t.device != x2.device or t.device.type != "cuda":
            raise ValueError(f"qmatmul: {name} lies on {t.device}, need the "
                             f"CUDA device of x ({x2.device})")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"qmatmul: {name} of {shape} must be contiguous "
                             f"and 16-byte aligned")
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"qmatmul: x is {x2.dtype}, need bf16")


def _unit(w: QTensor) -> torch.Tensor:
    """[K, N] f32: the decoded code of each entry, the value ``dequantize``
    multiplies by its group's scale (a book's entry for a learned book)."""
    if not w.fmt.is_sub_byte:
        return w.codes.to(torch.float32)
    raw = unpack_codes(w.codes, w.fmt, w.shape[0], group=w.group)
    if w.codebook is None:
        return code_values(raw, w.fmt)
    bk = w.codebook.to(torch.float32)
    return bk[raw.long()] if bk.dim() == 1 else torch.gather(bk, 1, raw.long())


def weight_grads(x2: torch.Tensor, dy: torch.Tensor, w: QTensor,
                 want_scales: bool = True, want_book: bool = True):
    """(dscales, dbook) of ``y = x2 @ deq(w)`` for ``dy``, in the dtype
    chain ``jax.vjp`` takes through ``QTensor.dequantize`` and the dot:
    ``dW = bf16(x2ᵀ·dy)`` (f32 accumulation, as the dot's transpose rounds
    to the dequantized weight's dtype), then in f32
    ``dscales[g, n] = Σ_{k∈g} unit[k, n]·dW[k, n]`` and, for a learned
    book, ``dbook[c] += scales·dW`` over the entries coded c (per row for a
    [K, 2^bits] book), each cast to its tensor's dtype. None where not
    wanted."""
    K, N = w.shape[0], w.shape[-1]
    ng, g = w.n_groups, w.group
    dw = torch.matmul(x2.to(torch.bfloat16).t(), dy.to(torch.bfloat16)
                      ).to(torch.float32).reshape(ng, g, N)
    dscales = dbook = None
    if want_scales:
        unit = _unit(w).reshape(ng, g, N)
        dscales = (unit * dw).sum(dim=1).to(w.scales.dtype)
    if want_book and w.codebook is not None:
        dcode = (dw * w.scales.to(torch.float32)[:, None, :]).reshape(K, N)
        raw = unpack_codes(w.codes, w.fmt, K, group=w.group).long()
        book = w.codebook
        acc = torch.zeros(book.shape, dtype=torch.float32, device=dy.device)
        if book.dim() == 1:
            acc.index_add_(0, raw.reshape(-1), dcode.reshape(-1))
        else:
            acc.scatter_add_(1, raw, dcode)
        dbook = acc.to(book.dtype)
    return dscales, dbook


class QMatmul(torch.autograd.Function):
    """``y = x2 @ w`` with the gradient of the dequantize-and-dot path that
    the JAX package differentiates (``koifish_tpu/ops/matmul.py``):
    ``dx = dy · deq(w)ᵀ``, a plain product on the dequantized bf16 weight,
    and, where ``scales`` or ``book`` (``w``'s own tensors, passed so that
    autograd sees them) need one, ``weight_grads``. The forward is
    ``_forward`` (the kernel on the card, the plain version on the CPU);
    the codes get no gradient."""

    @staticmethod
    def forward(ctx, x2, scales, book, w, out_dtype=torch.bfloat16):
        ctx.w = w
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            ctx.save_for_backward(x2)
        return _forward(x2, w, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        w = ctx.w
        dx = dscales = dbook = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(dy, w.dequantize(dy.dtype).t())
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            (x2,) = ctx.saved_tensors
            dscales, dbook = weight_grads(x2, dy, w, ctx.needs_input_grad[1],
                                          ctx.needs_input_grad[2])
        return dx, dscales, dbook, None, None


def _weight_grad(w: QTensor) -> bool:
    return w.scales.requires_grad or (w.codebook is not None
                                      and w.codebook.requires_grad)


def qmatmul(x2: torch.Tensor, w: QTensor,
            out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x2 [m, K] bf16 @ w`` -> [m, N] bf16 for a kernel-covered QTensor
    (``out_dtype`` f32: the f32 sum, unrounded, for a caller that adds
    other partials to it). A CPU tensor takes the plain version; a CUDA
    tensor launches the GEMV shape (m <= 32) or the GEMM shape (m > 32).

    Under autograd the product goes through ``QMatmul`` on both devices,
    except that on the CPU a weight gradient (scales or book: gama
    training) keeps the plain version's own autograd."""
    if torch.is_grad_enabled() and (x2.requires_grad or _weight_grad(w)):
        if x2.device.type == "cpu" and _weight_grad(w):
            return _forward(x2, w, out_dtype)
        return QMatmul.apply(x2, w.scales, w.codebook, w, out_dtype)
    return _forward(x2, w, out_dtype)


def _forward(x2: torch.Tensor, w: QTensor,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"qmatmul: out_dtype {out_dtype}: the kernels write "
                         f"bf16 or f32")
    book = w.codebook
    if x2.device.type == "cpu":
        if book is not None:
            return qmatmul_book_plain(x2, w.codes, w.scales, book, w.fmt,
                                      w.group, out_dtype)
        return qmatmul_plain(x2, w.codes, w.scales, w.fmt, w.group,
                             out_dtype)
    _check(x2, w)
    m, K = x2.shape
    N = w.out_features
    bm, gps, splits = _plan(m, K, N)
    out = torch.empty((m, N), dtype=out_dtype, device=x2.device)
    f32 = int(out_dtype == torch.float32)
    lib, fn, fn_book = _kernel(bm)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    ptrs = (x2.data_ptr(), w.codes.data_ptr(), w.scales.data_ptr())
    if book is not None:
        ptrs += (book.data_ptr(),)
        fn = fn_book
    fmt = ((FORMATS[w.fmt], int(book.dim() == 2)) if book is not None
           else (FORMATS[w.fmt],))
    if bm == 32:   # the cluster's blocks sum the K split: no workspace
        rc = fn(*ptrs, out.data_ptr(), f32, m, K, N, *fmt, gps, splits,
                stream)
        name = GEMV if book is None else BOOK_GEMV
    else:
        work = (torch.empty((splits, m, N), dtype=torch.float32,
                            device=x2.device) if splits > 1 else None)
        rc = fn(*ptrs, out.data_ptr(), None if work is None
                else work.data_ptr(), f32, m, K, N, *fmt, gps, stream)
        name = GEMM if book is None else BOOK_GEMM
    _build.check(lib, rc, f"{name} x{tuple(x2.shape)} {w.fmt.name}")
    kernel_log.count(name, k=K)
    return out
