"""Per-lane KV slot and page writes: the CUDA kernel's wrappers and plain
versions.

The kernel (``csrc/slotwrite.cu``) replaces the JAX package's Pallas
``_slot_write_call``/``_kernel`` (row 8) and ``page_write_or_none``/
``_page_kernel`` (row 9) in ``koifish_tpu/ops/pallas/slotwrite.py``:

- ``slot_write(buf [B, H, S, Dc], val [B, H, Dc], slots [B])``: row
  ``slots[b]`` of lane b, for int8 codes, packed-INT4 uint8, bf16 and f32; a
  scale buffer ``[B, H, S]`` is the ``Dc = 1`` case.
- ``page_write(pages [H, NP, P, D], val [B, H, D], page_ids [B], rows [B])``:
  row ``rows[b]`` of page ``page_ids[b]``; lanes own distinct pages.

Both write in place, read their indices on the device (no host sync), and
take up to four buffers of one shape family in one launch
(``slot_write_many`` / ``page_write_many``): a decode step writes a layer's
K codes, V codes and both scales with one launch. A lane whose index lies
outside the buffer writes nothing.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.utils import kernel_log

NAME = "slotwrite"
SLOT = "slot_write"     # launch counter of the slot mode
PAGE = "page_write"     # launch counter of the page mode
MAX_BUFS = 4
DTYPES = (torch.int8, torch.uint8, torch.bfloat16, torch.float32)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load(NAME)
        fn = lib.koifish_row_write
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def _rows4(buf: torch.Tensor, val: torch.Tensor):
    """(buf, val) with a [B, H, S] scale buffer and its [B, H] values seen
    as rows of one element; val in the buffer's dtype, contiguous."""
    val = val.to(buf.dtype)
    if buf.dim() == 3:
        buf, val = buf.unsqueeze(-1), val.unsqueeze(-1)
    return buf, val.contiguous()


def slot_write_plain(buf: torch.Tensor, val: torch.Tensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """Plain version: the masked select of the JAX package's
    ``kvcache.ring_write`` — a new tensor equal to ``buf`` with row
    ``slots[b]`` of lane b replaced by ``val[b]``."""
    S = buf.shape[2]
    mask = (torch.arange(S, device=buf.device)[None, :]
            == slots.to(buf.device).long()[:, None])[:, None, :]  # [B, 1, S]
    if buf.dim() == 4:
        mask, val = mask[..., None], val[:, :, None, :]
    else:
        val = val[:, :, None]
    return torch.where(mask, val.to(buf.dtype), buf)


def page_write_plain(pages: torch.Tensor, val: torch.Tensor,
                     page_ids: torch.Tensor, rows: torch.Tensor
                     ) -> torch.Tensor:
    """Plain version: the JAX package's ``paged._page_write_ref`` — a
    one-hot [B, NP, P] of each lane's target row, contracted with the values
    (each (page, row) has at most one writer), selected over the pool."""
    NP, P = pages.shape[1], pages.shape[2]
    dev = pages.device
    hit = ((torch.arange(NP, device=dev)[None, :, None]
            == page_ids.long()[:, None, None])
           & (torch.arange(P, device=dev)[None, None, :]
              == rows.long()[:, None, None]))
    # f32 holds every value of the four dtypes exactly
    contrib = torch.einsum("bnp,bhd->hnpd", hit.to(torch.float32),
                           val.to(pages.dtype).to(torch.float32))
    any_hit = hit.any(dim=0)[None, :, :, None]
    return torch.where(any_hit, contrib.to(pages.dtype), pages)


def _check(what: str, pairs, idx, lead: Tuple[int, ...]) -> None:
    """Dtypes, devices, contiguity and shapes of the buffers of one launch:
    every buffer shares its first three axes ([B, H, S] or [H, NP, P]) with
    the first; ``lead`` is the (B, H) of every value [B, H, Dc]."""
    if not 1 <= len(pairs) <= MAX_BUFS:
        raise ValueError(f"{what}: {len(pairs)} buffers, need 1..{MAX_BUFS}")
    for t in idx:
        if t.device.type != "cuda" or t.dtype != torch.int32 \
                or tuple(t.shape) != lead[:1]:
            raise ValueError(f"{what}: indices {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}: need int32 [{lead[0]}] on the card")
    dev = idx[0].device
    want = tuple(pairs[0][0].shape[:3])
    for buf, val in pairs:
        shape = f"buf{tuple(buf.shape)} {buf.dtype} val{tuple(val.shape)}"
        if buf.dtype not in DTYPES or val.dtype != buf.dtype:
            raise ValueError(f"{what}: {shape}: need one of {DTYPES} for "
                             f"both")
        if buf.dim() != 4 or tuple(buf.shape[:3]) != want or val.dim() != 3 \
                or tuple(val.shape[:2]) != lead \
                or val.shape[2] != buf.shape[3]:
            raise ValueError(f"{what}: {shape}: need buffers sharing {want} "
                             f"and values [B, H, Dc] = {lead} + [Dc]")
        for name, t in (("buf", buf), ("val", val)):
            if t.device != dev or not t.is_contiguous():
                raise ValueError(f"{what}: {name} of {shape} lies on "
                                 f"{t.device}: need it contiguous on {dev}")


def _launch(pairs, idx, rows, B, H, S, NP, stream):
    n = len(pairs)
    bufs = (ctypes.c_ulonglong * n)(*[b.data_ptr() for b, _ in pairs])
    vals = (ctypes.c_ulonglong * n)(*[v.data_ptr() for _, v in pairs])
    rbs = (ctypes.c_longlong * n)(*[b.shape[3] * b.element_size()
                                    for b, _ in pairs])
    lib, fn = _kernel()
    rc = fn(n, ctypes.addressof(bufs), ctypes.addressof(vals),
            ctypes.addressof(rbs), idx.data_ptr(),
            None if rows is None else rows.data_ptr(), B, H, S, NP, stream)
    return lib, rc


def slot_write_many(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    slots: torch.Tensor) -> None:
    """``buf[b, :, slots[b]] = val[b]`` for up to four (buf, val) pairs that
    share (B, H, S), in place, in one launch. A CPU buffer takes the plain
    version; CUDA buffers launch the kernel."""
    pairs = [_rows4(b, v) for b, v in pairs]
    if pairs[0][0].device.type == "cpu":
        for buf, val in pairs:
            buf.copy_(slot_write_plain(buf, val, slots))
        return
    B, H, S = pairs[0][0].shape[:3]
    slots = slots.to(torch.int32)
    _check("slot_write", pairs, (slots,), (B, H))
    stream = torch.cuda.current_stream(slots.device).cuda_stream
    lib, rc = _launch(pairs, slots, None, B, H, S, 0, stream)
    _build.check(lib, rc, f"slot_write {len(pairs)} x buf"
                 f"{tuple(pairs[0][0].shape)}")
    kernel_log.count(SLOT)


def slot_write(buf: torch.Tensor, val: torch.Tensor,
               slots: torch.Tensor) -> torch.Tensor:
    """``buf [B, H, S, Dc] (or [B, H, S])`` <- ``val [B, H, Dc] (or [B, H])``
    at per-lane rows ``slots [B]``, in place; returns ``buf``."""
    slot_write_many([(buf, val)], slots)
    return buf


def page_write_many(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    page_ids: torch.Tensor, rows: torch.Tensor) -> None:
    """``pages[:, page_ids[b], rows[b]] = val[b]`` for up to four (pages,
    val) pairs that share [H, NP, P], in place, in one launch. Lanes must
    own distinct pages (``PageAllocator`` guarantees it)."""
    pairs = [(p, v.to(p.dtype).contiguous()) for p, v in pairs]
    if pairs[0][0].device.type == "cpu":
        for pages, val in pairs:
            pages.copy_(page_write_plain(pages, val, page_ids, rows))
        return
    H, NP, P = pairs[0][0].shape[:3]
    B = pairs[0][1].shape[0]
    page_ids, rows = page_ids.to(torch.int32), rows.to(torch.int32)
    _check("page_write", pairs, (page_ids, rows), (B, H))
    stream = torch.cuda.current_stream(page_ids.device).cuda_stream
    lib, rc = _launch(pairs, page_ids, rows, B, H, P, NP, stream)
    _build.check(lib, rc, f"page_write {len(pairs)} x pages"
                 f"{tuple(pairs[0][0].shape)}")
    kernel_log.count(PAGE)


def page_write(pages: torch.Tensor, val: torch.Tensor, page_ids: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """``pages [H, NP, P, D]`` <- ``val [B, H, D]`` at ``(page_ids[b],
    rows[b])``, in place; returns ``pages``."""
    page_write_many([(pages, val)], page_ids, rows)
    return pages
