"""Paged decode attention: the CUDA kernel's wrappers and plain versions.

The kernel (``csrc/paged_attn.cu``) replaces the library Pallas kernel that
the JAX package's ``serve/paged.py`` (``_paged_attention``) calls on the TPU,
``jax.experimental.pallas.ops.tpu.paged_attention``: one-token GQA attention
read through a page table from bf16 K/V pages. It computes what the JAX
package's gather path (``_paged_attention_ref``) computes: logits q·k·scale
and the softmax in f32, one rounding of the output to bf16 (the kernel's
P·V takes p as a bf16 hi and lo pair, ~16 bits). The live positions are
split over the blocks of a thread-block cluster (``plan``, row 7's split
over MAXP·128 positions); each rank takes a run of 64-position tiles
(``rank_tiles``) and rank 0 merges the ranks' (m, l, o) in rank order.

Two entries:

- ``paged_attention``: attention over the pages as they are.
- ``paged_attention_write``: write each lane's new bf16 K/V row at row
  ``rows[b]`` of page ``page_ids[b]`` (the page write, ``slotwrite.py``'s
  ``page_write``), then attend over the updated pages, in one launch (the
  paged decode step's write and attention).

Layout (``serve/paged.py``): pools ``[Hkv, NP, 128, D]`` bf16, one K and
one V a layer; ``page_table`` ``[B, MAXP]`` int32; position t of lane b is
row t % 128 of page ``page_table[b, t // 128]``. A lane reads only the
pages below ``ceil(lengths[b] / 128)``; ids past them may be anything.
"""
from __future__ import annotations

import ctypes

import torch

from koifish_tpu_torch.ops.attention import decode_attention
from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.ops.kernels import decode_attn as _da
from koifish_tpu_torch.ops.kernels.slotwrite import page_write_plain
from koifish_tpu_torch.utils import kernel_log

NAME = "paged_attn"
WRITE = "paged_attn_write"   # launch counter of the fused page write
PAGE = 128                   # positions a page
HEAD_DIMS = (64, 128, 256)
TILE = _da.TILE              # positions a tile: the unit of the split
GROUP = _da.GROUP            # q heads a block
MAX_SPLITS = _da.MAX_SPLITS

_fn = None
_sm_count = _da._sm_count


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load(NAME)
        fn = lib.koifish_paged_attn
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def plan(B: int, Hq: int, Hkv: int, max_pages: int, sms: int = 132) -> int:
    """Blocks per (b, kv head, head group), 1..8: row 7's split (``decode_attn
    .plan``) over the table's ``max_pages``·128 positions, from the grid
    and the table's width alone (never the lengths: no host sync)."""
    return _da.plan(B, Hq, Hkv, max_pages * PAGE, sms)


def rank_tiles(length: int, max_pages: int, splits: int):
    """Each rank's tiles [t0, t1) as the kernel derives them from a lane's
    length (tile t is rows (t % 2)·64.. of the lane's page t // 2)."""
    return _da.rank_tiles(length, max_pages * PAGE, splits)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """Each lane's pages in table order as a dense head-major view:
    [H, NP, P, D] through [B, MAXP] -> [B, H, MAXP·P, D]."""
    B, maxp = page_table.shape
    H, _, P, D = pages.shape
    return pages[:, page_table.long()].transpose(0, 1).reshape(
        B, H, maxp * P, D)


def paged_attention_plain(q, k_pages, v_pages, lengths, page_table,
                          scale: float) -> torch.Tensor:
    """Plain version (the JAX package's ``_paged_attention_ref``): gather
    every lane's whole table into a dense [B, S, H, D] view and run the
    masked f32 decode attention. q [B, Hq, D] -> [B, Hq, D] in q's dtype."""
    S = page_table.shape[1] * PAGE
    gk = gather_pages(k_pages, page_table).transpose(1, 2)
    gv = gather_pages(v_pages, page_table).transpose(1, 2)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    return decode_attention(q, gk, gv, valid, scale=scale)


def paged_attention_write_plain(q, k_new, v_new, k_pages, v_pages, lengths,
                                page_table, page_ids, rows, scale: float
                                ) -> torch.Tensor:
    """Plain version of the fused entry: ``page_write_plain`` of the new
    K/V [B, Hkv, D] into both pools (in place), then
    ``paged_attention_plain`` -> [B, Hq, D]."""
    for pages, val in ((k_pages, k_new), (v_pages, v_new)):
        pages.copy_(page_write_plain(pages, val, page_ids, rows))
    return paged_attention_plain(q, k_pages, v_pages, lengths, page_table,
                                 scale)


def paged_attention_splits_plain(q, k_pages, v_pages, lengths, page_table,
                                 scale: float, splits: int,
                                 drop_last: bool = False) -> torch.Tensor:
    """Plain emulation of the kernel's split: each rank's (m, l, o) over its
    tiles (``rank_tiles``) in f32, merged in rank order -> [B, Hq, D] f32.
    ``drop_last`` leaves out the last live rank of every lane that has two
    or more."""
    B, Hq, _ = q.shape
    maxp = page_table.shape[1]
    S = maxp * PAGE
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    ones = torch.ones(k.shape[:3], dtype=torch.float32, device=q.device)
    pos = torch.arange(S, device=q.device)[None, :]
    ranges = [rank_tiles(int(n), maxp, splits) for n in lengths.tolist()]
    live = [sum(t1 > t0 for t0, t1 in r) for r in ranges]
    parts = []
    for r in range(splits):
        lo = torch.tensor([rg[r][0] * TILE for rg in ranges], device=q.device)
        hi = torch.tensor([rg[r][1] * TILE for rg in ranges], device=q.device)
        sel = (pos >= lo[:, None]) & (pos < hi[:, None]) \
            & (pos < lengths[:, None])
        if drop_last:
            last = torch.tensor([n >= 2 and r == n - 1 for n in live],
                                device=q.device)
            sel = sel & ~last[:, None]
        parts.append(_da._partial(q, k, v, ones, ones, sel, scale,
                                  torch.float32))
    return _da._merge(parts).reshape(B, Hq, -1)


def _check(q, k_pages, v_pages, lengths, page_table, new=None):
    B, Hq, D = q.shape
    shape = (f"q{tuple(q.shape)} pages{tuple(k_pages.shape)} "
             f"table{tuple(page_table.shape)}")
    if k_pages.dim() != 4 or tuple(v_pages.shape) != tuple(k_pages.shape) \
            or k_pages.shape[2] != PAGE or k_pages.shape[3] != D:
        raise ValueError(f"paged_attn: {shape}: need K and V pools "
                         f"[Hkv, NP, {PAGE}, D] of q's D")
    Hkv = k_pages.shape[0]
    if Hq % Hkv or D not in HEAD_DIMS:
        raise ValueError(f"paged_attn: {shape}: need Hq % Hkv == 0 and D in "
                         f"{HEAD_DIMS}")
    if B * Hkv > 65535:
        raise ValueError(f"paged_attn: {shape}: B·Hkv = {B * Hkv} > 65535")
    if q.dtype != torch.bfloat16 or k_pages.dtype != torch.bfloat16 \
            or v_pages.dtype != torch.bfloat16:
        raise ValueError(f"paged_attn: {shape}: need bf16 q and pages, got "
                         f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32 \
            or page_table.dim() != 2 or page_table.shape[0] != B \
            or page_table.dtype != torch.int32:
        raise ValueError(f"paged_attn: {shape}: lengths {tuple(lengths.shape)}"
                         f" {lengths.dtype}, table {page_table.dtype}: need "
                         f"int32 [{B}] and [{B}, MAXP]")
    named = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
             ("lengths", lengths), ("page_table", page_table)]
    if new is not None:
        k_new, v_new, page_ids, rows = new
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            if tuple(t.shape) != (B, Hkv, D) or t.dtype != torch.bfloat16:
                raise ValueError(f"paged_attn: {shape}: {name} "
                                 f"{tuple(t.shape)} {t.dtype}: need bf16 "
                                 f"[{B}, {Hkv}, {D}]")
        for name, t in (("page_ids", page_ids), ("rows", rows)):
            if tuple(t.shape) != (B,) or t.dtype != torch.int32:
                raise ValueError(f"paged_attn: {name} {tuple(t.shape)} "
                                 f"{t.dtype}: need int32 [{B}]")
        named += [("k_new", k_new), ("v_new", v_new), ("page_ids", page_ids),
                  ("rows", rows)]
    for name, t in named:
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"paged_attn: {name} lies on {t.device}, need "
                             f"the CUDA device of q ({q.device})")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_attn: {name} of {shape} must be "
                             f"contiguous and 16-byte aligned")


def _launch(q, k_pages, v_pages, lengths, page_table, scale, new):
    """One launch of the kernel (``new``: (k_new, v_new, page_ids, rows) or
    None); allocates the output and nothing else."""
    B, Hq, D = q.shape
    Hkv, NP = k_pages.shape[0], k_pages.shape[1]
    maxp = page_table.shape[1]
    splits = plan(B, Hq, Hkv, maxp, _sm_count(q.device))
    out = torch.empty((B, Hq, D), dtype=torch.bfloat16, device=q.device)
    knew, vnew, pids, rows = (t.data_ptr() for t in new) if new is not None \
        else (None, None, None, None)
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), page_table.data_ptr(), out.data_ptr(), knew,
            vnew, pids, rows, B, Hq, Hkv, NP, maxp, D, float(scale), splits,
            stream)
    _build.check(lib, rc, f"paged_attn q{tuple(q.shape)}")
    kernel_log.count(NAME)
    if new is not None:
        kernel_log.count(WRITE)
    return out


def paged_attention(q, k_pages, v_pages, lengths, page_table,
                    scale: float) -> torch.Tensor:
    """One-token attention through the page table -> [B, Hq, D] bf16. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, lengths,
                                     page_table, scale)
    q = q.to(torch.bfloat16).contiguous()
    _check(q, k_pages, v_pages, lengths, page_table)
    return _launch(q, k_pages, v_pages, lengths, page_table, scale, None)


def paged_attention_write(q, k_new, v_new, k_pages, v_pages, lengths,
                          page_table, page_ids, rows, scale: float
                          ) -> torch.Tensor:
    """Write lane b's new K/V [B, Hkv, D] at row ``rows[b]`` of page
    ``page_ids[b]`` of both pools (in place) and attend over the updated
    pages -> [B, Hq, D] bf16: one launch on a CUDA tensor (counted under
    ``paged_attn`` and ``paged_attn_write``), the plain version on a CPU
    tensor. A page written here is read here only by the lane that writes
    it (each lane owns its pages, as ``PageAllocator`` hands them out)."""
    k_new, v_new = k_new.to(torch.bfloat16), v_new.to(torch.bfloat16)
    if q.device.type == "cpu":
        return paged_attention_write_plain(q, k_new, v_new, k_pages, v_pages,
                                           lengths, page_table, page_ids,
                                           rows, scale)
    q = q.to(torch.bfloat16).contiguous()
    new = (k_new.contiguous(), v_new.contiguous(),
           page_ids.to(torch.int32), rows.to(torch.int32))
    _check(q, k_pages, v_pages, lengths, page_table, new)
    return _launch(q, k_pages, v_pages, lengths, page_table, scale, new)
