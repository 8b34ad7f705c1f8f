"""Learned-codebook (k-means, MINI) and Sinkhorn-normalized quantization.

The JAX package's ``quant/cluster.py``:

- ``quantize_kmeans`` (``Q_Cluster``): a per-tensor 2^bits-entry codebook
  learned by 1-D Lloyd iterations over absmax-normalized group values.
- ``quantize_mini`` (``Q_Impurity``): a per-row codebook by the same Lloyd
  objective, the row absmax folded into the entries, identity group scales.
- ``quantize_sinkhorn`` (``SinkNormal``): rows and columns divided by their
  std in turn; the column factors fold into the group scales, the row
  factors ride the QTensor and fold into the activations at matmul time.

All three give ordinary QTensors with NF4/NF3 code layouts; the book
GEMV/GEMM (``ops/kernels/matmul.py``) serves the codebook ones.

One difference from the JAX package: above ``sample`` elements the k-means
book is fitted on a subsample that the JAX package draws with
``jax.random.permutation(PRNGKey(0))``; the port draws it with
``torch.randperm`` from a ``torch.Generator`` seeded with 0, so the indices
(and the book, by a little) differ. At or below ``sample`` elements there is
no subsample and the books agree.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from koifish_tpu_torch.dtypes import DEFAULT_GROUP, QFormat
from koifish_tpu_torch.quant.packing import pack_codes
from koifish_tpu_torch.quant.qtensor import QTensor
from koifish_tpu_torch.quant.rtn import quantize


def _quantile_points(k: int, device) -> torch.Tensor:
    # quantile init — robust for heavy-tailed weight distributions
    return torch.linspace(0.005, 0.995, k, dtype=torch.float32, device=device)


def _lloyd_step(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration over the last axis: x [..., N], cents [..., k]."""
    k = cents.shape[-1]
    d = torch.abs(x[..., :, None] - cents[..., None, :])      # [..., N, k]
    one = torch.nn.functional.one_hot(torch.argmin(d, dim=-1), k).to(
        torch.float32)
    count = one.sum(dim=-2)
    total = (one * x[..., :, None]).sum(dim=-2)
    return torch.where(count > 0, total / torch.clamp(count, min=1), cents)


def _kmeans_1d(x: torch.Tensor, k: int, iters: int = 12) -> torch.Tensor:
    """1-D Lloyd's algorithm -> sorted codebook [k] (f32). x: flat values."""
    x = x.to(torch.float32)
    cents = torch.quantile(x, _quantile_points(k, x.device))
    for _ in range(iters):
        cents = _lloyd_step(x, cents)
    return torch.sort(cents).values


def quantize_kmeans(w: torch.Tensor, bits: int = 4,
                    group: int = DEFAULT_GROUP, iters: int = 12,
                    sample: int = 65536) -> QTensor:
    """Per-tensor learned codebook over absmax-normalized values (Q_Cluster
    analog). bits in (3, 4)."""
    if bits not in (3, 4):
        raise ValueError(f"k-means codebooks take 3 or 4 bits, got {bits}")
    fmt = QFormat.NF4 if bits == 4 else QFormat.NF3
    k = 1 << bits
    w2 = w.reshape(w.shape[0], -1).to(torch.float32)
    G = w2.shape[0] // group
    g = w2.reshape(G, group, -1)
    scale = torch.clamp(torch.amax(torch.abs(g), dim=1), min=1e-12)  # [G, out]
    normed = (g / scale[:, None, :]).reshape(-1)
    if normed.numel() > sample:
        gen = torch.Generator(device=normed.device)
        gen.manual_seed(0)
        idx = torch.randperm(normed.numel(), generator=gen,
                             device=normed.device)[:sample]
        fit = normed[idx]
    else:
        fit = normed
    book = _kmeans_1d(fit, k, iters)
    # nearest codebook entry: the sorted book's midpoints, left-sided search
    mids = (book[1:] + book[:-1]) / 2.0
    raw = torch.searchsorted(mids, normed).to(torch.uint8)
    codes = pack_codes(raw.reshape(w2.shape), fmt, group=group)
    return QTensor(codes=codes, scales=scale, zeros=None, fmt=fmt,
                   shape=tuple(w2.shape), group=group, codebook=book)


def sinkhorn_normalize(w: torch.Tensor, iters: int = 6
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alternately divide rows/columns by their std -> (wn, r, c) with
    w = r[:, None] * wn * c[None, :] (SinkNormal)."""
    wn = w.to(torch.float32)
    r = torch.ones((w.shape[0],), dtype=torch.float32, device=w.device)
    c = torch.ones((w.shape[1],), dtype=torch.float32, device=w.device)
    for _ in range(iters):
        rs = torch.clamp(torch.std(wn, dim=1, correction=0), min=1e-8)
        wn = wn / rs[:, None]
        r = r * rs
        cs = torch.clamp(torch.std(wn, dim=0, correction=0), min=1e-8)
        wn = wn / cs[None, :]
        c = c * cs
    return wn, r, c


def quantize_sinkhorn(w: torch.Tensor, fmt: QFormat = QFormat.INT4,
                      group: int = DEFAULT_GROUP, iters: int = 6) -> QTensor:
    """Sinkhorn-normalize, quantize the balanced matrix, fold the column
    factors into the group scales and carry the row factors on the QTensor
    (activation-side fold)."""
    wn, r, c = sinkhorn_normalize(w, iters)
    qt = quantize(wn, fmt, group=group)
    scales = qt.scales.to(torch.float32) * c[None, :]
    return dataclasses.replace(qt, scales=scales, row_scale=r)


def _fit_rows(rows: torch.Tensor, k: int, iters: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row Lloyd books of a row chunk [rc, C] -> (books [rc, k] with the
    row absmax folded in, raw codes [rc, C] uint8)."""
    absmax = torch.clamp(torch.amax(torch.abs(rows), dim=1, keepdim=True),
                         min=1e-12)
    x = rows / absmax
    cents = torch.quantile(x, _quantile_points(k, x.device), dim=1).T
    for _ in range(iters):
        cents = _lloyd_step(x, cents)
    cents = torch.sort(cents, dim=1).values
    mids = (cents[:, 1:] + cents[:, :-1]) / 2.0
    codes = torch.searchsorted(mids.contiguous(), x.contiguous()).to(
        torch.uint8)
    return cents * absmax, codes


def quantize_mini(w: torch.Tensor, bits: int = 4, group: int = DEFAULT_GROUP,
                  iters: int = 10, row_chunk: int = 256) -> QTensor:
    """MINI quantization (the reference's ``Q_Impurity``): a per-ROW
    2^bits-entry codebook by Lloyd iterations — the within-bin-variance
    minimizer for a fixed bin count. Row absmax folds into the entries, so
    the QTensor carries identity group scales and a [rows, 2^bits] book."""
    if bits not in (3, 4):
        raise ValueError(f"MINI codebooks take 3 or 4 bits, got {bits}")
    fmt = QFormat.NF4 if bits == 4 else QFormat.NF3
    k = 1 << bits
    w2 = w.reshape(w.shape[0], -1).to(torch.float32)
    R, C = w2.shape
    # chunk rows: the unchunked fit builds [R, C, k] distance tensors
    # (hundreds of GB at model widths)
    rc = next((c for c in (256, 128, 64, 32, 16, 8, 1)
               if c <= row_chunk and R % c == 0), 1)
    parts = [_fit_rows(w2[i:i + rc], k, iters) for i in range(0, R, rc)]
    books = torch.cat([b for b, _ in parts])
    raw = torch.cat([r for _, r in parts])
    codes = pack_codes(raw, fmt, group=group)
    return QTensor(codes=codes,
                   scales=torch.ones((R // group, C), dtype=torch.float32,
                                     device=w.device),
                   zeros=None, fmt=fmt, shape=(R, C), group=group,
                   codebook=books)
