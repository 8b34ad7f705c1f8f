"""Low-rank weight compression — the lenda/LoSVD analog (the JAX package's
``quant/lowrank.py``; the reference's randomized SVD, lenda/kernel/
SVD_r.cpp:898, behind SparseNeuron's low-rank option, Neuron.hpp:306).

The factorization is one ``torch.linalg.svd`` in f32; the product value is
the compressed matmul ``x @ W ≈ (x @ A) @ B`` with ``A [in, r]``, ``B [r,
out]``: 2·r·(in+out) FLOPs a token instead of 2·in·out. Singular vectors
are defined up to sign, so two SVDs agree on ``A @ B``, not on the factors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def svd_compress(w: torch.Tensor, rank: Optional[int] = None,
                 energy: float = 0.95) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factor ``w [in, out]`` into ``A [in, r] @ B [r, out]``.

    ``rank``: explicit target rank; otherwise the smallest r capturing
    ``energy`` of the squared spectral mass (the LoSVD default mode).
    Returns bf16 factors; reconstruct with ``A @ B``."""
    wf = w.to(torch.float32)
    u, s, vt = torch.linalg.svd(wf, full_matrices=False)
    if rank is None:
        e = torch.cumsum(s ** 2, dim=0) / torch.sum(s ** 2)
        rank = int(torch.searchsorted(e, torch.tensor(
            [energy], dtype=e.dtype, device=e.device)).item()) + 1
    rank = max(1, min(rank, s.shape[0]))
    a = (u[:, :rank] * s[:rank][None, :]).to(torch.bfloat16)
    b = vt[:rank].to(torch.bfloat16)
    return a, b


def lowrank_error(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative Frobenius reconstruction error."""
    wf = w.to(torch.float32)
    rec = a.to(torch.float32) @ b.to(torch.float32)
    return float(torch.linalg.norm(wf - rec)
                 / (torch.linalg.norm(wf) + 1e-12))
