"""Model-FLOPs utilization of a train step (the JAX package's
``utils/mfu.py``): analytic model FLOPs / step time / the card's peak.
The PaLM convention: 6 x matmul parameters x tokens, plus the attention
quadratic term; the embedding gather is excluded."""
from __future__ import annotations

from typing import Optional

# dense bf16 tensor-core peaks (NVIDIA data sheets), FLOP/s, keyed by
# substrings of torch.cuda.get_device_name(); the first match wins
_PEAK_FLOPS = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),           # SXM ("NVIDIA H100 80GB HBM3")
    ("H200", 989e12),
)


def chip_peak_flops(name: Optional[str] = None) -> Optional[float]:
    """Peak bf16 FLOP/s of the current CUDA device (or of a device named
    ``name``); None on the CPU or for a card not in the table."""
    if name is None:
        import torch
        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(0)
    for key, peak in _PEAK_FLOPS:
        if key in name:
            return peak
    return None


def matmul_params(card) -> int:
    """Parameters that take part in matmuls (the head counts once)."""
    E, L = card.n_embd, card.n_layer
    q = card.n_head * card.head_dim
    kv = card.n_kv_head * card.head_dim
    attn = E * q + 2 * E * kv + q * E
    if getattr(card, "n_experts", 0):
        ffn = 3 * E * (card.moe_ffn or card.n_ffn) * \
            max(getattr(card, "n_experts_active", 1), 1)
        ffn += E * card.n_experts
    else:
        n_mats = 3 if card.act in ("silu", "swiglu") else 2
        ffn = n_mats * E * card.n_ffn
    return L * (attn + ffn) + E * card.vocab_size


def train_step_flops(card, n_tokens: int) -> float:
    """Matmul FLOPs of one train step over ``n_tokens``: fwd 2PT + bwd 4PT
    + the causal attention term (x3 for its backward)."""
    dense = 6.0 * matmul_params(card) * n_tokens
    attn_fwd = 2 * card.n_layer * n_tokens * 2 * (card.n_ctx / 2) * \
        (card.n_head * card.head_dim)
    return dense + 3.0 * attn_fwd


def step_mfu(card, n_tokens: int, dt: float,
             peak: Optional[float] = None) -> Optional[float]:
    """MFU in [0, 1] of one train step, or None off the card."""
    peak = peak if peak is not None else chip_peak_flops()
    if not peak or dt <= 0:
        return None
    return train_step_flops(card, n_tokens) / dt / peak
