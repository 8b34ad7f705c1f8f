"""Rotary position embeddings, including YaRN/NTK long-context scaling.

Neox-style (rotate-half) pairing, as in the JAX package's ``ops/rope.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _yarn_scaled_inv_freq(inv_freq: torch.Tensor, scaling: dict,
                          head_dim: int) -> torch.Tensor:
    """YaRN frequency correction (interpolate low-freq, keep high-freq,
    linear ramp between) — reference rope.cu:129-155."""
    factor = float(scaling.get("factor", 1.0))
    orig_ctx = float(scaling.get("original_max_position_embeddings", 4096))
    beta_fast = float(scaling.get("beta_fast", 32.0))
    beta_slow = float(scaling.get("beta_slow", 1.0))

    wavelen = 2 * math.pi / inv_freq
    low = orig_ctx / (beta_fast * 2 * math.pi) if beta_fast else 0.0
    high = orig_ctx / (beta_slow * 2 * math.pi) if beta_slow else 0.0
    ramp = torch.clamp((wavelen - low) / max(high - low, 1e-6), 0.0, 1.0)
    scaled = inv_freq / factor
    return inv_freq * (1 - ramp) + scaled * ramp


def rope_inv_freq(head_dim: int, theta: float = 10_000.0,
                  scaling: Optional[dict] = None, device=None):
    """(inv_freq [head_dim/2] f32, attn_scale) with YaRN/linear scaling."""
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    inv_freq = 1.0 / (float(theta) ** expo)
    attn_scale = 1.0
    if scaling:
        rtype = scaling.get("rope_type", scaling.get("type", "yarn"))
        if rtype == "linear":
            inv_freq = inv_freq / float(scaling.get("factor", 1.0))
        elif rtype in ("yarn", "ntk", "dynamic"):
            inv_freq = _yarn_scaled_inv_freq(inv_freq, scaling, head_dim)
            factor = float(scaling.get("factor", 1.0))
            if factor > 1.0:
                # f32 like the JAX package's jnp.log on a weak float
                attn_scale = float(torch.tensor(
                    0.1 * math.log(factor) + 1.0, dtype=torch.float32))
    return inv_freq, attn_scale


def rope_freqs(head_dim: int, max_pos: int, theta: float = 10_000.0,
               scaling: Optional[dict] = None, dtype=torch.float32,
               device=None):
    """Precompute (cos, sin) tables of shape [max_pos, head_dim/2]."""
    inv_freq, attn_scale = rope_inv_freq(head_dim, theta, scaling, device)
    pos = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(pos, inv_freq)
    cos = (torch.cos(freqs) * attn_scale).to(dtype)
    sin = (torch.sin(freqs) * attn_scale).to(dtype)
    return cos, sin


def rope_cos_sin_at(head_dim: int, positions: torch.Tensor,
                    theta: float = 10_000.0, scaling: Optional[dict] = None,
                    dtype=torch.float32):
    """(cos, sin) evaluated directly at arbitrary — possibly >= max_pos —
    integer ``positions`` [B, T]: the decode path's unbounded-position rope."""
    inv_freq, attn_scale = rope_inv_freq(head_dim, theta, scaling,
                                         positions.device)
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    return ((torch.cos(freqs) * attn_scale).to(dtype),
            (torch.sin(freqs) * attn_scale).to(dtype))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor]) -> torch.Tensor:
    """Rotate-half RoPE. x: [B, T, H, D]; positions: [B, T] or [T] table
    indices — or None when cos/sin are already gathered [B, T, half]."""
    half = x.shape[-1] // 2
    if positions is None:
        c = cos[:, :, None, :]
        s = sin[:, :, None, :]
    else:
        c = cos[positions]
        s = sin[positions]
        if c.dim() == 2:  # [T, half] -> broadcast batch
            c = c[None, :, None, :]
            s = s[None, :, None, :]
        else:             # [B, T, half]
            c = c[:, :, None, :]
            s = s[:, :, None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
