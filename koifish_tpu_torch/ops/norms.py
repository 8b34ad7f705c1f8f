"""Normalization ops — RMSNorm / LayerNorm (+ fused residual add).

f32 math on bf16 storage, as in the JAX package's ``ops/norms.py``.
"""
from __future__ import annotations

from typing import Optional

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    if residual is not None:
        x = x + residual
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    if residual is not None:
        x = x + residual
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)
