"""Plain PyTorch forwards of GPT-2 and Qwen3 in float32, from the published
descriptions (HF ``modeling_gpt2`` and ``modeling_qwen3``), over the
benchmark's weight tree (``kbench/weights.py``). No kernel, cache or
batching: ``torch`` operations only. It imports nothing of the program.

- GPT-2: learned positions, pre-LayerNorm (eps 1e-5), biased q, k, v, o,
  a GELU (tanh) MLP, a final LayerNorm, the head tied to ``wte``.
- Qwen3: RMSNorm (eps 1e-6), per-head RMSNorm of q and k before
  rotate-half RoPE (theta 1e6), grouped-query attention, a SwiGLU MLP,
  a final RMSNorm, the head tied to ``wte``.

``lin``: how a projection is computed, ``lin(x, w, name)``; the reference
passes a float32 product, the control a lower-precision one.
``kv``: a function applied to each layer's K and V before the attention
of the query rows it is given (the serving reference's INT8 cache).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from kbench.work import Shapes

F32 = torch.float32


def strict_f32() -> None:
    """No TF32 anywhere: a float32 product is a float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def plain_lin(x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    return x @ w.to(F32)


def layernorm(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w.to(F32) + b.to(F32)


def rmsnorm(x, w, eps=1e-6):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * w.to(F32)


def rope(x, pos, theta):
    """Rotate-half RoPE of x [..., T, H, D] at positions ``pos`` [T]."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D // 2, device=x.device,
                                        dtype=F32) / (D // 2)))
    ang = pos.to(F32)[:, None] * inv[None, :]            # [T, D/2]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None, :]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attention(q, k, v, q_pos, k_pos, block: int = 1024):
    """Causal attention of q [B, Tq, Hq, D] over k, v [B, Tk, Hkv, D]:
    query at position p sees keys at positions <= p. Query rows in blocks
    of ``block``, each over the keys it can see."""
    B, Tq, Hq, D = q.shape
    g = Hq // k.shape[2]
    kk = k.repeat_interleave(g, dim=2).transpose(1, 2)     # [B, Hq, Tk, D]
    vv = v.repeat_interleave(g, dim=2).transpose(1, 2)
    qq = q.transpose(1, 2)
    outs = []
    for s in range(0, Tq, block):
        qb = qq[:, :, s: s + block]
        last = int(q_pos[min(s + block, Tq) - 1])
        nk = int((k_pos <= last).sum())
        sc = qb @ kk[:, :, :nk].transpose(-1, -2) / math.sqrt(D)
        mask = k_pos[None, :nk] <= q_pos[s: s + block, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        outs.append(torch.softmax(sc, -1) @ vv[:, :, :nk])
    return torch.cat(outs, 2).transpose(1, 2)               # [B, Tq, Hq, D]


def forward_hidden(sh: Shapes, params: Dict, tokens: torch.Tensor,
                   lin: Callable = plain_lin,
                   kv: Optional[Callable] = None,
                   theta: float = 1e6) -> torch.Tensor:
    """Final-norm hidden states [B, T, E] of ``tokens`` [B, T] at positions
    0..T-1. ``kv(k, v) -> (k_q, v_q, first)``: queries at positions >=
    ``first`` attend the keys and values ``k_q``, ``v_q`` (queries before
    it attend the exact ones)."""
    B, T = tokens.shape
    dev = tokens.device
    pos = torch.arange(T, device=dev)
    x = params["wte"][tokens].to(F32)
    if not sh.gated:
        x = x + params["wpe"][:T].to(F32)[None]
    for lp in params["layers"]:
        if sh.gated:
            h = rmsnorm(x, lp["ln1"])
            q = lin(h, lp["q"], "q").view(B, T, sh.Hq, sh.D)
            k = lin(h, lp["k"], "k").view(B, T, sh.Hkv, sh.D)
            v = lin(h, lp["v"], "v").view(B, T, sh.Hkv, sh.D)
            q = rope(rmsnorm(q, lp["qn"]), pos, theta)
            k = rope(rmsnorm(k, lp["kn"]), pos, theta)
        else:
            h = layernorm(x, lp["ln1"], lp["ln1_b"])
            q = (lin(h, lp["q"], "q") + lp["q_b"].to(F32)).view(
                B, T, sh.Hq, sh.D)
            k = (lin(h, lp["k"], "k") + lp["k_b"].to(F32)).view(
                B, T, sh.Hkv, sh.D)
            v = (lin(h, lp["v"], "v") + lp["v_b"].to(F32)).view(
                B, T, sh.Hkv, sh.D)
        if kv is None:
            a = attention(q, k, v, pos, pos)
        else:
            kq, vq, first = kv(k, v)
            parts = []
            if first > 0:
                parts.append(attention(q[:, :first], k, v, pos[:first], pos))
            if first < T:
                parts.append(attention(q[:, first:], kq, vq, pos[first:],
                                       pos))
            a = torch.cat(parts, 1)
        a = a.reshape(B, T, sh.Hq * sh.D)
        o = lin(a, lp["o"], "o")
        if not sh.gated:
            o = o + lp["o_b"].to(F32)
        x = x + o
        if sh.gated:
            h = rmsnorm(x, lp["ln2"])
            m = F.silu(lin(h, lp["gate"], "gate")) * lin(h, lp["up"], "up")
            x = x + lin(m, lp["down"], "down")
        else:
            h = layernorm(x, lp["ln2"], lp["ln2_b"])
            m = F.gelu(lin(h, lp["fc"], "fc") + lp["fc_b"].to(F32),
                       approximate="tanh")
            x = x + lin(m, lp["proj"], "proj") + lp["proj_b"].to(F32)
    if sh.gated:
        return rmsnorm(x, params["ln_f"])
    return layernorm(x, params["ln_f"], params["ln_f_b"])


def logits(sh: Shapes, params: Dict, hidden: torch.Tensor,
           lin: Callable = plain_lin) -> torch.Tensor:
    """The tied head: hidden [..., E] -> logits [..., V] (float32)."""
    return lin(hidden, params["wte"].t(), "head")
