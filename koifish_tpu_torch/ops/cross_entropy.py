"""Cross-entropy loss — the classifier head's loss (JAX package's
``ops/cross_entropy.py``).

``cross_entropy_loss`` takes logits; its autograd Function keeps only the
bf16 logits and the [B, T] lse for the backward and recomputes
p = exp(logits − lse) there, so no f32 [B, T, V] softmax outlives the
forward. ``fused_ce_loss`` takes hidden states and the head weight and
never writes the [B, T, V] logits: it runs the fused-CE kernels
(``ops/kernels/fused_ce.py``) for the shapes they take and otherwise a
checkpointed vocab-chunk scan with a running (max, sumexp, gold).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from koifish_tpu_torch.ops.int8_train import int8_matmul
from koifish_tpu_torch.ops.kernels import fused_ce as kfce
from koifish_tpu_torch.ops.tracectx import current_int8

_NEG_INF = -1e30
_ROW_ELEMS = 1 << 28     # f32 elements per row chunk of the [.., V] math


def _row_chunks(n_rows: int, v: int):
    step = max(1, _ROW_ELEMS // max(v, 1))
    return [(r, min(r + step, n_rows)) for r in range(0, n_rows, step)]


def _weights(mask, n, g_loss, device):
    if mask is None:
        return torch.full((n,), 1.0 / n, dtype=torch.float32,
                          device=device) * g_loss
    m = mask.reshape(n).to(torch.float32)
    return m / m.sum().clamp_min(1.0) * g_loss


class _CE(torch.autograd.Function):
    """The recompute backward of the JAX package's ``_ce`` custom VJP."""

    @staticmethod
    def forward(ctx, logits, targets, mask):
        V = logits.shape[-1]
        lg = logits.reshape(-1, V)
        tgt = targets.reshape(-1, 1).long()
        lse = torch.cat([torch.logsumexp(lg[a:b].to(torch.float32), dim=-1)
                         for a, b in _row_chunks(lg.shape[0], V)])
        # gold gathers from the original logits, upcast after
        gold = lg.gather(1, tgt)[:, 0].to(torch.float32)
        per_tok = (lse - gold).reshape(targets.shape)
        if mask is None:
            loss = per_tok.mean()
        else:
            m = mask.to(torch.float32)
            loss = (per_tok * m).sum() / m.sum().clamp_min(1.0)
        ctx.save_for_backward(logits, targets, mask, lse)
        return loss, per_tok

    @staticmethod
    def backward(ctx, g_loss, g_tok):
        logits, targets, mask, lse = ctx.saved_tensors
        V = logits.shape[-1]
        n = lse.shape[0]
        w = _weights(mask, n, g_loss, logits.device)
        if g_tok is not None:
            w = w + g_tok.reshape(n).to(torch.float32)
        lg = logits.reshape(n, V)
        tgt = targets.reshape(n, 1).long()
        out = torch.empty_like(lg)
        # dlogits = (softmax − onehot)·w, p recomputed, rounded once
        for a, b in _row_chunks(n, V):
            p = torch.exp(lg[a:b].to(torch.float32) - lse[a:b, None])
            pg = p.gather(1, tgt[a:b])
            p.mul_(w[a:b, None])
            p.scatter_(1, tgt[a:b], (pg - 1.0) * w[a:b, None])
            out[a:b] = p.to(logits.dtype)
        return out.reshape(logits.shape), None, None


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       z_loss: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean_loss, per_token_loss [B, T]) in f32 over logits [B, T, V].
    ``mask`` [B, T] (1/True = counted). The ``z_loss`` branch is plain
    autograd, as in the JAX package."""
    if z_loss:
        lf = logits.to(torch.float32)
        lse = torch.logsumexp(lf, dim=-1)
        gold = lf.gather(-1, targets.long()[..., None])[..., 0]
        per_tok = lse - gold + z_loss * torch.square(lse)
        if mask is None:
            return per_tok.mean(), per_tok
        m = mask.to(torch.float32)
        return (per_tok * m).sum() / m.sum().clamp_min(1.0), per_tok
    return _CE.apply(logits, targets, mask)


def _chunk_step(x2, w_c, tgt, m_run, s_run, gold, lo: int, start: int,
                int8: bool = False):
    """One vocab chunk of the scan: columns [start, start + chunk) of the
    head, of which those below ``lo`` were counted by the previous chunk.
    ``int8``: the chunk's logits through ``int8_matmul`` (bf16 grads)."""
    chunk = w_c.shape[1]
    if int8:
        logits = int8_matmul(x2, w_c, False).to(torch.float32)
    else:
        logits = x2.to(torch.float32) @ w_c.to(torch.float32)
    vpos = start + torch.arange(chunk, device=x2.device)
    logits = torch.where(vpos[None, :] >= lo, logits, _NEG_INF)
    m_new = torch.maximum(m_run, logits.amax(-1))
    s_run = s_run * torch.exp(m_run - m_new) + \
        torch.exp(logits - m_new[:, None]).sum(-1)
    local = tgt - start
    in_chunk = (tgt >= lo) & (local < chunk)
    picked = logits.gather(1, local.clamp(0, chunk - 1)[:, None])[:, 0]
    gold = torch.where(in_chunk, picked, gold)
    return m_new, s_run, gold


def fused_ce_loss(hidden: torch.Tensor, head_w: torch.Tensor,
                  targets: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  chunk: int = 8192, use_int8: Optional[bool] = None,
                  use_pallas: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE straight from hidden [B, T, E] and the head [E, V] (tied:
    ``wte.T``), never writing the [B, T, V] logits. ``use_pallas`` (the JAX
    package's name) not False sends the shapes the fused-CE kernels take to
    them; other shapes (logged through ``kernel_log`` as a fallback), or
    ``use_pallas=False``, run the vocab-chunk scan, whose chunks are
    checkpointed so no chunk's logits are kept for the backward.

    ``use_int8``: the chunk scan's dots run as ``int8_matmul`` (None: when
    the ambient ``Int8Policy`` passes the whole [E, V] head). The kernel
    route ignores it and follows the policy, as the JAX package's Pallas
    route does (ROADMAP "Known quirks")."""
    if use_pallas is not False:
        out = kfce.fused_ce_kernel_or_none(hidden, head_w, targets, mask)
        if out is not None:
            return out
    B, T, E = hidden.shape
    V = head_w.shape[-1]
    if use_int8 is None:
        pol = current_int8()
        use_int8 = pol is not None and pol.applies((E, V))
    chunk = min(chunk, V)
    n_chunks = -(-V // chunk)
    w = head_w.to(torch.bfloat16)
    x2 = hidden.reshape(B * T, E)
    tgt = targets.reshape(B * T).long()
    n = B * T
    m_run = torch.full((n,), _NEG_INF, dtype=torch.float32,
                       device=hidden.device)
    s_run = torch.zeros((n,), dtype=torch.float32, device=hidden.device)
    gold = torch.zeros((n,), dtype=torch.float32, device=hidden.device)
    for ci in range(n_chunks):
        start = min(ci * chunk, max(V - chunk, 0))
        m_run, s_run, gold = checkpoint(
            _chunk_step, x2, w[:, start:start + chunk], tgt, m_run, s_run,
            gold, ci * chunk, start, bool(use_int8), use_reentrant=False)
    lse = m_run + torch.log(s_run.clamp_min(1e-30))
    per_tok = (lse - gold).reshape(B, T)
    if mask is None:
        return per_tok.mean(), per_tok
    mk = mask.to(torch.float32)
    return (per_tok * mk).sum() / mk.sum().clamp_min(1.0), per_tok
