"""Evaluation: perplexity over token batches and HellaSwag accuracy (the JAX
package's ``evaluate.py``; the reference's ``SampLoader::Evaluate`` ->
per-token CE -> PPL = exp(mean CE), TokenSet.cpp:392-601, and HellaSwag's
per-completion masked loss argmin, TokenSet.cpp:480-516).

Both run the port's ``model_forward`` (f32 logits) and
``cross_entropy_loss`` under ``torch.no_grad()``, on the device of the
params; batches are numpy arrays or tensors.
"""
from __future__ import annotations

import math
from typing import Iterable, Tuple

import numpy as np
import torch

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.models import model_forward
from koifish_tpu_torch.ops.cross_entropy import cross_entropy_loss


@torch.no_grad()
def _batch_ce(card: ModelCard, params, tokens, mask):
    """(sum of the masked per-token CE, number of masked tokens) over
    tokens [B, T+1], mask [B, T+1] f32."""
    logits = model_forward(card, params, tokens[:, :-1])
    _, per_tok = cross_entropy_loss(logits, tokens[:, 1:], mask[:, 1:])
    return (per_tok * mask[:, 1:]).sum(), mask[:, 1:].sum()


def perplexity(card: ModelCard, params, batches: Iterable[dict],
               max_batches: int = 0) -> Tuple[float, float]:
    """(mean_ce, ppl) over batches {"tokens": [A, B, T+1]} (+ "loss_mask")."""
    dev = params["wte"].device
    tot, cnt = 0.0, 0.0
    for i, b in enumerate(batches):
        if max_batches and i >= max_batches:
            break
        T1 = b["tokens"].shape[-1]
        toks = torch.as_tensor(b["tokens"], device=dev,
                               dtype=torch.int64).reshape(-1, T1)
        mask = b.get("loss_mask")
        mask = (torch.as_tensor(mask, device=dev, dtype=torch.float32)
                .reshape(toks.shape)
                if mask is not None else
                torch.ones(toks.shape, dtype=torch.float32, device=dev))
        s, n = _batch_ce(card, params, toks, mask)
        tot += float(s)
        cnt += float(n)
    ce = tot / max(cnt, 1.0)
    return ce, float(math.exp(ce))


@torch.no_grad()
def _option_losses(card: ModelCard, params, tokens, mask):
    """tokens [4, T+1], mask [4, T+1] -> the mean masked CE of each option."""
    logits = model_forward(card, params, tokens[:, :-1])
    m = mask[:, 1:].to(torch.float32)
    _, per_tok = cross_entropy_loss(logits, tokens[:, 1:], m)
    return (per_tok * m).sum(-1) / m.sum(-1).clamp_min(1.0)


def hellaswag_accuracy(card: ModelCard, params, samples: Iterable,
                       seq_len: int = 0, max_samples: int = 0) -> float:
    """samples: iterable of (label, [4 x (tokens, completion_mask)])."""
    dev = params["wte"].device
    seq_len = seq_len or card.n_ctx
    correct = total = 0
    for label, options in samples:
        if max_samples and total >= max_samples:
            break
        T = seq_len + 1
        toks = np.zeros((4, T), np.int64)
        mask = np.zeros((4, T), bool)
        for i, (t, m) in enumerate(options):
            n = min(len(t), T)
            toks[i, :n] = t[:n]
            mask[i, :n] = m[:n]
        losses = _option_losses(card, params, torch.from_numpy(toks).to(dev),
                                torch.from_numpy(mask).to(dev))
        correct += int(int(torch.argmin(losses)) == label)
        total += 1
    return correct / max(total, 1)
