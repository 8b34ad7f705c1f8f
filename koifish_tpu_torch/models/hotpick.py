"""HotPicker — context-sparsity neuron selection for FFN inference (the
JAX package's ``models/hotpick.py``; the reference's HotPicker/CS_Picker,
src/Manifold/HotPicker.hpp:36): one calibration forward collects each FFN
neuron's activation energy, then each layer's FFN is sliced to its hottest
neurons — a smaller dense model, so every kernel keeps working.

A quantized ``gate``/``up`` (or ``fc``) is sliced on its out axis, codes
and scales directly. A quantized ``down`` (``proj``) is packed and grouped
on the sliced in axis: it is dequantized, sliced and quantized again in
its format with the eager ``quant/rtn.quantize`` (the JAX package's eager
``quantize``), so the picked codes equal JAX's byte for byte. The picked
``down`` has K = the kept width (1536 of Qwen3-0.6B's 3072 at keep 0.5),
which rows 3 and 4 take.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn.functional as F

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.models.transformer import (
    Params, _linear_l, _norm, gather_embed, mlp, qkv_project)
from koifish_tpu_torch.ops.attention import causal_attention
from koifish_tpu_torch.ops.matmul import qmatmul
from koifish_tpu_torch.ops.rope import rope_freqs
from koifish_tpu_torch.quant.qtensor import QTensor


@torch.no_grad()
def ffn_activation_energy(card: ModelCard, params: Params,
                          tokens: torch.Tensor) -> List[torch.Tensor]:
    """Per layer, the mean |silu(gate)·up| (gelu(fc) for a GELU FFN) of
    each FFN neuron over a [B, T] calibration batch: [F] f32 each."""
    B, T = tokens.shape
    dev = tokens.device
    positions = torch.arange(T, dtype=torch.int64, device=dev)
    cos = sin = None
    if card.pos_embed == "rope":
        cos, sin = rope_freqs(card.head_dim, card.max_pos, card.rope_theta,
                              card.rope_scaling_dict(), device=dev)
    x = gather_embed(params["wte"], tokens)    # no EmbedVAE, as in JAX
    if card.pos_embed == "learned":
        x = x + params["wpe"][positions]
    energies = []
    for lp in params["layers"]:
        h = _norm(card, x, lp["ln1"], lp.get("ln1_b"))
        q, k, v = qkv_project(card, lp, h, cos, sin, positions)
        a = causal_attention(q, k, v)
        x = x + _linear_l(a.reshape(B, T, -1), lp, "o")
        h = _norm(card, x, lp["ln2"], lp.get("ln2_b"))
        if "gate" in lp:
            act = (F.silu(qmatmul(h, lp["gate"]).to(torch.float32))
                   * qmatmul(h, lp["up"]).to(torch.float32))
        else:
            act = F.gelu(qmatmul(h, lp["fc"]).to(torch.float32),
                         approximate="tanh")
        energies.append(torch.mean(torch.abs(act), dim=(0, 1)))
        x = x + mlp(card, lp, h)
    return energies


def _slice_cols(w, idx: torch.Tensor):
    """The out axis (1): a QTensor's codes, scales and zeros slice
    directly (it packs along the in axis)."""
    if isinstance(w, QTensor):
        return dataclasses.replace(
            w, codes=w.codes[:, idx], scales=w.scales[:, idx],
            zeros=None if w.zeros is None else w.zeros[:, idx],
            shape=(w.shape[0], int(idx.shape[0])))
    return w[:, idx]


def _slice_rows(w, idx: torch.Tensor):
    """The in axis (0): a QTensor is dequantized, sliced and quantized
    again in its format (the eager ``quantize``)."""
    if isinstance(w, QTensor):
        from koifish_tpu_torch.quant.rtn import quantize
        dense = w.dequantize(torch.float32)[idx]
        return quantize(dense, w.fmt, group=min(w.group, dense.shape[0]),
                        symmetric=w.zeros is None,
                        scale_dtype=w.scales.dtype)
    return w[idx]


@torch.no_grad()
def pick_hot(card: ModelCard, params: Params, energies: List[torch.Tensor],
             keep: float = 0.5) -> tuple:
    """Slice each layer's FFN to its hottest ``keep`` fraction of neurons
    (a multiple of 128, at least 128), in index order. Returns (card',
    params'); the other leaves are shared with ``params``."""
    k = int(card.n_ffn * keep)
    k = max(128, (k // 128) * 128)
    new_layers = []
    for lp, e in zip(params["layers"], energies):
        nlp = dict(lp)
        # the top k of a stable ascending sort, read from its end (JAX's
        # argsort(e)[::-1][:k]), then back in index order
        idx = torch.argsort(e, stable=True).flip(0)[:k].sort().values
        if "gate" in lp:
            nlp["gate"] = _slice_cols(lp["gate"], idx)
            nlp["up"] = _slice_cols(lp["up"], idx)
            nlp["down"] = _slice_rows(lp["down"], idx)
        elif "fc" in lp:
            nlp["fc"] = _slice_cols(lp["fc"], idx)
            nlp["fc_b"] = lp["fc_b"][idx]
            nlp["proj"] = _slice_rows(lp["proj"], idx)
        new_layers.append(nlp)
    return (dataclasses.replace(card, n_ffn=k),
            dict(params, layers=new_layers))
