"""Guppy — the vocab-memory FFN (the JAX package's ``models/guppy.py``;
the reference's ``Guppy``, gLLM.hpp:231-247, SparseNeuron.cpp:151-179).

A decoder whose FFN weights are sampled token-embedding rows r =
wte[samps]: y = gain · gelu(x rᵀ / sqrt(E)) r. The rows resample every
training step from the step's key; gradients reach the sampled rows of
wte through the gather. Evaluation and serving use the fixed sample of
``sample_ids(card, None)``.

The sample is the JAX package's, bit for bit: ``randint`` under
``split(key, L)`` of threefry keys, drawn in numpy (``utils/prng.py``). A
trained Guppy computes a different function under any other sample.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.utils import prng


@functools.lru_cache(maxsize=8)
def _eval_sample(n_layer: int, n_ffn: int, vocab: int) -> np.ndarray:
    keys = prng.split(prng.prng_key(0), n_layer)
    return np.stack([prng.randint(k, (n_ffn,), 0, vocab) for k in keys])


def sample_ids(card: ModelCard, key: Optional[np.ndarray] = None
               ) -> np.ndarray:
    """[L, F] int32 token ids: layer l draws ``randint`` under the l-th key
    of ``split(key, L)``. ``key`` (uint32 [2], already step-folded by the
    trainer) None -> the fixed evaluation sample, that of PRNGKey(0)."""
    if key is None:
        return _eval_sample(card.n_layer, card.n_ffn, card.vocab_size).copy()
    keys = prng.split(key, card.n_layer)
    return np.stack([prng.randint(k, (card.n_ffn,), 0, card.vocab_size)
                     for k in keys])


def inject_rows(card: ModelCard, params: Dict[str, Any],
                samps=None) -> Dict[str, Any]:
    """Params with each layer's ``guppy_rows`` = wte[samps[l]] (a
    differentiable gather: wte trains through the FFN). ``samps`` [L, F]
    (numpy or a tensor), None -> the evaluation sample. A no-op where the
    rows are already there or the card is no GUPPY. Takes per-layer-list
    params and layer-stacked ones (``serve/stacked.py``: one [L, F, E]
    leaf)."""
    if card.arch != "GUPPY":
        return params
    from koifish_tpu_torch.models.transformer import gather_embed
    layers = params["layers"]
    stacked = not isinstance(layers, list)
    if "guppy_rows" in (layers if stacked else layers[0]):
        return params
    if samps is None:
        samps = sample_ids(card)
    wte = params["wte"]
    dev = wte.device if isinstance(wte, torch.Tensor) else wte.codes.device
    if not isinstance(samps, torch.Tensor):
        samps = torch.from_numpy(np.array(samps, dtype=np.int64))
    samps = samps.to(dev).long()
    out = dict(params)
    if stacked:
        L, Fn = samps.shape
        rows = gather_embed(wte, samps.reshape(-1))
        out["layers"] = dict(layers, guppy_rows=rows.reshape(
            L, Fn, rows.shape[-1]))
    else:
        out["layers"] = [dict(lp, guppy_rows=gather_embed(wte, samps[li]))
                         for li, lp in enumerate(layers)]
    return out


def guppy_ffn(lp: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    rows = lp["guppy_rows"].to(x.dtype)                  # [F, E]
    # 1/sqrt(E) in f32, then the activations' dtype, as JAX rounds it
    scale = (1.0 / torch.sqrt(torch.tensor(float(rows.shape[-1]),
                                           dtype=torch.float32))).to(x.dtype)
    h = torch.matmul(x, rows.T) * scale.to(x.device)
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    y = torch.matmul(h, rows)
    return y * lp["guppy_gain"].to(x.dtype)
