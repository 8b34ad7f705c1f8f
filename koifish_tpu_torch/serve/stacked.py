"""Layer-stacked decode params and the decode step over them.

The JAX package stacks the per-layer params into [L, ...] leaves so that a
``lax.scan`` runs one compiled layer body (``serve/stacked.py``). PyTorch
runs eagerly and has no scan to gain from, but the stacked form is part of
the serving API (``generate(decode_params=stack_layers(params))``), so the
port keeps it: ``stack_layers`` builds it, ``layer_params`` takes one
layer's views back out (no copy), and the decode steps run their layer loop
over those views.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.models.transformer import Params
from koifish_tpu_torch.quant.qtensor import TENSOR_FIELDS, QTensor
from koifish_tpu_torch.serve.kvcache import KVCache


def _stack(xs: List[Any]) -> Any:
    """Stack one leaf across layers; None when the layers differ."""
    x0 = xs[0]
    if isinstance(x0, dict):
        if any(not isinstance(x, dict) or sorted(x) != sorted(x0)
               for x in xs):
            return None
        out = {k: _stack([x[k] for x in xs]) for k in x0}
        return None if any(v is None for v in out.values()) else out
    if isinstance(x0, QTensor):
        meta = (x0.fmt, tuple(x0.shape), x0.group)
        if any(not isinstance(x, QTensor)
               or (x.fmt, tuple(x.shape), x.group) != meta for x in xs):
            return None
        fields = {}
        for f in TENSOR_FIELDS:
            vals = [getattr(x, f) for x in xs]
            if all(v is None for v in vals):
                fields[f] = None
                continue
            fields[f] = _stack(vals)
            if fields[f] is None:
                return None
        return dataclasses.replace(x0, **fields)
    if isinstance(x0, torch.Tensor):
        if any(not isinstance(x, torch.Tensor) or x.shape != x0.shape
               or x.dtype != x0.dtype or x.device != x0.device for x in xs):
            return None
        return torch.stack(xs)
    return None


def stack_layers(params: Params) -> Optional[Params]:
    """Stack per-layer params into [L, ...] leaves (a QTensor's tensor
    fields each gain the layer axis); None if the layers are heterogeneous
    (other keys, formats, shapes or dtypes)."""
    stacked = _stack(list(params["layers"]))
    if stacked is None:
        return None
    out = dict(params)
    out["layers"] = stacked
    return out


def layer_params(stacked: Any, li: int) -> Any:
    """Layer ``li``'s params out of stacked [L, ...] leaves (views)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, li) for k, v in stacked.items()}
    if isinstance(stacked, QTensor):
        return dataclasses.replace(stacked, **{
            f: None if getattr(stacked, f) is None else getattr(stacked, f)[li]
            for f in TENSOR_FIELDS})
    return stacked[li]


def unstack_layers(card: ModelCard, params: Params) -> Params:
    """Params with a per-layer list, from stacked or per-layer params."""
    if isinstance(params["layers"], list):
        return params
    out = dict(params)
    out["layers"] = [layer_params(params["layers"], li)
                     for li in range(card.n_layer)]
    return out


def decode_step_stacked(card: ModelCard, sparams: Params, token: torch.Tensor,
                        cache: KVCache, streaming: bool = True
                        ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step over layer-stacked params and a ``KVCache``: token
    [B] -> logits [B, V] f32 and the cache (written in place, ``pos``
    advanced). The JAX package scans one compiled layer body here; eager
    PyTorch has nothing to gain from that, so this is ``engine.decode_step``
    — the layer loop over each layer's views — held to stacked params."""
    if isinstance(sparams["layers"], list):
        raise ValueError("decode_step_stacked takes layer-stacked params "
                         "(stack_layers); a per-layer list goes to "
                         "engine.decode_step")
    from koifish_tpu_torch.serve.engine import decode_step
    return decode_step(card, sparams, token, cache, streaming)
