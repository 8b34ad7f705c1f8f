"""Carry parameters and KV caches across from the JAX package, via numpy.

``params_from_numpy`` takes the JAX package's parameter tree with every leaf
already a numpy array (``np.asarray`` on the JAX side) and every QTensor
given as a dict of its numpy fields plus its metadata (``fmt`` as the
format's string value, ``shape``, ``group``). ``cache_from_numpy`` does the
same for a ``KVCache`` (stacked leaves) or a ``LayeredKVCache`` (per-layer
lists), ``opt_state_from_numpy`` for an optimizer state and
``train_state_from_numpy`` for a whole train state. bf16 arrives as ``ml_dtypes.bfloat16``; it is carried as a
``uint16`` view and reinterpreted as ``torch.bfloat16``, bit for bit. This
module imports no JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.quant.qtensor import TENSOR_FIELDS, QTensor
from koifish_tpu_torch.serve.kvcache import KVCache
from koifish_tpu_torch.serve.layered import LayeredKVCache
from koifish_tpu_torch.utils.device import resolve_device
from koifish_tpu_torch.utils.tree import leaves as _leaves


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One numpy array (bf16 as ml_dtypes.bfloat16) -> tensor on device, of
    the array's shape (a 0-d leaf, such as Guppy's ``guppy_gain``, stays
    0-d: ``np.ascontiguousarray`` alone would give it one dimension)."""
    a = np.asarray(a)
    c = np.ascontiguousarray(a).reshape(a.shape)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(c.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(c.copy()).to(device)


def _fmt(f) -> QFormat:
    return QFormat(getattr(f, "value", f))


def qtensor_from_numpy(d: Dict[str, Any], device) -> QTensor:
    fields = {k: (None if d.get(k) is None
                  else tensor_from_numpy(d[k], device)) for k in TENSOR_FIELDS}
    return QTensor(fmt=_fmt(d["fmt"]), shape=tuple(d["shape"]),
                   group=int(d["group"]), **fields)


def _leaf(x, device):
    if isinstance(x, dict) and "codes" in x and "fmt" in x:
        return qtensor_from_numpy(x, device)
    if isinstance(x, dict):
        return {k: _leaf(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_leaf(v, device) for v in x]
    return tensor_from_numpy(x, device)


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX package's param tree (numpy leaves) -> the port's params."""
    return _leaf(tree, resolve_device(device))


def cache_from_numpy(tree: Dict[str, Any], device=None):
    """A (layered) KV cache as numpy fields -> ``KVCache`` when ``k`` is one
    stacked array, ``LayeredKVCache`` when it is a per-layer list."""
    dev = resolve_device(device)
    layered = isinstance(tree["k"], (list, tuple))

    def conv(x):
        if x is None:
            return None
        if layered:
            return tuple(tensor_from_numpy(a, dev) for a in x)
        return tensor_from_numpy(x, dev)

    kw = dict(k=conv(tree["k"]), v=conv(tree["v"]),
              k_scale=conv(tree.get("k_scale")),
              v_scale=conv(tree.get("v_scale")),
              pos=tensor_from_numpy(tree["pos"], dev),
              fmt=_fmt(tree["fmt"]), sinks=int(tree.get("sinks", 2)))
    if layered:
        return LayeredKVCache(uniform=bool(tree.get("uniform", True)), **kw)
    return KVCache(**kw)


def opt_state_from_numpy(tree: Dict[str, Any], device=None):
    """The JAX package's ``OptState`` as numpy fields — ``m`` and ``v``
    trees of the params' structure, ``step`` and ``spikes`` scalars — ->
    the port's ``train.optimizer.OptState`` (moments keep their dtype)."""
    from koifish_tpu_torch.train.optimizer import OptState
    dev = resolve_device(device)
    return OptState(m=_leaf(tree["m"], dev),
                    v=None if tree.get("v") is None else _leaf(tree["v"], dev),
                    step=int(np.asarray(tree["step"])),
                    spikes=torch.tensor(int(np.asarray(tree["spikes"])),
                                        dtype=torch.int32, device=dev))


def train_state_from_numpy(tree: Dict[str, Any], device=None):
    """The JAX package's ``TrainState`` as numpy fields — ``params`` (LoRA
    adapter dicts included), ``opt`` (as ``opt_state_from_numpy`` takes it)
    and ``rng`` (its uint32 key data) — -> the port's ``TrainState``, its
    float params requiring a gradient and its generator seeded from the key
    as ``io/checkpoint.py`` seeds it."""
    from koifish_tpu_torch.io.checkpoint import generator_from_words
    from koifish_tpu_torch.train.trainer import TrainState
    params = params_from_numpy(tree["params"], device)
    for p in _leaves(params):
        if isinstance(p, torch.Tensor) and p.is_floating_point():
            p.requires_grad_(True)
    return TrainState(
        params=params, opt=opt_state_from_numpy(tree["opt"], device),
        gen=generator_from_words(torch.from_numpy(
            np.asarray(tree["rng"]).astype(np.int64))))
