"""Training checkpoints: params, optimizer moments, step counter and the
random state in one self-describing safetensors file (the JAX package's
``io/checkpoint.py``; the reference's ``.ckp`` STATE format, huTensor.cu:
501-515, Fish.cpp:445-458).

A file written by either package loads in the other: the same tensor names
(``params/layers.3.q``, ``opt_m/...``, ``opt_v/...``, ``opt/step``,
``opt/spikes``, ``rng``) and ``__metadata__`` keys (``format``,
``model_card`` and any extra keys, JSON-encoded). ``rng`` is a uint32 [2]
tensor as the JAX package writes its key data: the port writes two words
drawn from a copy of its generator and, on load, seeds its generator with
them (high word first); stochastic-rounding draws of the two packages
differ in any case. A QTensor is written as its ``__codes``, ``__scales``
and ``__zeros`` only: its ``codebook`` and ``row_scale`` are neither
written nor restored, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import torch

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.io.safetensors import (read_header, read_safetensors,
                                              write_safetensors)
from koifish_tpu_torch.quant.qtensor import QTensor
from koifish_tpu_torch.train.optimizer import OptState
from koifish_tpu_torch.train.trainer import TrainState

FORMAT_CKPT = "koifish_tpu.ckpt.v1"
FORMAT_MODEL = "koifish_tpu.model.v1"


def _flatten(tree: Any, prefix: str) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def rec(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{path}.{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{path}.{i}")
        elif isinstance(node, QTensor):
            rec(node.codes, path + ".__codes")
            rec(node.scales, path + ".__scales")
            if node.zeros is not None:
                rec(node.zeros, path + ".__zeros")
        else:
            out[f"{prefix}/{path}"] = node.detach()

    rec(tree, "")
    return out


def _unflatten_into(template: Any, flat: Dict[str, torch.Tensor],
                    prefix: str):
    """A tree of ``template``'s structure, each tensor from ``flat`` on the
    template leaf's device and in its dtype."""

    def get(name, like):
        return flat[f"{prefix}/{name}"].to(device=like.device,
                                           dtype=like.dtype, copy=True)

    def rec(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rec(v, f"{path}.{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v, f"{path}.{i}") for i, v in enumerate(node)]
        if isinstance(node, QTensor):
            zeros = (get(path + ".__zeros", node.zeros)
                     if node.zeros is not None else None)
            return QTensor(codes=get(path + ".__codes", node.codes),
                           scales=get(path + ".__scales", node.scales),
                           zeros=zeros, fmt=node.fmt, shape=node.shape,
                           group=node.group)
        return get(path, node)

    return rec(template, "")


def rng_words(gen: torch.Generator) -> torch.Tensor:
    """uint32 [2] drawn from a copy of ``gen`` (``gen`` does not advance)."""
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    w = torch.randint(0, 2 ** 32, (2,), generator=g, dtype=torch.int64,
                      device=gen.device)
    return w.cpu().to(torch.uint32)


def generator_from_words(words: torch.Tensor,
                         device="cpu") -> torch.Generator:
    w = [int(x) for x in words.to(torch.int64).reshape(-1).tolist()]
    gen = torch.Generator(device=device)
    gen.manual_seed((w[0] << 32) | w[1] if len(w) > 1 else w[0])
    return gen


def _meta(fmt: str, card: Optional[ModelCard],
          extra_meta: Optional[Dict[str, Any]] = None) -> Dict[str, str]:
    meta = {"format": fmt}
    if card is not None:
        meta["model_card"] = json.dumps(dataclasses.asdict(card))
    if extra_meta:
        meta.update({k: json.dumps(v) for k, v in extra_meta.items()})
    return meta


def save_train_state(path: str, state: TrainState,
                     card: Optional[ModelCard] = None,
                     extra_meta: Optional[Dict[str, Any]] = None) -> None:
    tensors: Dict[str, torch.Tensor] = {}
    tensors.update(_flatten(state.params, "params"))
    tensors.update(_flatten(state.opt.m, "opt_m"))
    if state.opt.v is not None:
        tensors.update(_flatten(state.opt.v, "opt_v"))
    tensors["opt/step"] = torch.tensor(int(state.opt.step), dtype=torch.int32)
    tensors["opt/spikes"] = state.opt.spikes.detach().to(torch.int32)
    tensors["rng"] = rng_words(state.gen)
    write_safetensors(path, tensors, metadata=_meta(FORMAT_CKPT, card,
                                                    extra_meta))


def load_train_state(path: str, template: TrainState,
                     ) -> Tuple[TrainState, Dict[str, str]]:
    """(state, metadata): ``template``'s structure, devices and dtypes."""
    flat, meta = read_safetensors(path)
    params = _unflatten_into(template.params, flat, "params")
    m = _unflatten_into(template.opt.m, flat, "opt_m")
    v = None
    if template.opt.v is not None:
        v = _unflatten_into(template.opt.v, flat, "opt_v")
    spikes = template.opt.spikes
    opt = OptState(m=m, v=v, step=int(flat["opt/step"]),
                   spikes=flat["opt/spikes"].to(device=spikes.device,
                                                dtype=spikes.dtype,
                                                copy=True))
    gen = generator_from_words(flat["rng"], template.gen.device)
    return TrainState(params=params, opt=opt, gen=gen), meta


def save_model(path: str, params: Any, card: Optional[ModelCard] = None,
               ) -> None:
    """Inference-only single-file export (the ``.kun`` BEST/FULL analog):
    params, packed QTensors included, and the model card."""
    write_safetensors(path, _flatten(params, "params"),
                      metadata=_meta(FORMAT_MODEL, card))


def load_model(path: str, template_params: Any) -> Any:
    flat, _ = read_safetensors(path)
    return _unflatten_into(template_params, flat, "params")


def load_model_card(path: str) -> Optional[ModelCard]:
    header, _ = read_header(path)
    meta = header.get("__metadata__", {})
    if "model_card" in meta:
        d = json.loads(meta["model_card"])
        if d.get("rope_scaling"):
            d["rope_scaling"] = tuple(tuple(x) for x in d["rope_scaling"])
        # JSON lists back to the card's tuples, so the card stays hashable
        return ModelCard(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in d.items()})
    return None
