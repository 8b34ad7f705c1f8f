"""LoRA adapters and the SFT trainable-parameter selection (the JAX
package's ``train/lora.py``; the reference's ``HIERARCH_LorAB`` adapters,
Neuron.hpp:60-86, and the SFT_CARD methods, CLI_params.hpp:449-474).

A LoRA adapter for a weight ``w`` [in, out] is ``lp[key + "_lora"] =
{"a": [in, r], "b": [r, out]}`` with the alpha/r scaling folded into the
init of ``a``; ``b`` starts at zero, so the model starts at its base
weights. The forward hook is ``models/transformer.py::_linear_l``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from koifish_tpu_torch.config import SFTCard
from koifish_tpu_torch.quant.qtensor import QTensor
from koifish_tpu_torch.utils.tree import tree_map

_KEY_TO_TARGET = {"q": "wq", "k": "wk", "v": "wv", "o": "wo",
                  "gate": "wgate", "up": "wup", "down": "wdown",
                  "fc": "wfc", "proj": "wproj"}


def add_lora(params: Dict[str, Any], sft: SFTCard,
             generator: Optional[torch.Generator] = None,
             dtype=torch.bfloat16) -> Dict[str, Any]:
    """Params with an adapter beside every targeted 2-D weight: ``a`` ~
    N(0, 1)·(alpha/r)/sqrt(in) drawn in f32 from ``generator`` (a CPU
    ``torch.Generator``; one seeded with 0 if None) and moved to the params'
    device, so a seed gives the same adapters on every device; ``b`` zero.
    Layers are visited in order, keys in each layer's order."""
    out = dict(params)
    r = sft.lora_rank
    scale = sft.lora_alpha / r
    dev = params["wte"].device
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    new_layers = []
    for lp in params["layers"]:
        nlp = dict(lp)
        for name, w in lp.items():
            tgt = _KEY_TO_TARGET.get(name)
            if tgt is None or tgt not in sft.lora_targets:
                continue
            shape = tuple(w.shape)
            if len(shape) != 2:
                continue
            a = (torch.randn((shape[0], r), generator=generator,
                             dtype=torch.float32)
                 * (scale / shape[0] ** 0.5)).to(device=dev, dtype=dtype)
            b = torch.zeros((r, shape[1]), dtype=dtype, device=dev)
            nlp[name + "_lora"] = {"a": a, "b": b}
        new_layers.append(nlp)
    out["layers"] = new_layers
    return out


def merge_lora(params: Dict[str, Any]) -> Dict[str, Any]:
    """Fold the adapters into their base weights (bf16 bases only; an
    adapter beside a QTensor is dropped with the other adapters)."""
    out = dict(params)
    new_layers = []
    with torch.no_grad():
        for lp in params["layers"]:
            nlp = {}
            for name, w in lp.items():
                if name.endswith("_lora"):
                    continue
                lora = lp.get(name + "_lora")
                if lora is not None and not isinstance(w, QTensor):
                    delta = (lora["a"].to(torch.float32)
                             @ lora["b"].to(torch.float32))
                    w = (w.to(torch.float32) + delta).to(w.dtype)
                nlp[name] = w
            new_layers.append(nlp)
    out["layers"] = new_layers
    return out


def _leaf_mask(method: str, name: str, in_layer: bool) -> bool:
    if method == "full":
        return True
    if method == "lora":
        return name.endswith("_lora")
    if method == "bitfit":
        return name.endswith("_b") or name.startswith("ln") or \
            name in ("qn", "kn")
    if method in ("onlyattention", "only_attention"):
        return in_layer and name.split("_")[0] in ("q", "k", "v", "o",
                                                   "qn", "kn", "ln1")
    if method in ("onlyhead", "only_head"):
        return name in ("head", "wte", "ln_f", "ln_f_b")
    if method in ("onlyscale", "only_scale", "gama"):
        return False  # QTensor scales are handled by the dtype rule
    return True


def trainable_mask(params: Dict[str, Any], method: str) -> Any:
    """A tree of bools of the params' structure: which leaves the optimizer
    updates (SFT_CARD::isFixWeight): one flag for each leaf of a weight (a
    QTensor's tensor fields, an adapter dict's tensors)."""
    method = method.lower()

    def expand(name, in_layer, w):
        flag = _leaf_mask(method, name, in_layer)
        return tree_map(lambda _: flag, w)

    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = [{n: expand(n, True, w) for n, w in lp.items()}
                      for lp in v]
        else:
            out[k] = expand(k, False, v)
    return out
