"""Quantize-at-load: apply a QuantCard to a model param dict.

The same path rules as the JAX package's ``quant/apply.py``: each 2-D
weight whose HF-style path matches a QuantCard rule is replaced by a packed
QTensor. Embeddings quantize in head layout [E, V].
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from koifish_tpu_torch.config import ModelCard, QuantCard
from koifish_tpu_torch.quant.cluster import (quantize_kmeans, quantize_mini,
                                             quantize_sinkhorn)
from koifish_tpu_torch.quant.rtn import quantize_jit
from koifish_tpu_torch.utils.device import check_on, resolve_device

# param-key -> HF-style path fragment, so reference quantizer configs
# ("self_attn": {...}, "mlp": {...}) match.
_KEY_PATH = {
    "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
    "o": "self_attn.o_proj",
    "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj",
    "fc": "mlp.c_fc", "proj": "mlp.c_proj",
    "wte": "embed_tokens", "head": "lm_head",
}


def param_path(layer_idx: Optional[int], key: str) -> str:
    frag = _KEY_PATH.get(key, key)
    if layer_idx is None:
        return f"model.{frag}"
    return f"model.layers.{layer_idx}.{frag}"


def quantize_params(params: Dict[str, Any], qcard: QuantCard,
                    card: Optional[ModelCard] = None,
                    device=None) -> Dict[str, Any]:
    """Returns a new param dict with rule-matched weights as QTensors.
    The params must already lie on ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    check_on(params["wte"], dev, "params['wte']")
    out = dict(params)

    def maybe_quant(w, path, head_layout=False):
        rule = qcard.rule_for(path)
        if rule is None or not isinstance(w, torch.Tensor) or w.dim() != 2:
            return w
        # embeddings -> head layout [E, V], contiguous: the kernels take
        # contiguous codes only
        mat = w.T.contiguous() if head_layout else w
        if mat.shape[0] % rule.group:
            return w
        if rule.method in ("CLUSTER", "KMEANS"):
            return quantize_kmeans(mat, bits=rule.fmt.bits, group=rule.group)
        if rule.method in ("MINI", "MINI_GBDT"):
            return quantize_mini(mat, bits=rule.fmt.bits, group=rule.group)
        if rule.method in ("SNQ", "SINKHORN"):
            return quantize_sinkhorn(mat, rule.fmt, group=rule.group)
        return quantize_jit(mat, rule.fmt, group=rule.group,
                            symmetric=rule.symmetric)

    new_layers = []
    for li, lp in enumerate(params["layers"]):
        nlp = dict(lp)
        for key, w in lp.items():
            if key.endswith("_b") or key in ("ln1", "ln2", "qn", "kn"):
                continue
            nlp[key] = maybe_quant(w, param_path(li, key))
        new_layers.append(nlp)
    out["layers"] = new_layers
    out["wte"] = maybe_quant(params["wte"], param_path(None, "wte"),
                             head_layout=True)
    if "head" in params:
        out["head"] = maybe_quant(params["head"], param_path(None, "head"))
    return out
