"""Backbone-JSON graph spec: the config tree that names the model's layers.

A pure-Python copy of the JAX package's ``models/backbone.py``. In the
reference the ``model.backbone`` section drives graph construction
(``Fish::jToGraph`` -> ``J2Neuron``, src/Manifold/TGraph.cpp:1586-1651,
1534-1581): each key is a neuron-tree node, ``layer``/``Layer`` keys expand
to n_layer copies (``s2layerinfo``, TGraph.cpp:1498-1532; ``name*N``
repeats N times), ``#``-prefixed keys are comments, and leaf values
``{NeuronType: []}`` instantiate neurons (``GeNeuron::MakeInstance``
registry, Neuron.cpp:16-52).

The decoder here is a fixed program, so the tree is flattened to its neuron
sequence, checked against the layouts the decoder implements ("decoder",
"moe", "hybrid"), and anything else raises ``BackboneError``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

# neuron-type registry (GeNeuron::MakeInstance prefixes, Neuron.cpp:26-51)
_TYPES = ("EMBED", "LINEAR", "GAU", "BROWN", "QKV", "DROPOUT", "SILU",
          "FFN", "MOE", "NORMAL", "CLASIFY")
_SPLIT = r"[ ,:;{}()\t=]+"


class BackboneError(ValueError):
    pass


def _type_of(key: str) -> str:
    up = key.upper()
    for t in _TYPES:
        if up.startswith(t):
            return t
    raise BackboneError(f"unknown neuron type {key!r} in backbone "
                        f"(known prefixes: {', '.join(_TYPES)})")


def _expand_count(key: str, n_layer: int) -> int:
    """`layer` -> n_layer; `name*N` -> N; else 1 (s2layerinfo semantics)."""
    head = re.split(_SPLIT, key.strip())
    count = 1
    if head and head[0].lower() == "layer":
        count = n_layer
    for tok in head[1:]:
        if tok.startswith("*"):
            try:
                count = int(tok[1:])
            except ValueError:
                pass
    return count


def flatten_backbone(backbone: Dict[str, Any], n_layer: int,
                     ) -> List[Tuple[str, str]]:
    """-> [(path, TYPE)] in graph order, layers expanded."""
    out: List[Tuple[str, str]] = []

    def walk(prefix: str, node: Dict[str, Any]):
        for key, val in node.items():
            if key.startswith("#"):
                continue
            if isinstance(val, dict):
                n = _expand_count(key, n_layer)
                base = re.split(_SPLIT, key.strip())[0]
                for i in range(n):
                    name = f"{base}.{i}" if n > 1 else base
                    walk(f"{prefix}.{name}" if prefix else name, val)
            elif isinstance(val, list):
                out.append((f"{prefix}.{key}" if prefix else key,
                            _type_of(key)))
            else:
                raise BackboneError(
                    f"backbone node {key!r}: expected object or [], "
                    f"got {type(val).__name__}")

    walk("", backbone)
    return out


def _layer_ffn_kinds(seq: List[str], n_layer: int):
    """If ``seq`` is EMBED [(QKV|BROWN) (FFN|MOE) | GAU]xL NORMAL CLASIFY,
    return the L per-layer block kinds ("FFN" | "MOE" | "GAU" | "BROWN" |
    "BROWN_MOE": a GAU block replaces the attention+FFN pair, BROWN
    replaces the attention and keeps the mlp neuron); else None."""
    if not seq or seq[0] != "EMBED" or seq[-2:] != ["NORMAL", "CLASIFY"]:
        return None
    body, kinds, i = seq[1:-2], [], 0
    while i < len(body):
        if body[i] in ("QKV", "BROWN"):
            if i + 1 >= len(body) or body[i + 1] not in ("FFN", "MOE"):
                return None
            if body[i] == "BROWN":
                kinds.append("BROWN" if body[i + 1] == "FFN"
                             else "BROWN_MOE")
            else:
                kinds.append(body[i + 1])
            i += 2
        elif body[i] == "GAU":
            kinds.append("GAU")
            i += 1
        else:
            return None
    return kinds if len(kinds) == n_layer else None


def validate_backbone(backbone: Dict[str, Any], n_layer: int) -> str:
    """Check the flattened sequence against the decoder layouts. Returns
    the layout name ("decoder" | "moe" | "hybrid": per-layer mixed
    dense/MoE/GAU/BROWN blocks, TGraph.cpp:1534-1651) or raises
    BackboneError for arrangements the decoder cannot honour."""
    seq = [t for _, t in flatten_backbone(backbone, n_layer)]
    kinds = _layer_ffn_kinds(seq, n_layer)
    if kinds is not None:
        if all(k == "FFN" for k in kinds):
            return "decoder"
        if all(k == "MOE" for k in kinds):
            return "moe"
        return "hybrid"
    raise BackboneError(
        "backbone tree does not match a supported layout.\n"
        f"  got ({len(seq)} neurons): {' '.join(seq[:8])}"
        f"{' ...' if len(seq) > 8 else ''}\n"
        f"  supported: EMBED [(QKV|BROWN) FFN|MOE | GAU]x{n_layer} "
        "NORMAL CLASIFY (dense / MoE / per-layer hybrid / GAU / BROWN)\n"
        "  Other arrangements (extra neurons, reordered blocks) are not "
        "silently coerced — adjust the backbone or extend models/.")


def moe_layer_indices(backbone: Dict[str, Any], n_layer: int,
                      ) -> Tuple[int, ...]:
    """Layer indices whose FFN is MOE in a hybrid backbone (BROWN layers
    with a MoE mlp included)."""
    return _kind_indices(backbone, n_layer, lambda k: k.endswith("MOE"))


def gau_layer_indices(backbone: Dict[str, Any], n_layer: int,
                      ) -> Tuple[int, ...]:
    """Layer indices that are GAU blocks in a hybrid backbone."""
    return _kind_indices(backbone, n_layer, lambda k: k == "GAU")


def brown_layer_indices(backbone: Dict[str, Any], n_layer: int,
                        ) -> Tuple[int, ...]:
    """Layer indices whose attention is BROWN (learned fixed attention) in
    a hybrid backbone."""
    return _kind_indices(backbone, n_layer, lambda k: k.startswith("BROWN"))


def _kind_indices(backbone, n_layer, pred) -> Tuple[int, ...]:
    seq = [t for _, t in flatten_backbone(backbone, n_layer)]
    kinds = _layer_ffn_kinds(seq, n_layer)
    if kinds is None:
        raise BackboneError("not a layerwise decoder backbone")
    return tuple(i for i, k in enumerate(kinds) if pred(k))
