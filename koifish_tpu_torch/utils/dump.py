"""Structure / debug dumps (the JAX package's ``utils/dump.py``; the
reference's DUMP_SWITCH, CLI_params.hpp:720-726).

``nn_structure`` prints the model at startup (Fish::Dump); here the model
is the param tree, so the dump is one line per leaf with its shape, dtype
and bytes, layer 0 in full and the others collapsed to "... x N layers".
A QTensor shows its tensor fields as the JAX package's pytree leaves do
(``layers.0.q..codes``: ``utils.tree`` keys them ``".codes"``).
"""
from __future__ import annotations

from typing import Any, List

from koifish_tpu_torch.utils.tree import flatten_with_path


def _path_str(path) -> str:
    """("layers", 0, "q") -> "layers.0.q" (keys of ``utils.tree`` paths)."""
    return ".".join(str(p) for p in path)


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _leaf_line(path: str, leaf: Any) -> str:
    shape = tuple(leaf.shape)
    nbytes = leaf.numel() * leaf.element_size()
    return f"  {path:<40s} {str(shape):<24s} {_dtype_name(leaf):<10s} " \
           f"{nbytes / 1e6:8.2f} MB"


def model_structure(params: Any) -> str:
    """Param-tree structure dump: layer 0 in full, layers 1.. collapsed."""
    lines: List[str] = []
    n_layers = 0
    total_bytes = 0
    total_params = 0
    for path, leaf in flatten_with_path(params):
        ps = _path_str(path)
        size = leaf.numel() if leaf.dim() else 0   # as the JAX package counts
        total_params += size
        total_bytes += size * leaf.element_size()
        if ps.startswith("layers."):
            idx = ps.split(".")[1]
            if idx == "0":
                lines.append(_leaf_line(ps, leaf))
            n_layers = max(n_layers, int(idx) + 1)
        else:
            lines.append(_leaf_line(ps, leaf))
    if n_layers > 1:
        lines.append(f"  ... x {n_layers} layers")
    lines.append(f"  total: {total_params / 1e6:.1f}M params, "
                 f"{total_bytes / 1e9:.2f} GB")
    return "\n".join(lines)
