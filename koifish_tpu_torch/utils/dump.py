"""Structure / debug dumps (the JAX package's ``utils/dump.py``): the part
the training loop needs, a leaf path as a dotted string."""
from __future__ import annotations


def _path_str(path) -> str:
    """("layers", 0, "q") -> "layers.0.q" (keys of ``utils.tree`` paths)."""
    return ".".join(str(p) for p in path)
