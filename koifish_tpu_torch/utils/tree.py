"""Parameter trees: nested dicts and lists of tensors, flattened in the JAX
package's leaf order (dict keys sorted, lists in order), so leaf indices,
paths and per-leaf metrics line up with ``jax.tree_util``. A QTensor is a
node, as its JAX pytree is: its tensor fields that are set are leaves, in
field order, each under the path key ``".<field>"`` (the string of JAX's
``GetAttrKey``), so scales train and codes take size-0 stubs."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

from koifish_tpu_torch.quant.qtensor import TENSOR_FIELDS, QTensor

Path = Tuple[Any, ...]


def _fields(q: QTensor) -> List[str]:
    return [f for f in TENSOR_FIELDS if getattr(q, f) is not None]


def flatten_with_path(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """[(path, leaf)] in ``jax.tree_util.tree_flatten_with_path`` order."""
    if isinstance(tree, QTensor):
        return [(prefix + ("." + f,), getattr(tree, f)) for f in _fields(tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_path(v, prefix + (i,))
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten_like(tree: Any, new_leaves: List[Any]) -> Any:
    """A tree of ``tree``'s structure holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, QTensor):
            return dataclasses.replace(t, **{f: next(it) for f in _fields(t)})
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(tree)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    others = [leaves(r) for r in rest]
    return unflatten_like(tree, [fn(x, *(o[i] for o in others))
                                 for i, x in enumerate(leaves(tree))])
