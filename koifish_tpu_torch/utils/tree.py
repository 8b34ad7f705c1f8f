"""Parameter trees: nested dicts and lists of tensors, flattened in the JAX
package's leaf order (dict keys sorted, lists in order), so leaf indices,
paths and per-leaf metrics line up with ``jax.tree_util``."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def flatten_with_path(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """[(path, leaf)] in ``jax.tree_util.tree_flatten_with_path`` order."""
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
