"""Parameter and optimizer trees: nested dictionaries (and lists or tuples)
of tensors, walked in the JAX package's leaf order — dictionary keys
sorted, sequences by index — so that leaf lists, checkpoint keys and
global-norm sums line up with ``jax.tree`` on the same structure."""
from __future__ import annotations

from typing import Any, Callable, Dict, List

_END = object()


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{key: leaf} in leaf order, the key the "/"-joined path of dictionary
    keys and sequence indices (``jax.tree_util``'s key path as the JAX
    package's checkpoints spell it, e.g. ``params/blocks/wq``)."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for k, v in kids:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def leaves(tree) -> List[Any]:
    return list(flatten(tree).values())


def unflatten(like, values) -> Any:
    """A tree of ``like``'s structure holding ``values`` (a list in leaf
    order)."""
    it = iter(values)

    def build(t):
        kids = _children(t)
        if kids is None:
            return next(it)
        if isinstance(t, dict):
            return {k: build(v) for k, v in kids}
        return type(t)(build(v) for _, v in kids)
    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("unflatten: more values than leaves")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure)."""
    cols = [leaves(t) for t in (tree,) + rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
