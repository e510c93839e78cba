"""Trees of tensors: nestings of dicts, lists, tuples and NamedTuples (an
`AdamState`, a relay state, a `TrainState`), the port's counterpart of
`jax.tree.map` and `jax.tree.leaves`. None is an empty subtree."""
from __future__ import annotations

from typing import List


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of trees of one structure; None leaves stay
    None, and a NamedTuple keeps its type."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(o[k] for o in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def leaves(tree) -> List:
    """The leaves in `tree_map`'s order."""
    out: List = []
    tree_map(out.append, tree)
    return out
