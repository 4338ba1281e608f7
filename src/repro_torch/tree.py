"""Trees of parameters: nested dicts and lists with tensors at the leaves."""
from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of a tree, dicts in insertion order and lists in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of trees of one structure; a None in ``rest`` is a
    leaf (a replicated leaf's FSDP dim)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)
