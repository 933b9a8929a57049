"""Nested dicts of tensors as trees, keyed as ``jax.tree_util`` keys them.

The training state (``{"params", "opt": {"m", "v", "count"}, "step"}``)
and the parameter trees are nested dicts.  JAX flattens a dict with its
keys sorted at every level and names a leaf by ``keystr`` of its path,
``"['layers']['attn']['wq']"``; the optimizer's weight-decay rule and the
checkpoint manifest read those strings, so the port builds the same ones.
"""
from __future__ import annotations


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def tree_leaves_with_path(tree, path=()) -> list:
    """``[(keystr, leaf)]`` depth first, keys sorted at every level (JAX's
    leaf order)."""
    if not isinstance(tree, dict):
        return [(keystr(path), tree)]
    out = []
    for k in sorted(tree):
        out.extend(tree_leaves_with_path(tree[k], path + (k,)))
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), as a new tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, *rest, path=()):
    """``tree_map`` whose ``fn`` also takes the leaf's ``keystr`` first."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    return fn(keystr(path), tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in JAX's order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]
