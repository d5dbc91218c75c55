"""Pytrees of tensors in the reference's leaf order.

``jax.tree_util`` walks a dict in sorted key order, a tuple or list in
index order, and treats None as a subtree with no leaves. The optimizer's
global norm sums its leaves in that order and a checkpoint names each
leaf by its path in it, so both go through these helpers rather than the
insertion-order walk of ``models.model.tree_leaves``.
"""

from __future__ import annotations

_END = object()


def flatten_with_path(tree, path: tuple = ()) -> list:
    """[(path, leaf), ...] in the reference's order; a path is a tuple of
    dict keys and sequence indices."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree)
                for pl in flatten_with_path(v, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves) -> object:
    """A tree of ``like``'s structure holding ``new_leaves`` in the
    reference's order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}       # keep the caller's key order
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return next(it)

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (each flattened up to ``tree``'s structure)."""
    flat = leaves(tree)
    others = [leaves_up_to(tree, r) for r in rest]
    return unflatten(tree, [fn(*args) for args in zip(flat, *others)])


def leaves_up_to(like, tree) -> list:
    """``tree``'s subtrees at the leaf positions of ``like`` (the
    reference's ``treedef.flatten_up_to``)."""
    if isinstance(like, dict):
        if set(like) != set(tree):
            raise ValueError(f"keys differ: {sorted(like)} vs {sorted(tree)}")
        return [s for k in sorted(like)
                for s in leaves_up_to(like[k], tree[k])]
    if isinstance(like, (tuple, list)):
        if len(like) != len(tree):
            raise ValueError("sequence lengths differ")
        return [s for a, b in zip(like, tree) for s in leaves_up_to(a, b)]
    if like is None:
        return []
    return [tree]
