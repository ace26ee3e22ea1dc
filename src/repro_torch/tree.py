"""Nested dicts of tensors: the port's pytrees.

Flattening visits dict keys in sorted order, which is the order and the
naming of JAX's ``tree_flatten_with_path`` over the same nested dicts: the
optimizer's decay mask and the checkpoint store's leaf names
(``"/"``-joined paths) are the same in both packages.  An empty dict (a
non-parametric norm's params) holds no leaf and survives a round trip.
"""
from __future__ import annotations

__all__ = ["flatten", "unflatten", "tree_map", "leaf_name"]


def flatten(tree, prefix: tuple = ()) -> list:
    """[(path, leaf)] in JAX's order: dict keys sorted, depth first."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(flatten(tree[k], prefix + (k,)))
    return out


def unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`flatten`'s order)."""
    it = iter(leaves)

    def build(node):
        if not isinstance(node, dict):
            return next(it)
        return {k: build(node[k]) for k in sorted(node)}

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaf_name(path: tuple) -> str:
    """The checkpoint store's name of a leaf: its path joined by ``/``."""
    return "/".join(str(k) for k in path)
