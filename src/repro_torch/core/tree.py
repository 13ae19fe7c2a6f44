"""Nested containers of tensors (the LM's parameter and training-state
trees) flattened in ``jax.tree``'s leaf order: dict items by sorted key,
tuple and list items in order, ``None`` an empty subtree, anything else
(a tuple type that sets ``tree_leaf``, the models' ``P``, too) a leaf.  The optimizer, the train step and the checkpoints walk trees
with these, so a checkpoint's ``leaf_i`` is the same array in either
package."""
from __future__ import annotations


def _children(node):
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (tuple, list)) and not getattr(node, "tree_leaf",
                                                       False):
        return list(node)
    return None


def leaves(tree) -> list:
    """The tree's leaves in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in leaves(kid)]


def unflatten(like, new_leaves) -> object:
    """A tree shaped as ``like`` whose leaves are ``new_leaves``, taken in
    ``leaves(like)`` order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _children(node) is None:
            return next(it)
        return type(node)(build(kid) for kid in node)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure), as ``jax.tree.map``."""
    others = [leaves(t) for t in rest]
    mine = leaves(tree)
    for o in others:
        if len(o) != len(mine):
            raise ValueError(f"trees differ: {len(mine)} and {len(o)} "
                             f"leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(mine, *others)])

