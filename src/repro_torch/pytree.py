"""Trees of tensors as the port keeps them: nested dictionaries and lists
(a model's ``blocks`` is a list of per-layer dictionaries) with tensors, or
any other object, at the leaves.  The port's stand-ins for ``jax.tree.map``
and ``jax.tree.leaves``; leaves come in insertion order."""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """Every leaf of ``tree``, depth first."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and trees of the same
    structure, in a new tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in the order
    :func:`tree_leaves` gives."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


__all__ = ["tree_leaves", "tree_map", "tree_unflatten"]
