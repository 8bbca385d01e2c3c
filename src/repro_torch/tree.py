"""Trees of tensors: the reference's pytree rules over dicts, lists,
tuples and NamedTuples, without JAX.

Leaves come in the reference's order (``jax.tree_util.tree_leaves``):
dicts by sorted key, lists, tuples and NamedTuples in order, ``None`` an
empty node.  So a list of leaves written by either package's checkpoint
restores into the other's tree of the same structure.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List

__all__ = ["tree_leaves", "tree_map", "tree_unflatten"]


def _children(node: Any):
    """(rebuild, children) of an inner node; None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return (lambda vals: dict(zip(keys, vals))), [node[k] for k in keys]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return (lambda vals: type(node)(*vals)), list(node)
    if isinstance(node, (list, tuple)):
        return (lambda vals: type(node)(vals)), list(node)
    return None


def _iter_leaves(tree: Any) -> Iterator[Any]:
    if tree is None:
        return
    split = _children(tree)
    if split is None:
        yield tree
        return
    for child in split[1]:
        yield from _iter_leaves(child)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in the reference's order."""
    return list(_iter_leaves(tree))


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result keeps the
    structure (and the key order of ``tree``'s dicts)."""
    if tree is None:
        return None
    if isinstance(tree, dict):  # visit in sorted key order, keep tree's order
        done = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
        return {k: done[k] for k in tree}
    split = _children(tree)
    if split is None:
        return fn(tree, *rest)
    rebuild, kids = split
    others = [_children(r)[1] for r in rest]
    return rebuild([tree_map(fn, k, *(o[i] for o in others))
                    for i, k in enumerate(kids)])


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in the order
    :func:`tree_leaves` gives), e.g. a restored checkpoint's."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, it) is not it:
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{len(tree_leaves(like))}")
    return out
