"""Paths and leaves of the port's parameter trees: nested dicts, lists,
tuples and NamedTuples of tensors (or ints), in a fixed depth-first order.

A path names a leaf as the JAX package's key paths do: a dict key, a list
index, or ``.field`` for a NamedTuple's field (``str`` of JAX's
``GetAttrKey``), so that ``"/".join`` of a path is the key the JAX
package's checkpoints use.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _children(tree) -> list | None:
    """[(path entry, child)] of a node, or None for a leaf."""
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def leaves_with_path(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in depth-first order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for key, child in kids
            for item in leaves_with_path(child, prefix + (key,))]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def key_of(path: tuple) -> str:
    """The flat checkpoint key of a path: its entries joined by '/'."""
    return "/".join(str(p) for p in path)


def rebuild(tree, new_leaves):
    """``tree``'s structure with its leaves replaced, in
    :func:`leaves_with_path` order, by the items of ``new_leaves``."""
    it = iter(new_leaves)
    out = _rebuild(tree, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


_END = object()


def _rebuild(tree, it: Iterator):
    kids = _children(tree)
    if kids is None:
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("fewer leaves than the tree has")
        return leaf
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in kids}
    vals = [_rebuild(v, it) for _, v in kids]
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


def map_leaves(fn: Callable, tree):
    """``fn`` applied to every leaf, in the tree's structure."""
    return rebuild(tree, [fn(leaf) for leaf in leaves(tree)])
