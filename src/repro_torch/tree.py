"""Nested dict / list trees of tensors: the port's stand-in for the
reference's ``jax.tree_util`` over params, optimizer state and grads.

A tree is a dict (walked in sorted key order, as ``jax.tree_util``
walks dicts), a list or tuple, or a leaf (a tensor, or ``None`` for a
gradient that does not exist).  A leaf's path is the tuple of keys and
indices down to it; ``path_key`` joins it with "/" as the reference's
checkpoint names arrays.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def leaves_with_path(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) of every leaf, depth first."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure); a tree of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree, flat: List[Any]):
    """A tree of ``tree``'s structure whose leaves are ``flat``, in
    ``leaves_with_path`` order."""
    it = iter(flat)

    def walk(t):
        if isinstance(t, dict):
            done = {k: walk(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)

    out = walk(tree)
    if next(it, it) is not it:
        raise ValueError("unflatten_like: more leaves than the tree holds")
    return out


def path_key(path: Path) -> str:
    return "/".join(str(k) for k in path)
