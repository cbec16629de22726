"""Nested containers of tensors: the port's pytrees.

Params, optimizer state and checkpoints are nested dicts and lists of
tensors (a segment is a list of per-layer dicts), and a dataclass such as
``TrainState`` is a node whose children are its fields.  Everything else is
a leaf.  Children keep the container's own order; dicts are matched by key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Mapping


def _children(tree) -> list[tuple[Any, Any]] | None:
    """``(key, child)`` pairs of a node, ``None`` for a leaf."""
    if isinstance(tree, Mapping):
        return list(tree.items())
    if isinstance(tree, list):
        return list(enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def _rebuild(like, values: dict) -> Any:
    if isinstance(like, Mapping):
        return dict(values)
    if isinstance(like, list):
        return [values[i] for i in range(len(like))]
    return dataclasses.replace(like, **values)


def leaves_with_paths(tree, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` in order; a path holds dict keys, list indices and
    dataclass field names."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, child in kids:
        yield from leaves_with_paths(child, prefix + (key,))


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest, with_path: bool = False, _path: tuple = ()) -> Any:
    """``fn(leaf, *matching leaves of rest)`` over ``tree``'s structure
    (``fn(path, leaf, ...)`` with ``with_path``)."""
    kids = _children(tree)
    if kids is None:
        return fn(_path, tree, *rest) if with_path else fn(tree, *rest)
    rest_kids = [dict(_children(r)) for r in rest]
    return _rebuild(tree, {
        key: tree_map(fn, child, *(rk[key] for rk in rest_kids),
                      with_path=with_path, _path=_path + (key,))
        for key, child in kids
    })


def unflatten(like, values) -> Any:
    """``like``'s structure with its leaves taken in order from ``values``."""
    it = iter(values)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than leaves")
    return out


__all__ = ["leaves_with_paths", "leaves", "tree_map", "unflatten"]
