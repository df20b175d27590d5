"""Walks over params trees: nested dicts and lists whose leaves are tensors
(or anything else). A leaf module, so that ``parallel`` and ``training``
both import it without importing each other."""

from __future__ import annotations

from typing import Any

import torch

Path = tuple[str, ...]


def iter_paths(tree: Any, prefix: Path = ()):
    """(path, leaf) of every leaf, in dict and list order; a path is the
    keys and list indices on the way down, as strings."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from iter_paths(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def map_with_paths(tree: Any, fn, prefix: Path = ()):
    """The tree of ``fn(path, leaf)`` (tuples come back as lists)."""
    if isinstance(tree, dict):
        return {k: map_with_paths(v, fn, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_paths(v, fn, prefix + (str(i),)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def tree_map(fn, *trees):
    """The tree of ``fn(*leaves)`` over trees of one structure (the first's)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *(t[i] for t in trees)) for i in range(len(first))]
    return fn(*trees)


def to_device(tree: Any, device) -> Any:
    """``tree`` with every tensor on ``device`` (the same tensors where they
    are there already); other leaves as they are."""
    return map_with_paths(tree, lambda _, t: t.to(device) if isinstance(t, torch.Tensor) else t)
