"""Nested dict/list parameter trees: map and flatten them the way the
reference package's pytrees are (dict keys in sorted order, lists in
order), so per-leaf random keys and checkpoint leaf names line up."""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` to every leaf of ``tree`` and the matching node of each
    tree in ``rest``; the first tree's structure decides what a leaf is
    (a node of ``rest`` at a leaf may be a subtree, as JAX's
    ``flatten_up_to``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_path(tree: Tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in JAX's flatten order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree: Tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map_with_path(fn: Callable, tree: Tree, path: Tuple = ()) -> Tree:
    """``fn(path, leaf)`` for every leaf, keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)
