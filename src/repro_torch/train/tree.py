"""Trees of tensors: nested dicts, lists and tuples, flattened in the
order of ``jax.tree.flatten`` (dict keys sorted, lists and tuples in
order, ``None`` an empty node), so that a leaf's index names the same
weight in both packages' checkpoints."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(node) -> Tuple[str, list]:
    if isinstance(node, dict):
        keys = sorted(node)
        return "dict", [(k, node[k]) for k in keys]
    if isinstance(node, (list, tuple)):
        return type(node).__name__, list(enumerate(node))
    return "", []


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef): ``treedef`` rebuilds the tree from new leaves."""
    leaves: List[Any] = []

    def walk(node):
        if node is None:
            return None
        kind, kids = _children(node)
        if not kind:
            leaves.append(node)
            return "*"
        return kind, [(k, walk(v)) for k, v in kids]

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == "*":
            return next(it)
        kind, kids = d
        if kind == "dict":
            return {k: build(v) for k, v in kids}
        out = [build(v) for _, v in kids]
        return tuple(out) if kind == "tuple" else out

    tree = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return tree


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the leaves of ``rest`` at
    the same positions), in a tree of the same structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
