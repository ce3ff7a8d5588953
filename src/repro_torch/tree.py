"""Trees as the port keeps parameters, gradients and optimizer state:
nested dicts whose leaves are tensors (the JAX package's pytrees of
dicts).  Two trees of one structure hold their keys in one order."""

from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure, leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_paths(tree, path: str = ""):
    """``(path, leaf)`` of every leaf, the path's keys joined by ``/``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{path}/{k}" if path else str(k))
    else:
        yield path, tree


def tree_leaves(tree):
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from
    ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
