"""Trees of tensors: nested dicts, lists, tuples and NamedTuples, walked in
the order ``jax.tree`` walks them (dict keys sorted, sequences by index,
NamedTuple fields in declaration order).

A leaf's path is the tuple of its keys as the JAX checkpoint manager writes
them: a dict key as itself, a list or tuple index as its digits, a
NamedTuple field as ``.name`` (``("opt_state", ".mu", "blocks", "attn",
"wq")``), so a flat checkpoint of a port tree has the JAX tree's keys.
"""

from __future__ import annotations


def _children(node):
    """``[(key, child), ...]`` of a container node; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    return type(node)(children)


def leaves_with_path(tree, is_leaf=None, prefix=()):
    """``[(path tuple, leaf), ...]`` in the JAX order."""
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, c in kids:
        out.extend(leaves_with_path(c, is_leaf, prefix + (k,)))
    return out


def leaves(tree, is_leaf=None) -> list:
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf)]


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); returns a tree of the results."""
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [[c for _, c in _children(r)] for r in rest]
    return _rebuild(tree, [
        tree_map(fn, c, *(o[i] for o in others), is_leaf=is_leaf)
        for i, (_, c) in enumerate(kids)])


def map_with_path(fn, tree, prefix=()):
    """``fn(path, leaf)`` over the leaves; returns a tree of the results."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    return _rebuild(tree, [map_with_path(fn, c, prefix + (k,))
                           for k, c in kids])
