"""Trees of tensors: nested dicts, lists, tuples and NamedTuples, as the
port's parameters, optimizer state and checkpoints hold them.

The order and the path names follow ``jax.tree_util``'s, so a checkpoint
key names the same leaf in both packages: dict keys in sorted order, a
list or tuple entry by its index, a NamedTuple field as ``.<name>``;
``None`` is an empty subtree (no leaf).
"""

from __future__ import annotations


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves_with_paths(tree, prefix: tuple = ()) -> list:
    """``[(path, leaf), ...]`` in the tree's order; a path is a tuple of
    dict keys, list indices and ``.field`` names."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in leaves_with_paths(tree[k], prefix + (k,))]
    if _is_namedtuple(tree):
        return [item for f in tree._fields
                for item in leaves_with_paths(getattr(tree, f),
                                              prefix + ("." + f,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in leaves_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def path_key(path: tuple) -> str:
    """A leaf's checkpoint key: its path's entries joined by ``/``."""
    return "/".join(str(p) for p in path)


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over ``tree``'s structure
    (a ``None`` subtree stays ``None``), leaf by leaf in the order of
    :func:`leaves`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)



def get_at(tree, path: tuple):
    """The subtree of ``tree`` at ``path`` (a path of
    :func:`leaves_with_paths`), whatever lies there: a tree whose leaves
    are tuples (a sharding spec, a ``(mesh, placements)`` pair) is read
    along another tree's paths."""
    for p in path:
        tree = getattr(tree, p[1:]) if isinstance(p, str) and \
            p.startswith(".") and _is_namedtuple(tree) else tree[p]
    return tree
