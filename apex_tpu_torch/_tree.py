"""Nested containers walked in ``jax.tree_util``'s order.

The port's state is tensors in plain containers (dicts, lists, tuples,
named tuples). Telemetry groups them by path, checkpoints checksum them
leaf by leaf, and both must name and order the leaves as the JAX package
does, so that a module prefix, a manifest entry or a post-mortem reads
the same in either package:

- a ``dict`` in sorted key order, an ``OrderedDict`` in its own order;
- a list or tuple by index, a named tuple by field;
- ``None`` holds no leaf;
- anything else is a leaf.

The path entries print as JAX's key types print (``['k']``, ``[0]``,
``.name``) and carry the same attributes (``key``, ``idx``, ``name``).
"""

import collections


class DictKey:
    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key

    def __str__(self):
        return f"[{self.key!r}]"


class SequenceKey:
    __slots__ = ("idx",)

    def __init__(self, idx):
        self.idx = idx

    def __str__(self):
        return f"[{self.idx}]"


class GetAttrKey:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __str__(self):
        return f".{self.name}"


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """``[(entry, child), ...]`` of a container, or None for a leaf."""
    if isinstance(tree, collections.OrderedDict):
        return [(DictKey(k), v) for k, v in tree.items()]
    if isinstance(tree, dict):
        return [(DictKey(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(GetAttrKey(f), getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(SequenceKey(i), v) for i, v in enumerate(tree)]
    return None


def flatten_with_path(tree):
    """``[(path, leaf), ...]`` in JAX's order; ``path`` a tuple of
    entries."""
    out = []

    def walk(t, path):
        if t is None:
            return
        kids = _children(t)
        if kids is None:
            out.append((path, t))
            return
        for entry, child in kids:
            walk(child, path + (entry,))

    walk(tree, ())
    return out


def leaves(tree):
    return [leaf for _, leaf in flatten_with_path(tree)]


def path_str(path):
    """A path as ``parallel.distributed._leaf_path_str`` spells it in the
    JAX package: the keys and indices joined by ``/`` (a named tuple's
    field as ``.name``)."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), in the same containers; ``None`` stays ``None``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in tree}
        return type(tree)(out) if isinstance(
            tree, collections.OrderedDict) else out
    items = [tree_map(fn, v, *(r[i] for r in rest))
             for i, v in enumerate(tree)]
    if _is_namedtuple(tree):
        return type(tree)(*items)
    return type(tree)(items)


def structure(tree):
    """A hashable description of the containers and their keys (the
    leaves left out): two trees with equal structures map leaf for
    leaf."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return "*"
    return (type(tree).__name__,
            tuple((str(e), structure(c)) for e, c in kids))


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of ``tree``, in the same
    containers (``path`` as :func:`flatten_with_path` gives it)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    mapped = {str(e): tree_map_with_path(fn, c, path + (e,))
              for e, c in kids}
    if isinstance(tree, dict):
        out = {k: mapped[str(DictKey(k))] for k in tree}
        return type(tree)(out) if isinstance(
            tree, collections.OrderedDict) else out
    items = [mapped[str(e)] for e, _ in kids]
    if _is_namedtuple(tree):
        return type(tree)(*items)
    return type(tree)(items)
