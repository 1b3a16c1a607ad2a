"""Minimal pytree helpers over NamedTuples, tuples, lists and dicts.

Parameter trees of the port are NamedTuples of tensors (mirroring the JAX
package's), so paths join NamedTuple field names with dots — the naming of
the JAX package's ``models.common._path_str`` (e.g. ``layers.attn.wq``).
``None`` is an empty subtree.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x):
    if _is_namedtuple(x):
        return list(zip(x._fields, x))
    if isinstance(x, (list, tuple)):
        return list(enumerate(x))
    if isinstance(x, dict):
        return [(k, x[k]) for k in sorted(x)]
    return None


def leaves_with_paths(tree, is_leaf: Optional[Callable[[Any], bool]] = None
                      ) -> List[Tuple[str, Any]]:
    """[(dot path, leaf)] in tree order; ``None`` subtrees have no leaves."""
    out: List[Tuple[str, Any]] = []

    def walk(x, path):
        if x is None:
            return
        kids = None if (is_leaf is not None and is_leaf(x)) else _children(x)
        if kids is None:
            out.append((".".join(path), x))
            return
        for k, v in kids:
            walk(v, path + (str(k),))

    walk(tree, ())
    return out


def leaves(tree, is_leaf=None) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf)]


def map_with_path(fn: Callable[[str, Any], Any], tree,
                  is_leaf: Optional[Callable[[Any], bool]] = None):
    """Rebuild ``tree`` with every leaf replaced by ``fn(path, leaf)``."""

    def walk(x, path):
        if x is None:
            return None
        if is_leaf is not None and is_leaf(x):
            return fn(".".join(path), x)
        if _is_namedtuple(x):
            return type(x)(*[walk(v, path + (k,))
                             for k, v in zip(x._fields, x)])
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, path + (str(i),)) for i, v in enumerate(x))
        if isinstance(x, dict):
            return {k: walk(x[k], path + (str(k),)) for k in x}
        return fn(".".join(path), x)

    return walk(tree, ())


def map_leaves(fn: Callable[[Any], Any], tree, is_leaf=None):
    return map_with_path(lambda _p, leaf: fn(leaf), tree, is_leaf)
