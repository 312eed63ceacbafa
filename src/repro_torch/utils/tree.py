"""Parameter trees: nested dicts, lists and tuples of tensors.

Flattening follows JAX's order exactly, because global block ids are
numbered along it (``core/blocks.py``) and the scaled-TV norm's aux data is
keyed by leaf name:

- dict keys are visited in sorted order, whatever order they were inserted
  in (``torch.utils._pytree`` keeps insertion order and would renumber
  every block);
- lists and tuples are visited in index order (a tuple whose class sets
  ``tree_leaf``, such as a partition spec, is a leaf);
- ``None`` is an empty subtree with no leaves;
- anything else is a leaf.

Leaf names use ``jax.tree_util.keystr`` form, e.g. ``"['net']['fc1']"``
or ``"['layers'][3]['q']"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TreeDef:
    kind: str                       # "dict" | "list" | "tuple" | "none" | "leaf"
    keys: tuple = ()                # sorted dict keys (dict nodes only)
    children: tuple = ()            # child TreeDefs, in flatten order


def keystr(path: tuple) -> str:
    """The ``jax.tree_util.keystr`` form of a path, whose entries are
    ``("key", dict_key)`` or ``("idx", sequence_index)``."""
    return "".join(f"[{k!r}]" if kind == "key" else f"[{k}]"
                   for kind, k in path)


_LEAF, _NONE = TreeDef("leaf"), TreeDef("none")


# The walks below are module-level functions taking their accumulator, not
# nested closures: a recursive closure refers to itself through its cell, a
# reference cycle that keeps the leaves it collected alive until the cyclic
# collector runs (a whole model's worth after a recovery's flattens).

def _flatten(node, out: list, path: Optional[tuple]) -> TreeDef:
    """Append ``node``'s leaves to ``out`` (as ``(path, leaf)`` pairs when
    ``path`` is not None) and return its structure."""
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return TreeDef("dict", keys, tuple(
            _flatten(node[k], out, None if path is None
                     else path + (("key", k),)) for k in keys))
    if isinstance(node, (list, tuple)) and not getattr(node, "tree_leaf",
                                                       False):
        return TreeDef("list" if isinstance(node, list) else "tuple", (),
                       tuple(_flatten(x, out, None if path is None
                                      else path + (("idx", i),))
                             for i, x in enumerate(node)))
    if node is None:
        return _NONE
    out.append(node if path is None else (path, node))
    return _LEAF


def flatten_with_path(tree: PyTree) -> tuple[list[tuple[tuple, Any]], TreeDef]:
    """``[(path, leaf)]`` in JAX's flatten order, plus the tree's structure."""
    out: list[tuple[tuple, Any]] = []
    return out, _flatten(tree, out, ())


def tree_flatten(tree: PyTree) -> tuple[list, TreeDef]:
    """The leaves in flatten order and the tree's structure (no paths)."""
    out: list = []
    return out, _flatten(tree, out, None)


def tree_leaves(tree: PyTree) -> list:
    return tree_flatten(tree)[0]


def _build(td: TreeDef, it):
    if td.kind == "leaf":
        return next(it)
    if td.kind == "none":
        return None
    kids = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.keys, kids))
    return kids if td.kind == "list" else tuple(kids)


def tree_unflatten(treedef: TreeDef, leaves) -> PyTree:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError("trees have different numbers of leaves")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
