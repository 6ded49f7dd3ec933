"""Read the pytree checkpoints that the JAX package writes, without JAX.

``rtvm_tpu/utils/checkpoint.py:save_pytree_npz`` stores a pytree as an npz:
``leaf_0 .. leaf_{n-1}`` in JAX's flatten order, and ``__treedef__``, the
``str()`` of the tree's PyTreeDef, as bytes. For a tree of nested dicts that
string reads like a Python literal with ``*`` for each leaf:

    PyTreeDef({'batch_stats': {'C2f_0': {...: {'mean': *, 'var': *}}}, 'params': {...}})

JAX flattens a dict in sorted key order, depth first, so walking the parsed
string the same way gives every leaf its path.
"""

from __future__ import annotations

import ast
from typing import Dict

import numpy as np


def parse_treedef(text: str) -> dict:
    """The nested dict of a dict-only PyTreeDef string, with ``None`` at each leaf."""
    prefix, suffix = "PyTreeDef(", ")"
    if not (text.startswith(prefix) and text.endswith(suffix)):
        raise ValueError(f"not a PyTreeDef string: {text[:60]!r}")
    tree = ast.literal_eval(text[len(prefix) : -len(suffix)].replace("*", "None"))
    if not isinstance(tree, dict):
        raise ValueError("only a tree of nested dicts is supported")
    return tree


def leaf_paths(tree: dict, prefix: str = "") -> list:
    """Leaf paths ('a/b/c') of a nested dict, in JAX's flatten order."""
    out = []
    for key in sorted(tree):
        sub = tree[key]
        path = f"{prefix}{key}"
        if isinstance(sub, dict):
            out += leaf_paths(sub, path + "/")
        elif sub is None:
            out.append(path)
        else:
            raise ValueError(f"unsupported node at {path!r}: {sub!r}")
    return out


def load_pytree_npz(path: str) -> Dict[str, np.ndarray]:
    """{leaf path: array} of a checkpoint written by the JAX package's
    ``save_pytree_npz``. Raises when the file has no ``__treedef__`` or when
    its leaf count disagrees with the treedef."""
    with np.load(path) as data:
        if "__treedef__" not in data.files:
            raise ValueError(f"{path}: no __treedef__, the leaf names are unknown")
        paths = leaf_paths(parse_treedef(bytes(data["__treedef__"]).decode()))
        n_leaves = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_leaves != len(paths):
            raise ValueError(f"{path}: {n_leaves} leaves, the treedef names {len(paths)}")
        return {p: data[f"leaf_{i}"] for i, p in enumerate(paths)}
