"""Read and write the pytree checkpoints of the JAX package, without JAX.

``rtvm_tpu/utils/checkpoint.py:save_pytree_npz`` stores a pytree as an npz:
``leaf_0 .. leaf_{n-1}`` in JAX's flatten order, and ``__treedef__``, the
``str()`` of the tree's PyTreeDef, as bytes. For a tree of nested dicts that
string reads like a Python literal with ``*`` for each leaf:

    PyTreeDef({'batch_stats': {'C2f_0': {...: {'mean': *, 'var': *}}}, 'params': {...}})

JAX flattens a dict in sorted key order, depth first, so walking the parsed
string the same way gives every leaf its path.

The writer builds that string itself (``treedef_str``), byte for byte as
JAX prints it, for trees of dicts, tuples and named tuples
(``NamedNode``: JAX's ``CustomNode(namedtuple[Name], [...])``, the node of
a trainer's ``TrainState`` and of optax's optimizer states), so that JAX's
``load_pytree_npz``, which refuses any other string, reads what the port
writes. Training states go to ``.npz`` only: orbax, JAX's other route, is
not a dependency of the port.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Any, Dict, Mapping

import numpy as np


@dataclasses.dataclass(frozen=True)
class NamedNode:
    """A named tuple of JAX's pytree: its type name and its fields in order."""

    name: str
    children: tuple = ()


def treedef_str(tree: Any) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` of a tree of mappings
    (sorted keys), tuples, ``NamedNode``s and leaves (anything else)."""

    def node(t) -> str:
        if isinstance(t, Mapping):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, NamedNode):
            return (f"CustomNode(namedtuple[{t.name}], ["
                    + ", ".join(node(c) for c in t.children) + "])")
        if isinstance(t, tuple):
            inner = ", ".join(node(c) for c in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"

    return f"PyTreeDef({node(tree)})"


def tree_leaves(tree: Any) -> list:
    """The leaves of `tree` in JAX's flatten order."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, NamedNode):
        return [leaf for c in tree.children for leaf in tree_leaves(c)]
    if isinstance(tree, tuple):
        return [leaf for c in tree for leaf in tree_leaves(c)]
    return [tree]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """`like` with its leaves replaced, in flatten order, by `leaves`."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, Mapping):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, NamedNode):
            return NamedNode(t.name, tuple(build(c) for c in t.children))
        if isinstance(t, tuple):
            return tuple(build(c) for c in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def save_pytree_npz(path: str, tree: Any) -> None:
    """What JAX's ``save_pytree_npz`` writes for the same tree of numpy
    arrays (or tensors on any device): the leaves as ``leaf_i`` and the
    treedef string, compressed."""
    leaves = [np.asarray(leaf.detach().cpu() if hasattr(leaf, "detach") else leaf)
              for leaf in tree_leaves(tree)]
    np.savez_compressed(
        path,
        __treedef__=np.frombuffer(treedef_str(tree).encode(), dtype=np.uint8),
        **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)},
    )


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


def load_pytree_npz(path: str, like: Any = None) -> Any:
    """Without `like`: {leaf path: array} of a dict-tree checkpoint written
    by ``save_pytree_npz`` (either package's); raises when the file has no
    ``__treedef__`` or when its leaf count disagrees with the treedef.

    With `like` (any tree ``treedef_str`` takes, leaves with a ``shape``):
    JAX's ``load_pytree_npz(path, like)``, `like` with the file's leaves;
    raises unless the stored string equals `like`'s and every leaf has its
    reference's shape."""
    with np.load(path) as data:
        if like is not None:
            want = treedef_str(like)
            if "__treedef__" in data.files:
                saved = bytes(data["__treedef__"]).decode()
                if saved != want:
                    raise ValueError(f"checkpoint structure mismatch:\n  saved: {saved}\n"
                                     f"  expected: {want}")
            restored = []
            for i, ref in enumerate(tree_leaves(like)):
                leaf = data[f"leaf_{i}"]
                ref_shape = tuple(getattr(ref, "shape", np.shape(ref)))
                if tuple(leaf.shape) != ref_shape:
                    raise ValueError(f"checkpoint leaf {i} shape {leaf.shape} != expected "
                                     f"{ref_shape}")
                restored.append(leaf)
            return tree_unflatten(like, restored)
        if "__treedef__" not in data.files:
            raise ValueError(f"{path}: no __treedef__, the leaf names are unknown")
        paths = leaf_paths(parse_treedef(bytes(data["__treedef__"]).decode()))
        n_leaves = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_leaves != len(paths):
            raise ValueError(f"{path}: {n_leaves} leaves, the treedef names {len(paths)}")
        return {p: data[f"leaf_{i}"] for i, p in enumerate(paths)}


_NO_ORBAX = ("an orbax checkpoint directory needs orbax, which the port does not use; "
             "pass the .npz a trainer writes")


def save_train_state(ckpt_dir: str, state_tree: Any, step: int) -> str:
    """``{ckpt_dir}/step_{step}.npz`` of a training state's tree: JAX's
    ``save_train_state`` where orbax is absent."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step}.npz")
    save_pytree_npz(path, state_tree)
    return path


def load_train_state(path: str, like: Any) -> Any:
    """A state tree from a ``.npz`` (``load_pytree_npz(path, like)``); any
    other path is an orbax directory and raises ImportError."""
    if path.endswith(".npz"):
        return load_pytree_npz(path, like)
    raise ImportError(_NO_ORBAX)


def flat_to_nested(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{'a/b': x} -> {'a': {'b': x}}."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out
