"""Checkpoints drawn from the seed, for a configuration with ``"weights":
"seeded"``: its reference's ``draw`` written as a checkpoint in the port's
format, which the program then loads through its normal path and the
reference reads with its own reader, as a bundled one.

The format is the JAX package's ``save_pytree_npz``: an npz of ``leaf_i``
arrays, the i-th leaf of the tree walked depth first in sorted key order,
and ``__treedef__``, the tree's ``PyTreeDef`` string, as bytes; the class
names in a json beside it (``{"classes": [...]}``). Written by the
benchmark's own code, uncompressed, into a fresh directory under
``TMPDIR`` that the run deletes at its end.
"""

from __future__ import annotations

import json
import shutil
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np


def _nested(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _treedef(node) -> str:
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(node[k])}" for k in sorted(node)) + "}"
    return "*"


def _leaves(node) -> List[np.ndarray]:
    if isinstance(node, dict):
        return [leaf for k in sorted(node) for leaf in _leaves(node[k])]
    return [node]


def write_checkpoint(npz_path: str, flat: Dict[str, np.ndarray], classes: List[str]) -> None:
    """`flat` ({leaf path: array}) as ``npz_path`` and the class names as the
    json beside it."""
    tree = _nested(flat)
    text = f"PyTreeDef({_treedef(tree)})"
    np.savez(npz_path, __treedef__=np.frombuffer(text.encode(), dtype=np.uint8),
             **{f"leaf_{i}": np.asarray(a, np.float32) for i, a in enumerate(_leaves(tree))})
    Path(npz_path[: -len(".npz")] + ".json").write_text(json.dumps({"classes": list(classes)}))


def class_names(yc: dict) -> List[str]:
    """The configuration's ``classes``, or ``class_0`` .. ``class_{nc-1}``."""
    return list(yc.get("classes") or [f"class_{i}" for i in range(yc["nc"])])


def seeded_checkpoint(reference, yc: dict, seed: int, frames, imgsz) -> Tuple[str, Callable]:
    """(npz path, a function that deletes it) of ``reference.draw(yc, seed,
    frames, imgsz)`` in a fresh directory under TMPDIR."""
    flat = reference.draw(yc, seed, frames, imgsz)
    tmp = tempfile.mkdtemp(prefix="bench_port_weights_")
    path = str(Path(tmp) / f"{yc['variant']}_seeded.npz")
    try:
        write_checkpoint(path, flat, class_names(yc))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path, lambda: shutil.rmtree(tmp, ignore_errors=True)
