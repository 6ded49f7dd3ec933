"""Carry a Flax YOLO checkpoint into the port's ``state_dict``.

The port's modules carry Flax's names (see ``modules.py``), so a leaf path
``params/C2f_0/Bottleneck_0/ConvBnSiLU_0/Conv_0/kernel`` is the key
``C2f_0.Bottleneck_0.ConvBnSiLU_0.Conv_0.weight``: the collection
(``params`` or ``batch_stats``) is dropped, ``/`` becomes ``.``, and only a
convolution's ``kernel`` is renamed ``weight`` and moved from Flax's HWIO to
PyTorch's OIHW (a depthwise ``(kh, kw, 1, C)`` becomes ``(C, 1, kh, kw)``),
a ``Dense`` kernel from ``(in, out)`` to ``nn.Linear``'s ``(out, in)``.
BatchNorm's ``scale``, ``bias``, ``mean`` and ``var``, an ``Embed``'s
``embedding`` (``[V, D]``), the open-vocabulary head's 0-dim
``logit_scale`` and ``logit_bias``, and YOLOv8-Worldv2's text embeddings
``params/txt_feats`` (``[K, 512]``, the buffer ``txt_feats``), attention
``bias`` (``[heads]``) and contrastive heads' ``bias`` (``[1]``) and 0-dim
``logit_scale`` keep their names and shapes.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from rtvm_tpu_torch.models.yolo.model import VARIANTS_WORLDV2, YOLOv8, YOLOWorldV2, YoloConfig

COLLECTIONS = ("params", "batch_stats")


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """{'a/b/c': leaf} of a nested mapping; a flat {path: leaf} passes through."""
    out = {}
    for key, sub in tree.items():
        if isinstance(sub, Mapping):
            out.update(flatten_tree(sub, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = sub
    return out


def state_dict_key(path: str) -> Tuple[str, bool]:
    """(state_dict key, whether the leaf is a conv kernel to transpose) of a
    Flax leaf path."""
    parts = path.split("/")
    if parts[0] not in COLLECTIONS:
        raise ValueError(f"{path!r}: not under {COLLECTIONS}")
    is_kernel = parts[-1] == "kernel"
    if is_kernel:
        parts[-1] = "weight"
    return ".".join(parts[1:]), is_kernel


def flax_to_torch(tree: Mapping) -> Dict[str, torch.Tensor]:
    """{state_dict key: float32 tensor} of Flax variables of any of the port's
    modules: the nested ``{'params': ..., 'batch_stats': ...}`` of numpy
    arrays, or the flat ``{path: array}`` that
    ``utils.checkpoint.load_pytree_npz`` returns. Checks nothing."""
    sd = {}
    for path, leaf in flatten_tree(tree).items():
        key, is_kernel = state_dict_key(path)
        a = np.asarray(leaf, dtype=np.float32)
        if is_kernel:
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        sd[key] = torch.from_numpy(np.array(a, order="C"))  # keeps 0-dim leaves 0-dim
    return sd


def flax_to_state_dict(tree: Mapping, variant: str) -> Dict[str, torch.Tensor]:
    """The port's state_dict of the whole model `variant` from its Flax
    variables (see flax_to_torch): the open-vocabulary ``YOLOWorld`` when
    the tree has a ``WorldHead_0``, ``YOLOWorldV2`` with as many classes as
    ``txt_feats`` has rows for a Worldv2 variant, else ``YOLOv8`` with the
    class count that the head's last convolution gives. Raises ValueError
    unless the names and shapes are exactly those of that model."""
    sd = flax_to_torch(tree)
    with torch.device("meta"):
        if "WorldHead_0.logit_scale" in sd:
            from rtvm_tpu_torch.models.yolo.world import YOLOWorld

            dim = sd["WorldHead_0.Conv_1.bias"].shape[0]
            want = YOLOWorld(YoloConfig(variant=variant, num_classes=dim), dim=dim).state_dict()
        elif variant in VARIANTS_WORLDV2:
            num_classes = sd.get("txt_feats", torch.empty(0)).shape[0]
            want = YOLOWorldV2(YoloConfig(variant=variant, num_classes=num_classes)).state_dict()
        else:
            num_classes = sd.get("DetectHead_0.Conv_1.bias", torch.empty(0)).shape[0]
            want = YOLOv8(YoloConfig(variant=variant, num_classes=num_classes)).state_dict()
    missing, extra = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or extra:
        raise ValueError(f"{variant}: checkpoint names differ from the model's: "
                         f"missing {missing[:5]}, unexpected {extra[:5]}")
    bad = [k for k in want if tuple(want[k].shape) != tuple(sd[k].shape)]
    if bad:
        raise ValueError(f"{variant}: shapes differ at {bad[:5]}")
    return sd


def flax_path(key: str, buffer_names: frozenset = frozenset({"mean", "var"})) -> str:
    """The Flax leaf path of a state_dict key (the inverse of
    ``state_dict_key``): BatchNorm's ``mean`` and ``var`` are
    ``batch_stats``, everything else ``params``, and ``weight`` is ``kernel``."""
    parts = key.split(".")
    collection = "batch_stats" if parts[-1] in buffer_names else "params"
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join([collection] + parts)


def torch_to_flax_arrays(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{Flax leaf path: float32 array} of {state_dict key: tensor}: a
    convolution's OIHW ``weight`` becomes the HWIO ``kernel`` (a depthwise
    ``(C, 1, kh, kw)`` becomes ``(kh, kw, 1, C)``), an ``nn.Linear``'s
    ``(out, in)`` the ``(in, out)`` ``kernel``. Also maps tensors shaped
    as the parameters, such as AdamW's moments."""
    out = {}
    for key, t in tensors.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        if key.endswith(".weight"):
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        out[flax_path(key)] = np.array(a, order="C")  # keeps 0-dim leaves 0-dim
    return out


def torch_to_flax(model: torch.nn.Module) -> dict:
    """The Flax variables ``{'params': ..., 'batch_stats': ...}`` (nested
    dicts of float32 numpy arrays) of any of the port's YOLO modules: the
    inverse of ``flax_to_torch``, so that ``save_pytree_npz`` of it is a
    checkpoint the JAX package loads."""
    from rtvm_tpu_torch.utils.checkpoint import flat_to_nested

    tree = flat_to_nested(torch_to_flax_arrays(model.state_dict()))
    tree.setdefault("batch_stats", {})
    return tree
