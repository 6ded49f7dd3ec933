"""Ultralytics ``.pt`` checkpoints into the port's YOLO (counterpart of
``rtvm_tpu/models/yolo/weights.py``, whose tables and key map this module
copies: the port imports nothing of the JAX package).

Mapping is by NAME: ``ult_key_to_flax`` translates each ultralytics
state-dict key (``model.<idx>.<submodule>.<tensor>``) to the Flax variable
path of the JAX package's graph, and ``models/yolo/convert.py:
state_dict_key`` turns that path into the port's ``state_dict`` key (the
port's modules carry Flax's names). Positional pairing is unusable: Flax
orders its paths alphabetically, torch interleaves conv and BatchNorm
tensors, and BatchNorm's gamma and beta share a shape.

No transpose: ultralytics and the port are both OIHW (a depthwise
``(C, 1, kh, kw)`` too). BatchNorm's weight and bias become ``scale`` and
``bias``, its running statistics ``mean`` and ``var``.

A real ultralytics checkpoint pickles ultralytics' classes, so
``torch.load`` needs that package installed to read one, in both packages.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from rtvm_tpu_torch.models.yolo.convert import state_dict_key
from rtvm_tpu_torch.models.yolo.model import yolo11_c3k_flags

# ultralytics DetectionModel layer index -> our flax top-level module name
# (model.py YOLOv8.__call__ declaration order; indices 10/11/13/14/17/20 are
# parameter-free Upsample/Concat layers).
_TOP = {
    "0": "ConvBnSiLU_0",
    "1": "ConvBnSiLU_1",
    "2": "C2f_0",
    "3": "ConvBnSiLU_2",
    "4": "C2f_1",
    "5": "ConvBnSiLU_3",
    "6": "C2f_2",
    "7": "ConvBnSiLU_4",
    "8": "C2f_3",
    "9": "SPPF_0",
    "12": "C2f_4",
    "15": "C2f_5",
    "16": "ConvBnSiLU_5",
    "18": "C2f_6",
    "19": "ConvBnSiLU_6",
    "21": "C2f_7",
    "22": "DetectHead_0",
}

# yolo11.yaml layer indices (11/14 Upsample, 12/15/18/21 Concat are
# parameter-free) -> model.py yolo11_features declaration order.
_TOP11 = {
    "0": "ConvBnSiLU_0",
    "1": "ConvBnSiLU_1",
    "2": "C3k2_0",
    "3": "ConvBnSiLU_2",
    "4": "C3k2_1",
    "5": "ConvBnSiLU_3",
    "6": "C3k2_2",
    "7": "ConvBnSiLU_4",
    "8": "C3k2_3",
    "9": "SPPF_0",
    "10": "C2PSA_0",
    "13": "C3k2_4",
    "16": "C3k2_5",
    "17": "ConvBnSiLU_5",
    "19": "C3k2_6",
    "20": "ConvBnSiLU_6",
    "22": "C3k2_7",
    "23": "DetectHead_0",
}


def c3k_layer_indices(variant: str) -> frozenset:
    """Ultralytics layer indices whose C3k2 runs with c3k=True, which tells
    a ``m.i.cv1`` key of a plain Bottleneck from one of a nested C3k; from
    ``model.yolo11_c3k_flags``, which the graph itself reads."""
    return frozenset(i for i, f in yolo11_c3k_flags(variant).items() if f)


def load_ultralytics_state_dict(pt_path: str) -> Dict[str, np.ndarray]:
    """A ``.pt`` checkpoint as a flat float32 numpy state dict (the model's
    ``state_dict`` after ``.float()``)."""
    ckpt = torch.load(pt_path, map_location="cpu", weights_only=False)
    model = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    model = model.float()
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _conv_bn_path(rest: Tuple[str, ...], scope: Tuple[str, ...]):
    """Translate the tail of an ultralytics Conv(conv+bn) module key.

    rest is e.g. ('conv', 'weight') or ('bn', 'running_mean'); scope is the flax
    path of the enclosing ConvBnSiLU module. Returns (collection, full path,
    needs_conv_transpose) or None for ignorable tensors."""
    if rest == ("conv", "weight"):
        return "params", scope + ("Conv_0", "kernel"), True
    if rest == ("bn", "weight"):
        return "params", scope + ("BatchNorm_0", "scale"), False
    if rest == ("bn", "bias"):
        return "params", scope + ("BatchNorm_0", "bias"), False
    if rest == ("bn", "running_mean"):
        return "batch_stats", scope + ("BatchNorm_0", "mean"), False
    if rest == ("bn", "running_var"):
        return "batch_stats", scope + ("BatchNorm_0", "var"), False
    if rest[-1] == "num_batches_tracked":
        return None
    raise KeyError(f"unrecognized Conv-module tensor: {'.'.join(rest)}")


def ult_key_to_flax(key: str, variant: str = "yolov8n"):
    """Map one ultralytics state-dict key to (collection, flax path, transpose).

    ``variant`` picks the graph: v8 names use the C2f table, 11-series names the
    C3k2/C2PSA table (c3k placement depends on the scale — c3k_layer_indices).
    Returns None for tensors with no flax counterpart (num_batches_tracked, the
    fixed DFL expectation conv). Raises KeyError for unknown structure (e.g. a
    yolo11 C3k2 checkpoint fed to the v8 graph)."""
    is11 = variant.startswith("yolo11")
    top_map = _TOP11 if is11 else _TOP
    parts = key.split(".")
    if parts[0] == "model":
        parts = parts[1:]
    idx, rest = parts[0], tuple(parts[1:])
    if idx not in top_map:
        raise KeyError(f"unmapped ultralytics layer index in key: {key}")
    top = top_map[idx]

    if top.startswith("ConvBnSiLU"):
        return _conv_bn_path(rest, (top,))

    if top.startswith("C2f"):
        # ultralytics C2f declares cv1, cv2, m.[i] (state-dict order); our C2f
        # declares cv1 -> ConvBnSiLU_0, bottlenecks -> Bottleneck_i, cv2 ->
        # ConvBnSiLU_1 (modules.py C2f).
        if rest[0] == "cv1":
            return _conv_bn_path(rest[1:], (top, "ConvBnSiLU_0"))
        if rest[0] == "cv2":
            return _conv_bn_path(rest[1:], (top, "ConvBnSiLU_1"))
        if rest[0] == "m":
            i = rest[1]
            sub = {"cv1": "ConvBnSiLU_0", "cv2": "ConvBnSiLU_1"}[rest[2]]
            return _conv_bn_path(rest[3:], (top, f"Bottleneck_{i}", sub))
        raise KeyError(f"unrecognized C2f tensor: {key}")

    if top.startswith("C3k2"):
        # ultralytics C3k2: cv1, cv2, m.[i] where m.i is a C3k (cv1/cv2/cv3 +
        # m.[j] bottlenecks) when c3k else a plain Bottleneck (cv1/cv2). Our
        # C3k2: ConvBnSiLU_0 (cv1), C3k_i | Bottleneck_i, ConvBnSiLU_1 (cv2);
        # our C3k: ConvBnSiLU_0 (cv1/a), ConvBnSiLU_1 (cv2/b), Bottleneck_j,
        # ConvBnSiLU_2 (cv3).
        if rest[0] == "cv1":
            return _conv_bn_path(rest[1:], (top, "ConvBnSiLU_0"))
        if rest[0] == "cv2":
            return _conv_bn_path(rest[1:], (top, "ConvBnSiLU_1"))
        if rest[0] == "m":
            i = rest[1]
            if idx in c3k_layer_indices(variant):
                c3k = (top, f"C3k_{i}")
                if rest[2] == "cv1":
                    return _conv_bn_path(rest[3:], c3k + ("ConvBnSiLU_0",))
                if rest[2] == "cv2":
                    return _conv_bn_path(rest[3:], c3k + ("ConvBnSiLU_1",))
                if rest[2] == "cv3":
                    return _conv_bn_path(rest[3:], c3k + ("ConvBnSiLU_2",))
                if rest[2] == "m":
                    j = rest[3]
                    sub = {"cv1": "ConvBnSiLU_0", "cv2": "ConvBnSiLU_1"}[rest[4]]
                    return _conv_bn_path(rest[5:], c3k + (f"Bottleneck_{j}", sub))
            else:
                sub = {"cv1": "ConvBnSiLU_0", "cv2": "ConvBnSiLU_1"}[rest[2]]
                return _conv_bn_path(rest[3:], (top, f"Bottleneck_{i}", sub))
        raise KeyError(f"unrecognized C3k2 tensor: {key}")

    if top.startswith("C2PSA"):
        # ultralytics C2PSA: cv1, cv2, m.[i] PSABlock(attn{qkv,proj,pe},
        # ffn{0,1}). Ours: ConvBnSiLU_0 (cv1), PSABlock_i (SpatialAttention_0
        # with ConvBn_0=qkv / ConvBn_1=pe / ConvBn_2=proj, ConvBnSiLU_0=ffn.0,
        # ConvBn_0=ffn.1), ConvBnSiLU_1 (cv2).
        if rest[0] == "cv1":
            return _conv_bn_path(rest[1:], (top, "ConvBnSiLU_0"))
        if rest[0] == "cv2":
            return _conv_bn_path(rest[1:], (top, "ConvBnSiLU_1"))
        if rest[0] == "m":
            blk = (top, f"PSABlock_{rest[1]}")
            if rest[2] == "attn":
                sub = {"qkv": "ConvBn_0", "pe": "ConvBn_1", "proj": "ConvBn_2"}[rest[3]]
                return _conv_bn_path(rest[4:], blk + ("SpatialAttention_0", sub))
            if rest[2] == "ffn":
                sub = {"0": "ConvBnSiLU_0", "1": "ConvBn_0"}[rest[3]]
                return _conv_bn_path(rest[4:], blk + (sub,))
        raise KeyError(f"unrecognized C2PSA tensor: {key}")

    if top.startswith("SPPF"):
        sub = {"cv1": "ConvBnSiLU_0", "cv2": "ConvBnSiLU_1"}[rest[0]]
        return _conv_bn_path(rest[1:], (top, sub))

    if top.startswith("DetectHead"):
        if rest[0] == "dfl":
            return None  # fixed arange conv == our dfl_expectation, not a weight
        branch, s, j = rest[0], int(rest[1]), rest[2]
        if branch not in ("cv2", "cv3"):
            raise KeyError(f"unrecognized head tensor: {key}")
        if is11:
            # yolo11 head (legacy=False): cv2.s = (Conv, Conv, Conv2d) box;
            # cv3.s = (Seq(DWConv, Conv), Seq(DWConv, Conv), Conv2d) cls. Our
            # dw_cls head creates per scale: ConvBnSiLU_{6s}..{6s+1} (box),
            # ConvBnSiLU_{6s+2}..{6s+5} (cls), Conv_{2s} (box), Conv_{2s+1}.
            if branch == "cv2":
                if j in ("0", "1"):
                    return _conv_bn_path(rest[3:], (top, f"ConvBnSiLU_{6 * s + int(j)}"))
                if j == "2":
                    return _head_final_conv(rest[3:], top, f"Conv_{2 * s}", key)
            else:
                if j in ("0", "1"):
                    sub = f"ConvBnSiLU_{6 * s + 2 + 2 * int(j) + int(rest[3])}"
                    return _conv_bn_path(rest[4:], (top, sub))
                if j == "2":
                    return _head_final_conv(rest[3:], top, f"Conv_{2 * s + 1}", key)
            raise KeyError(f"unrecognized head tensor: {key}")
        # v8 head: cv2 = box branch, cv3 = cls branch; per scale s the
        # Sequential is (Conv, Conv, Conv2d). Our DetectHead creates, per scale:
        # ConvBnSiLU_{4s}, ConvBnSiLU_{4s+1}, Conv_{2s} (box) then
        # ConvBnSiLU_{4s+2}, ConvBnSiLU_{4s+3}, Conv_{2s+1} (cls).
        boff = 0 if branch == "cv2" else 2
        if j in ("0", "1"):
            sub = f"ConvBnSiLU_{4 * s + boff + int(j)}"
            return _conv_bn_path(rest[3:], (top, sub))
        if j == "2":  # plain conv with bias
            return _head_final_conv(
                rest[3:], top, f"Conv_{2 * s + (0 if branch == 'cv2' else 1)}", key
            )
        raise KeyError(f"unrecognized head tensor: {key}")

    raise KeyError(f"unmapped key: {key}")


def _head_final_conv(rest: Tuple[str, ...], top: str, conv: str, key: str):
    if rest[0] == "weight":
        return "params", (top, conv, "kernel"), True
    if rest[0] == "bias":
        return "params", (top, conv, "bias"), False
    raise KeyError(f"unrecognized head tensor: {key}")


def convert_to_state_dict(state: Dict[str, np.ndarray], model: torch.nn.Module,
                          variant: str = "yolov8n") -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for `model` (a ``YOLOv8`` of `variant`) from
    an ultralytics v8/11 state dict, by name. As the JAX package's
    ``convert_to_flax`` checks, every tensor must land on a key of the same
    shape, and every key must be written exactly once; otherwise this
    raises (KeyError or ValueError) rather than mix converted and random
    weights."""
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, tensor in state.items():
        m = ult_key_to_flax(key, variant)
        if m is None:
            continue
        collection, path, _ = m
        name, _ = state_dict_key("/".join((collection,) + path))
        if name not in want:
            raise KeyError(f"{key}: the model has no {name}")
        if name in out:
            raise ValueError(f"{key}: {name} written twice")
        value = np.asarray(tensor, dtype=np.float32)
        if tuple(want[name].shape) != value.shape:
            raise ValueError(f"{key}: shape {value.shape} != the model's {name} "
                             f"{tuple(want[name].shape)}")
        out[name] = torch.from_numpy(np.array(value, order="C"))
    missing = sorted(set(want) - set(out))
    if missing:
        raise ValueError(f"{len(missing)} of the model's tensors are not in the checkpoint, "
                         f"e.g. {missing[:5]}")
    return out
