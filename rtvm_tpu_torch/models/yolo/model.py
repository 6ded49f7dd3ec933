"""The YOLOv8 (n/s/m/l/x), YOLO11 (n/s/m/l/x) and YOLOv8-Worldv2
(``yolov8{n,s,m,l,x}-worldv2``) detectors as NCHW ``nn.Module``s
(counterpart of ``rtvm_tpu/models/yolo/model.py``, which has no Worldv2).

CSP backbone -> SPPF (-> C2PSA for YOLO11) -> PAN neck -> decoupled DFL head
over strides (8, 16, 32). The families share one graph; they differ in the
CSP block (C2f or C3k2), the widths and depths, the attention block on the
stride-32 map and the head's classification branch. YOLOv8-Worldv2
(Ultralytics ``yolov8-worldv2.yaml``, YOLO-World) is the YOLOv8 trunk of the
same scale whose neck's four C2f are C2fAttn, guided by the vocabulary's
text embeddings, with ``WorldDetectHead``; the embeddings are a buffer of
the model read from its checkpoint, so that ``model(x) -> (box, cls)`` is
every family's call. Modules are registered in the order the Flax model
creates them (Ultralytics' for Worldv2), so their names are Flax's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.models.yolo.modules import (C2PSA, SPPF, C2f, C2fAttn, C3k2, ConvBnSiLU,
                                                DetectHead, FlaxScope, WorldDetectHead)

# depth multiple, width multiple, ratio (last-stage channel ratio)
VARIANTS = {
    "yolov8n": (1 / 3, 0.25, 2.0),
    "yolov8s": (1 / 3, 0.50, 2.0),
    "yolov8m": (2 / 3, 0.75, 1.5),
    "yolov8l": (1.0, 1.00, 1.0),
    "yolov8x": (1.0, 1.25, 1.0),
}

# YOLO11 family: depth multiple, width multiple, max channels
VARIANTS11 = {
    "yolo11n": (0.50, 0.25, 1024),
    "yolo11s": (0.50, 0.50, 1024),
    "yolo11m": (0.50, 1.00, 512),
    "yolo11l": (1.00, 1.00, 512),
    "yolo11x": (1.00, 1.50, 512),
}


# YOLOv8-Worldv2: the yaml's max_channels of each scale (the trunk is the
# YOLOv8 variant of the same scale)
VARIANTS_WORLDV2 = {"yolov8n-worldv2": 1024, "yolov8s-worldv2": 1024, "yolov8m-worldv2": 768,
                    "yolov8l-worldv2": 512, "yolov8x-worldv2": 512}
TEXT_DIM = 512  # CLIP ViT-B/32's text embeddings: WorldDetect's embed, C2fAttn's gc
# the yaml's heads of the neck's C2fAttn blocks (n4, n3, m4, m5)
_WORLDV2_HEADS = (8, 4, 8, 16)


def _make_divisible(x: float) -> int:
    """Ultralytics make_divisible(x, 8) (ceil, not round), at least 16."""
    return max(16, math.ceil(x / 8) * 8)


def _ch(w: float, c: int) -> int:
    return _make_divisible(c * w)


# c3k flag per ultralytics yolo11.yaml C3k2 layer index (backbone 2/4/6/8,
# neck 13/16/19/22): n/s run plain bottlenecks except at 6/8/22; m/l/x use
# nested C3k everywhere.
_C3K2_LAYERS = ("2", "4", "6", "8", "13", "16", "19", "22")
_C3K_ALWAYS = frozenset({"6", "8", "22"})


def yolo11_c3k_flags(variant: str) -> dict:
    deep = variant[-1] in "mlx"
    return {i: deep or i in _C3K_ALWAYS for i in _C3K2_LAYERS}


def _d(dm: float, n: int) -> int:
    return max(1, round(n * dm))


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    variant: str = "yolov8n"
    num_classes: int = 80
    reg_max: int = 16
    strides: Tuple[int, ...] = (8, 16, 32)


def yolo_features(cfg: YoloConfig, m: FlaxScope) -> Tuple[List[str], List[int]]:
    """Registers the YOLOv8 trunk (C2f backbone + SPPF + PAN neck) on `m` in
    Flax's creation order. Returns the trunk's module names in call order (see
    YOLOv8.forward) and the channels of its stride 8/16/32 outputs. A
    Worldv2 variant's neck blocks are C2fAttn, with the heads of Ultralytics'
    ``parse_model`` (the yaml's, capped at max_channels // 64, times the
    width); every block's embed channels then equal its hidden ones."""
    world = cfg.variant in VARIANTS_WORLDV2
    dm, wm, r = VARIANTS[cfg.variant.split("-")[0] if world else cfg.variant]
    c1, c2, c3, c4 = _ch(wm, 64), _ch(wm, 128), _ch(wm, 256), _ch(wm, 512)
    c5 = _ch(wm * r, 512)

    def neck(c_in: int, c_out: int, i: int):
        if not world:
            return C2f(c_in, c_out, _d(dm, 3))
        mc = VARIANTS_WORLDV2[cfg.variant]
        heads = int(max(round(min(_WORLDV2_HEADS[i], mc // 64)) * wm, 1))
        return C2fAttn(c_in, c_out, _d(dm, 3), heads, TEXT_DIM)

    names = [
        m.child(ConvBnSiLU(3, c1, 3, 2)),  # P1
        m.child(ConvBnSiLU(c1, c2, 3, 2)),  # P2
        m.child(C2f(c2, c2, _d(dm, 3), shortcut=True)),
        m.child(ConvBnSiLU(c2, c3, 3, 2)),  # P3
        m.child(C2f(c3, c3, _d(dm, 6), shortcut=True)),  # -> p3
        m.child(ConvBnSiLU(c3, c4, 3, 2)),  # P4
        m.child(C2f(c4, c4, _d(dm, 6), shortcut=True)),  # -> p4
        m.child(ConvBnSiLU(c4, c5, 3, 2)),  # P5
        m.child(C2f(c5, c5, _d(dm, 3), shortcut=True)),
        m.child(SPPF(c5, c5)),  # -> p5
        # PAN neck
        m.child(neck(c5 + c4, c4, 0)),  # n4
        m.child(neck(c4 + c3, c3, 1)),  # n3, stride 8
        m.child(ConvBnSiLU(c3, c3, 3, 2)),
        m.child(neck(c3 + c4, c4, 2)),  # m4, stride 16
        m.child(ConvBnSiLU(c4, c4, 3, 2)),
        m.child(neck(c4 + c5, c5, 3)),  # m5, stride 32
    ]
    return names, [c3, c4, c5]


def yolo11_features(cfg: YoloConfig, m: FlaxScope) -> Tuple[List[str], List[int]]:
    """Registers the YOLO11 trunk (C3k2 backbone + SPPF + C2PSA + PAN neck) on
    `m`, as yolo_features does; the C2PSA block follows SPPF."""
    dm, wm, mc = VARIANTS11[cfg.variant]

    def ch(c: int) -> int:
        return _make_divisible(min(c, mc) * wm)

    def rep(n: int) -> int:
        return max(1, round(n * dm))

    c3k = yolo11_c3k_flags(cfg.variant)
    c1, c2, c3, c4, c5 = ch(64), ch(128), ch(256), ch(512), ch(1024)
    names = [
        m.child(ConvBnSiLU(3, c1, 3, 2)),  # P1
        m.child(ConvBnSiLU(c1, c2, 3, 2)),  # P2
        m.child(C3k2(c2, c3, rep(2), c3k=c3k["2"], expansion=0.25)),
        m.child(ConvBnSiLU(c3, c3, 3, 2)),  # P3
        m.child(C3k2(c3, c4, rep(2), c3k=c3k["4"], expansion=0.25)),  # -> p3
        m.child(ConvBnSiLU(c4, c4, 3, 2)),  # P4
        m.child(C3k2(c4, c4, rep(2), c3k=c3k["6"])),  # -> p4
        m.child(ConvBnSiLU(c4, c5, 3, 2)),  # P5
        m.child(C3k2(c5, c5, rep(2), c3k=c3k["8"])),
        m.child(SPPF(c5, c5)),
        m.child(C2PSA(c5, c5, rep(2))),  # -> p5
        # PAN neck
        m.child(C3k2(c5 + c4, c4, rep(2), c3k=c3k["13"])),  # n4
        m.child(C3k2(c4 + c4, c3, rep(2), c3k=c3k["16"])),  # n3, stride 8
        m.child(ConvBnSiLU(c3, c3, 3, 2)),
        m.child(C3k2(c3 + c4, c4, rep(2), c3k=c3k["19"])),  # m4, stride 16
        m.child(ConvBnSiLU(c4, c4, 3, 2)),
        m.child(C3k2(c4 + c5, c5, rep(2), c3k=c3k["22"])),  # m5, stride 32
    ]
    return names, [c3, c4, c5]


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 (jax.image.resize "nearest" by 2 is a repeat)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YoloTrunk(FlaxScope):
    """The trunk of either family, chosen by ``cfg.variant``, registered
    first; subclasses add their head after it. features(x [B, 3, H, W] RGB
    in 0..1) -> [n3, m4, m5], NCHW at strides 8, 16 and 32."""

    def __init__(self, cfg: YoloConfig):
        super().__init__()
        self.cfg = cfg
        self.is11 = cfg.variant in VARIANTS11
        if not (self.is11 or cfg.variant in VARIANTS or cfg.variant in VARIANTS_WORLDV2):
            raise ValueError(f"unknown YOLO variant {cfg.variant!r}")
        self.trunk, self.feature_channels = (yolo11_features if self.is11 else yolo_features)(
            cfg, self)

    def features(self, x, text=None) -> List[torch.Tensor]:
        """`text`: the text embeddings that guide a Worldv2 neck."""
        layer = [getattr(self, n) for n in self.trunk]
        x = layer[1](layer[0](x))
        p3 = layer[4](layer[3](layer[2](x)))
        p4 = layer[6](layer[5](p3))
        p5 = layer[9](layer[8](layer[7](p4)))
        neck = layer[10:]
        if self.is11:
            p5, neck = neck[0](p5), neck[1:]
        csp = (lambda blk, y: blk(y)) if text is None else (lambda blk, y: blk(y, text))
        n4 = csp(neck[0], torch.cat([_upsample2(p5), p4], dim=1))
        n3 = csp(neck[1], torch.cat([_upsample2(n4), p3], dim=1))
        m4 = csp(neck[3], torch.cat([neck[2](n3), n4], dim=1))
        m5 = csp(neck[5], torch.cat([neck[4](m4), p5], dim=1))
        return [n3, m4, m5]


class YOLOv8(YoloTrunk):
    """Either family, chosen by ``cfg.variant``. forward(x [B, 3, H, W] RGB
    in 0..1) -> (box_logits, cls_logits), one NCHW tensor per stride."""

    def __init__(self, cfg: YoloConfig):
        super().__init__(cfg)
        self.head = self.child(DetectHead(self.feature_channels, cfg.num_classes, cfg.reg_max,
                                          dw_cls=self.is11))

    def forward(self, x):
        return getattr(self, self.head)(self.features(x))


class YOLOWorldV2(YoloTrunk):
    """YOLOv8-Worldv2: the trunk with a C2fAttn neck, then
    ``WorldDetectHead_0``, both guided by ``txt_feats`` [num_classes, 512],
    the vocabulary's L2-normalised text embeddings (a buffer, cast with the
    weights; random unit rows until a checkpoint is loaded). forward(x [B,
    3, H, W] RGB in 0..1) -> (box_logits, cls_logits), one NCHW tensor per
    stride, one class channel a row of ``txt_feats``."""

    def __init__(self, cfg: YoloConfig):
        super().__init__(cfg)
        self.register_buffer("txt_feats", F.normalize(torch.randn(cfg.num_classes, TEXT_DIM),
                                                      dim=-1))
        self.head = self.child(WorldDetectHead(self.feature_channels, cfg.num_classes, TEXT_DIM,
                                               cfg.reg_max))

    def forward(self, x):
        return getattr(self, self.head)(self.features(x, self.txt_feats), self.txt_feats)


def build_yolo(variant: str = "yolov8n", num_classes: int = 80, seed: int = 0,
               device=None) -> YoloTrunk:
    """The model (YOLOWorldV2 for a Worldv2 variant, else YOLOv8) with
    seeded random weights (PyTorch's default init drawn from `seed`; the
    global generator is left as it was), in eval mode on `device` (``cuda``
    unless given)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        cls = YOLOWorldV2 if variant in VARIANTS_WORLDV2 else YOLOv8
        model = cls(YoloConfig(variant=variant, num_classes=num_classes))
    return model.eval().to(dev)
