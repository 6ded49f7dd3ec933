"""Open-vocabulary detection: the text-conditioned YOLO head, the
counterpart of ``rtvm_tpu/models/yolo/world.py``.

- ``tokenize_names``: class names -> hashed character-trigram ids (FNV-1a),
  a host copy of the JAX function.
- ``TextEncoder``: embedding bag -> MLP -> L2-normalized text embeddings.
- ``WorldHead``: the box branch and an L2-normalized region-embedding
  branch; class logits are ``logit_scale`` times the cosine similarity to
  the text embeddings plus ``logit_bias``.
- ``YOLOWorld``: the shared trunk (``model.YoloTrunk``) with that head.
- ``YoloWorldDetector``: ``set_classes``, ``predict`` (letterbox at up to
  1280, optional horizontal-flip TTA merged by ``_merge_tta``) and
  ``predict_batch`` (same-size tiles in one call), in float32 as JAX runs it.

Modules keep Flax's submodule names (``TextEncoder_0/Embed_0/embedding``,
``Dense_n``, ``WorldHead_0/Conv_n``), so ``convert.flax_to_state_dict`` maps
``weights/yolov8n_world.npz`` leaf by leaf.

The letterbox resize is cv2's ``INTER_LINEAR`` on uint8, reproduced in
integer arithmetic on the device (11-bit weights, the row blend as cv2's
vectorised path rounds it): ``resize_linear_u8``.

Unlike the JAX class, which looks for the checkpoint only at the relative
path ``weights/{variant}_world.npz``, the detector searches where
``ObjectDetector`` does (``.``, ``weights/``, the checkout's ``weights/``).
Without a checkpoint it falls back to a closed-set detector restricted to
the requested names, as the JAX class does.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rtvm_tpu_torch.detect.classes import AERIAL_CLASSES, normalize_class_name
from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.models.yolo import postprocess as pp
from rtvm_tpu_torch.models.yolo.model import YoloConfig, YoloTrunk
from rtvm_tpu_torch.models.yolo.modules import ConvBnSiLU, FlaxScope

TEXT_VOCAB = 2048  # trigram hash buckets
TEXT_MAXLEN = 24  # trigrams per class name
EMBED_DIM = 64
_REPO_WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))), "weights")
WEIGHT_SEARCH_PATHS = [".", "weights", _REPO_WEIGHTS]


def tokenize_names(names: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Class names -> (ids [C, T] int32, mask [C, T] float32) of FNV-1a
    hashed trigrams of the lowercase ' name '."""
    ids = np.zeros((len(names), TEXT_MAXLEN), np.int32)
    mask = np.zeros((len(names), TEXT_MAXLEN), np.float32)
    for i, raw in enumerate(names):
        s = f" {str(raw).strip().lower()} "
        grams = [s[j : j + 3] for j in range(max(len(s) - 2, 1))]
        for t, g in enumerate(grams[:TEXT_MAXLEN]):
            h = 2166136261
            for ch in g.encode("utf-8"):
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            ids[i, t] = h % TEXT_VOCAB
            mask[i, t] = 1.0
    return ids, mask


def _l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=1e-6)


class Embed(nn.Module):
    """Flax's ``nn.Embed``: a [num, dim] table named ``embedding``."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(num, dim) * dim ** -0.5)

    def forward(self, ids):
        return self.embedding[ids]


class TextEncoder(FlaxScope):
    def __init__(self, dim: int = EMBED_DIM):
        super().__init__()
        self.embed = self.child(Embed(TEXT_VOCAB, dim))
        self.fc = [self.child(nn.Linear(dim, dim * 2), "Dense"),
                   self.child(nn.Linear(dim * 2, dim), "Dense")]

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[C, T] ids and mask -> [C, dim] L2-normalized text embeddings."""
        e = getattr(self, self.embed)(ids.to(torch.int64))  # [C, T, D]
        h = (e * mask[..., None]).sum(1) / torch.clamp(mask.sum(1, keepdim=True), min=1.0)
        h = F.silu(getattr(self, self.fc[0])(h))
        return _l2_normalize(getattr(self, self.fc[1])(h), -1)


class WorldHead(FlaxScope):
    """Per stride: the DFL box branch, and region embeddings whose cosine
    similarity to the text embeddings, scaled and shifted, are the class
    logits. The widths follow the first feature map, as in the JAX head."""

    def __init__(self, in_chs: Sequence[int], reg_max: int = 16, dim: int = EMBED_DIM):
        super().__init__()
        c2 = max(16, in_chs[0] // 4, reg_max * 4)
        c3 = max(in_chs[0], dim)
        self.logit_scale = nn.Parameter(torch.tensor(10.0))
        self.logit_bias = nn.Parameter(torch.tensor(-10.0))
        self.box: List[List[str]] = []
        self.emb: List[List[str]] = []
        for f in in_chs:
            self.box.append([self.child(ConvBnSiLU(f, c2, 3)), self.child(ConvBnSiLU(c2, c2, 3)),
                             self.child(nn.Conv2d(c2, 4 * reg_max, 1), "Conv")])
            self.emb.append([self.child(ConvBnSiLU(f, c3, 3)), self.child(ConvBnSiLU(c3, c3, 3)),
                             self.child(nn.Conv2d(c3, dim, 1), "Conv")])

    def forward(self, feats, text_embeds: torch.Tensor):
        box_outs, cls_outs = [], []
        for box, emb, f in zip(self.box, self.emb, feats):
            box_outs.append(self.run(box, f))
            e = _l2_normalize(self.run(emb, f), 1)
            cls_outs.append(torch.einsum("bdhw,cd->bchw", e, text_embeds.to(e.dtype))
                            * self.logit_scale + self.logit_bias)
        return box_outs, cls_outs


class YOLOWorld(YoloTrunk):
    """Text-conditioned YOLO: the trunk, then ``TextEncoder_0`` and
    ``WorldHead_0``. forward(x [B, 3, H, W] RGB in 0..1, ids, mask) ->
    (box_logits, cls_logits) per stride, NCHW; the vocabulary is an input."""

    def __init__(self, cfg: YoloConfig, dim: int = EMBED_DIM):
        super().__init__(cfg)
        self.text = self.child(TextEncoder(dim))
        self.head = self.child(WorldHead(self.feature_channels, cfg.reg_max, dim))

    def forward(self, x, text_ids, text_mask):
        text = getattr(self, self.text)(text_ids, text_mask)
        return getattr(self, self.head)(self.features(x), text)


def build_yolo_world(variant: str = "yolov8n", seed: int = 0, dim: int = EMBED_DIM,
                     device=None) -> YOLOWorld:
    """The model with seeded random weights, in eval mode on `device`
    (``cuda`` unless given)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = YOLOWorld(YoloConfig(variant=variant, num_classes=dim), dim=dim)
    return model.eval().to(dev)


def _linear_taps(ssize: int, dsize: int, clamp: bool):
    """cv2's INTER_LINEAR source indices and 11-bit weights along one axis.
    Columns clamp the position into the image (weight 2048 on the edge
    pixel); rows keep the fraction and clip each source row alone."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        f[s < 0] = 0
        s[s < 0] = 0
        f[s >= ssize - 1] = 0
        s[s >= ssize - 1] = ssize - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return np.clip(s, 0, ssize - 1), np.clip(s + 1, 0, ssize - 1), w0, w1


def resize_linear_u8(img: torch.Tensor, nw: int, nh: int) -> torch.Tensor:
    """cv2.resize(img, (nw, nh)) (INTER_LINEAR) of a [H, W, C] uint8 tensor,
    in int32 on its device: the column pass in exact integers, the row pass
    as cv2's vectorised fixed-point blend (each row's product kept to its
    high 16 bits, then (sum + 2) >> 2)."""
    h, w = img.shape[:2]
    if (nh, nw) == (h, w):
        return img.clone()
    dev = img.device
    x0, x1, a0, a1 = (torch.from_numpy(t).to(dev) for t in _linear_taps(w, nw, True))
    y0, y1, b0, b1 = (torch.from_numpy(t).to(dev) for t in _linear_taps(h, nh, False))
    src = img.to(torch.int32)
    cols = (src.index_select(1, x0) * a0[None, :, None]
            + src.index_select(1, x1) * a1[None, :, None])  # [H, nw, C], pixels * 2048
    s0, s1 = cols.index_select(0, y0) >> 4, cols.index_select(0, y1) >> 4
    v = ((s0 * b0[:, None, None]) >> 16) + ((s1 * b1[:, None, None]) >> 16)
    return torch.clamp((v + 2) >> 2, 0, 255).to(torch.uint8)


class YoloWorldDetector:
    """``set_classes`` + ``predict(augment=)`` on ``device`` (``cuda``
    unless given). With a world checkpoint the vocabulary conditions the
    network itself; without one the detector is ``base_detector`` (an
    ``ObjectDetector`` on the same device if none is given) restricted to
    the requested names."""

    def __init__(self, base_detector=None, classes: Optional[List[str]] = None,
                 weights_path: Optional[str] = None, variant: str = "yolov8n", device=None):
        self.device = resolve_device(device)
        self.variant = variant
        self.model = None
        self.weights_source = None
        path = weights_path or self._find_weights(variant)
        if path and os.path.exists(path):
            from rtvm_tpu_torch.models.yolo.convert import flax_to_state_dict
            from rtvm_tpu_torch.utils.checkpoint import load_pytree_npz

            model = build_yolo_world(variant, device="cpu")
            model.load_state_dict(flax_to_state_dict(load_pytree_npz(path), variant))
            self.model = model.to(self.device)
            self.weights_source = path
        else:
            if base_detector is None:
                from rtvm_tpu_torch.detect.detector import ObjectDetector

                base_detector = ObjectDetector(device=self.device)
            self.base = base_detector
        self.classes: List[str] = []
        self.set_classes(list(classes or AERIAL_CLASSES))

    @staticmethod
    def _find_weights(variant: str) -> Optional[str]:
        for d in WEIGHT_SEARCH_PATHS:
            p = os.path.join(d, f"{variant}_world.npz")
            if os.path.exists(p):
                return p
        return None

    @property
    def is_open_vocab(self) -> bool:
        return self.model is not None

    def set_classes(self, classes: List[str]) -> None:
        """Change the vocabulary: the next forward pass computes its logits
        against the new names' text embeddings."""
        self.classes = [normalize_class_name(c) for c in classes]
        self._raw_classes = list(classes)
        ids, mask = tokenize_names(self._raw_classes)
        self._text_ids = torch.from_numpy(ids).to(self.device)
        self._text_mask = torch.from_numpy(mask).to(self.device)

    def head_logits(self, images_u8: torch.Tensor):
        """[B, H, W, 3] BGR uint8 on the device -> (box_logits, cls_logits)
        per stride, float32 NCHW."""
        x = images_u8.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0
        with torch.inference_mode():
            return self.model(x, self._text_ids, self._text_mask)

    def _run_world(self, images_u8, conf: float, iou: float) -> List[List[dict]]:
        """[B, H, W, 3] BGR uint8 -> per-image detection dicts (one
        card-to-host copy for the whole batch)."""
        images = torch.as_tensor(images_u8).to(self.device)
        box_l, cls_l = self.head_logits(images)
        cfg = self.model.cfg
        with torch.inference_mode():
            boxes, scores = pp.decode_predictions(box_l, cls_l, cfg.strides, cfg.reg_max)
            det = pp.nms_fixed(boxes, scores, conf, iou)
            table = torch.cat([det.boxes, det.scores[..., None], det.classes[..., None].float(),
                               det.valid[..., None].float()], -1).cpu().numpy()
        out: List[List[dict]] = []
        for rows in table:
            out.append([{"bbox": [float(v) for v in r[:4]],
                         "class": self.classes[int(r[5])],
                         "confidence": float(r[4])}
                        for r in rows[rows[:, 6] > 0]])
        return out

    def predict(self, image, conf: float = 0.02, imgsz: int = 1280, iou: float = 0.5,
                augment: bool = False) -> List[dict]:
        """Open-vocabulary detection of one [H, W, 3] BGR uint8 image (numpy
        or a tensor), letterboxed to imgsz rounded to the stride (32) and
        kept in 320-1280; augment=True adds the horizontal flip and merges
        the two passes."""
        if not self.is_open_vocab:
            img = torch.as_tensor(image)
            dets = self.base._run_pass(img[None], imgsz=imgsz, conf=conf, iou=iou)[0]
            allowed = set(self.classes)
            return [d for d in dets if d["class"] in allowed]

        img = torch.as_tensor(image).to(self.device)
        h, w = img.shape[:2]
        size = int(np.clip(round(imgsz / 32) * 32, 320, 1280))
        scale = size / max(h, w)
        resized = resize_linear_u8(img, int(round(w * scale)), int(round(h * scale)))
        pad = torch.zeros((size, size, 3), dtype=torch.uint8, device=self.device)
        pad[: resized.shape[0], : resized.shape[1]] = resized
        batch = [pad]
        if augment:
            batch.append(pad.flip(1))
        dets_b = self._run_world(torch.stack(batch), conf, iou)
        dets = list(dets_b[0])
        if augment:
            for d in dets_b[1]:
                x1, y1, x2, y2 = d["bbox"]
                dets.append(dict(d, bbox=[size - x2, y1, size - x1, y2]))
            dets = _merge_tta(dets, iou_th=0.55)
        for d in dets:
            d["bbox"] = [float(np.clip(v / scale, 0, [w, h, w, h][i]))
                         for i, v in enumerate(d["bbox"])]
        return dets

    def predict_batch(self, images, conf: float = 0.03, iou: float = 0.5) -> List[List[dict]]:
        """Same-size [B, H, W, 3] BGR uint8 images (e.g. tiles) in one call;
        the sides are zero-padded up to the 32-px stride."""
        images = torch.as_tensor(images).to(self.device)
        b, h, w = images.shape[:3]
        ph, pw = (h + 31) // 32 * 32, (w + 31) // 32 * 32
        if (ph, pw) != (h, w):
            images = F.pad(images, (0, 0, 0, pw - w, 0, ph - h))
        dets_b = self._run_world(images, conf, iou)
        for dets in dets_b:
            for d in dets:
                d["bbox"] = [float(np.clip(v, 0, [w, h, w, h][i]))
                             for i, v in enumerate(d["bbox"])]
        return dets_b


def _merge_tta(dets: List[dict], iou_th: float = 0.55) -> List[dict]:
    """Greedy same-class merge of TTA duplicates (confidence-weighted box mean)."""

    def iou(a, b):
        x1, y1 = max(a[0], b[0]), max(a[1], b[1])
        x2, y2 = min(a[2], b[2]), min(a[3], b[3])
        inter = max(x2 - x1, 0) * max(y2 - y1, 0)
        ar = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
        return inter / max(ar, 1e-9)

    dets = sorted(dets, key=lambda d: -d["confidence"])
    out: List[dict] = []
    for d in dets:
        merged = False
        for o in out:
            if o["class"] == d["class"] and iou(o["bbox"], d["bbox"]) > iou_th:
                wa, wb = o["confidence"], d["confidence"]
                o["bbox"] = [(wa * a + wb * b) / (wa + wb) for a, b in zip(o["bbox"], d["bbox"])]
                o["confidence"] = max(wa, wb)
                merged = True
                break
        if not merged:
            out.append(dict(d))
    return out
