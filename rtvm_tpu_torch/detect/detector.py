"""Object detection (counterpart of ``rtvm_tpu/detect/detector.py``): the
YOLO detector (closed-set YOLOv8 and YOLO11, and YOLOv8-Worldv2 over the
vocabulary its checkpoint embeds) with its checkpoint search and batched
inference,
the open-vocabulary companion (``models/yolo/world.py``) that
``load_world=True`` loads, the person pass, and ``detect_objects``, the
multi-pass detection on the mosaic.

Inference is the JAX package's: letterbox -> model -> decode -> NMS ->
un-letterbox, batched over whatever frames a call gets. ``_infer_fn`` runs
the model in bfloat16 by default, as the JAX detector does (every weight and
the input cast to bf16, the logits cast back to float32 for decode and NMS);
``dtype=torch.float32`` runs it in float32. The open-vocabulary model runs in
float32, as JAX runs it.

``detect_objects`` keeps the image on the detector's device for the three
passes (the world model at 1280 with flip TTA, the CLAHE-enhanced image,
640-px tiles through both models), and for the classical detectors' masks;
each pass reads its detections back in one copy, and the deduplication and
filters run on the host.

``draw_detections`` draws with ``utils/draw.py`` in place of cv2. An
ultralytics ``.pt`` goes through ``models/yolo/weights.py``.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from rtvm_tpu_torch.detect import classes as C
from rtvm_tpu_torch.detect.classical import detect_buildings_classical, detect_vehicles_classical
from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.models.rtdetr import postprocess as rtdetr_pp
from rtvm_tpu_torch.models.rtdetr.model import build_rtdetr, is_rtdetr, state_dict_from_leaves
from rtvm_tpu_torch.models.yolo import postprocess as pp
from rtvm_tpu_torch.models.yolo.convert import flax_to_state_dict
from rtvm_tpu_torch.models.yolo.model import build_yolo
from rtvm_tpu_torch.ops.clahe import enhance_for_detection
from rtvm_tpu_torch.utils import draw
from rtvm_tpu_torch.utils.checkpoint import load_pytree_npz
from rtvm_tpu_torch.utils.timing import count, span

_REPO_WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "weights")
_WEIGHT_SEARCH_PATHS = [".", "weights", _REPO_WEIGHTS]


def _iou(a, b) -> float:
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def _center_dist(a, b) -> float:
    ax, ay = (a[0] + a[2]) / 2, (a[1] + a[3]) / 2
    bx, by = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
    return float(np.hypot(ax - bx, ay - by))


def tile_starts(dim: int, win: int = 640, stride: int = 400) -> List[int]:
    """Tile origins along one side: every `stride` px, plus a last tile
    anchored at dim - win so that every pixel is tiled."""
    xs = list(range(0, max(dim - win, 0) + 1, stride))
    if xs[-1] != max(dim - win, 0):
        xs.append(max(dim - win, 0))
    return xs


class ObjectDetector:
    """YOLOv8/YOLO11/YOLOv8-Worldv2/RT-DETR detector on ``device`` (``cuda``
    unless given). ``model`` names a variant of ``models/yolo/model.py``:
    ``yolov8{n,s,m,l,x}``, ``yolo11{n,s,m,l,x}`` or
    ``yolov8{n,s,m,l,x}-worldv2``, whose checkpoint holds the vocabulary's
    text embeddings (``txt_feats``, one row a class of its json): its class
    logits are scores against those names, and every path here runs it as
    the closed-set models; or of ``models/rtdetr/model.py``
    (``rtdetr-r101vd``), whose ``.npz`` holds its
    ``state_dict`` (leaf paths with ``/`` for ``.``): it takes no NMS
    (``_infer_fn`` selects one detection a query) and has no ``.pt`` route.

    Weights, in the JAX class's order: the Flax checkpoint ``weights_path``
    if it is an ``.npz``, else ``{model}_aerial.npz`` found in ``.``,
    ``weights/`` or the repository's ``weights/``, with its class names from
    the json beside it; else an ultralytics ``.pt`` (``weights_path`` or
    ``{model}.pt`` found there) converted by name onto the model of
    ``num_classes`` classes (``models/yolo/weights.py``). So a ``.pt`` passed
    as ``weights_path`` loses to a bundled ``{model}_aerial.npz``, as in the
    JAX class. A checkpoint that fails to load or convert raises (the JAX
    class warns and keeps random weights). With none found the model keeps
    random weights drawn from `seed` and ``num_classes`` classes, as the JAX
    class does (``weights_loaded`` False, ``weights_source`` "random").

    ``load_world=True`` also builds the open-vocabulary companion
    ``model_world`` (YOLOv8n-world over ``AERIAL_CLASSES``) when its
    checkpoint ``yolov8n_world.npz`` is found; without it ``model_world`` is
    None, as in the JAX class. A world checkpoint that fails to load raises
    (the JAX class prints a warning and goes on without it)."""

    def __init__(self, model: str = "yolov8n", weights_path: Optional[str] = None,
                 num_classes: int = 80, seed: int = 0, load_world: bool = True, device=None):
        self.device = resolve_device(device)
        self.model_name = model
        self.model_world = None
        self.weights_loaded = False
        self.weights_source = "random"

        npz = (weights_path if weights_path and weights_path.endswith(".npz") else None) \
            or self._find_weights(model, ".npz", suffix="_aerial")
        if npz:
            meta_path = npz[: -len(".npz")] + ".json"
            classes = C.SYNTH_AERIAL_CLASSES
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    classes = json.load(f)["classes"]
            if is_rtdetr(model):
                self.model = build_rtdetr(model, num_classes=len(classes), seed=seed,
                                          device="cpu")
                self.model.load_state_dict(state_dict_from_leaves(load_pytree_npz(npz)))
            else:
                self.model = build_yolo(model, num_classes=len(classes), seed=seed, device="cpu")
                self.model.load_state_dict(flax_to_state_dict(load_pytree_npz(npz), model))
            self.model.to(self.device)
            self.class_names = list(classes)
            self.weights_loaded = True
            self.weights_source = npz
        elif is_rtdetr(model):  # no .pt route: the random model of `seed`
            self.model = build_rtdetr(model, num_classes=num_classes, seed=seed,
                                      device=self.device)
            self.class_names = (C.COCO_CLASSES if num_classes == 80
                                else [str(i) for i in range(num_classes)])
        else:
            self.model = build_yolo(model, num_classes=num_classes, seed=seed, device="cpu")
            self.class_names = (C.COCO_CLASSES if num_classes == 80
                                else [str(i) for i in range(num_classes)])
            pt = weights_path or self._find_weights(model, ".pt")
            if pt:
                from rtvm_tpu_torch.models.yolo.weights import (convert_to_state_dict,
                                                                load_ultralytics_state_dict)

                self.model.load_state_dict(convert_to_state_dict(
                    load_ultralytics_state_dict(pt), self.model, variant=model))
                self.weights_loaded = True
                self.weights_source = pt
            self.model.to(self.device)
        self._models = {torch.float32: self.model}
        self._infer_cache = {}
        if load_world:
            from rtvm_tpu_torch.models.yolo.world import YoloWorldDetector

            w = YoloWorldDetector(base_detector=self, classes=C.AERIAL_CLASSES,
                                  device=self.device)
            if w.is_open_vocab:
                self.model_world = w

    @staticmethod
    def _find_weights(model: str, ext: str = ".pt", suffix: str = "") -> Optional[str]:
        for d in _WEIGHT_SEARCH_PATHS:
            p = os.path.join(d, f"{model}{suffix}{ext}")
            if os.path.exists(p):
                return p
        return None

    # ------------------------------------------------------------------ core
    def model_as(self, dtype: torch.dtype) -> torch.nn.Module:
        """The model with every weight and statistic cast to `dtype` (kept)."""
        if dtype not in self._models:
            self._models[dtype] = copy.deepcopy(self.model).to(dtype)
        return self._models[dtype]

    def _frames(self, frames) -> torch.Tensor:
        if isinstance(frames, torch.Tensor):
            return frames.to(device=self.device, dtype=torch.uint8)
        return torch.as_tensor(np.asarray(frames), dtype=torch.uint8).to(self.device)

    def head_logits(self, frames_u8, imgsz, dtype: torch.dtype = torch.bfloat16):
        """Letterbox [B, H, W, 3] BGR uint8 frames and run the model in
        `dtype`. Returns (box_logits, cls_logits) per stride as float32 NCHW,
        and the letterbox's (scale, pad_y, pad_x)."""
        with span("detect.preprocess"):
            x, scale, py, px = pp.preprocess_frames(self._frames(frames_u8), imgsz)
        with span("detect.model"):
            with torch.inference_mode():
                box_l, cls_l = self.model_as(dtype)(x.to(dtype))
            return ([b.float() for b in box_l], [c.float() for c in cls_l]), (scale, py, px)

    def _infer_fn(self, imgsz, conf: float, iou: float,
                  dtype: torch.dtype = torch.bfloat16) -> Callable[..., pp.Detections]:
        """run(frames_u8 [B, H, W, 3] BGR) -> Detections of [B, 300] in frame
        pixels (cached per argument set)."""
        key = (imgsz, conf, iou, dtype)
        if key not in self._infer_cache and is_rtdetr(self.model_name):
            self._infer_cache[key] = self._rtdetr_infer_fn(imgsz, conf, dtype)
        if key not in self._infer_cache:
            cfg = self.model.cfg

            def run(frames_u8) -> pp.Detections:
                (box_l, cls_l), (scale, py, px) = self.head_logits(frames_u8, imgsz, dtype)
                with torch.inference_mode():
                    with span("detect.decode"):
                        boxes, scores = pp.decode_predictions(box_l, cls_l, cfg.strides,
                                                              cfg.reg_max)
                    with span("detect.nms"):  # counts its sweeps (nms_fixed)
                        det = pp.nms_fixed(boxes, scores, conf, iou)
                        return det._replace(boxes=pp.unletterbox_boxes(det.boxes, scale, py, px))

            self._infer_cache[key] = run
        return self._infer_cache[key]

    def _rtdetr_infer_fn(self, imgsz, conf: float, dtype: torch.dtype):
        """RT-DETR's run: no NMS, one detection a query
        (``models/rtdetr/postprocess.py``) in the span ``detect.decode``; IoU
        plays no part."""
        queries = self.model.spec.num_queries

        def run(frames_u8) -> pp.Detections:
            (box_l, cls_l), (scale, py, px) = self.head_logits(frames_u8, imgsz, dtype)
            with torch.inference_mode():
                with span("detect.decode"):
                    det = rtdetr_pp.select_detections(box_l, cls_l, queries, imgsz, conf)
                    return det._replace(boxes=pp.unletterbox_boxes(det.boxes, scale, py, px))

        return run

    def _run_pass(self, images_u8, imgsz, conf: float, iou: float) -> List[List[dict]]:
        """images [B, H, W, 3] BGR uint8 -> per-image detection dicts."""
        with span("detect.pass"):
            det = self._infer_fn(imgsz, conf, iou)(images_u8)
            with span("detect.read"):
                host = [t.cpu().numpy() for t in (det.boxes, det.scores, det.classes, det.valid)]
                count("bytes", sum(a.nbytes for a in host))
            boxes, scores, cls, valid = host
            with span("detect.dicts"):
                out = []
                for b in range(len(images_u8)):
                    out.append([{"bbox": [float(v) for v in boxes[b, i]],
                                 "class": C.normalize_class_name(self.class_names[int(cls[b, i])]),
                                 "confidence": float(scores[b, i]),
                                 "source": "yolo"}
                                for i in np.flatnonzero(valid[b])])
            return out

    # ------------------------------------------------------------- public API
    def detect_people(self, frame) -> List[List[int]]:
        """Person boxes only (conf 0.5, iou 0.45, imgsz 640)."""
        dets = self._run_pass(self._frames(frame)[None], imgsz=640, conf=0.5, iou=0.45)[0]
        return [[int(v) for v in d["bbox"]] for d in dets if d["class"] == "person"]

    def detect_objects(self, image, window_threshold: int = 800,
                       debug_dir: Optional[str] = None) -> List[dict]:
        """Multi-pass detection on a [H, W, 3] BGR uint8 image (numpy or a
        tensor) with dedup and filters, then the classical detectors merged
        in; debug_dir receives debug_watershed.jpg from the classical stage."""
        img = self._frames(image)
        h, w = img.shape[:2]

        # pass (a): the full image at a large size and a low confidence; the
        # open-vocabulary model, when loaded, with flip TTA
        all_dets: List[dict] = []
        if self.model_world is not None:
            all_dets += self.model_world.predict(img, conf=0.02, iou=0.5, augment=True)
        else:
            all_dets += self._run_pass(img[None], imgsz=1280, conf=0.02, iou=0.5)[0]

        # pass (b): the CLAHE-enhanced image (truncated to uint8)
        enhanced = enhance_for_detection(img).to(torch.uint8)
        if self.model_world is not None:
            all_dets += self.model_world.predict(enhanced, conf=0.02, iou=0.5)
        else:
            all_dets += self._run_pass(enhanced[None], imgsz=1280, conf=0.02, iou=0.5)[0]

        # pass (c): 640-px tiles of a large image, the last one anchored at
        # dim - 640, through the world model and the closed-set model (whose
        # detections come second, so the world's win the dedup's ties)
        if max(h, w) > window_threshold:
            win = 640
            offsets = [(x0, y0) for y0 in tile_starts(h, win) for x0 in tile_starts(w, win)]
            ph, pw = max(win - h, 0), max(win - w, 0)
            src = F.pad(img, (0, 0, 0, pw, 0, ph)) if (ph or pw) else img
            tile_batch = torch.stack([src[y0 : y0 + win, x0 : x0 + win] for x0, y0 in offsets])
            if self.model_world is not None:
                per_tile = self.model_world.predict_batch(tile_batch, conf=0.03, iou=0.5)
                per_tile_cs = self._run_pass(tile_batch, imgsz=640, conf=0.03, iou=0.5)
                per_tile = [a + b for a, b in zip(per_tile, per_tile_cs)]
            else:
                per_tile = self._run_pass(tile_batch, imgsz=640, conf=0.03, iou=0.5)
            for dets, (x0, y0) in zip(per_tile, offsets):
                for d in dets:
                    b = d["bbox"]
                    d["bbox"] = [b[0] + x0, b[1] + y0, b[2] + x0, b[3] + y0]
                    d["confidence"] *= 0.9
                    all_dets.append(d)

        deduped = self._dedup(all_dets, center_px=40.0, iou_th=0.5)
        filtered = self._area_filter(deduped, h, w)

        # the classical detectors, merged with a tighter dedup
        dbg = os.path.join(debug_dir, "debug_watershed.jpg") if debug_dir else None
        classical = detect_buildings_classical(img, debug_path=dbg) + detect_vehicles_classical(img)
        for cd in classical:
            if not any(_iou(cd["bbox"], d["bbox"]) > 0.3 or _center_dist(cd["bbox"], d["bbox"]) < 25
                       for d in filtered):
                filtered.append(cd)
        return filtered

    @staticmethod
    def _dedup(dets: List[dict], center_px: float, iou_th: float) -> List[dict]:
        """Keep the highest-confidence instance among same-class near-duplicates."""
        kept: List[dict] = []
        for d in sorted(dets, key=lambda x: -x["confidence"]):
            dup = any(
                (d["class"] == k["class"])
                and (_center_dist(d["bbox"], k["bbox"]) < center_px
                     or _iou(d["bbox"], k["bbox"]) > iou_th)
                for k in kept
            )
            if not dup:
                kept.append(d)
        return kept

    @staticmethod
    def _area_filter(dets: List[dict], h: int, w: int) -> List[dict]:
        """Area and size filters: at most 15% of the image; buildings at least
        200 px^2 with sides of 25 and 40; persons 36 px^2; others 80 px^2."""
        out = []
        max_area = 0.15 * h * w
        for d in dets:
            x1, y1, x2, y2 = d["bbox"]
            bw, bh = x2 - x1, y2 - y1
            area = bw * bh
            if area > max_area or area <= 0:
                continue
            if d["class"] == "building":
                if area < 200 or min(bw, bh) < 25 or max(bw, bh) < 40:
                    continue
            elif d["class"] == "person":
                if area < 36:
                    continue
            else:
                if area < 80:
                    continue
            out.append(d)
        return out

    @staticmethod
    def draw_detections(image: np.ndarray, dets: List[dict]) -> np.ndarray:
        """A copy of the BGR uint8 `image` with each detection's box (thickness
        2) and its label "{class} {confidence:.2f}" above it, in the JAX
        class's colours."""
        out = np.array(image, copy=True)
        colors = {"building": (0, 140, 255), "car": (0, 255, 0), "person": (0, 0, 255)}
        for d in dets:
            x1, y1, x2, y2 = [int(v) for v in d["bbox"]]
            c = colors.get(d["class"], (255, 200, 0))
            draw.rectangle(out, (x1, y1), (x2, y2), c, 2)
            draw.put_text(out, f"{d['class']} {d['confidence']:.2f}", (x1, max(y1 - 4, 10)),
                          0.45, c)
        return out
