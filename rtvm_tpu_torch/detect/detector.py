"""Per-frame YOLO detection (counterpart of ``rtvm_tpu/detect/detector.py``:
the closed-set detector, its checkpoint search, the batched inference
function and the person pass).

Inference is the JAX package's: letterbox -> model -> decode -> NMS ->
un-letterbox, batched over whatever frames a call gets. ``_infer_fn`` runs
the model in bfloat16 by default, as the JAX detector does (every weight and
the input cast to bf16, the logits cast back to float32 for decode and NMS);
``dtype=torch.float32`` runs it in float32.

``draw_detections`` draws with ``utils/draw.py`` in place of cv2.

Not ported yet (ROADMAP.md, Queue 1 item 5): ``detect_objects`` (CLAHE,
the classical detectors, the open-vocabulary model), the ultralytics ``.pt``
route of the constructor, and the open-vocabulary companion that
``load_world=True`` loads. Each raises NotImplementedError.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from rtvm_tpu_torch.detect import classes as C
from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.models.yolo import postprocess as pp
from rtvm_tpu_torch.models.yolo.convert import flax_to_state_dict
from rtvm_tpu_torch.models.yolo.model import build_yolo
from rtvm_tpu_torch.utils import draw
from rtvm_tpu_torch.utils.checkpoint import load_pytree_npz

_REPO_WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "weights")
_WEIGHT_SEARCH_PATHS = [".", "weights", _REPO_WEIGHTS]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, Queue 1 item 5)")


class ObjectDetector:
    """YOLOv8/YOLO11 detector on ``device`` (``cuda`` unless given).

    Weights, in the JAX class's order: the Flax checkpoint ``weights_path``
    if it is an ``.npz``, else ``{model}_aerial.npz`` found in ``.``,
    ``weights/`` or the repository's ``weights/``, with its class names from
    the json beside it; else an ultralytics ``.pt`` (``weights_path`` or
    ``{model}.pt`` found there), which raises NotImplementedError. A
    checkpoint that fails to load raises. With none found the model keeps
    random weights drawn from `seed` and ``num_classes`` classes, as the JAX
    class does (``weights_loaded`` False, ``weights_source`` "random")."""

    def __init__(self, model: str = "yolov8n", weights_path: Optional[str] = None,
                 num_classes: int = 80, seed: int = 0, load_world: bool = True, device=None):
        if load_world:
            raise _not_ported("the open-vocabulary companion (load_world=True)")
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
            self.model = build_yolo(model, num_classes=len(classes), seed=seed, device="cpu")
            self.model.load_state_dict(flax_to_state_dict(load_pytree_npz(npz), model))
            self.model.to(self.device)
            self.class_names = list(classes)
            self.weights_loaded = True
            self.weights_source = npz
        else:
            pt = weights_path or self._find_weights(model, ".pt")
            if pt:
                raise _not_ported(f"loading an ultralytics checkpoint ({pt})")
            self.model = build_yolo(model, num_classes=num_classes, seed=seed, device=self.device)
            self.class_names = (C.COCO_CLASSES if num_classes == 80
                                else [str(i) for i in range(num_classes)])
        self._models = {torch.float32: self.model}
        self._infer_cache = {}

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
        x, scale, py, px = pp.preprocess_frames(self._frames(frames_u8), imgsz)
        with torch.inference_mode():
            box_l, cls_l = self.model_as(dtype)(x.to(dtype))
        return ([b.float() for b in box_l], [c.float() for c in cls_l]), (scale, py, px)

    def _infer_fn(self, imgsz, conf: float, iou: float,
                  dtype: torch.dtype = torch.bfloat16) -> Callable[..., pp.Detections]:
        """run(frames_u8 [B, H, W, 3] BGR) -> Detections of [B, 300] in frame
        pixels (cached per argument set)."""
        key = (imgsz, conf, iou, dtype)
        if key not in self._infer_cache:
            cfg = self.model.cfg

            def run(frames_u8) -> pp.Detections:
                (box_l, cls_l), (scale, py, px) = self.head_logits(frames_u8, imgsz, dtype)
                with torch.inference_mode():
                    boxes, scores = pp.decode_predictions(box_l, cls_l, cfg.strides, cfg.reg_max)
                    det = pp.nms_fixed(boxes, scores, conf, iou)
                    return det._replace(boxes=pp.unletterbox_boxes(det.boxes, scale, py, px))

            self._infer_cache[key] = run
        return self._infer_cache[key]

    def _run_pass(self, images_u8, imgsz, conf: float, iou: float) -> List[List[dict]]:
        """images [B, H, W, 3] BGR uint8 -> per-image detection dicts."""
        det = self._infer_fn(imgsz, conf, iou)(images_u8)
        boxes, scores = det.boxes.cpu().numpy(), det.scores.cpu().numpy()
        cls, valid = det.classes.cpu().numpy(), det.valid.cpu().numpy()
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

    def detect_objects(self, image, window_threshold: int = 800, debug_dir=None):
        raise _not_ported("detect_objects (multi-pass detection with CLAHE, tiles and the "
                          "classical detectors)")

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
