"""Detection evaluation: AP@0.5 and mAP on labelled scenes, the port's copy
of ``rtvm_tpu/models/yolo/eval.py`` (pure numpy).

The synthetic-aerial trainers (``train_synth.py``, ``train_world.py``) gate
on it: detection quality, not only shapes."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between one box [4] and many [N, 4]."""
    ix1 = np.maximum(a[0], b[:, 0])
    iy1 = np.maximum(a[1], b[:, 1])
    ix2 = np.minimum(a[2], b[:, 2])
    iy2 = np.minimum(a[3], b[:, 3])
    inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) - inter
    return inter / np.maximum(ua, 1e-9)


def average_precision(
    pred_boxes: Sequence[np.ndarray],
    pred_scores: Sequence[np.ndarray],
    gt_boxes: Sequence[np.ndarray],
    iou_threshold: float = 0.5,
) -> float:
    """VOC-style AP for one class, 101-point interpolated. Lists are per image."""
    records = []  # (score, is_tp)
    n_gt = 0
    for pb, ps, gb in zip(pred_boxes, pred_scores, gt_boxes):
        n_gt += len(gb)
        order = np.argsort(-ps)
        taken = np.zeros(len(gb), bool)
        for i in order:
            if len(gb) == 0:
                records.append((ps[i], False))
                continue
            ious = _iou(pb[i], gb)
            ious[taken] = 0.0
            j = int(np.argmax(ious))
            if ious[j] >= iou_threshold:
                taken[j] = True
                records.append((ps[i], True))
            else:
                records.append((ps[i], False))
    if n_gt == 0:
        return float("nan")
    if not records:
        return 0.0
    records.sort(key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in records])
    fp = np.cumsum([not r[1] for r in records])
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1e-9)
    ap = 0.0
    for r in np.linspace(0, 1, 101):
        mask = recall >= r
        ap += precision[mask].max() if mask.any() else 0.0
    return float(ap / 101.0)


def evaluate_map(
    per_image_dets: List[List[dict]],
    gt_boxes: List[np.ndarray],
    gt_classes: List[np.ndarray],
    class_names: List[str],
    iou_threshold: float = 0.5,
) -> Dict[str, float]:
    """per_image_dets: detector output dicts ({'bbox', 'class', 'confidence'}).
    Returns {'<class>': AP, ..., 'mAP50': ...} over the classes present in
    the ground truth, rounded to 4 places."""
    out: Dict[str, float] = {}
    aps = []
    for ci, name in enumerate(class_names):
        pb, ps, gb = [], [], []
        for dets, boxes, cls in zip(per_image_dets, gt_boxes, gt_classes):
            sel = [d for d in dets if d["class"] == name]
            pb.append(np.array([d["bbox"] for d in sel]).reshape(-1, 4))
            ps.append(np.array([d["confidence"] for d in sel]))
            gb.append(boxes[cls == ci].reshape(-1, 4))
        ap = average_precision(pb, ps, gb, iou_threshold)
        if not np.isnan(ap):
            out[name] = round(ap, 4)
            aps.append(ap)
    out["mAP50"] = round(float(np.mean(aps)) if aps else 0.0, 4)
    return out
