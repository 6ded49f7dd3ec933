"""YOLO letterbox, decode and fixed-shape NMS, batched over frames
(counterpart of ``rtvm_tpu/models/yolo/postprocess.py``, which vmaps a
single-image NMS).

The NMS is the JAX package's: top K=min(300, N) candidates by confidence,
then greedy suppression solved as a Jacobi fixpoint over the [K, K]
suppression matrix. Here the sweep runs on the whole [frames, K, K] batch
until no frame changes; each convergence test is one card-to-host read, and
a frame at its fixpoint stays there, so the extra sweeps change nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from rtvm_tpu_torch.models.yolo.modules import dfl_expectation
from rtvm_tpu_torch.utils.timing import count

PAD_VALUE = 0.447  # the letterbox's fill, in 0..1


class Detections(NamedTuple):
    boxes: torch.Tensor  # [F, K, 4] xyxy in input-image pixels
    scores: torch.Tensor  # [F, K] (0 where not kept)
    classes: torch.Tensor  # [F, K] int32
    valid: torch.Tensor  # [F, K] bool


def decode_predictions(box_logits: Sequence[torch.Tensor], cls_logits: Sequence[torch.Tensor],
                       strides: Tuple[int, ...] = (8, 16, 32), reg_max: int = 16):
    """Per-stride head outputs (NCHW) -> (boxes xyxy [B, N, 4], scores [B, N, C]),
    the candidates in the JAX package's order (stride by stride, row-major)."""
    all_boxes, all_scores = [], []
    for bl, cl, s in zip(box_logits, cls_logits, strides):
        b, _, h, w = bl.shape
        d = dfl_expectation(bl, reg_max)  # [B, 4, H, W] ltrb in stride units
        cy = (torch.arange(h, dtype=torch.float32, device=bl.device) + 0.5)[None, :, None]
        cx = (torch.arange(w, dtype=torch.float32, device=bl.device) + 0.5)[None, None, :]
        boxes = torch.stack([(cx - d[:, 0]) * s, (cy - d[:, 1]) * s,
                             (cx + d[:, 2]) * s, (cy + d[:, 3]) * s], dim=-1)
        all_boxes.append(boxes.reshape(b, h * w, 4))
        all_scores.append(torch.sigmoid(cl).reshape(b, cl.shape[1], h * w).transpose(1, 2))
    return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1)


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """[..., K, 4] xyxy -> [..., K, K] IoU."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, conf_threshold: float = 0.25,
              iou_threshold: float = 0.45, max_detections: int = 300,
              class_aware: bool = True) -> Detections:
    """NMS with a static output size over frames: boxes [F, N, 4], scores
    [F, N, C] -> Detections of [F, K] with K = min(max_detections, N).

    The top K are taken by a stable descending sort, so equal scores keep
    the lower index first, as ``jax.lax.top_k`` does."""
    conf, cls = torch.max(scores, dim=-1)  # first index of the maximum, as jnp.argmax
    conf = torch.where(conf >= conf_threshold, conf, torch.zeros_like(conf))
    k = min(max_detections, boxes.shape[1])
    top_conf, idx = torch.sort(conf, dim=-1, descending=True, stable=True)
    top_conf, idx = top_conf[:, :k], idx[:, :k]
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls, 1, idx).to(torch.int32)

    iou = _iou_matrix(top_boxes)
    if class_aware:
        iou = iou * (top_cls[:, :, None] == top_cls[:, None, :])
    rank = torch.arange(k, device=boxes.device)
    sup = (iou > iou_threshold) & (rank[:, None] < rank[None, :])
    keep0 = top_conf > 0.0
    # keep[j] = keep0[j] and no kept higher-ranked i suppresses j: a
    # stratified recursion whose parallel sweep reaches the greedy result
    keep = keep0
    for _ in range(k):
        nxt = keep0 & ~torch.any(sup & keep[:, :, None], dim=1)
        changed = bool(torch.any(nxt != keep))  # one card-to-host read a sweep
        count("sweeps")
        keep = nxt
        if not changed:
            break
    scores = torch.where(keep, top_conf, torch.zeros_like(top_conf))
    return Detections(boxes=top_boxes, scores=scores, classes=top_cls, valid=keep)


def letterbox_params(h: int, w: int, imgsz) -> Tuple[float, int, int, int, int]:
    """Aspect-preserving resize-with-pad geometry (scale, new_h, new_w, pad_y,
    pad_x); imgsz is a square side (int) or (out_h, out_w)."""
    th, tw = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
    scale = min(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    py, px = (th - nh) // 2, (tw - nw) // 2
    return scale, nh, nw, py, px


def preprocess_frames(frames_u8: torch.Tensor, imgsz) -> Tuple[torch.Tensor, float, int, int]:
    """[B, H, W, 3] BGR uint8 -> ([B, 3, th, tw] RGB float32 in 0..1,
    letterboxed), scale, pad_y, pad_x. The resize is bilinear with
    antialiasing, as ``jax.image.resize``'s."""
    b, h, w, _ = frames_u8.shape
    th, tw = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
    scale, nh, nw, py, px = letterbox_params(h, w, imgsz)
    x = frames_u8.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0  # BGR -> RGB
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=True)
    x = F.pad(x, (px, tw - nw - px, py, th - nh - py), value=PAD_VALUE)
    return x, scale, py, px


def unletterbox_boxes(boxes: torch.Tensor, scale: float, py: int, px: int) -> torch.Tensor:
    """Map boxes from letterboxed coordinates back to the original image's pixels."""
    out = boxes.clone()  # Python scalars: no tensor of offsets to copy to the device
    out[..., 0::2] -= px
    out[..., 1::2] -= py
    return out / scale


def match_detections(ref: Detections, got: Detections, iou_min: float = 0.9) -> dict:
    """Detection-level agreement of two runs on the same frames (a check,
    not part of inference). A valid detection of one run is matched when the
    other run has a valid detection of the same class at IoU >= iou_min in the
    same frame; its score gap is the least |score difference| among those.
    Returns the counts, ``share`` (the smaller of the two runs' matched
    fractions; 1.0 when neither has a detection) and ``max_score_gap`` over
    the matched detections of both runs."""
    ref = Detections(*(t.detach().cpu() for t in ref))
    got = Detections(*(t.detach().cpu() for t in got))
    counts = {"n_ref": 0, "n_got": 0, "matched_ref": 0, "matched_got": 0}
    gap = 0.0
    for f in range(ref.boxes.shape[0]):
        a, b = ref.valid[f], got.valid[f]
        boxes = torch.cat([ref.boxes[f][a], got.boxes[f][b]]).to(torch.float32)
        na = int(a.sum())
        iou = _iou_matrix(boxes)[:na, na:]
        ok = (iou >= iou_min) & (ref.classes[f][a][:, None] == got.classes[f][b][None, :])
        d = (ref.scores[f][a][:, None] - got.scores[f][b][None, :]).abs()
        d = torch.where(ok, d, torch.full_like(d, float("inf")))
        counts["n_ref"] += na
        counts["n_got"] += int(b.sum())
        counts["matched_ref"] += int(ok.any(1).sum())
        counts["matched_got"] += int(ok.any(0).sum())
        if bool(ok.any()):
            gap = max(gap, float(d.min(1).values[ok.any(1)].max()),
                      float(d.min(0).values[ok.any(0)].max()))
    share = min(counts["matched_ref"] / counts["n_ref"] if counts["n_ref"] else 1.0,
                counts["matched_got"] / counts["n_got"] if counts["n_got"] else 1.0)
    return dict(counts, share=share, max_score_gap=gap)
