"""RT-DETR's NMS-free post-process: one detection a query, as Ultralytics'
``RTDETRPredictor.postprocess`` makes it (the largest class's sigmoid, kept
above ``conf``, cx-cy-w-h to x-y-x-y), read from the heads ``model.py``
returns, into the port's fixed ``Detections`` [B, num_queries].

It reads only that layout: the selection map gives the selected cells
(a top-k of the 0/1 map, fixed-size, no host read), and their last-layer
box and class logits are gathered there. So it runs the same on any model
that writes the layout, the benchmark's plain reference included.
"""

from __future__ import annotations

from typing import Sequence

import torch

from rtvm_tpu_torch.models.yolo.postprocess import Detections


def select_detections(box: Sequence[torch.Tensor], cls: Sequence[torch.Tensor],
                      num_queries: int, imgsz, conf: float) -> Detections:
    """Heads per level (box [B, 8, h, w], cls [B, 2C + 1, h, w]) ->
    Detections of [B, num_queries] in the letterboxed input's pixels (imgsz:
    a side, or (rows, cols)); a slot is valid where its score exceeds conf,
    and its score is 0 otherwise."""
    th, tw = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
    nc = (cls[0].shape[1] - 1) // 2
    sel = torch.cat([c[:, 2 * nc].flatten(1) for c in cls], 1)  # [B, A]
    idx = torch.topk(sel, num_queries, dim=1).indices  # the selected cells, in any order
    dec_cls = torch.cat([c[:, nc : 2 * nc].flatten(2) for c in cls], 2)  # [B, C, A]
    dec_box = torch.cat([b[:, 4:].flatten(2) for b in box], 2)  # [B, 4, A]
    logits = dec_cls.gather(2, idx[:, None].expand(-1, nc, -1))  # [B, C, Q]
    cxcywh = torch.sigmoid(dec_box.gather(2, idx[:, None].expand(-1, 4, -1)))  # [B, 4, Q]
    score, label = torch.sigmoid(logits).max(1)
    cx, cy, w, h = cxcywh.unbind(1)
    boxes = torch.stack([(cx - w / 2) * tw, (cy - h / 2) * th, (cx + w / 2) * tw,
                         (cy + h / 2) * th], -1)
    valid = score > conf
    return Detections(boxes=boxes, scores=torch.where(valid, score, torch.zeros_like(score)),
                      classes=label.to(torch.int32), valid=valid)
