"""The navigation map, the counterpart of ``rtvm_tpu/navigate/mapping.py``:
the obstacle masks on the image's device (``navigate/obstacles.py``), read
back in one copy; then on the host the red obstacle contours, the white
start marker (bottom centre), a green route to each building (the straight
line when it is clear, else the smoothed A* route, else a one-bend detour,
else a dotted line), the labels and the legend, drawn with ``utils/draw.py``.

The JAX package writes the labels and the legend with PIL's DejaVuSans; the
port draws them with its bitmap font (``draw.put_text_top``), which has the
legend's Cyrillic letters.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.io.jpeg import imwrite_jpg
from rtvm_tpu_torch.navigate.astar import find_path_astar, is_path_clear, smooth_path
from rtvm_tpu_torch.navigate.obstacles import obstacle_masks
from rtvm_tpu_torch.utils import contours as C
from rtvm_tpu_torch.utils import draw
from rtvm_tpu_torch.utils.image import draw_dotted_line

LEGEND = [
    ("Маршрут", (0, 255, 0)),
    ("Препятствия", (0, 0, 255)),
    ("Старт", (255, 255, 255)),
]


def analyze_for_navigation(
    image_bgr,
    detections: List[dict],
    start_point: Optional[Tuple[int, int]] = None,
    grid_scale: int = 4,
    dilate_size: int = 15,
    debug_dir: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """The rendered navigation map (BGR uint8 numpy) of a [H, W, 3] BGR
    uint8 image: numpy (moved to `device`, ``cuda`` unless given) or a
    tensor (used where it lies). debug_dir receives debug_texture_mask.jpg."""
    if isinstance(image_bgr, torch.Tensor):
        img, out = image_bgr, image_bgr.cpu().numpy().copy()
    else:
        out = np.array(image_bgr, dtype=np.uint8, copy=True)
        img = torch.from_numpy(out.copy()).to(resolve_device(device))
    h, w = out.shape[:2]
    m, nav, texture = obstacle_masks(img, detections, dilate_size)
    both = torch.stack([m, nav.to(torch.float32), texture.to(torch.float32)]).cpu().numpy()
    weights, nav_mask, texture = both[0], (both[1] > 0).astype(np.uint8), both[2] > 0

    if debug_dir:
        tex = texture.astype(np.uint8) * 255
        imwrite_jpg(os.path.join(debug_dir, "debug_texture_mask.jpg"),
                    np.repeat(tex[..., None], 3, axis=2))

    # red obstacle contours, with the reference's area gate
    for c in C.find_external_contours(weights > 0.3):
        if 20 < C.contour_area(c) < 500000:
            draw.draw_contours(out, [c], (0, 0, 255), 2)

    # start: bottom centre by default
    start = start_point or (w // 2, h - 30)
    draw.circle(out, start, 10, (255, 255, 255), -1)
    draw.circle(out, start, 10, (0, 0, 0), 2)

    for d in detections:
        if d.get("class") != "building":
            continue
        x1, y1, x2, y2 = [int(v) for v in d["bbox"]]
        goal = ((x1 + x2) // 2, min(y2 + 10, h - 1))
        if is_path_clear(nav_mask, start, goal):
            draw.line(out, start, goal, (0, 255, 0), 2)
            continue
        path = find_path_astar(nav_mask, start, goal, scale=grid_scale)
        if path is not None and len(path) >= 2:
            draw.polylines(out, [np.asarray(smooth_path(path), np.int32)], False, (0, 255, 0), 2)
        else:
            # one-bend midpoint detour, else a dotted direct line
            mid = ((start[0] + goal[0]) // 2, max((start[1] + goal[1]) // 2 - 50, 0))
            if is_path_clear(nav_mask, start, mid) and is_path_clear(nav_mask, mid, goal):
                draw.line(out, start, mid, (0, 255, 0), 2)
                draw.line(out, mid, goal, (0, 255, 0), 2)
            else:
                draw_dotted_line(out, start, goal, (0, 255, 0), 2)
        draw.put_text_top(out, d["class"], (x1, max(y1 - 18, 0)), (0, 255, 255))

    y0 = 24
    for label, colr in LEGEND:
        draw.rectangle(out, (10, y0 - 12), (26, y0 + 2), colr, -1)
        draw.put_text_top(out, label, (32, y0 - 12), (255, 255, 255))
        y0 += 22
    return out
