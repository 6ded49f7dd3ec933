"""Obstacle masks for the navigation map, the counterpart of
``rtvm_tpu/navigate/obstacles.py``: class-weighted detection buffers (host;
a handful of rectangles), the fire, smoke and texture-anomaly masks and the
navigation dilation (the image's device).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from rtvm_tpu_torch.detect.classes import OBSTACLE_GROUPS
from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.ops import color, filters

# (buffer px, weight) per obstacle group
GROUP_PARAMS = {
    "danger": (40, 1.0),
    "vehicle": (25, 0.9),
    "living": (20, 0.85),
    "static": (15, 0.7),
}


def detection_obstacle_mask(shape: Tuple[int, int], detections: List[dict]) -> np.ndarray:
    """Rasterize detection boxes with class-dependent buffers scaled by the
    object's size. Returns float32 [H, W] weights in [0, 1]."""
    h, w = shape
    mask = np.zeros((h, w), np.float32)
    for d in detections:
        cls = d.get("class", "")
        grp = next((g for g, classes in OBSTACLE_GROUPS.items() if cls in classes), None)
        if grp is None:
            continue
        buf, weight = GROUP_PARAMS[grp]
        x1, y1, x2, y2 = [int(v) for v in d["bbox"]]
        area = max((x2 - x1) * (y2 - y1), 1)
        scale = float(np.clip(np.sqrt(area) / 100.0, 0.5, 2.0))
        b = int(buf * scale)
        xa, ya = max(x1 - b, 0), max(y1 - b, 0)
        xb, yb = min(x2 + b, w), min(y2 + b, h)
        mask[ya:yb, xa:xb] = np.maximum(mask[ya:yb, xa:xb], weight)
    return mask


def color_texture_masks(img: torch.Tensor):
    """Fire, smoke and texture-anomaly bool masks of a [H, W, 3] BGR uint8
    image. Fire: three hue bands with high saturation and brightness, or BGR
    dominance. Smoke: low-saturation bright gray with a low local standard
    deviation (11x11). Texture: |gray - blur| > 6 inside the eroded valid
    area."""
    imgf = img.to(torch.float32)
    hsv = color.bgr2hsv(imgf)
    hch, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    b, g, r = imgf[..., 0], imgf[..., 1], imgf[..., 2]
    valid = torch.any(imgf > 10.0, dim=-1)

    fire_h = (hch <= 10) | (hch >= 170) | ((hch >= 11) & (hch <= 25)) | ((hch >= 26) & (hch <= 35))
    fire_hsv = fire_h & (s > 120) & (v > 150)
    fire_bgr = ((r > 180) & (r > g * 1.5) & (r > b * 1.8)) | ((r > 200) & (g > 120) & (b < 100))
    fire = (fire_hsv | fire_bgr) & valid

    gray = color.bgr2gray(imgf)
    local_mean = filters.box_blur(gray, 11)
    local_sq = filters.box_blur(gray * gray, 11)
    local_std = torch.sqrt(torch.clamp(local_sq - local_mean**2, min=0.0))
    grayish = ((r - g).abs() < 25) & ((g - b).abs() < 25) & ((r - b).abs() < 25)
    smoke_hsv = ((s < 40) & (v > 100) & (v < 220)) | ((s < 60) & (v > 140))
    smoke = (smoke_hsv | grayish) & (gray > 70) & (local_std < 12.0) & valid

    texture = ((gray - filters.gaussian_blur(gray, 2.0, 5)).abs() > 6.0) & (
        filters.erode(valid.to(torch.float32), 5) > 0)
    return fire, smoke, texture


def combine_and_dilate(det_mask: torch.Tensor, fire: torch.Tensor, smoke: torch.Tensor,
                       texture: torch.Tensor, dilate_size: int = 15):
    """(obstacle weights, navigation-blocked mask): the union of the sources
    (fire 1.0, smoke 0.8, texture 0.5, detections by class), and its > 0.3
    part dilated for clearance."""
    m = torch.maximum(det_mask, fire.to(torch.float32))
    m = torch.maximum(m, smoke.to(torch.float32) * 0.8)
    m = torch.maximum(m, texture.to(torch.float32) * 0.5)
    nav = filters.dilate((m > 0.3).to(torch.float32), dilate_size)
    return m, nav > 0


def obstacle_masks(img: torch.Tensor, detections: List[dict], dilate_size: int = 15):
    """(obstacle weights, nav_blocked, texture) of a [H, W, 3] BGR uint8
    tensor, on its device."""
    det_mask = torch.from_numpy(detection_obstacle_mask(tuple(img.shape[:2]), detections))
    fire, smoke, texture = color_texture_masks(img)
    m, nav = combine_and_dilate(det_mask.to(img.device), fire, smoke, texture, dilate_size)
    return m, nav, texture


def build_obstacle_masks(image_bgr, detections: List[dict], dilate_size: int = 15, device=None):
    """The whole mask pipeline on `image_bgr` (numpy, moved to `device`,
    ``cuda`` unless given; or a tensor, used where it lies). Returns
    (obstacle_weights [H, W] float32, nav_blocked [H, W] bool) as numpy."""
    img = image_bgr if isinstance(image_bgr, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(image_bgr)).to(resolve_device(device))
    m, nav, _ = obstacle_masks(img, detections, dilate_size)
    both = torch.stack([m, nav.to(torch.float32)]).cpu().numpy()  # one copy
    return both[0], both[1] > 0
