"""Classical (non-learned) aerial detectors, the counterpart of
``rtvm_tpu/detect/classical.py``: the watershed building detector and the
bright-blob vehicle detector.

The colour masks, thresholds and morphology run on the image's device; one
copy brings each detector's mask to the host, where the flooding and the
contour statistics run through ``utils/contours.py`` (cv2's algorithms,
without cv2). ``debug_path`` is written with the port's JPEG writer.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import scipy.ndimage as ndi
import torch

from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.io.jpeg import imwrite_jpg
from rtvm_tpu_torch.ops import color, filters
from rtvm_tpu_torch.utils import contours as C


def _image(image_bgr, device) -> torch.Tensor:
    if isinstance(image_bgr, torch.Tensor):
        return image_bgr
    return torch.from_numpy(np.ascontiguousarray(image_bgr)).to(resolve_device(device))


def _building_masks(img: torch.Tensor):
    """Device part of the building detector: the gray-roof HSV mask (opened)
    and the dilated strong-edge map, as bool [H, W]."""
    hsv = color.bgr2hsv(img)
    s, v = hsv[..., 1], hsv[..., 2]
    valid = torch.any(img > 0, dim=-1)
    roof = (s <= 50) & (v >= 60) & (v <= 220) & valid
    gray = color.bgr2gray(img)
    gx, gy = filters.sobel(filters.gaussian_blur(gray, 1.4))
    mag = torch.sqrt(gx * gx + gy * gy)
    # hysteresis-free Canny stand-in: strong edges dilated (reference dilates Canny x3)
    edges = filters.dilate((mag > 120).to(torch.float32), 3, iterations=3) > 0
    roof_clean = filters.morph_open(roof.to(torch.float32), 3, iterations=2) > 0
    return roof_clean, edges


def detect_buildings_classical(image_bgr, debug_path: Optional[str] = None,
                               device=None) -> List[dict]:
    """Gray-roof building candidates via mask -> watershed -> contour filters.
    `image_bgr` is a [H, W, 3] uint8 numpy array (moved to `device`, ``cuda``
    unless given) or a tensor (used where it lies). debug_path, when set,
    receives the separated-buildings mask."""
    img = _image(image_bgr, device)
    h, w = img.shape[:2]
    roof, edges = _building_masks(img)
    mask = ((roof & ~edges).to(torch.uint8) * 255).cpu().numpy()
    if debug_path:
        imwrite_jpg(debug_path, np.repeat(mask[..., None], 3, axis=2))

    # watershed split of touching roofs (host-side)
    dist = C.distance_transform(mask)
    fg = (dist > 0.3 * max(float(dist.max()), 1e-6)).astype(np.uint8)
    bg = ndi.maximum_filter(mask, size=7, mode="nearest")  # 3x3 dilation, 3 iterations
    unknown = (bg > 0) & (fg == 0)
    _, markers = C.connected_components(fg)
    markers = markers + 1
    markers[unknown] = 0
    markers = C.watershed(np.repeat(mask[..., None], 3, axis=2), markers)

    out = []
    max_area = 0.08 * h * w
    labels = np.maximum(markers, 0)
    areas = np.bincount(labels.ravel())
    boxes = ndi.find_objects(labels)  # each label's bounding slices: its contours lie inside
    for lbl in range(2, int(markers.max()) + 1):
        area = int(areas[lbl])
        if area < 400 or area > max_area:
            continue
        ys, xs = boxes[lbl - 1]
        cnts = C.find_external_contours(markers[ys, xs] == lbl)
        if not cnts:
            continue
        c = max(cnts, key=C.contour_area) + np.array([xs.start, ys.start], np.int32)
        x, y, bw, bh = C.bounding_rect(c)
        if min(bw, bh) < 15:
            continue
        rectangularity = area / max(bw * bh, 1)
        if rectangularity < 0.35:
            continue
        aspect = max(bw, bh) / max(min(bw, bh), 1)
        if aspect > 5:
            continue
        approx = C.approx_poly_dp(c, 0.02 * C.arc_length(c, True), True)
        if len(approx) < 4:
            continue
        conf = min(0.75, rectangularity * 0.5 + 0.2)
        out.append({"bbox": [int(x), int(y), int(x + bw), int(y + bh)], "class": "building",
                    "confidence": float(conf), "source": "classical"})
    return out


def _vehicle_mask(img: torch.Tensor) -> torch.Tensor:
    gray = color.bgr2gray(img)
    valid = gray > 10
    bright = (gray > 180) & valid
    m = filters.morph_close(bright.to(torch.float32), 3, iterations=2)
    m = filters.morph_open(m, 3, iterations=1)
    return m > 0


def detect_vehicles_classical(image_bgr, device=None) -> List[dict]:
    """Bright-blob vehicle candidates (area 150-8000, aspect 0.3-4, sides
    over 8 and under 150, extent over 0.5); the image as in
    detect_buildings_classical."""
    mask = _vehicle_mask(_image(image_bgr, device)).cpu().numpy()
    out = []
    for c in C.find_external_contours(mask):
        area = C.contour_area(c)
        if area < 150 or area > 8000:
            continue
        x, y, bw, bh = C.bounding_rect(c)
        aspect = bw / max(bh, 1)
        if aspect < 0.3 or aspect > 4:
            continue
        if min(bw, bh) <= 8 or max(bw, bh) >= 150:
            continue
        extent = area / max(bw * bh, 1)
        if extent <= 0.5:
            continue
        out.append({"bbox": [int(x), int(y), int(x + bw), int(y + bh)], "class": "car",
                    "confidence": float(0.3 + extent * 0.3), "source": "classical"})
    return out
