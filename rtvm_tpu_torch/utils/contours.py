"""Host-side contour and region algorithms in place of cv2's (the card has
no cv2), on numpy and scipy, with the per-pixel loops in the port's host C++
(``csrc_host/contours.cpp``, loaded by ``navigate/native.py``). Each returns
what the cv2 call it replaces returns for the same input:

- ``connected_components``: cv2.connectedComponents (8-connectivity), labels
  numbered as cv2's block-based scan meets the components (2x2 blocks in
  raster order);
- ``find_external_contours``: cv2.findContours with RETR_EXTERNAL and
  CHAIN_APPROX_SIMPLE, [N, 2] int32 (x, y) points per contour, in cv2's
  order;
- ``contour_area`` (the shoelace formula over the points), ``bounding_rect``,
  ``arc_length`` and ``approx_poly_dp`` (Douglas-Peucker as cv2 runs it on a
  closed curve);
- ``distance_transform``: cv2.distanceTransform with DIST_L2 and mask 5 (the
  5x5 chamfer, not the exact distance);
- ``watershed``: cv2.watershed's marker flooding, -1 on the boundaries.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import scipy.ndimage as ndi

from rtvm_tpu_torch.navigate import native


def connected_components(mask: np.ndarray) -> Tuple[int, np.ndarray]:
    """(label count including the background, int32 [H, W] labels) of the
    nonzero pixels, 8-connected, as cv2.connectedComponents numbers them."""
    lab, n = ndi.label(np.asarray(mask) != 0, structure=np.ones((3, 3), bool))
    if n == 0:
        return 1, lab.astype(np.int32)
    ys, xs = np.nonzero(lab)
    first = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, lab[ys, xs], (ys // 2) * ((lab.shape[1] + 1) // 2) + xs // 2)
    remap = np.zeros(n + 1, np.int32)
    remap[1 + np.argsort(first[1:], kind="stable")] = np.arange(1, n + 1, dtype=np.int32)
    return n + 1, remap[lab]


def find_external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """The outer borders of the nonzero regions that lie in no hole, each
    [N, 2] int32 (x, y) with only the end points of straight runs."""
    m = np.ascontiguousarray(np.asarray(mask) != 0, dtype=np.uint8)
    h, w = m.shape
    lib = native.library()
    pts_p, ends_p, n_pts = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int64()
    n = lib.rtvm_external_contours(m.ctypes.data, h, w, ctypes.byref(pts_p),
                                   ctypes.byref(n_pts), ctypes.byref(ends_p))
    if n < 0:
        raise MemoryError("rtvm_external_contours: out of memory")
    try:
        pts = np.ctypeslib.as_array(ctypes.cast(pts_p, ctypes.POINTER(ctypes.c_int32)),
                                    (max(n_pts.value, 1) * 2,))[: n_pts.value * 2].copy()
        ends = np.ctypeslib.as_array(ctypes.cast(ends_p, ctypes.POINTER(ctypes.c_int64)),
                                     (max(n, 1),))[:n].copy()
    finally:
        lib.rtvm_free(pts_p)
        lib.rtvm_free(ends_p)
    pts = pts.reshape(-1, 2)
    starts = np.concatenate([[0], ends[:-1]]) if n else ends
    return [pts[a:b] for a, b in zip(starts, ends)][::-1]  # cv2 lists them last found first


def contour_area(c: np.ndarray) -> float:
    """cv2.contourArea: |shoelace sum| / 2 over the points as a closed polygon."""
    p = np.asarray(c, np.float64).reshape(-1, 2)
    if len(p) < 3:
        return 0.0
    q = np.roll(p, 1, axis=0)
    return float(abs(np.sum(q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0])) * 0.5)


def bounding_rect(c: np.ndarray) -> Tuple[int, int, int, int]:
    """cv2.boundingRect of integer points: (x, y, w, h) with w, h inclusive."""
    p = np.asarray(c).reshape(-1, 2)
    x0, y0 = p.min(0)
    x1, y1 = p.max(0)
    return int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1)


def arc_length(c: np.ndarray, closed: bool = True) -> float:
    """cv2.arcLength: the sum of the segment lengths (float32 each, as cv2
    computes them), with the closing segment when `closed`."""
    p = np.asarray(c, np.float32).reshape(-1, 2)
    if len(p) < 2:
        return 0.0
    d = np.diff(np.concatenate([p[-1:], p]) if closed else p, axis=0)
    return float(np.sum(np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]), dtype=np.float64))


def _segment_dist2(pt, a, b, dx, dy, seg2) -> float:
    """Squared distance of pt to the segment a-b (to its nearer end when
    the projection falls outside it)."""
    px, py = pt[0] - a[0], pt[1] - a[1]
    dot = px * dx + py * dy
    if seg2 == 0 or dot <= 0:
        return float(px * px + py * py)
    if dot >= seg2:
        qx, qy = pt[0] - b[0], pt[1] - b[1]
        return float(qx * qx + qy * qy)
    cross = py * dx - px * dy
    return cross * cross / seg2


def approx_poly_dp(c: np.ndarray, epsilon: float, closed: bool = True) -> np.ndarray:
    """cv2.approxPolyDP of integer points: Douglas-Peucker with cv2's start
    (on a closed curve, the farthest point from the first, found three
    times over), its stack order and its final pass that drops a middle
    point lying within sqrt(0.5) * epsilon of a slanted chord."""
    src = [tuple(int(v) for v in p) for p in np.asarray(c).reshape(-1, 2)]
    count = len(src)
    if count == 0:
        return np.zeros((0, 2), np.int32)
    eps = epsilon * epsilon
    dst: List[Tuple[int, int]] = []
    stack: List[Tuple[int, int]] = []
    is_closed = closed
    start_pt = (-1000000, -1000000)
    init_iters = 3
    if not is_closed:
        if src[-1] != src[0]:
            stack.append((0, count - 1))
        else:
            is_closed, init_iters = True, 1
    pos = 0
    if is_closed:
        right_start = 0
        le_eps = False
        for _ in range(init_iters):
            pos = (pos + right_start) % count
            start_pt = src[pos]
            pos = (pos + 1) % count
            max_dist = 0.0
            for j in range(1, count):
                pt = src[pos]
                pos = (pos + 1) % count
                dx, dy = pt[0] - start_pt[0], pt[1] - start_pt[1]
                dist = float(dx * dx + dy * dy)
                if dist > max_dist:
                    max_dist = dist
                    right_start = j
            le_eps = max_dist <= eps
        if not le_eps:
            s0 = pos % count
            s1 = (right_start + s0) % count
            stack.append((s1, s0))  # right slice
            stack.append((s0, s1))
        else:
            dst.append(start_pt)
    while stack:
        s0, s1 = stack.pop()
        end_pt = src[s1]
        pos = s0
        start_pt = src[pos]
        pos = (pos + 1) % count
        if pos != s1:
            dx, dy = end_pt[0] - start_pt[0], end_pt[1] - start_pt[1]
            seg2 = dx * dx + dy * dy
            max_dist, right_start = 0.0, s0
            while pos != s1:
                pt = src[pos]
                pos = (pos + 1) % count
                dist = _segment_dist2(pt, start_pt, end_pt, dx, dy, seg2)
                if dist > max_dist:
                    max_dist = dist
                    right_start = (pos + count - 1) % count
            le_eps = max_dist <= eps
        else:
            le_eps = True
            start_pt = src[s0]
        if le_eps:
            dst.append(start_pt)
        else:
            stack.append((right_start, s1))
            stack.append((s0, right_start))
    if not is_closed:
        dst.append(src[-1])

    # drop the middle point of nearly straight triples
    is_closed = closed
    count = new_count = len(dst)
    pos = count - 1 if is_closed else 0
    start_pt = dst[pos]
    pos = (pos + 1) % count
    wpos = pos
    pt = dst[pos]
    pos = (pos + 1) % count
    i = 0 if is_closed else 1
    while i < count - (0 if is_closed else 1) and new_count > 2:
        end_pt = dst[pos]
        pos = (pos + 1) % count
        dx, dy = end_pt[0] - start_pt[0], end_pt[1] - start_pt[1]
        dist = abs((pt[0] - start_pt[0]) * dy - (pt[1] - start_pt[1]) * dx)
        inner = (pt[0] - start_pt[0]) * (end_pt[0] - pt[0]) + (pt[1] - start_pt[1]) * (end_pt[1] - pt[1])
        if dist * dist <= 0.5 * eps * (dx * dx + dy * dy) and dx != 0 and dy != 0 and inner >= 0:
            new_count -= 1
            dst[wpos] = start_pt = end_pt
            wpos = (wpos + 1) % count
            pt = dst[pos]
            pos = (pos + 1) % count
            i += 2
            continue
        dst[wpos] = start_pt = pt
        wpos = (wpos + 1) % count
        pt = end_pt
        i += 1
    if not is_closed:
        dst[wpos] = pt
    return np.asarray(dst[:new_count], np.int32).reshape(-1, 2)


def distance_transform(mask: np.ndarray) -> np.ndarray:
    """cv2.distanceTransform(mask, DIST_L2, 5): float32 [H, W] distance of
    each nonzero pixel to the nearest zero pixel by the 5x5 chamfer."""
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    out = np.empty(m.shape, np.float32)
    native.library().rtvm_distance_l2_5x5(m.ctypes.data, m.shape[0], m.shape[1], out.ctypes.data)
    return out


def watershed(image_bgr: np.ndarray, markers: np.ndarray) -> np.ndarray:
    """cv2.watershed(image, markers) on a copy: int32 [H, W] labels, -1 on
    the boundaries between basins and on the one-pixel frame."""
    img = np.ascontiguousarray(image_bgr, dtype=np.uint8)
    out = np.array(markers, dtype=np.int32, order="C")
    if img.shape[:2] != out.shape or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"watershed: image {img.shape} and markers {out.shape} do not fit")
    native.library().rtvm_watershed(img.ctypes.data, out.shape[0], out.shape[1], out.ctypes.data)
    return out
