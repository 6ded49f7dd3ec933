"""Synthetic aerial scenes for YOLO training: the port's copy of
``rtvm_tpu/models/yolo/synth.py``, drawn without cv2.

Top-down scenes composited from a background (a crop of the reference's
drone clips where they exist and can be decoded, else a procedural ground
texture) and rendered objects of the aerial classes (person, car, truck,
bus, building, boat, tent, pool). Every draw from the ``RandomState``
happens in the JAX module's order, so a seed gives the same scenes, and
the boxes come from the same polygon geometry, so they are identical. The
pixels are drawn by ``utils/draw.py`` (cv2's ``fillPoly``, ``ellipse``,
``line``, ``polylines``, ``circle``, ``addWeighted`` and ``GaussianBlur``
in numpy); they equal cv2's but for a few pixels on the image's border
where a polygon leaves it.

The clips are looked for in ``Data/*.mp4`` of the working directory (the
reference's clip folder; the JAX module looks in the reference checkout's
absolute path) and are read only where ``io/video.py`` can decode them,
that is where cv2 is installed. This is host-side data generation; the
training math runs in ``train.py`` on the card.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from rtvm_tpu_torch.utils import draw

AERIAL_CLASSES = ["person", "car", "truck", "bus", "building", "boat", "tent", "pool"]

_DATA_GLOB = os.path.join("Data", "*.mp4")


def _rot_rect_pts(cx, cy, w, h, ang):
    c, s = np.cos(ang), np.sin(ang)
    pts = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]])
    r = pts @ np.array([[c, -s], [s, c]]).T + [cx, cy]
    return r.astype(np.int32)


def _jitter_color(rng, base, spread=25):
    return tuple(int(np.clip(b + rng.randint(-spread, spread + 1), 0, 255)) for b in base)


def _draw_shadow(img, pts, offset=(2, 3)):
    sh = pts + np.asarray(offset)
    overlay = img.copy()
    draw.fill_poly(overlay, [sh], (20, 20, 20))
    # cv2.addWeighted(overlay, 0.35, img, 0.65, 0, img); a pixel the fill
    # left alone keeps its value, so only the polygon's box is blended
    (x0, y0), (x1, y1) = np.maximum(sh.min(0), 0), sh.max(0) + 1
    img[y0:y1, x0:x1] = draw.add_weighted(overlay[y0:y1, x0:x1], 0.35, img[y0:y1, x0:x1], 0.65, 0)


def _render_vehicle(rng, img, cx, cy, length, width, kind):
    ang = rng.rand() * np.pi
    body_colors = {
        "car": [(200, 200, 200), (40, 40, 45), (30, 30, 160), (150, 60, 30), (60, 130, 60), (230, 230, 235)],
        "truck": [(220, 220, 225), (180, 180, 190), (40, 60, 160), (200, 160, 60)],
        "bus": [(40, 160, 220), (30, 180, 180), (60, 60, 200), (220, 220, 100)],
    }[kind]
    color = _jitter_color(rng, body_colors[rng.randint(len(body_colors))])
    pts = _rot_rect_pts(cx, cy, length, width, ang)
    _draw_shadow(img, pts)
    draw.fill_poly(img, [pts], color)
    # windshield / roof details along the axis
    c, s = np.cos(ang), np.sin(ang)
    if kind == "car":
        wcx, wcy = cx + c * length * 0.18, cy + s * length * 0.18
        wpts = _rot_rect_pts(wcx, wcy, length * 0.28, width * 0.78, ang)
        draw.fill_poly(img, [wpts], _jitter_color(rng, (60, 50, 40), 15))
    elif kind == "truck":
        # cab (short, front) + trailer (long, lighter)
        ccx, ccy = cx + c * length * 0.36, cy + s * length * 0.36
        cpts = _rot_rect_pts(ccx, ccy, length * 0.22, width, ang)
        draw.fill_poly(img, [cpts], _jitter_color(rng, (50, 60, 80), 20))
    else:  # bus: roof hatches
        for t in (-0.25, 0.0, 0.25):
            hx, hy = cx + c * length * t, cy + s * length * t
            hpts = _rot_rect_pts(hx, hy, length * 0.12, width * 0.5, ang)
            draw.fill_poly(img, [hpts], _jitter_color(rng, (90, 90, 90), 15))
    draw.polylines(img, [pts], True, tuple(int(v * 0.6) for v in color), 1)
    xs, ys = pts[:, 0], pts[:, 1]
    return [int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())]


def _render_person(rng, img, cx, cy, size):
    body = _jitter_color(rng, [(160, 60, 60), (60, 60, 170), (60, 150, 60), (200, 200, 200)][rng.randint(4)])
    ang = rng.rand() * 180.0
    ax1, ax2 = max(2, int(size * 0.55)), max(1, int(size * 0.3))
    draw.ellipse(img, (int(cx + 1), int(cy + 2)), (ax1, ax2), ang, 0, 360, (25, 25, 25), -1)
    draw.ellipse(img, (int(cx), int(cy)), (ax1, ax2), ang, 0, 360, body, -1)
    head = _jitter_color(rng, (150, 120, 110), 30)
    draw.circle(img, (int(cx), int(cy)), max(1, int(size * 0.22)), head, -1)
    r = max(ax1, ax2) + 1
    return [int(cx - r), int(cy - r), int(cx + r), int(cy + r)]


def _render_building(rng, img, cx, cy, w, h):
    ang = rng.rand() * np.pi / 2
    roof_colors = [(110, 110, 115), (70, 70, 75), (140, 140, 145), (40, 60, 140), (60, 80, 100), (90, 120, 140)]
    color = _jitter_color(rng, roof_colors[rng.randint(len(roof_colors))], 12)
    pts = _rot_rect_pts(cx, cy, w, h, ang)
    _draw_shadow(img, pts, offset=(4, 6))
    draw.fill_poly(img, [pts], color)
    # gable ridge line + panel texture
    c, s = np.cos(ang), np.sin(ang)
    p1 = (int(cx - c * w * 0.45), int(cy - s * w * 0.45))
    p2 = (int(cx + c * w * 0.45), int(cy + s * w * 0.45))
    draw.line(img, p1, p2, tuple(int(v * 1.25) % 256 for v in color), 2)
    for t in np.linspace(-0.4, 0.4, rng.randint(2, 5)):
        q1 = (int(cx + c * w * t - -s * h * 0.45), int(cy + s * w * t - c * h * 0.45))
        q2 = (int(cx + c * w * t + -s * h * 0.45), int(cy + s * w * t + c * h * 0.45))
        draw.line(img, q1, q2, tuple(int(v * 0.85) for v in color), 1)
    draw.polylines(img, [pts], True, tuple(int(v * 0.55) for v in color), 2)
    xs, ys = pts[:, 0], pts[:, 1]
    return [int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())]


def _render_boat(rng, img, cx, cy, length):
    ang = rng.rand() * np.pi
    width = length * (0.3 + rng.rand() * 0.15)
    # water patch under the boat
    draw.ellipse(img, (int(cx), int(cy)), (int(length * 1.6), int(width * 3.2)),
                 np.degrees(ang), 0, 360, _jitter_color(rng, (120, 80, 30), 20), -1)
    hull = _jitter_color(rng, [(230, 230, 230), (200, 200, 210), (50, 50, 150)][rng.randint(3)])
    pts = _rot_rect_pts(cx, cy, length, width, ang)
    # pointed bow
    c, s = np.cos(ang), np.sin(ang)
    bow = np.array([[int(cx + c * length * 0.75), int(cy + s * length * 0.75)]])
    poly = np.vstack([pts[:2], bow, pts[2:]]).astype(np.int32)
    draw.fill_poly(img, [poly], hull)
    xs, ys = poly[:, 0], poly[:, 1]
    return [int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())]


def _render_tent(rng, img, cx, cy, size):
    color = _jitter_color(rng, [(40, 170, 220), (50, 180, 80), (30, 100, 220), (160, 120, 40)][rng.randint(4)])
    ang = rng.rand() * np.pi
    pts = _rot_rect_pts(cx, cy, size, size * 0.8, ang)
    _draw_shadow(img, pts)
    draw.fill_poly(img, [pts], color)
    c, s = np.cos(ang), np.sin(ang)
    draw.line(img, (int(cx - c * size * 0.45), int(cy - s * size * 0.45)),
              (int(cx + c * size * 0.45), int(cy + s * size * 0.45)),
              tuple(int(v * 1.4) % 256 for v in color), 1)
    xs, ys = pts[:, 0], pts[:, 1]
    return [int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())]


def _render_pool(rng, img, cx, cy, w, h):
    color = _jitter_color(rng, (200, 160, 40), 20)  # BGR bright blue water
    if rng.rand() < 0.5:
        draw.ellipse(img, (int(cx), int(cy)), (int(w / 2), int(h / 2)), 0, 0, 360, color, -1)
        draw.ellipse(img, (int(cx), int(cy)), (int(w / 2), int(h / 2)), 0, 0, 360, (220, 220, 220), 1)
        return [int(cx - w / 2) - 1, int(cy - h / 2) - 1, int(cx + w / 2) + 1, int(cy + h / 2) + 1]
    pts = _rot_rect_pts(cx, cy, w, h, 0.0)
    draw.fill_poly(img, [pts], color)
    draw.polylines(img, [pts], True, (220, 220, 220), 1)
    xs, ys = pts[:, 0], pts[:, 1]
    return [int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())]


class BackgroundPool:
    """Random crops from the reference's drone clips; the procedural ground
    texture when there are none (on the card, where no clip decodes, and in
    the tests)."""

    def __init__(self, size: int, n_frames: int = 24, rng: Optional[np.random.RandomState] = None):
        from rtvm_tpu_torch.io.video import SeekableVideo

        self.size = size
        self.frames: List[np.ndarray] = []
        rng = rng or np.random.RandomState(0)
        try:
            for path in sorted(glob.glob(_DATA_GLOB))[:4]:
                video = SeekableVideo(path)
                total = video.frame_count or 1
                for _ in range(n_frames // 4 + 1):
                    fr = video.read(rng.randint(max(total, 1)))
                    if fr is not None and min(fr.shape[:2]) >= size:
                        self.frames.append(fr)
                video.close()
        except ImportError:  # no decoder here: procedural backgrounds only
            pass

    def sample(self, rng: np.random.RandomState) -> np.ndarray:
        if self.frames and rng.rand() < 0.8:
            fr = self.frames[rng.randint(len(self.frames))]
            h, w = fr.shape[:2]
            y0 = rng.randint(h - self.size + 1)
            x0 = rng.randint(w - self.size + 1)
            out = fr[y0 : y0 + self.size, x0 : x0 + self.size].copy()
        else:
            out = self._procedural(rng)
        if rng.rand() < 0.3:  # brightness jitter
            out = np.clip(out.astype(np.int16) + rng.randint(-30, 31), 0, 255).astype(np.uint8)
        return out

    def _procedural(self, rng) -> np.ndarray:
        s = self.size
        base = np.array(
            [(40, 70, 55), (50, 90, 95), (85, 85, 85), (60, 95, 120)][rng.randint(4)], np.float32
        )
        img = np.clip(base[None, None] + rng.randn(s, s, 3) * 12, 0, 255).astype(np.uint8)
        img = draw.gaussian_blur_u8(img, 1.5)
        if rng.rand() < 0.6:  # a road
            p1 = (rng.randint(s), 0)
            p2 = (rng.randint(s), s - 1)
            draw.line(img, p1, p2, (90, 90, 95), rng.randint(10, 26))
        return img


def make_scene(
    rng: np.random.RandomState,
    bg: BackgroundPool,
    size: int = 320,
    max_objects: int = 12,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One composited scene: (img BGR uint8 [S, S, 3], boxes [M, 4] xyxy,
    classes [M] int32) with M <= max_objects (unpadded)."""
    img = bg.sample(rng)
    boxes, classes = [], []
    n = rng.randint(2, max_objects + 1)
    occupied: List[List[int]] = []

    def overlaps(b):
        for o in occupied:
            if not (b[2] < o[0] or o[2] < b[0] or b[3] < o[1] or o[3] < b[1]):
                return True
        return False

    for _ in range(n):
        cls = rng.randint(len(AERIAL_CLASSES))
        name = AERIAL_CLASSES[cls]
        for _attempt in range(6):
            if name == "building":
                # the ranges of the 320 px training size; shrunk on tiny
                # scenes so the placement range stays non-empty
                w = rng.randint(min(36, size // 4), max(min(36, size // 4) + 1, min(110, size // 2)))
                h = rng.randint(min(30, size // 4), max(min(30, size // 4) + 1, min(100, size // 2)))
                m = max(w, h)
                cx, cy = rng.randint(m // 2 + 2, size - m // 2 - 2, 2)
                b = _render_building(rng, img, cx, cy, w, h) if not overlaps(
                    [cx - m, cy - m, cx + m, cy + m]
                ) else None
            elif name in ("car", "truck", "bus"):
                length = {"car": rng.randint(14, 30), "truck": rng.randint(26, 48), "bus": rng.randint(24, 42)}[name]
                width = int(length * (0.42 if name == "car" else 0.3 + rng.rand() * 0.1))
                m = length
                cx, cy = rng.randint(m // 2 + 2, size - m // 2 - 2, 2)
                b = _render_vehicle(rng, img, cx, cy, length, width, name) if not overlaps(
                    [cx - m, cy - m, cx + m, cy + m]
                ) else None
            elif name == "person":
                sz = rng.randint(5, 11)
                cx, cy = rng.randint(sz + 2, size - sz - 2, 2)
                b = _render_person(rng, img, cx, cy, sz) if not overlaps(
                    [cx - sz * 2, cy - sz * 2, cx + sz * 2, cy + sz * 2]
                ) else None
            elif name == "boat":
                # the margin is length + 4 a side: clamped so tiny scenes
                # keep a non-empty placement range
                length = rng.randint(12, max(13, min(40, size // 2 - 5)))
                cx, cy = rng.randint(length + 4, size - length - 4, 2)
                b = _render_boat(rng, img, cx, cy, length) if not overlaps(
                    [cx - length * 2, cy - length * 2, cx + length * 2, cy + length * 2]
                ) else None
            elif name == "tent":
                sz = rng.randint(10, 24)
                cx, cy = rng.randint(sz + 2, size - sz - 2, 2)
                b = _render_tent(rng, img, cx, cy, sz) if not overlaps(
                    [cx - sz, cy - sz, cx + sz, cy + sz]
                ) else None
            else:  # pool
                w, h = rng.randint(16, 44), rng.randint(12, 36)
                m = max(w, h)
                cx, cy = rng.randint(m // 2 + 2, size - m // 2 - 2, 2)
                b = _render_pool(rng, img, cx, cy, w, h) if not overlaps(
                    [cx - m, cy - m, cx + m, cy + m]
                ) else None
            if b is not None:
                b = [max(0, b[0]), max(0, b[1]), min(size - 1, b[2]), min(size - 1, b[3])]
                if b[2] - b[0] >= 3 and b[3] - b[1] >= 3:
                    boxes.append(b)
                    classes.append(cls)
                    occupied.append(b)
                break
    if rng.rand() < 0.5:  # sensor noise
        img = np.clip(img.astype(np.int16) + rng.randn(*img.shape) * 4, 0, 255).astype(np.uint8)
    return img, np.asarray(boxes, np.float32).reshape(-1, 4), np.asarray(classes, np.int32)


def make_batch(
    rng: np.random.RandomState, bg: BackgroundPool, batch: int, size: int = 320, max_targets: int = 16
):
    """Padded training batch: (images [B, S, S, 3] uint8, boxes [B, M, 4],
    classes [B, M], valid [B, M])."""
    imgs = np.zeros((batch, size, size, 3), np.uint8)
    boxes = np.zeros((batch, max_targets, 4), np.float32)
    cls = np.zeros((batch, max_targets), np.int32)
    valid = np.zeros((batch, max_targets), bool)
    for i in range(batch):
        img, b, c = make_scene(rng, bg, size)
        m = min(len(b), max_targets)
        imgs[i] = img
        boxes[i, :m] = b[:m]
        cls[i, :m] = c[:m]
        valid[i, :m] = True
    return imgs, boxes, cls, valid
