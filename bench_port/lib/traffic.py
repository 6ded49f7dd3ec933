"""The traffic: a textured world and a camera that orbits over it, made from
the seed.

``make_world`` (with ``_blur_axis``) and ``make_stream_world`` are frozen
copies of ``chip_smoke.py``'s generators as they stood when the benchmark was
written: the port's smoke test may change them, this file does not.
``orbit`` is the benchmark's own: a closed ellipse of even integer crop
origins, so every frame is an exact crop of the world and a whole number of
windows brings the camera back to where it started.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def _blur_axis(a: np.ndarray, sigma: float, axis: int) -> np.ndarray:
    """Frozen copy of ``chip_smoke.py:_blur_axis``."""
    r = max(1, int(math.ceil(3 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    taps = np.exp(-(x**2) / (2 * sigma**2))
    taps /= taps.sum()
    pad = [(0, 0)] * a.ndim
    pad[axis] = (r, r)
    p = np.pad(a, pad, mode="edge")
    n = a.shape[axis]
    return sum(t * np.take(p, np.arange(i, i + n), axis=axis) for i, t in enumerate(taps))


def make_world(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """Frozen copy of ``chip_smoke.py:make_world``: a textured BGR uint8
    world, blurred noise at two scales plus random filled rectangles
    (corners and blobs for SIFT at every octave)."""
    img = rng.uniform(0, 255, (h, w, 3))
    img = _blur_axis(_blur_axis(img, 1.0, 0), 1.0, 1)
    coarse = rng.uniform(0, 255, (h // 16 + 2, w // 16 + 2, 3))
    coarse = np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:h, :w]
    coarse = _blur_axis(_blur_axis(coarse, 6.0, 0), 6.0, 1)
    img = 0.6 * img + 0.4 * coarse
    for _ in range(h * w // 900):
        y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
        dy, dx = rng.randint(6, 40), rng.randint(6, 40)
        img[y : y + dy, x : x + dx] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_stream_world(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """Frozen copy of ``chip_smoke.py:make_stream_world``: make_world at a
    third of the size, upsampled 3x (bilinear), with sparse sharp rectangles
    at full size."""
    base = make_world(rng, h // 3 + 2, w // 3 + 2)
    up = torch.nn.functional.interpolate(torch.from_numpy(base).permute(2, 0, 1)[None].float(),
                                         scale_factor=3, mode="bilinear", align_corners=False)
    img = up[0].permute(1, 2, 0).numpy()[:h, :w].copy()
    for _ in range(h * w // 12000):
        y, x = rng.randint(0, h - 90), rng.randint(0, w - 90)
        img[y : y + rng.randint(12, 90), x : x + rng.randint(12, 90)] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


WORLDS = {"make_world": make_world, "make_stream_world": make_stream_world}


def orbit(period: int, semi_axes: Tuple[float, float]) -> np.ndarray:
    """[period, 2] integer (dx, dy) offsets of frames 0..period-1 from frame
    0: an ellipse with semi-axes (ax, ay) px, frame 0 at its lowest point,
    every offset rounded to an even number (an odd step biases SIFT's coarse
    octaves, ROADMAP Queue 3 item 3). Frame `period` is frame 0 again."""
    ax, ay = semi_axes
    t = 2.0 * np.pi * np.arange(period) / period
    dx = ax * np.sin(t)
    dy = ay * (np.cos(t) - 1.0)  # up is -y: the camera climbs from frame 0
    even = lambda v: 2 * np.round(v / 2.0)  # noqa: E731
    return np.stack([even(dx), even(dy)], -1).astype(np.int64)


def make_orbit(seed: int, frame_hw: Tuple[int, int], mix: Dict) -> Dict:
    """One orbit of frames from the seed: the world, the offsets and the
    [period, H, W, 3] uint8 BGR frames, as a decoder hands them over.
    `mix` gives the world's generator, the period in windows, the window
    size and the semi-axes in frame heights."""
    h, w = frame_hw
    period = int(mix["period_windows"]) * int(mix["window_size"])
    ax, ay = (float(s) * h for s in mix["semi_axes_frame_heights"])
    off = orbit(period, (ax, ay))
    margin = 8
    x0, y0 = margin - int(off[:, 0].min()), margin - int(off[:, 1].min())
    wh = h + int(off[:, 1].max() - off[:, 1].min()) + 2 * margin
    ww = w + int(off[:, 0].max() - off[:, 0].min()) + 2 * margin
    # the seed may exceed 32 bits: fold it into RandomState's range
    rng = np.random.RandomState(int(seed) % (2**32 - 1))
    world = WORLDS[mix["world"]](rng, wh, ww)
    frames = np.stack([world[y0 + dy : y0 + dy + h, x0 + dx : x0 + dx + w] for dx, dy in off])
    return {"world": world, "offsets": off, "frames": np.ascontiguousarray(frames),
            "period": period}
