"""Host-side image utilities, the counterpart of ``rtvm_tpu/utils/image.py``:
``crop_black_areas``, ``get_screen_size`` and ``psnr`` are copies;
``scale_to_screen`` implements cv2's ``INTER_AREA`` downscale itself, since the
card has no cv2; ``draw_dotted_line`` draws with ``utils/draw.py``.
"""

from __future__ import annotations

import math

import numpy as np

from rtvm_tpu_torch.utils.draw import line


def crop_black_areas(image: np.ndarray, threshold: int = 15, margin: int = 5) -> np.ndarray:
    """Crop away near-black borders (the driver calls it with threshold=80,
    margin=30)."""
    gray = image.mean(axis=2) if image.ndim == 3 else image
    mask = gray > threshold
    if not mask.any():
        return image
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    y0 = max(int(rows[0]) - margin, 0)
    y1 = min(int(rows[-1]) + margin + 1, image.shape[0])
    x0 = max(int(cols[0]) - margin, 0)
    x1 = min(int(cols[-1]) + margin + 1, image.shape[1])
    return image[y0:y1, x0:x1]


def get_screen_size() -> tuple[int, int]:
    """Screen size, with the reference's fallback of 1920x1080 off Windows."""
    try:  # pragma: no cover - Windows only
        import ctypes

        user32 = ctypes.windll.user32
        return int(user32.GetSystemMetrics(0)), int(user32.GetSystemMetrics(1))
    except Exception:
        return 1920, 1080


def area_weights(ssize: int, dsize: int) -> np.ndarray:
    """[dsize, ssize] float64 weights of cv2's INTER_AREA along one axis: each
    output pixel averages the source interval [d*s, (d+1)*s), s = ssize/dsize,
    each source pixel weighted by its overlap (cv2's computeResizeAreaTab,
    with its 1e-3 cut for slivers)."""
    scale = 1.0 / (dsize / ssize)
    wts = np.zeros((dsize, ssize), np.float64)
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s2 = min(math.floor(f2), ssize - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            wts[d, s1 - 1] = (s1 - f1) / cell
        wts[d, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            wts[d, s2] = min(f2 - s2, 1.0, cell) / cell
    return wts


def resize_area(image: np.ndarray, nw: int, nh: int) -> np.ndarray:
    """cv2.resize(image, (nw, nh), interpolation=cv2.INTER_AREA) for a
    downscale of a uint8 [H, W] or [H, W, C] image: the per-axis weights
    applied as two products, then rounded."""
    h, w = image.shape[:2]
    wy = area_weights(h, nh).astype(np.float32)
    wx = area_weights(w, nw).astype(np.float32)
    img = image.astype(np.float32)
    rows = np.tensordot(wy, img, axes=(1, 0))  # [nh, W, ...]
    out = np.moveaxis(np.tensordot(wx, rows, axes=(1, 1)), 0, 1)  # [nh, nw, ...]
    return np.clip(np.rint(out), 0, 255).astype(image.dtype)


def scale_to_screen(image: np.ndarray, screen: tuple[int, int] | None = None) -> np.ndarray:
    """Aspect-preserving downscale so the image fits the screen, with
    INTER_AREA. Never upscales."""
    sw, sh = screen if screen is not None else get_screen_size()
    h, w = image.shape[:2]
    scale = min(sw / w, sh / h, 1.0)
    if scale >= 1.0:
        return image
    return resize_area(image, int(w * scale), int(h * scale))


def draw_dotted_line(img: np.ndarray, p1, p2, color, thickness: int = 2, gap: int = 10):
    """A dotted segment: every other `gap`-px piece of p1-p2, in place."""
    p1 = np.asarray(p1, float)
    p2 = np.asarray(p2, float)
    dist = float(np.hypot(*(p2 - p1)))
    n = max(int(dist / gap), 1)
    for i in range(0, n + 1, 2):
        a = p1 + (p2 - p1) * (i / n)
        b = p1 + (p2 - p1) * (min(i + 1, n) / n)
        line(img, tuple(a.astype(int)), tuple(b.astype(int)), color, thickness)
    return img


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """Peak signal-to-noise ratio between two uint8-range images."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0**2 / mse)
