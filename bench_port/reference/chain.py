"""The window step's chain, plain: what the stitcher's homographies must be
on the benchmark's traffic.

Every frame is an exact crop of the world at a known even integer origin,
so the true relative homography of frame i against frame i - 1 is the
translation by the difference of their origins. The stitcher's stage after
matching and RANSAC (validate, smooth over the last ``history_size``
relative homographies with weights linspace(0.5, 1, c) normalised, compose
H_abs = H_old @ H_smoothed) is applied to those in float64, from frame 0's
place on the canvas. This is the reference for each frame's H_abs and its
accepted and blended flags: a correct match and fit returns the true
translation, so the program's chain has to follow this one.
"""

from __future__ import annotations

import numpy as np


def translation(dx: float, dy: float) -> np.ndarray:
    return np.array([[1.0, 0.0, dx], [0.0, 1.0, dy], [0.0, 0.0, 1.0]])


def valid(H: np.ndarray, stab: dict) -> bool:
    """The anti-shake check of a relative homography."""
    t = np.hypot(H[0, 2], H[1, 2])
    det = H[0, 0] * H[1, 1] - H[0, 1] * H[1, 0]
    return bool(np.all(np.isfinite(H)) and t <= stab["translation_threshold"] and det > 0
                and abs(np.sqrt(det) - 1.0) <= stab["scale_threshold"]
                and abs(H[2, 0]) <= stab["perspective_threshold"]
                and abs(H[2, 1]) <= stab["perspective_threshold"])


def truth_chain(offsets: np.ndarray, n_frames: int, origin_xy, stab: dict):
    """H_abs [n, 3, 3], ok [n] and blended [n] of frames 1..n, where frame k
    is the orbit's frame k mod period (offsets [period, 2] (dx, dy) from
    frame 0) and frame 0 sits at origin_xy (col, row) on the canvas."""
    period = len(offsets)
    s = int(stab["history_size"])
    hist: list = []
    H_old = translation(*origin_xy)
    out = np.empty((n_frames, 3, 3))
    ok = np.empty(n_frames, bool)
    for k in range(1, n_frames + 1):
        d = offsets[k % period] - offsets[(k - 1) % period]
        H_rel = translation(float(d[0]), float(d[1]))
        good = valid(H_rel, stab)
        H_v = H_rel if good else np.eye(3)
        hist = (hist + [H_v])[-s:]
        if len(hist) < 2:
            H_s = H_v
        else:
            w = np.linspace(0.5, 1.0, len(hist))
            H_s = np.einsum("s,sij->ij", w / w.sum(), np.stack(hist))
        H_old = H_old @ H_s
        out[k - 1] = H_old
        ok[k - 1] = good
    return out, ok, np.ones(n_frames, bool)


def corner_gap(H_a: np.ndarray, H_b: np.ndarray, h: int, w: int) -> np.ndarray:
    """Per frame, the largest distance (px) between a frame's four corners
    mapped by H_a [n, 3, 3] and by H_b."""
    c = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], np.float64).T

    def proj(H):
        p = np.einsum("nij,jk->nik", H.astype(np.float64), c)
        return p[:, :2] / p[:, 2:3]

    return np.abs(proj(H_a) - proj(H_b)).max(axis=(1, 2))


def outside(H: np.ndarray, frame_hw, canvas_hw) -> float:
    """The largest distance (px) by which a frame corner mapped by H [n, 3, 3]
    lies outside the canvas (rows, cols); 0 when every frame is inside."""
    h, w = frame_hw
    hc, wc = canvas_hw
    c = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], np.float64).T
    p = np.einsum("nij,jk->nik", H, c)
    x, y = p[:, 0] / p[:, 2], p[:, 1] / p[:, 2]
    return float(max(0.0, (-x).max(), (x - wc).max(), (-y).max(), (y - hc).max()))
