"""Pyramidal Lucas-Kanade optical flow (counterpart of
``rtvm_tpu/slam/flow.py``): cv2.calcOpticalFlowPyrLK as the reference's
visual odometry uses it (21x21 window, 3 levels, forward and backward
tracking with a 1 px consistency gate). All K points iterate together, each
pyramid level a few batched gathers (``ops/sampling.py:bilinear_sample``)
over [K, 21, 21] windows; no loop runs per point.

Precision (a stated deviation, ROADMAP.md Queue 3): the pyramids and the
iterations run in float64 and the points come back in the input's dtype.
In float32 the card's and the CPU's sums, taken in other orders, leave the
tracked points about 3.5e-3 px apart after 30 frames; the visual
odometry's RANSAC, which keeps one 8-point hypothesis without a refit,
turns differences that small into other poses. In float64 both devices
round to the same float32 points.
"""

from __future__ import annotations

from typing import List

import torch

from rtvm_tpu_torch.ops.filters import gaussian_blur
from rtvm_tpu_torch.ops.sampling import bilinear_sample


def build_pyramid(gray: torch.Tensor, levels: int = 3) -> List[torch.Tensor]:
    """[H, W] float -> `levels` images, each the previous one blurred
    (sigma 1) and decimated by 2."""
    pyr = [gray]
    for _ in range(levels - 1):
        pyr.append(gaussian_blur(pyr[-1], 1.0)[::2, ::2])
    return pyr


def _lk_level(img0, img1, pts0, guess, win_radius: int, iters: int):
    """One pyramid level: refine the displacements `guess` [K, 2] of the
    points pts0 [K, 2] by `iters` Gauss-Newton steps over their windows.
    Returns (displacements [K, 2], ok [K]: the structure tensor is
    invertible)."""
    d = torch.arange(-win_radius, win_radius + 1, dtype=img0.dtype, device=img0.device)
    xs = pts0[:, 0, None, None] + d[None, None, :]  # [K, 21, 21]
    ys = pts0[:, 1, None, None] + d[None, :, None]
    gx_img = 0.5 * (torch.roll(img0, -1, 1) - torch.roll(img0, 1, 1))
    gy_img = 0.5 * (torch.roll(img0, -1, 0) - torch.roll(img0, 1, 0))
    t0 = bilinear_sample(img0, xs, ys)
    gx = bilinear_sample(gx_img, xs, ys)
    gy = bilinear_sample(gy_img, xs, ys)
    a11 = torch.sum(gx * gx, dim=(1, 2))
    a12 = torch.sum(gx * gy, dim=(1, 2))
    a22 = torch.sum(gy * gy, dim=(1, 2))
    det = a11 * a22 - a12 * a12
    ok = det > 1e-4
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    dv = guess
    for _ in range(iters):
        t1 = bilinear_sample(img1, xs + dv[:, 0, None, None], ys + dv[:, 1, None, None])
        e = t1 - t0
        b1 = torch.sum(e * gx, dim=(1, 2))
        b2 = torch.sum(e * gy, dim=(1, 2))
        du = -(a22 * b1 - a12 * b2) * inv_det
        dvv = -(-a12 * b1 + a11 * b2) * inv_det
        dv = dv + torch.stack([du, dvv], dim=-1)
    return dv, ok


def track_lk(gray0: torch.Tensor, gray1: torch.Tensor, pts0: torch.Tensor, valid0: torch.Tensor,
             levels: int = 3, win_radius: int = 10, iters: int = 10):
    """Track pts0 [K, 2] from gray0 to gray1 ([H, W] float) forward, then
    back. Returns (pts1 [K, 2], valid [K]): valid needs valid0, both
    directions' systems invertible, a forward-backward error under 1 px and
    pts1 at least a pixel inside the image."""
    h, w = gray0.shape
    dtype = pts0.dtype
    gray0, gray1, pts0 = gray0.to(torch.float64), gray1.to(torch.float64), pts0.to(torch.float64)
    p0 = build_pyramid(gray0, levels)
    p1 = build_pyramid(gray1, levels)

    def run(pyr_a, pyr_b, pts):
        disp = torch.zeros_like(pts)  # in the current level's pixels
        ok_all = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
        for lvl in range(levels - 1, -1, -1):
            disp, ok = _lk_level(pyr_a[lvl], pyr_b[lvl], pts / 2.0**lvl, disp, win_radius, iters)
            ok_all = ok_all & ok
            if lvl > 0:
                disp = disp * 2.0
        return disp, ok_all

    fwd, ok_f = run(p0, p1, pts0)
    pts1 = pts0 + fwd
    bwd, ok_b = run(p1, p0, pts1)
    fb_err = torch.sqrt(torch.sum((pts1 + bwd - pts0) ** 2, dim=-1))
    inb = (pts1[:, 0] >= 1) & (pts1[:, 0] < w - 1) & (pts1[:, 1] >= 1) & (pts1[:, 1] < h - 1)
    return pts1.to(dtype), valid0 & ok_f & ok_b & (fb_err < 1.0) & inb
