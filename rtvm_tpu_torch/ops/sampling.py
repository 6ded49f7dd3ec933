"""Bilinear sampling (counterpart of ``rtvm_tpu/ops/sampling.py``)."""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample img [H, W] or [H, W, C] at float coords (xs, ys) of any
    shape. Out-of-range coordinates are clamped (callers mask separately)."""
    h, w = img.shape[0], img.shape[1]
    x0 = torch.clamp(torch.floor(xs), 0, w - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(ys), 0, h - 2).to(torch.int64)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    if img.dim() == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    p00 = img[y0, x0]
    p01 = img[y0, x0 + 1]
    p10 = img[y0 + 1, x0]
    p11 = img[y0 + 1, x0 + 1]
    top = p00 * (1.0 - fx) + p01 * fx
    bot = p10 * (1.0 - fx) + p11 * fx
    return top * (1.0 - fy) + bot * fy
