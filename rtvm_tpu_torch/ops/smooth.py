"""cv2's uint8 smoothing filters in plain PyTorch, on the image's device:
``cv2.medianBlur`` and ``cv2.bilateralFilter`` on one 8-bit channel, as
``depth3d/pipeline.py:ImageTerrainReconstructor`` calls them (the card has
no cv2).

- ``median_blur_u8``: the median of each k x k window, cv2's replicated
  border. A median is exact, so the result is cv2's byte for byte.
- ``bilateral_filter_u8``: cv2's ``bilateralFilter_8u`` for one channel
  (OpenCV's ``bilateral_filter.simd.hpp``): a circular window of radius d/2
  (offsets with sqrt(dy^2 + dx^2) <= radius, row by row), float32 space
  weights exp(-r^2 / (2 sigma_space^2)) and a 256-entry float32 colour table
  exp(-i^2 / (2 sigma_color^2)), both computed in double and rounded to
  float as cv2 does, ``BORDER_REFLECT_101``, float32 sums over the offsets in
  cv2's order, and ``cvRound`` (half to even) of sum / wsum. cv2's vector
  loop adds each value times its weight to the sum with a fused
  multiply-add (``v_muladd``); that one rounding is reproduced by doing the
  product and the sum in float64 and rounding to float32 once (the product
  of two float32 numbers is exact in float64).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _border_index(n: int, r: int, mode: str, device) -> torch.Tensor:
    """Source index of each of n + 2r padded positions."""
    i = torch.arange(-r, n + r, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if n == 1:
        return torch.zeros_like(i)
    # reflect 101 (the edge pixel is not repeated), bouncing as often as a
    # window wider than the image needs, as cv2's borderInterpolate does
    i = torch.remainder(i, 2 * (n - 1))
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _pad(img: torch.Tensor, r: int, mode: str) -> torch.Tensor:
    h, w = img.shape
    return img[_border_index(h, r, mode, img.device)][:, _border_index(w, r, mode, img.device)]


def median_blur_u8(img: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """``cv2.medianBlur(img, ksize)`` of a [H, W] uint8 tensor."""
    if img.dtype != torch.uint8 or img.dim() != 2 or ksize % 2 == 0 or ksize < 3:
        raise ValueError(f"median_blur_u8 takes [H, W] uint8 and an odd ksize >= 3, got "
                         f"{tuple(img.shape)} {img.dtype} and {ksize}")
    r = ksize // 2
    win = _pad(img, r, "replicate").unfold(0, ksize, 1).unfold(1, ksize, 1)  # [H, W, k, k]
    return win.reshape(*img.shape, ksize * ksize).median(dim=-1).values


@functools.lru_cache(maxsize=16)
def bilateral_tables(d: int, sigma_color: float, sigma_space: float):
    """cv2's tables: (radius, the window's (dy, dx) offsets in order, their
    float32 space weights, the 256 float32 colour weights)."""
    sigma_color = sigma_color if sigma_color > 0 else 1.0
    sigma_space = sigma_space if sigma_space > 0 else 1.0
    gc = -0.5 / (sigma_color * sigma_color)
    gs = -0.5 / (sigma_space * sigma_space)
    radius = max(d // 2 if d > 0 else int(np.rint(sigma_space * 1.5)), 1)
    color = np.array([math.exp(i * i * gc) for i in range(256)], np.float32)
    offsets, space = [], []
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r = math.sqrt(float(i * i + j * j))
            if r > radius:
                continue
            offsets.append((i, j))
            space.append(math.exp(r * r * gs))
    return radius, tuple(offsets), np.array(space, np.float32), color


def bilateral_filter_u8(img: torch.Tensor, d: int = 5, sigma_color: float = 50.0,
                        sigma_space: float = 50.0) -> torch.Tensor:
    """``cv2.bilateralFilter(img, d, sigma_color, sigma_space)`` of a [H, W]
    uint8 tensor (one channel, ``BORDER_DEFAULT``)."""
    if img.dtype != torch.uint8 or img.dim() != 2:
        raise ValueError(f"bilateral_filter_u8 takes [H, W] uint8, got {tuple(img.shape)} "
                         f"{img.dtype}")
    radius, offsets, space, color = bilateral_tables(d, float(sigma_color), float(sigma_space))
    h, w = img.shape
    dev = img.device
    p = _pad(img, radius, "reflect101").to(torch.int64)
    val0 = p[radius : radius + h, radius : radius + w]
    color_t = torch.from_numpy(color).to(dev)
    acc = torch.zeros((h, w), dtype=torch.float32, device=dev)
    wsum = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for (dy, dx), sw in zip(offsets, space.tolist()):
        val = p[radius + dy : radius + dy + h, radius + dx : radius + dx + w]
        wk = color_t[(val - val0).abs()] * sw  # float32 product (sw is a float32 value)
        wsum = wsum + wk
        acc = (val.to(torch.float64) * wk.to(torch.float64) + acc.to(torch.float64)).to(torch.float32)
    return torch.round(acc / wsum).to(torch.uint8)
