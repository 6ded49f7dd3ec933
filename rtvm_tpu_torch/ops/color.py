"""Color conversions (counterpart of ``rtvm_tpu/ops/color.py``): BGR to
gray and to HSV, gray to BGR."""

from __future__ import annotations

import numpy as np
import torch

# ITU-R BT.601 luma weights, matching cv2.COLOR_BGR2GRAY.
_B_W, _G_W, _R_W = 0.114, 0.587, 0.299
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def bgr2gray(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] BGR (any numeric dtype) -> [..., H, W] float32 gray."""
    img = img.to(torch.float32)
    return img[..., 0] * _B_W + img[..., 1] * _G_W + img[..., 2] * _R_W


def bgr2hsv(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] BGR uint8-range -> [..., H, W, 3] float32 HSV with
    OpenCV's 8-bit ranges (H in [0, 180), S and V in [0, 255]). The scale to
    0..1 is a product by the float32 reciprocal of 255, as XLA compiles the
    JAX function's division by a constant: a quotient would put S = 50 of
    some gray pixels a float32 step to the other side of the thresholds."""
    img = img.to(torch.float32) * _INV_255
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    mn = torch.minimum(torch.minimum(b, g), r)
    c = v - mn
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    h_r = (g - b) / safe_c
    h_g = 2.0 + (b - r) / safe_c
    h_b = 4.0 + (r - g) / safe_c
    h = torch.where(v == r, h_r, torch.where(v == g, h_g, h_b))
    h = torch.where(c > 0, h, torch.zeros_like(h))
    h = torch.remainder(h * 60.0, 360.0)
    s = torch.where(v > 0, c / torch.where(v > 0, v, torch.ones_like(v)), torch.zeros_like(v))
    return torch.stack([h / 2.0, s * 255.0, v * 255.0], dim=-1)


def gray2bgr(gray: torch.Tensor) -> torch.Tensor:
    return torch.stack([gray, gray, gray], dim=-1)
