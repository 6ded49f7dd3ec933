"""Color conversion (counterpart of ``rtvm_tpu/ops/color.py``)."""

from __future__ import annotations

import torch

# ITU-R BT.601 luma weights, matching cv2.COLOR_BGR2GRAY.
_B_W, _G_W, _R_W = 0.114, 0.587, 0.299


def bgr2gray(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] BGR (any numeric dtype) -> [..., H, W] float32 gray."""
    img = img.to(torch.float32)
    return img[..., 0] * _B_W + img[..., 1] * _G_W + img[..., 2] * _R_W
