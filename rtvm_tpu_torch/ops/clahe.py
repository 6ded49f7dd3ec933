"""CLAHE (contrast-limited adaptive histogram equalization), the counterpart
of ``rtvm_tpu/ops/clahe.py`` (cv2.createCLAHE(clipLimit=3.0,
tileGridSize=(8, 8)) in the reference's detection pre-enhancement).

The tile histograms are one ``bincount`` over (tile, level) pairs, clipped and
redistributed; each pixel takes its four surrounding tiles' LUTs by one
gather each and blends them bilinearly, as the JAX function does.
"""

from __future__ import annotations

import torch

from rtvm_tpu_torch.ops.color import bgr2gray


def clahe(gray: torch.Tensor, clip_limit: float = 3.0, grid: int = 8) -> torch.Tensor:
    """gray [H, W] float 0..255 -> equalized [H, W] float32 0..255."""
    h, w = gray.shape
    th, tw = -(-h // grid), -(-w // grid)  # ceil tile sizes
    ph, pw = th * grid - h, tw * grid - w
    img = gray.to(torch.float32)
    img = torch.cat([img, img[-1:].expand(ph, w)], 0) if ph else img
    img = torch.cat([img, img[:, -1:].expand(img.shape[0], pw)], 1) if pw else img
    hp, wp = img.shape
    dev = img.device

    vals = torch.clamp(img, 0, 255).to(torch.int64)
    tile = (torch.arange(hp, device=dev) // th)[:, None] * grid + \
        (torch.arange(wp, device=dev) // tw)[None, :]
    hist = torch.bincount((tile * 256 + vals).reshape(-1), minlength=grid * grid * 256)
    hist = hist.reshape(grid * grid, 256).to(torch.float32)

    # clip + redistribute the excess uniformly
    limit = clip_limit * (th * tw) / 256.0
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / 256.0

    cdf = torch.cumsum(hist, dim=1)
    luts = (cdf - cdf[:, :1]) / torch.clamp(cdf[:, -1:] - cdf[:, :1], min=1.0) * 255.0
    luts = luts.reshape(-1)  # [(ty * grid + tx) * 256 + level]

    # bilinear interpolation between the 4 surrounding tile LUTs
    gy = (torch.arange(hp, dtype=torch.float32, device=dev) - th / 2.0) / th
    gx = (torch.arange(wp, dtype=torch.float32, device=dev) - tw / 2.0) / tw
    y0 = torch.clamp(torch.floor(gy), 0, grid - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(gx), 0, grid - 1).to(torch.int64)
    y1 = torch.clamp(y0 + 1, 0, grid - 1)
    x1 = torch.clamp(x0 + 1, 0, grid - 1)
    fy = torch.clamp(gy - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(gx - x0, 0.0, 1.0)[None, :]

    def lut(ty, tx):
        return luts[((ty[:, None] * grid + tx[None, :]) * 256 + vals)]

    out = (lut(y0, x0) * (1 - fy) * (1 - fx)
           + lut(y0, x1) * (1 - fy) * fx
           + lut(y1, x0) * fy * (1 - fx)
           + lut(y1, x1) * fy * fx)
    return out[:h, :w]


def enhance_for_detection(bgr: torch.Tensor, clip_limit: float = 3.0, grid: int = 8) -> torch.Tensor:
    """[H, W, 3] BGR -> float32 [H, W, 3] in 0..255: the luma equalized by
    CLAHE and every channel scaled by the luma's gain (clipped to 0.25-4)."""
    img = bgr.to(torch.float32)
    luma = bgr2gray(img)
    eq = clahe(luma, clip_limit, grid)
    gain = eq / torch.clamp(luma, min=1.0)
    gain = torch.clamp(gain, 0.25, 4.0)
    return torch.clamp(img * gain[..., None], 0, 255)
