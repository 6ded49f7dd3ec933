"""Separable filters and morphology (counterpart of ``rtvm_tpu/ops/filters.py``).

A 1-D filter with edge-replicate padding is a banded matrix with the clipped
taps folded into the border rows, so each pass is one matrix product on the
last or second-to-last axis: plain PyTorch, in full float32 (TF32 is off, see
the package ``__init__``). Dilation and erosion are rectangular max pools
with "SAME" padding by -inf (for a max) or +inf (for a min), so the border
never erodes.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    """1-D Gaussian taps; matches cv2.getGaussianKernel for odd sizes."""
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def band_matrix(taps: np.ndarray, n: int) -> np.ndarray:
    """[n, n] float32 B with (B @ x)[i] = sum_t taps[t] * x[clip(i + t - r)]:
    a 1-D correlation with edge-replicate padding."""
    r = (taps.shape[0] - 1) // 2
    b = np.zeros((n, n), np.float32)
    rows = np.arange(n)
    for t in range(taps.shape[0]):
        np.add.at(b, (rows, np.clip(rows + t - r, 0, n - 1)), taps[t])
    return b


@functools.lru_cache(maxsize=64)
def _band_tensor(taps_key: tuple, n: int, device: torch.device) -> torch.Tensor:
    """band_matrix built on `device` itself: its float32 sums are the same,
    in the same order, and no host-to-device copy waits for the device (a
    canvas that grows meets new sizes mid-run)."""
    r = (len(taps_key) - 1) // 2
    b = torch.zeros((n, n), dtype=torch.float32, device=device)
    rows = torch.arange(n, device=device)
    for t, v in enumerate(taps_key):
        cols = torch.clamp(rows + (t - r), 0, n - 1)
        b.index_put_((rows, cols), torch.full((n,), v, dtype=torch.float32, device=device),
                     accumulate=True)
    return b


def conv1d_edge(img: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Correlate [..., H, W] along axis -1 or -2 with edge-replicate padding."""
    key = tuple(float(t) for t in taps)
    if axis == -1:
        b = _band_tensor(key, img.shape[-1], img.device).to(img.dtype)
        return torch.matmul(img, b.T)
    b = _band_tensor(key, img.shape[-2], img.device).to(img.dtype)
    return torch.matmul(b, img)


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur of a [..., H, W] float image."""
    taps = gaussian_kernel1d(sigma, radius)
    return conv1d_edge(conv1d_edge(img, taps, axis=-1), taps, axis=-2)


def box_blur(img: torch.Tensor, size: int) -> torch.Tensor:
    """size x size mean filter of a [..., H, W] float image, edges replicated."""
    taps = np.full((size,), 1.0 / size, dtype=np.float32)
    return conv1d_edge(conv1d_edge(img, taps, axis=-1), taps, axis=-2)


def sobel(img: torch.Tensor):
    """(gx, gy) of the 3x3 Sobel operator (cv2.Sobel with ksize=3), edges
    replicated."""
    d = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
    s = np.array([1.0, 2.0, 1.0], dtype=np.float32)
    gx = conv1d_edge(conv1d_edge(img, d, axis=-1), s, axis=-2)
    gy = conv1d_edge(conv1d_edge(img, s, axis=-1), d, axis=-2)
    return gx, gy


def _max_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    """size x size max over the last two axes with "SAME" padding by -inf
    (lax.reduce_window's: (size - 1) // 2 before, the rest after)."""
    lo = (size - 1) // 2
    hi = size - 1 - lo
    x = img.reshape((-1, 1) + img.shape[-2:])
    x = F.pad(x, (lo, hi, lo, hi), value=-math.inf)
    return F.max_pool2d(x, size, stride=1).reshape(img.shape)


def dilate(mask: torch.Tensor, size: int, iterations: int = 1) -> torch.Tensor:
    """Dilation of a [..., H, W] mask by a size x size rectangle (cv2.dilate),
    as float32."""
    out = mask.to(torch.float32)
    for _ in range(iterations):
        out = _max_filter(out, size)
    return out


def erode(mask: torch.Tensor, size: int, iterations: int = 1) -> torch.Tensor:
    """Erosion by a size x size rectangle, as float32; outside the image
    counts as +inf."""
    out = mask.to(torch.float32)
    for _ in range(iterations):
        out = -_max_filter(-out, size)
    return out


def morph_open(mask: torch.Tensor, size: int, iterations: int = 1) -> torch.Tensor:
    return dilate(erode(mask, size, iterations), size, iterations)


def morph_close(mask: torch.Tensor, size: int, iterations: int = 1) -> torch.Tensor:
    return erode(dilate(mask, size, iterations), size, iterations)


def _shift(img: torch.Tensor, off: int, dim: int, fill: float) -> torch.Tensor:
    """out[i] = img[i - off] along dim, `fill` where that falls outside."""
    n = img.shape[dim]
    out = torch.full_like(img, fill)
    if off >= 0:
        out.narrow(dim, off, n - off).copy_(img.narrow(dim, 0, n - off))
    else:
        out.narrow(dim, 0, n + off).copy_(img.narrow(dim, -off, n + off))
    return out


def maxpool3x3(img: torch.Tensor) -> torch.Tensor:
    """3x3 max filter with SAME padding."""
    ninf = -math.inf if img.is_floating_point() else torch.iinfo(img.dtype).min
    d = img.dim()
    mx = torch.maximum(img, torch.maximum(_shift(img, 1, d - 1, ninf), _shift(img, -1, d - 1, ninf)))
    return torch.maximum(mx, torch.maximum(_shift(mx, 1, d - 2, ninf), _shift(mx, -1, d - 2, ninf)))


def minmaxpool3x3(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(max, min) 3x3 filters with SAME padding. Edge replication is exact for
    both: a border window re-reads an in-window value."""
    p = torch.cat([img[..., :1, :], img, img[..., -1:, :]], dim=-2)
    a, b, c = p[..., :-2, :], p[..., 1:-1, :], p[..., 2:, :]
    rmax = torch.maximum(a, torch.maximum(b, c))
    rmin = torch.minimum(a, torch.minimum(b, c))
    pmax = torch.cat([rmax[..., :1], rmax, rmax[..., -1:]], dim=-1)
    pmin = torch.cat([rmin[..., :1], rmin, rmin[..., -1:]], dim=-1)
    mx = torch.maximum(pmax[..., :-2], torch.maximum(pmax[..., 1:-1], pmax[..., 2:]))
    mn = torch.minimum(pmin[..., :-2], torch.minimum(pmin[..., 1:-1], pmin[..., 2:]))
    return mx, mn
