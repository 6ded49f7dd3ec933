"""Disparity refinement (counterpart of ``rtvm_tpu/stereo/refine.py``): a
confidence-weighted guided filter with the left gray image as guide (the
stand-in for the reference's WLS filter), and speckle suppression by local
support (the stand-in for ``cv2.filterSpeckles``).

The box sums are float32 cumulative sums over an edge-padded map, as in JAX.
Their sums of squares pass 2^24, so the order of the additions shows in the
result: ``cumsum_blocked`` adds in the order of XLA's CPU cumulative sum,
the same on every device (``torch.cumsum`` adds in double on the CPU and in
another order on the card). Speckle suppression counts integers and is
exact.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


CUMSUM_BLOCK = 16  # XLA's CPU cumulative sum adds blocks of 16 in order


def cumsum_blocked(x: torch.Tensor, dim: int) -> torch.Tensor:
    """float32 cumulative sum along `dim` in XLA's CPU order: within blocks
    of 16 in sequence, then each block's running sum plus the cumulative sum
    (the same way, recursively) of the totals of the blocks before it."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    b = CUMSUM_BLOCK
    nb = -(-n // b)
    if nb > 1:
        x = torch.cat([x, x.new_zeros((nb * b - n,) + x.shape[1:])]).view((nb, b) + x.shape[1:])
    else:
        x = x[None]
    within = x.clone()
    for k in range(1, within.shape[1]):
        within[:, k] += within[:, k - 1]
    if nb > 1:
        pre = cumsum_blocked(within[:, -1], 0)
        within[1:] += pre[:-1, None]
    return within.reshape((-1,) + x.shape[2:])[:n].movedim(0, dim)


def _box(x: torch.Tensor, r: int) -> torch.Tensor:
    """Separable (2r+1)^2 box sum with edge-replicate padding, via padded
    cumulative sums."""
    for axis in (0, 1):
        n = x.shape[axis]
        src = torch.arange(-r - 1, n + r, device=x.device).clamp(0, n - 1)
        c = cumsum_blocked(x.index_select(axis, src), axis)
        x = c.narrow(axis, 2 * r + 1, n) - c.narrow(axis, 0, n)
    return x


def guided_refine(disparity: torch.Tensor, guide_gray: torch.Tensor, radius: int = 8,
                  eps: float = 40.0) -> torch.Tensor:
    """Confidence-weighted guided filter of a disparity map [H, W] (invalid
    -1) with `guide_gray` [H, W] on the 0..255 scale (eps in intensity^2).
    Holes are filled where the window has support, -1 elsewhere."""
    d = disparity.to(torch.float32)
    g = guide_gray.to(torch.float32)
    conf = (d >= 0.0).to(torch.float32)
    dz = torch.where(conf > 0, d, 0.0)

    n = _box(torch.ones_like(g), radius)
    nc = _box(conf, radius)
    ok = nc > 0.5

    mean_g = _box(g, radius) / n
    var_g = _box(g * g, radius) / n - mean_g**2
    ncs = nc.clamp(min=1e-6)
    mean_d = _box(dz, radius) / ncs
    mean_gd = _box(g * dz, radius) / ncs
    mean_g_v = _box(g * conf, radius) / ncs
    cov = mean_gd - mean_g_v * mean_d

    a = cov / (var_g + eps)
    b = mean_d - a * mean_g_v
    mean_a = _box(a, radius) / n
    mean_b = _box(b, radius) / n
    out = mean_a * g + mean_b
    return torch.where(ok, out.clamp(min=0.0), -1.0)


def speckle_suppress(disparity: torch.Tensor, radius: int = 6, max_diff: float = 1.5,
                     min_support: int = 24) -> torch.Tensor:
    """Invalidate small isolated blobs: a pixel survives when at least
    `min_support` pixels of its (2r+1)^2 window (itself included) lie within
    `max_diff` of it. Invalid pixels and the outside support nobody."""
    d = disparity.to(torch.float32)
    valid = d >= 0.0
    h, w = d.shape
    k = 2 * radius + 1
    pad = F.pad(torch.where(valid, d, -1e6)[None, None], (radius,) * 4, value=-1e6)
    nb = F.unfold(pad, k)[0].view(k * k, h, w)  # every window offset at once
    supp = ((nb - d).abs() <= max_diff).sum(0)
    keep = valid & (supp >= min_support)
    return torch.where(keep, d, -1.0)
