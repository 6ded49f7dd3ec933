"""Stereo matching (counterpart of ``rtvm_tpu/stereo/sgm.py``): census cost
volume, semi-global aggregation along rows and columns, winner-takes-all
with parabolic subpixel refinement, uniqueness and left-right checks.

The census codes are 24 bits in int32 (torch has no popcount and the CPU
cannot shift uint32); the Hamming cost counts bits with a SWAR popcount,
exactly. The aggregation adds and takes minima of integers below 2^24 in
float32, so it is exact and the integer disparity equals JAX's. Each axis
runs its forward and reverse passes in one Python loop with both carries
stacked, and nothing in the loop waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BIG = 1e9  # the scan's out-of-range neighbour cost, as in JAX


class StereoResult(NamedTuple):
    disparity: torch.Tensor  # [H, W] float32 (px), invalid = -1
    cost_volume: torch.Tensor  # [H, W, D] aggregated


def _f32(x: float) -> float:
    """`x` rounded to float32, so that a tensor op with it computes what JAX's
    weakly typed float32 scalar does."""
    return float(np.float32(x))


def census_transform(gray: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """[H, W] float -> [H, W] int32 census code over the (2r+1)^2-1
    neighbours (edge-replicated), bit i set where neighbour i > centre."""
    h, w = gray.shape
    ys = (torch.arange(-radius, h + radius, device=gray.device)).clamp(0, h - 1)
    xs = (torch.arange(-radius, w + radius, device=gray.device)).clamp(0, w - 1)
    pad = gray[ys][:, xs]
    out = torch.zeros((h, w), dtype=torch.int32, device=gray.device)
    i = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            nb = pad[radius + dy : radius + dy + h, radius + dx : radius + dx + w]
            out |= (nb > gray).to(torch.int32) << i
            i += 1
    return out


def popcount24(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each non-negative int32 below 2^24 (SWAR: pairs, nibbles,
    then the three bytes)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x & 0xFF) + ((x >> 8) & 0xFF) + ((x >> 16) & 0xFF)


def build_cost_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int) -> torch.Tensor:
    """Hamming cost between census codes at all disparities -> [H, W, D]
    float32; the right code at x - d is clamped to column 0, as JAX's edge
    padding does."""
    h, w = left.shape
    cl = census_transform(left)
    cr = census_transform(right)
    x = torch.arange(w, device=left.device)
    d = torch.arange(num_disp, device=left.device)
    src = (x[:, None] - d[None, :]).clamp(min=0)  # [W, D]
    return popcount24(cl[..., None] ^ cr[:, src]).to(torch.float32)


def _scan_both(c: torch.Tensor, p1: float, p2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """SGM messages along the leading axis of c [N, M, D], forward and
    reverse, in one loop over N with the two carries stacked [2, M, D]."""
    n = c.shape[0]
    cs = torch.stack([c, c.flip(0)])  # [2, N, M, D]
    out = torch.empty_like(cs)
    out[:, 0] = cs[:, 0]
    big, p1, p2 = _f32(BIG), _f32(p1), _f32(p2)
    for i in range(1, n):
        prev = out[:, i - 1]
        m = prev.amin(-1, keepdim=True)
        pad = torch.cat([prev[..., :1] + big, prev, prev[..., -1:] + big], -1)
        # min(a + p1, b + p1) == min(a, b) + p1 exactly: rounding is monotone
        best = torch.minimum(torch.minimum(prev, m + p2),
                             torch.minimum(pad[..., :-2], pad[..., 2:]) + p1)
        torch.sub(cs[:, i] + best, m, out=out[:, i])
    return out[0], out[1].flip(0)


def _scan_axis(cost: torch.Tensor, p1: float, p2: float, axis: int):
    """(forward, reverse) aggregation of cost [H, W, D] along `axis` (0 scans
    down the columns, 1 along the rows), each [H, W, D]."""
    c = cost.transpose(0, 1).contiguous() if axis == 1 else cost
    fwd, rev = _scan_both(c, p1, p2)
    if axis == 1:
        fwd, rev = fwd.transpose(0, 1), rev.transpose(0, 1)
    return fwd, rev


def _aggregate_dir(cost: torch.Tensor, p1: float, p2: float, axis: int, reverse: bool) -> torch.Tensor:
    """One direction of the aggregation, JAX's ``_aggregate_dir``."""
    return _scan_axis(cost, p1, p2, axis)[int(reverse)]


def aggregate(cost: torch.Tensor, p1: float = 8.0, p2: float = 96.0) -> torch.Tensor:
    """The sum of the four directions, in JAX's order (rows forward, rows
    reverse, columns forward, columns reverse)."""
    hf, hr = _scan_axis(cost, p1, p2, axis=1)
    vf, vr = _scan_axis(cost, p1, p2, axis=0)
    return hf + hr + vf + vr


def sgm_disparity(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    num_disp: int = 128,
    p1: float = 8.0,
    p2: float = 96.0,
    uniqueness: float = 0.10,
    lr_threshold: float = 1.5,
) -> StereoResult:
    """Full SGM on [H, W] float grays on their device. Returns subpixel
    disparity with invalid pixels -1 (uniqueness and left-right checks, and
    disparity 0), and the aggregated cost volume."""
    agg = aggregate(build_cost_volume(left_gray, right_gray, num_disp), p1, p2)
    dev = agg.device
    d = agg.shape[-1]
    w = left_gray.shape[1]

    d_int = agg.argmin(-1)  # [H, W], first index on ties
    cmin = agg.amin(-1)

    dd = torch.arange(d, device=dev)
    near = (dd - d_int[..., None]).abs() <= 1
    second = torch.where(near, _f32(BIG), agg).amin(-1)
    unique_ok = cmin * _f32(np.float32(1.0) + np.float32(uniqueness)) <= second

    dm = (d_int - 1).clamp(0, d - 1)
    dp = (d_int + 1).clamp(0, d - 1)
    cm = agg.gather(-1, dm[..., None])[..., 0]
    cp = agg.gather(-1, dp[..., None])[..., 0]
    denom = cm + cp - 2.0 * cmin
    offset = torch.where(denom.abs() > _f32(1e-6),
                         0.5 * (cm - cp) / denom.clamp(min=_f32(1e-6)), 0.0)
    disp = d_int.to(torch.float32) + offset.clamp(-0.5, 0.5)

    # left-right: the cost of right pixel x at disparity d is the left one's at x + d
    xs = torch.arange(w, device=dev)
    right_cost = agg[:, (xs[:, None] + dd[None, :]).clamp(0, w - 1), dd[None, :].expand(w, d)]
    d_right = right_cost.argmin(-1)
    xr = (xs[None, :] - d_int).clamp(0, w - 1)
    d_r_at = d_right.gather(1, xr)
    lr_ok = (d_int - d_r_at).abs() <= lr_threshold

    valid = unique_ok & lr_ok & (d_int > 0)
    disp = torch.where(valid, disp, -1.0)
    return StereoResult(disparity=disp, cost_volume=agg)


def disparity_to_depth(
    disparity: np.ndarray, focal_px: float, baseline_m: float,
    min_disp: float = 0.1, max_depth: float = 100.0,
) -> np.ndarray:
    """Z = f * B / d with the reference's clamps (numpy, a copy)."""
    d = np.where(disparity > min_disp, disparity, np.nan)
    z = focal_px * baseline_m / d
    z = np.where(np.isfinite(z) & (z <= max_depth), z, 0.0)
    return z.astype(np.float32)
