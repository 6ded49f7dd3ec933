"""FAST-9/16 corners and the blocked top-k (counterpart of
``rtvm_tpu/ops/features/fast.py``).

``fast_score_map`` and ``detect_fast`` are the ORB path's detector;
``topk2d_blocked`` also ranks the SIFT path's extrema.

The JAX version ranks with ``approx_max_k``, which is exact off the TPU; this
one is exact everywhere: a stable descending sort, so ties go to the lower
index as ``lax.top_k`` breaks them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx).
CIRCLE_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


class Keypoints(NamedTuple):
    """Fixed-K keypoint sets. Invalid slots have valid=False, score 0, coords 0."""

    xy: torch.Tensor  # [..., K, 2] float32 (x, y)
    score: torch.Tensor  # [..., K] float32
    valid: torch.Tensor  # [..., K] bool


def _has_arc(mask: torch.Tensor, arc: int) -> torch.Tensor:
    """mask [N, 16, H, W] bool -> [N, H, W]: some circular run of `arc`
    consecutive True values along axis 1 (a run of length 2L is the AND of
    two runs of length L, so the run is built by doubling)."""
    m = torch.cat([mask, mask[:, : arc - 1]], dim=1)  # [N, 16+arc-1, H, W]
    length, run = 1, m
    while length * 2 <= arc:
        run = run[:, : run.shape[1] - length] & run[:, length:]
        length *= 2
    rem = arc - length
    if rem:
        run = run[:, : run.shape[1] - rem] & m[:, rem : rem + run.shape[1] - rem]
    return torch.any(run, dim=1)


def fast_score_map(gray: torch.Tensor, threshold: float = 20.0, arc: int = 9) -> torch.Tensor:
    """Per-pixel FAST corner score for [..., H, W] float images.

    The score sums, over the 16 circle pixels, how far each lies beyond the
    threshold band (on the brighter or the darker side, whichever is larger);
    pixels without an arc of `arc` brighter or darker circle pixels score 0.
    The border is padded with edge values."""
    *lead, h, w = gray.shape
    center = gray.reshape(-1, 1, h, w)
    pad = F.pad(center, (3, 3, 3, 3), mode="replicate")[:, 0]
    shifted = torch.stack(
        [pad[:, 3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dy, dx in CIRCLE_OFFSETS.tolist()],
        dim=1,
    )  # [N, 16, H, W]
    bright = shifted > center + threshold
    dark = shifted < center - threshold
    corner = _has_arc(bright, arc) | _has_arc(dark, arc)
    # the 16 terms added one at a time in circle order: the JAX version's
    # float32 roundings, and the same on every device (torch.sum's order is
    # the device's choice, and a score a rounding apart reorders the top-k)
    over = torch.clamp(shifted - center - threshold, min=0.0)
    under = torch.clamp(center - shifted - threshold, min=0.0)
    sb, sd = over[:, 0], under[:, 0]
    for i in range(1, over.shape[1]):
        sb = sb + over[:, i]
        sd = sd + under[:, i]
    score = torch.where(corner, torch.maximum(sb, sd), torch.zeros_like(sb))
    return score.reshape(*lead, h, w)


def detect_fast(gray: torch.Tensor, max_keypoints: int = 700, threshold: float = 20.0,
                border_margin: int = 16, arc: int = 9) -> Keypoints:
    """FAST corners of [..., H, W] float images -> 3x3 non-max suppression ->
    top-K. Returns fixed-size Keypoints with xy [..., K, 2]."""
    h, w = gray.shape[-2:]
    score = fast_score_map(gray, threshold, arc)
    # 3x3 NMS against the 8 neighbours; the roll wraps around at the edges
    # as jnp.roll does (the border is zeroed below anyway)
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                keep &= score >= torch.roll(score, shifts=(dy, dx), dims=(-2, -1))
    score = torch.where(keep, score, torch.zeros_like(score))
    m = border_margin
    inside = torch.zeros((h, w), dtype=torch.bool, device=gray.device)
    inside[m : h - m, m : w - m] = True
    score = torch.where(inside, score, torch.zeros_like(score))

    top, ky, kx, valid = topk2d_blocked(score, max_keypoints)
    xy = torch.stack([kx.to(torch.float32), ky.to(torch.float32)], dim=-1)
    xy = torch.where(valid[..., None], xy, torch.zeros_like(xy))
    return Keypoints(xy=xy, score=torch.where(valid, top, torch.zeros_like(top)), valid=valid)


def topk2d_blocked(score: torch.Tensor, k: int):
    """Top-k over [..., H, W] non-negative score maps -> (score, y, x, valid),
    each [..., k].

    The lane offset (x mod 8) is packed into the 3 low mantissa bits of the
    score's int32 bit pattern (order-preserving for non-negative floats), each
    8-wide block keeps its maximum, and the top k blocks are taken: at most one
    keypoint per 8-pixel row block, as in the JAX version."""
    *lead, h, w = score.shape
    wp = ((w + 7) // 8) * 8
    sp = torch.nn.functional.pad(score.to(torch.float32), (0, wp - w)).contiguous()
    enc = sp.view(torch.int32)
    lane = torch.arange(wp, device=score.device, dtype=torch.int32) % 8
    enc = (enc & ~7) | lane
    enc = torch.where(sp > 0.0, enc, torch.zeros_like(enc))
    blocks = enc.reshape(*lead, h, wp // 8, 8).amax(dim=-1).reshape(*lead, -1)
    top_enc, bidx = torch.sort(blocks, dim=-1, descending=True, stable=True)
    top_enc, bidx = top_enc[..., :k].contiguous(), bidx[..., :k]
    off = top_enc & 7
    top = (top_enc & ~7).view(torch.float32)
    ky = bidx // (wp // 8)
    kx = (bidx % (wp // 8)) * 8 + off
    return top, ky, kx, top_enc > 0
