"""Oriented BRIEF (rBRIEF) descriptors (counterpart of
``rtvm_tpu/ops/features/orb.py``).

Per keypoint: a 32x32 uint8 patch of the smoothed image, the intensity-
centroid orientation from two moment sums over it, the orientation quantised
to 32 bins, and 256 intensity tests ``v1 < v2`` at the pattern rotated to that
bin (static per-bin flat-patch indices). The tables are the JAX package's,
built by the same numpy code from the same seed.

The JAX package packs the bits into uint32 words. PyTorch has no uint32
arithmetic, so the port's words are int32 with the same bit pattern:
``np.asarray(jax_bits).view(np.int32)`` equals them.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from rtvm_tpu_torch.ops.filters import gaussian_blur
from rtvm_tpu_torch.ops.kernel_patches import extract_patches_plain

PATCH = 32  # patch side; radius 15 covers the rotated 13-px pattern at any angle
N_ANGLE_BINS = 32
TWO_PI = 2.0 * math.pi


class Descriptors(NamedTuple):
    bits: torch.Tensor  # [..., K, words] int32 packed descriptor (uint32 bit pattern)
    angle: torch.Tensor  # [..., K] float32 radians
    valid: torch.Tensor  # [..., K] bool


@functools.lru_cache(maxsize=8)
def brief_pattern(n_bits: int = 256, radius: int = 13, seed: int = 0x5EED) -> np.ndarray:
    """[n_bits, 4] float32 (x1, y1, x2, y2) test offsets ~ N(0, (2r/5)^2), clipped to r."""
    rng = np.random.RandomState(seed)
    sigma = (2.0 * radius) / 5.0
    pts = np.clip(rng.randn(n_bits, 4) * sigma, -radius, radius)
    return pts.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _rotated_index_tables(n_bits: int, radius: int, patch: int = PATCH, bins: int = N_ANGLE_BINS):
    """Static per-bin nearest-pixel flat indices into a patch**2 vector:
    (idx1 [bins, n_bits], idx2 [bins, n_bits]) int32."""
    pat = brief_pattern(n_bits, radius)
    ctr = (patch - 1) / 2.0
    idx1 = np.zeros((bins, n_bits), np.int32)
    idx2 = np.zeros((bins, n_bits), np.int32)
    for b in range(bins):
        th = 2.0 * np.pi * b / bins
        c, s = np.cos(th), np.sin(th)
        for (xcol, ycol), out in (((0, 1), idx1), ((2, 3), idx2)):
            px, py = pat[:, xcol], pat[:, ycol]
            rx = np.clip(np.round(ctr + c * px - s * py), 0, patch - 1).astype(np.int32)
            ry = np.clip(np.round(ctr + s * px + c * py), 0, patch - 1).astype(np.int32)
            out[b] = ry * patch + rx
    return idx1, idx2


@functools.lru_cache(maxsize=4)
def _moment_masks(radius: int = 15, patch: int = PATCH):
    """Circular-mask dx/dy weight grids [patch, patch] for intensity moments."""
    d = np.arange(patch, dtype=np.float32) - (patch - 1) / 2.0
    yy, xx = np.meshgrid(d, d, indexing="ij")
    circ = (yy**2 + xx**2) <= radius * radius
    return (circ * xx).astype(np.float32), (circ * yy).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_tables(n_bits: int, pattern_radius: int, orientation_radius: int,
                   device: torch.device):
    """The index tables (int64 [bins, n_bits]) and moment masks ([P, P]
    float32) on `device`, built once per device."""
    idx1, idx2 = _rotated_index_tables(n_bits, pattern_radius)
    mx, my = _moment_masks(orientation_radius)
    return tuple(torch.from_numpy(a).to(device) for a in
                 (idx1.astype(np.int64), idx2.astype(np.int64), mx, my))


def smooth_u8(grays: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """[..., H, W] float gray -> blurred, clipped to [0, 255] and truncated
    to uint8 (OpenCV's ORB describes a smoothed 8-bit image)."""
    return torch.clamp(gaussian_blur(grays, sigma), 0.0, 255.0).to(torch.uint8)


def extract_patches_batch(imgs: torch.Tensor, xy: torch.Tensor, patch: int = PATCH) -> torch.Tensor:
    """imgs [B, H, W] (any dtype), xy [B, K, 2] -> [B, K, patch, patch]
    patches with their top-left corner at the integer keypoint less
    patch/2, clamped into the image."""
    b, h, w = imgs.shape
    half = patch // 2
    ys = torch.clamp(xy[..., 1].to(torch.int64) - half, 0, max(h - patch, 0))
    xs = torch.clamp(xy[..., 0].to(torch.int64) - half, 0, w - patch)
    return extract_patches_plain(imgs, ys, xs, patch)


def describe_smoothed(smooth: torch.Tensor, kp_xy: torch.Tensor, kp_valid: torch.Tensor,
                      n_bits: int = 256, pattern_radius: int = 13,
                      orientation_radius: int = 15) -> Descriptors:
    """Steered-BRIEF descriptors for [B, K, 2] keypoints over [B, H, W]
    uint8 smoothed images (``smooth_u8``)."""
    idx1, idx2, mx, my = _device_tables(n_bits, pattern_radius, orientation_radius,
                                        smooth.device)
    patches = extract_patches_batch(smooth, kp_xy)  # [B, K, P, P] uint8
    b, k = patches.shape[:2]
    # Moments: integer pixels times half-integer offsets, partial sums below
    # 2^21, so every order of summation gives the same float32 sums.
    pf = patches.to(torch.float32)
    m10 = torch.einsum("bkpq,pq->bk", pf, mx)
    m01 = torch.einsum("bkpq,pq->bk", pf, my)
    angle = torch.atan2(m01, m10)

    # floor-mod, then round half to even, as jnp's % and round
    bin_f = torch.remainder(angle, TWO_PI) / TWO_PI * N_ANGLE_BINS
    bin_i = torch.remainder(torch.round(bin_f).to(torch.int64), N_ANGLE_BINS)
    # the 256 tests at each keypoint's own bin
    flat = patches.reshape(b, k, PATCH * PATCH)
    v1 = torch.gather(flat, -1, idx1[bin_i])  # [B, K, n_bits]
    v2 = torch.gather(flat, -1, idx2[bin_i])
    bits = (v1 < v2).to(torch.int64).reshape(b, k, n_bits // 32, 32)
    # words < 2^32 in int64, then the wrapping cast keeps the bit pattern
    shifts = torch.arange(32, dtype=torch.int64, device=smooth.device)
    packed = torch.sum(bits << shifts, dim=-1).to(torch.int32)
    return Descriptors(bits=packed, angle=angle, valid=kp_valid)


def describe_orb_batch(grays: torch.Tensor, kp_xy: torch.Tensor, kp_valid: torch.Tensor,
                       n_bits: int = 256, pattern_radius: int = 13, blur_sigma: float = 2.0,
                       orientation_radius: int = 15) -> Descriptors:
    """Steered-BRIEF descriptors for [B, K, 2] keypoints over [B, H, W]
    float gray images -> Descriptors with bits [B, K, n_bits/32] int32."""
    return describe_smoothed(smooth_u8(grays, blur_sigma), kp_xy, kp_valid, n_bits,
                             pattern_radius, orientation_radius)
