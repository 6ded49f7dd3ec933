"""Descriptor matching (counterpart of ``rtvm_tpu/ops/match.py``): Hamming
distance with a mutual cross-check for ORB's packed words, L2 with Lowe's
ratio test for SIFT's float descriptors.

Everything is fixed size [..., K] with validity masks and batches over
leading axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_BIG = 1 << 30
_BIG_F = 1e30


class Matches(NamedTuple):
    """For each query keypoint (current frame): index into the train set
    (previous frame), a validity flag and the match distance."""

    train_idx: torch.Tensor  # [..., K] int64
    valid: torch.Tensor  # [..., K] bool
    distance: torch.Tensor  # [..., K] float32


def _unpack_pm1(packed: torch.Tensor) -> torch.Tensor:
    """[..., K, W] int32 words -> [..., K, 32*W] float32 in {-1, +1}. The
    shift is arithmetic, and ``& 1`` still gives bit s of the word."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return (2 * bits - 1).to(torch.float32).reshape(*packed.shape[:-1], -1)


def hamming_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., Ka, W], b [..., Kb, W] int32 words -> [..., Ka, Kb] int32
    Hamming distances, (n_bits - a.b) / 2 over the {-1, +1} unpacked bits.
    The product is exact in float32: its terms are +-1 and its sums integers
    below 2^24 (TF32 would keep them exact too, since +-1 needs no mantissa)."""
    n_bits = a.shape[-1] * 32
    dot = torch.matmul(_unpack_pm1(a), _unpack_pm1(b).transpose(-1, -2))
    return torch.div(n_bits - dot.to(torch.int32), 2, rounding_mode="floor")


def match_hamming_crosscheck(desc_q, valid_q, desc_t, valid_t) -> Matches:
    """Mutual-nearest-neighbour Hamming matching of [..., K, W] int32 words
    (BFMatcher crossCheck semantics); argmin ties go to the first index."""
    d = hamming_distance_matrix(desc_q, desc_t)
    both = valid_q[..., :, None] & valid_t[..., None, :]
    d = torch.where(both, d, torch.full_like(d, _BIG))
    best_t = torch.argmin(d, dim=-1)  # [..., Kq]
    best_q = torch.argmin(d, dim=-2)  # [..., Kt]
    dist = torch.gather(d, -1, best_t[..., None])[..., 0]
    ar = torch.arange(d.shape[-2], device=d.device)
    mutual = (torch.gather(best_q, -1, best_t) == ar) & (dist < _BIG)
    return Matches(train_idx=best_t, valid=mutual, distance=dist.to(torch.float32))


def match_l2_ratio(desc_q, valid_q, desc_t, valid_t, ratio: float = 0.7) -> Matches:
    """knn(k=2) + Lowe ratio test on float descriptors [..., K, D]: squared L2
    distances from one matrix product, |a-b|^2 = |a|^2 + |b|^2 - 2 a.b."""
    qq = torch.sum(desc_q * desc_q, dim=-1, keepdim=True)  # [..., Kq, 1]
    tt = torch.sum(desc_t * desc_t, dim=-1)[..., None, :]  # [..., 1, Kt]
    cross = torch.matmul(desc_q, desc_t.transpose(-1, -2))
    d2 = torch.clamp(qq + tt - 2.0 * cross, min=0.0)
    both = valid_q[..., :, None] & valid_t[..., None, :]
    d2 = torch.where(both, d2, torch.full_like(d2, _BIG_F))
    # two nearest, ties to the lower index (lax.top_k's rule)
    top2, idx2 = torch.sort(d2, dim=-1, stable=True)
    d1, d2nd = top2[..., 0], top2[..., 1]
    ok = (d1 < (ratio * ratio) * d2nd) & (d1 < _BIG_F)
    return Matches(train_idx=idx2[..., 0], valid=ok, distance=torch.sqrt(torch.clamp(d1, min=0.0)))


def gather_correspondences(kp_q, kp_t, m: Matches):
    """-> (src [..., K, 2] query/current pts, dst [..., K, 2] matched
    train/previous pts, valid [..., K])."""
    idx = m.train_idx[..., None].expand(*m.train_idx.shape, 2)
    return kp_q, torch.gather(kp_t, -2, idx), m.valid
