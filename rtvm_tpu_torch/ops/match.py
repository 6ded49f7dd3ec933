"""Descriptor matching for the SIFT path (counterpart of ``match_l2_ratio`` and
``gather_correspondences`` in ``rtvm_tpu/ops/match.py``; the Hamming matcher
of the ORB path belongs to a later slice).

Everything is fixed size [..., K] with validity masks and batches over
leading axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_BIG_F = 1e30


class Matches(NamedTuple):
    """For each query keypoint (current frame): index into the train set
    (previous frame), a validity flag and the match distance."""

    train_idx: torch.Tensor  # [..., K] int64
    valid: torch.Tensor  # [..., K] bool
    distance: torch.Tensor  # [..., K] float32


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
