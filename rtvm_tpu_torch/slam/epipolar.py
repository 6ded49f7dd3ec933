"""Essential matrix and relative pose (counterpart of
``rtvm_tpu/slam/epipolar.py``): cv2.findEssentialMat (RANSAC, threshold
1 px) and cv2.recoverPose as the reference's visual odometry uses them. A
fixed batch of eight-point solves votes by Sampson distance; the best E is
decomposed into its four (R, t) and the one with the most inliers in front
of both cameras wins.

Random draws: the JAX version draws ``jax.random.uniform`` [hypotheses, K]
and takes each hypothesis's top 8 over the valid points. PyTorch cannot
replay that stream, so the draws are an argument (``uniforms``); without
them they come from ``generator``. The SVDs of the two packages may choose
other column signs; the four candidates are the same set either way, so R,
t and the inliers agree, not necessarily E's sign.

Precision (a stated deviation, ROADMAP.md Queue 3): the eight-point solve
runs in float64. In float32 its 9x9 normal matrix squares the condition
number, and the null vector comes out about 4% off (median, on 256
hypotheses of a synthetic scene), in a direction that depends on the
eigensolver: the JAX package's and a float32 port's E differ from each
other by as much, and so would the card's and the CPU's. In float64 they
agree where the sample's null space is one vector. Eight points from one
plane leave it three vectors wide, and each eigensolver returns another E
from it: on a clip of three depths, where such samples tied for the best
count, the card's and the CPU's votes parted on the same inputs. Neither
float64 nor the solver can choose for them; a scene spread over many
depths keeps such samples from winning.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch


class PoseResult(NamedTuple):
    R: torch.Tensor  # [3, 3]
    t: torch.Tensor  # [3] unit norm
    E: torch.Tensor  # [3, 3]
    inliers: torch.Tensor  # [K] bool
    num_inliers: torch.Tensor  # int64
    ok: torch.Tensor  # bool


def _normalize(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels -> normalized camera coordinates through K^-1."""
    return torch.stack([(pts[..., 0] - K[0, 2]) / K[0, 0], (pts[..., 1] - K[1, 2]) / K[1, 1]],
                       dim=-1)


def _eight_point(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """E [..., 3, 3] (float32) from 8 normalized correspondences [..., 8, 2]
    each (x2^T E x1 = 0), with rank 2 enforced; solved in float64."""
    dtype = x1.dtype
    x1, x2 = x1.to(torch.float64), x2.to(torch.float64)
    one = torch.ones_like(x1[..., 0])
    a = torch.stack([
        x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1], x2[..., 0],
        x2[..., 1] * x1[..., 0], x2[..., 1] * x1[..., 1], x2[..., 1],
        x1[..., 0], x1[..., 1], one,
    ], dim=-1)  # [..., 8, 9]
    m = a.transpose(-1, -2) @ a
    vecs = torch.linalg.eigh(m)[1]
    e = vecs[..., :, 0].reshape(*m.shape[:-2], 3, 3)
    u, s, vt = torch.linalg.svd(e)
    sbar = (s[..., 0] + s[..., 1]) / 2.0
    d = torch.stack([sbar, sbar, torch.zeros_like(sbar)], dim=-1)
    return ((u * d[..., None, :]) @ vt).to(dtype)


def _sampson2(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distances [H, K] of correspondences [K, 2] under each
    E [H, 3, 3]."""
    ones = torch.ones_like(x1[:, :1])
    p1 = torch.cat([x1, ones], dim=-1)  # [K, 3]
    p2 = torch.cat([x2, ones], dim=-1)
    ex1 = p1 @ E.transpose(-1, -2)  # [H, K, 3]
    etx2 = p2 @ E
    num = torch.sum(p2 * ex1, dim=-1) ** 2
    den = ex1[..., 0] ** 2 + ex1[..., 1] ** 2 + etx2[..., 0] ** 2 + etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _triangulate_depths(R, t, x1, x2):
    """Midpoint depths of each correspondence along its ray in camera 1
    (at the origin) and camera 2 (X2 = R X1 + t)."""
    ones = torch.ones_like(x1[:, :1])
    d1 = torch.cat([x1, ones], dim=-1)
    d2 = torch.cat([x2, ones], dim=-1) @ R  # R^T of camera 2's ray
    c2 = -R.T @ t
    a11 = torch.sum(d1 * d1, dim=-1)
    a12 = -torch.sum(d1 * d2, dim=-1)
    a22 = torch.sum(d2 * d2, dim=-1)
    b1 = torch.sum(d1 * c2[None], dim=-1)
    b2 = -torch.sum(d2 * c2[None], dim=-1)
    det = a11 * a22 - a12 * a12
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    return (a22 * b1 - a12 * b2) / det, (a11 * b2 - a12 * b1) / det


@functools.lru_cache(maxsize=8)
def _w_matrix(device: torch.device) -> torch.Tensor:
    """The decomposition's W, built once per device (read only)."""
    return torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=device)


def recover_pose(E: torch.Tensor, inliers: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """cv2.recoverPose's choice: of E's four decompositions {R1, R2} x {t, -t}
    the (R, t) with the most inliers (normalized correspondences x1 -> x2)
    in front of both cameras; the first on a tie."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = _w_matrix(E.device)
    R1, R2, tv = U @ W @ Vt, U @ W.T @ Vt, U[:, 2]
    cands = [(R1, tv), (R1, -tv), (R2, tv), (R2, -tv)]
    w = inliers.to(torch.float32)

    def score(R, t):
        alpha, beta = _triangulate_depths(R, t, x1, x2)
        return torch.sum(((alpha > 0) & (beta > 0)).to(torch.float32) * w)

    bi = torch.argmax(torch.stack([score(R, t) for R, t in cands])).reshape(1)
    return (torch.stack([c[0] for c in cands]).index_select(0, bi)[0],
            torch.stack([c[1] for c in cands]).index_select(0, bi)[0])


def find_essential_and_pose(pts1: torch.Tensor, pts2: torch.Tensor, valid: torch.Tensor,
                            K: torch.Tensor, uniforms: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None,
                            num_hypotheses: int = 256, threshold_px: float = 1.0,
                            min_matches: int = 8) -> PoseResult:
    """findEssentialMat + recoverPose for pts1 (previous frame) -> pts2
    (current) [K, 2] pixels: R, t with X2 = R X1 + t (cv2's convention).
    `uniforms` [num_hypotheses, K] are the draws whose top 8 over the valid
    points make each hypothesis; without them they are drawn with
    `generator`."""
    n = pts1.shape[0]
    dev = pts1.device
    x1 = _normalize(pts1, K)
    x2 = _normalize(pts2, K)
    f_mean = (K[0, 0] + K[1, 1]) / 2.0
    th2 = (threshold_px / f_mean) ** 2
    n_valid = torch.sum(valid.to(torch.int64))

    if uniforms is None:
        uniforms = torch.rand((num_hypotheses, n), generator=generator, device=dev)
    scores = torch.where(valid[None, :], uniforms.to(dev), torch.full_like(uniforms, -1.0))
    # top 8 with ties to the lower index (lax.top_k's rule); int64 gather indices
    samp = torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :8].to(torch.int64)

    Es = _eight_point(x1[samp], x2[samp])  # [H, 3, 3]
    finite = torch.isfinite(Es).flatten(1).all(dim=1)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    Es = torch.where(finite[:, None, None], Es, eye)
    votes = (_sampson2(Es, x1, x2) < th2) & valid[None]
    counts = torch.sum(votes, dim=1) * finite.to(torch.int64)
    best = torch.argmax(counts).reshape(1)  # first maximum
    E = Es.index_select(0, best)[0]
    inl = votes.index_select(0, best)[0]

    Rbest, tbest = recover_pose(E, inl, x1, x2)
    ok = (n_valid >= min_matches) & (torch.sum(inl) >= min_matches) & torch.isfinite(E).all()
    inl = inl & ok
    return PoseResult(R=torch.where(ok, Rbest, eye), t=torch.where(ok, tbest, torch.zeros_like(tbest)),
                      E=E, inliers=inl, num_inliers=torch.sum(inl), ok=ok)
