"""Homography estimation, validation and smoothing (counterpart of
``rtvm_tpu/geometry/homography.py``).

RANSAC evaluates a fixed batch of hypotheses at once: closed-form 4-point
solves, vectorized inlier voting, argmax, then masked least-squares refits.
Every function batches over leading axes. All arithmetic is float32 with TF32
off (package ``__init__``): rounded H entries move warped corners by pixels
and compound along the H chain.

Random sampling: the JAX version draws hypotheses with ``jax.random.uniform``
and ``top_k``; PyTorch cannot replay that stream. ``ransac_homography`` takes
the sample indices (or the uniform draws they come from, see
``sample_indices``) when the caller has them, and otherwise draws with a
``torch.Generator``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from rtvm_tpu_torch.device import resolve_device

EYE3 = np.eye(3, dtype=np.float32)


class RansacResult(NamedTuple):
    H: torch.Tensor  # [..., 3, 3] float32, maps src -> dst; identity on failure
    inliers: torch.Tensor  # [..., K] bool
    num_inliers: torch.Tensor  # [...] int64
    ok: torch.Tensor  # [...] bool — enough matches and a usable model


def _eye_like(H: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=H.dtype, device=H.device).expand_as(H)


def _safe(d: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(d.abs() < eps, torch.full_like(d, eps), d)


def project(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply H [..., 3, 3] to points [..., N, 2] (cv2.perspectiveTransform)."""
    x, y = pts[..., 0], pts[..., 1]

    def h(i, j):
        return H[..., i, j, None]

    d = _safe(h(2, 0) * x + h(2, 1) * y + h(2, 2), 1e-12)
    u = (h(0, 0) * x + h(0, 1) * y + h(0, 2)) / d
    v = (h(1, 0) * x + h(1, 1) * y + h(1, 2)) / d
    return torch.stack([u, v], dim=-1)


def _normalization(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Hartley normalization transform [..., 3, 3] for weighted points
    [..., K, 2], weights [..., K]."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    c = torch.sum(pts * w[..., None], dim=-2) / wsum[..., None]
    dist = torch.sqrt(torch.sum((pts - c[..., None, :]) ** 2, dim=-1))
    mean_dist = torch.clamp(torch.sum(dist * w, dim=-1) / wsum, min=1e-9)
    s = math.sqrt(2.0) / mean_dist
    z, o = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([
        torch.stack([s, z, -s * c[..., 0]], -1),
        torch.stack([z, s, -s * c[..., 1]], -1),
        torch.stack([z, z, o], -1),
    ], -2)


def _dlt_rows(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """[..., 2K, 9] DLT constraint matrix for src -> dst correspondences."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=-1)
    return torch.cat([r1, r2], dim=-2)


def _square_to_quad(q: torch.Tensor) -> torch.Tensor:
    """Closed-form homography [..., 3, 3] mapping the unit square to quad
    q [..., 4, 2] (Heckbert's construction)."""
    x0, y0 = q[..., 0, 0], q[..., 0, 1]
    x1, y1 = q[..., 1, 0], q[..., 1, 1]
    x2, y2 = q[..., 2, 0], q[..., 2, 1]
    x3, y3 = q[..., 3, 0], q[..., 3, 1]
    dx1, dy1 = x1 - x2, y1 - y2
    dx2, dy2 = x3 - x2, y3 - y2
    dx3, dy3 = x0 - x1 + x2 - x3, y0 - y1 + y2 - y3
    den = _safe(dx1 * dy2 - dx2 * dy1, 1e-12)
    g = (dx3 * dy2 - dx2 * dy3) / den
    h = (dx1 * dy3 - dx3 * dy1) / den
    a = x1 - x0 + g * x1
    b = x3 - x0 + h * x3
    d = y1 - y0 + g * y1
    e = y3 - y0 + h * y3
    return torch.stack([
        torch.stack([a, b, x0], -1),
        torch.stack([d, e, y0], -1),
        torch.stack([g, h, torch.ones_like(g)], -1),
    ], -2)


def _adjugate3(m: torch.Tensor) -> torch.Tensor:
    """3x3 adjugate of [..., 3, 3] (inverse up to scale)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)


def _unit_h22(H: torch.Tensor) -> torch.Tensor:
    return H / _safe(H[..., 2, 2], 1e-12)[..., None, None]


def dlt_homography_4pt(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Exact homography from 4 correspondences [..., 4, 2]: Hartley-normalize
    both sides, then H = S2Q(dst_n) @ adj(S2Q(src_n)) in closed form."""
    ones4 = torch.ones(src.shape[:-1], dtype=torch.float32, device=src.device)
    t_src = _normalization(src, ones4)
    t_dst = _normalization(dst, ones4)
    sn = project(t_src, src)
    dn = project(t_dst, dst)
    hn = _square_to_quad(dn) @ _adjugate3(_square_to_quad(sn))
    return _unit_h22(_adjugate3(t_dst) @ hn @ t_src)


def dlt_homography_weighted(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Least-squares homography over weighted correspondences (normal
    equations with the normalized h33 pinned to 1: one 8x8 solve)."""
    t_src = _normalization(src, w)
    t_dst = _normalization(dst, w)
    sn = project(t_src, src)
    dn = project(t_dst, dst)
    a = _dlt_rows(sn, dn)  # [..., 2K, 9]
    ww = torch.cat([w, w], dim=-1)[..., None]
    m = (a * ww).transpose(-1, -2) @ a  # [..., 9, 9]
    eye8 = torch.eye(8, dtype=m.dtype, device=m.device)
    h8 = torch.linalg.solve_ex(m[..., :8, :8] + 1e-8 * eye8, -m[..., :8, 8:9])[0][..., 0]
    hn = torch.cat([h8, torch.ones_like(h8[..., :1])], dim=-1).reshape(*h8.shape[:-1], 3, 3)
    return _unit_h22(torch.linalg.inv_ex(t_dst)[0] @ hn @ t_src)


def _reproj_err2(H: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    p = project(H, src)
    return torch.sum((p - dst) ** 2, dim=-1)


def _all_finite(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return torch.isfinite(x).flatten(-ndim).all(dim=-1)


def sample_indices(uniforms: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """4 distinct valid indices per hypothesis: the top 4 of the uniform draws
    [..., Hn, K] over valid slots (invalid slots score -1), ties to the lower
    index. The JAX version's rule, so its draws give its hypotheses."""
    scores = torch.where(valid[..., None, :], uniforms, torch.full_like(uniforms, -1.0))
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :4]


def ransac_homography(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    samples: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    num_hypotheses: int = 512,
    reproj_threshold: float = 2.0,
    refine_iterations: int = 2,
    min_matches: int = 4,
) -> RansacResult:
    """Vectorized RANSAC over [..., K] correspondences with a validity mask:
    `num_hypotheses` 4-point solves, inlier voting, argmax, then weighted-DLT
    refits that are kept only when they lose no inliers.

    `samples` [..., num_hypotheses, 4] gives the hypotheses' indices; without
    it they are drawn uniformly from the valid slots with `generator`."""
    th2 = reproj_threshold * reproj_threshold
    n_valid = torch.sum(valid.to(torch.int64), dim=-1)
    lead = src.shape[:-2]
    k = src.shape[-2]
    if samples is None:
        u = torch.rand((*lead, num_hypotheses, k), generator=generator, device=src.device)
        samples = sample_indices(u, valid)
    # int64: torch.gather with an expanded int32 index gives wrong rows on the CPU
    samples = samples.to(torch.int64)
    nh = samples.shape[-2]

    def take(pts):  # [..., K, 2] -> [..., Hn, 4, 2]
        idx = samples.reshape(*lead, nh * 4, 1).expand(*lead, nh * 4, 2)
        return torch.gather(pts, -2, idx).reshape(*lead, nh, 4, 2)

    Hs = dlt_homography_4pt(take(src), take(dst))  # [..., Hn, 3, 3]
    finite = _all_finite(Hs, 2)
    Hs = torch.where(finite[..., None, None], Hs, _eye_like(Hs))

    errs = _reproj_err2(Hs, src[..., None, :, :], dst[..., None, :, :])  # [..., Hn, K]
    votes = (errs < th2) & valid[..., None, :]
    counts = torch.sum(votes, dim=-1) * finite.to(torch.int64)
    best = torch.argmax(counts, dim=-1)  # first maximum
    H = torch.gather(Hs, -3, best[..., None, None, None].expand(*lead, 1, 3, 3))[..., 0, :, :]
    inl = torch.gather(votes, -2, best[..., None, None].expand(*lead, 1, k))[..., 0, :]

    for _ in range(refine_iterations):
        w = inl.to(torch.float32)
        enough = torch.sum(w, dim=-1) >= 4
        Hr = dlt_homography_weighted(src, dst, w)
        good = enough & _all_finite(Hr, 2)
        Hn = torch.where(good[..., None, None], Hr, H)
        inl_n = (_reproj_err2(Hn, src, dst) < th2) & valid
        better = torch.sum(inl_n, dim=-1) >= torch.sum(inl, dim=-1)
        H = torch.where(better[..., None, None], Hn, H)
        inl = torch.where(better[..., None], inl_n, inl)

    ok = (n_valid >= min_matches) & (torch.sum(inl, dim=-1) >= 4) & _all_finite(H, 2)
    H = torch.where(ok[..., None, None], H, _eye_like(H))
    inl = inl & ok[..., None]
    return RansacResult(H=H, inliers=inl, num_inliers=torch.sum(inl, dim=-1), ok=ok)


# ---------------------------------------------------------------------------
# Anti-shake validation + smoothing
# ---------------------------------------------------------------------------


def validate_homography(H, translation_threshold=50.0, scale_threshold=0.3,
                        perspective_threshold=1e-3) -> torch.Tensor:
    """bool [...] — True if the relative homography [..., 3, 3] looks like sane
    inter-frame motion."""
    finite = _all_finite(H, 2)
    t = torch.sqrt(H[..., 0, 2] ** 2 + H[..., 1, 2] ** 2)
    det = H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0]
    scale = torch.sqrt(torch.clamp(det, min=0.0))
    scale_ok = (det > 0) & ((scale - 1.0).abs() <= scale_threshold)
    persp_ok = (H[..., 2, 0].abs() <= perspective_threshold) & (
        H[..., 2, 1].abs() <= perspective_threshold
    )
    return finite & (t <= translation_threshold) & scale_ok & persp_ok


def smoothing_weights(history_size: int = 5, device=None) -> torch.Tensor:
    """[S, S] float32 table indexed by (fill count - 1, slot): the populated
    slots S-c..S-1 get normalized linspace(0.5, 1.0, c) weights."""
    s = history_size
    table = np.zeros((s, s), dtype=np.float32)
    for c in range(1, s + 1):
        w = np.linspace(0.5, 1.0, c)
        table[c - 1, s - c :] = w / w.sum()
    return torch.from_numpy(table).to(resolve_device(device))


def smooth_homography_step(hbuf: torch.Tensor, hcount: torch.Tensor, H: torch.Tensor,
                           weight_table: torch.Tensor):
    """Push H into the sliding history [S, 3, 3] and return (hbuf, hcount,
    weighted average); with fewer than 2 entries the raw H is returned."""
    size = hbuf.shape[0]
    hbuf = torch.cat([hbuf[1:], H[None]], dim=0)
    hcount = torch.clamp(hcount + 1, max=size)
    # index on the device: a 0-dim index tensor would be read with .item()
    w = weight_table.index_select(0, (hcount - 1).reshape(1))[0]  # [S]
    h_avg = torch.einsum("s,sij->ij", w, hbuf)
    return hbuf, hcount, torch.where(hcount < 2, H, h_avg)


@functools.lru_cache(maxsize=32)
def _frame_corners(w: int, h: int, device: torch.device) -> torch.Tensor:
    """[4, 2] float32 corners (0,0), (w,0), (w,h), (0,h), built once per
    device (read only)."""
    return torch.tensor([[0.0, 0.0], [float(w), 0.0], [float(w), float(h)], [0.0, float(h)]],
                        dtype=torch.float32, device=device)


def transform_corners(w: int, h: int, H: torch.Tensor) -> torch.Tensor:
    """Warped frame corners (0,0), (w,0), (w,h), (0,h) under H [..., 3, 3]."""
    return project(H, _frame_corners(w, h, H.device))
