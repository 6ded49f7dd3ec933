"""Point-to-point ICP (counterpart of ``rtvm_tpu/depth3d/icp.py``), on the card.

Replaces Open3D's registration_icp as used by the reference multi-frame fusion
(depth_to_3d.py:651-665: threshold 0.5, 50 iterations, fitness-gated accept).
Each iteration finds every source point's nearest target point by brute
force, |a - b|^2 = |a|^2 + |b|^2 - 2 a.b from one matrix product, argmin
with ties to the first index (``torch.matmul`` is a plain product outside
any kernel of the JAX package), and takes the aligning rigid transform from
the SVD of the weighted cross-covariance (Kabsch). Fixed-size inputs:
``register_clouds`` subsamples both clouds to ``max_points`` with the JAX
package's ``np.random.RandomState`` draws, so both align the same points.

The iterations run in float64 (the JAX version in float32), as LK does in
``slam/flow.py``: on near-planar aerial clouds the ICP objective is flat
along the ground, and in float32 a rounding difference between the card and
the CPU flips nearest-neighbour near-ties and moved t by 1.8e-3 after 50
iterations on the same clouds. The result is returned in float32, as JAX's.

The JAX version is one jitted scan. Here the 50 iterations are a Python loop
of PyTorch ops that never reads a value back on its own; the 3x3 SVD does
(PyTorch checks its LAPACK/cuSOLVER status on the host), so a call on the
card waits for it once per iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from rtvm_tpu_torch.device import resolve_device


class ICPResult(NamedTuple):
    R: torch.Tensor  # [3, 3]
    t: torch.Tensor  # [3]
    fitness: torch.Tensor  # fraction of source points with a match within threshold
    inlier_rmse: torch.Tensor


def _nearest(src: torch.Tensor, dst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each src point: (index of nearest dst point, squared distance).
    The argmin runs over |b|^2 - 2 a.b, one fused product (|a|^2 is the same
    along a row); |a|^2 is added to the chosen entries only."""
    part = torch.addmm((dst * dst).sum(1)[None, :], src, dst.T, alpha=-2.0)
    idx = torch.argmin(part, dim=1)
    return idx, torch.gather(part, 1, idx[:, None])[:, 0] + (src * src).sum(1)


def _kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor):
    """Weighted rigid alignment src -> dst."""
    wsum = torch.clamp(w.sum(), min=1e-6)
    cs = (src * w[:, None]).sum(0) / wsum
    cd = (dst * w[:, None]).sum(0) / wsum
    x = (src - cs) * w[:, None]
    y = dst - cd
    u, _, vt = torch.linalg.svd(x.T @ y)
    d = torch.sign(torch.linalg.det(vt.T @ u.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = vt.T @ D @ u.T
    return R, cd - R @ cs


def icp_point_to_point(source: torch.Tensor, target: torch.Tensor, threshold: float = 0.5,
                       max_iterations: int = 50) -> ICPResult:
    """Align source [N, 3] to target [M, 3] (on one device). Returns the
    final rigid transform in float32, on that device."""
    th2 = threshold * threshold
    source, target = source.to(torch.float64), target.to(torch.float64)
    R = torch.eye(3, dtype=torch.float64, device=source.device)
    t = torch.zeros(3, dtype=torch.float64, device=source.device)
    for _ in range(max_iterations):
        moved = source @ R.T + t
        idx, d2 = _nearest(moved, target)
        w = (d2 < th2).to(torch.float64)
        Rd, td = _kabsch(moved, target[idx], w)
        R, t = Rd @ R, Rd @ t + td
    moved = source @ R.T + t
    _, d2 = _nearest(moved, target)
    inl = d2 < th2
    fitness = inl.to(torch.float32).mean()
    rmse = torch.sqrt(torch.clamp((d2 * inl).sum() / torch.clamp(inl.sum(), min=1), min=0.0))
    return ICPResult(R=R.to(torch.float32), t=t.to(torch.float32), fitness=fitness,
                     inlier_rmse=rmse.to(torch.float32))


def register_clouds(source: np.ndarray, target: np.ndarray, threshold: float = 0.5,
                    max_iterations: int = 50, max_points: int = 4096, seed: int = 0,
                    device=None) -> ICPResult:
    """Host wrapper: subsample both clouds to a fixed size (the JAX
    package's draws) and run ICP on `device` (``cuda`` by default)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)

    def sub(x):
        if len(x) > max_points:
            return x[rng.choice(len(x), max_points, replace=False)]
        pad = max_points - len(x)
        if pad > 0 and len(x) > 0:
            x = np.concatenate([x, x[rng.choice(len(x), pad)]], axis=0)
        return x

    src = torch.from_numpy(np.ascontiguousarray(sub(source), np.float32)).to(dev)
    dst = torch.from_numpy(np.ascontiguousarray(sub(target), np.float32)).to(dev)
    return icp_point_to_point(src, dst, threshold, max_iterations)
