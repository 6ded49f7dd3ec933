"""Point-cloud operations: unprojection, voxel downsampling, statistical outlier
removal, normals, rotation. A copy of ``rtvm_tpu/depth3d/pointcloud.py``,
which is numpy and scipy (``cKDTree``) on the host in JAX as well; the
results are identical.

Replaces the reference's Open3D calls (DepthToPointCloud depth_to_3d.py:225-345,
voxel_down_sample / remove_statistical_outlier / estimate_normals
depth_to_3d.py:354-375,686-717).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def unproject_depth(
    depth: np.ndarray,
    image_bgr: Optional[np.ndarray] = None,
    fx: Optional[float] = None,
    fy: Optional[float] = None,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
    depth_scale: float = 5.0,
    stride: int = 1,
    invert: bool = True,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Pinhole back-projection of a normalized depth map -> [N, 3] points (+ colors).

    Mirrors reference create_point_cloud_manual (depth_to_3d.py:292-345): z =
    (1 - d) * depth_scale when `invert` (near=1 convention), x = (u - cx) z / fx.
    """
    h, w = depth.shape
    fx = fx or max(h, w)
    fy = fy or fx
    cx = cx if cx is not None else w / 2.0
    cy = cy if cy is not None else h / 2.0

    d = depth[::stride, ::stride]
    us = np.arange(0, w, stride, dtype=np.float32)
    vs = np.arange(0, h, stride, dtype=np.float32)
    uu, vv = np.meshgrid(us, vs)
    z = (1.0 - d) * depth_scale if invert else d * depth_scale
    valid = z > 0.01 * depth_scale
    x = (uu - cx) * z / fx
    y = (vv - cy) * z / fy
    pts = np.stack([x[valid], y[valid], z[valid]], axis=1).astype(np.float32)
    cols = None
    if image_bgr is not None:
        cols = image_bgr[::stride, ::stride][valid][:, ::-1].copy()  # BGR -> RGB
    return pts, cols


def voxel_downsample(
    points: np.ndarray, voxel: float, colors: Optional[np.ndarray] = None
):
    """Average points within voxels (o3d voxel_down_sample equivalent)."""
    if len(points) == 0:
        return points, colors
    keys = np.floor(points / voxel).astype(np.int64)
    # hash voxel coords
    hashed = keys[:, 0] * 73856093 ^ keys[:, 1] * 19349663 ^ keys[:, 2] * 83492791
    order = np.argsort(hashed, kind="stable")
    hs = hashed[order]
    starts = np.flatnonzero(np.concatenate([[True], hs[1:] != hs[:-1]]))
    counts = np.diff(np.concatenate([starts, [len(hs)]]))
    sums = np.add.reduceat(points[order], starts, axis=0)
    out = (sums / counts[:, None]).astype(np.float32)
    cout = None
    if colors is not None:
        csums = np.add.reduceat(colors[order].astype(np.float64), starts, axis=0)
        cout = (csums / counts[:, None]).astype(np.uint8)
    return out, cout


def remove_statistical_outliers(
    points: np.ndarray, nb_neighbors: int = 20, std_ratio: float = 2.0,
    colors: Optional[np.ndarray] = None,
):
    """Drop points whose mean kNN distance exceeds mean + std_ratio * std
    (o3d remove_statistical_outlier equivalent; scipy cKDTree backend)."""
    if len(points) < nb_neighbors + 1:
        return points, colors, np.ones(len(points), bool)
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    d, _ = tree.query(points, k=nb_neighbors + 1)
    mean_d = d[:, 1:].mean(axis=1)
    th = mean_d.mean() + std_ratio * mean_d.std()
    keep = mean_d <= th
    return points[keep], (colors[keep] if colors is not None else None), keep


def estimate_normals(points: np.ndarray, k: int = 16, orient_towards: Optional[np.ndarray] = None):
    """Per-point normals via local PCA (o3d estimate_normals equivalent)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    _, idx = tree.query(points, k=min(k, len(points)))
    nbrs = points[idx]  # [N, k, 3]
    mean = nbrs.mean(axis=1, keepdims=True)
    x = nbrs - mean
    cov = np.einsum("nki,nkj->nij", x, x) / x.shape[1]
    _, vecs = np.linalg.eigh(cov)
    normals = vecs[:, :, 0]
    if orient_towards is not None:
        to_cam = orient_towards[None, :] - points
        flip = np.sum(normals * to_cam, axis=1) < 0
        normals[flip] = -normals[flip]
    return normals.astype(np.float32)


def rotate_points(points: np.ndarray, axis: str, angle_rad: float) -> np.ndarray:
    """Rotate about a coordinate axis (reference rotates meshes pi about X,
    multi-view clouds about Y — depth_to_3d.py:726,1049)."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    if axis == "x":
        R = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    elif axis == "y":
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    else:
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return (points @ R.T).astype(np.float32)
