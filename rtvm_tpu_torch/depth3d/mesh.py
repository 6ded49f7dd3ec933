"""Mesh generation from depth maps and point clouds (a copy of
``rtvm_tpu/depth3d/mesh.py``, numpy on the host as there).

The reference meshes through Open3D Poisson / ball-pivoting (depth_to_3d.py:348-422);
Open3D is absent here, so meshing is done with methods that suit the data sources
directly:

- `depth_grid_mesh`: regular-grid triangulation of a depth map, with
  depth-discontinuity edges dropped via a jump threshold.
- `heightfield_mesh_from_points`: rasterize a cloud into a height grid (mean z per
  cell, hole-filled) and triangulate.
- `surface_mesh_from_points`: dispatcher: heightfield-like clouds to the above,
  others to the volumetric smoothed-indicator reconstruction of tsdf.py, whose
  smoothing runs on `device`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def depth_grid_mesh(
    depth: np.ndarray,
    image_bgr: Optional[np.ndarray] = None,
    fx: Optional[float] = None,
    depth_scale: float = 5.0,
    stride: int = 2,
    jump_threshold: float = 0.08,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Triangulate a normalized depth map into a mesh.

    Returns (vertices [N,3], faces [M,3], colors [N,3] uint8 RGB or None).
    Triangles spanning a depth jump larger than jump_threshold (normalized units)
    are removed to avoid rubber-sheet artifacts.
    """
    h, w = depth.shape
    fx = fx or max(h, w)
    d = depth[::stride, ::stride]
    gh, gw = d.shape
    us = np.arange(0, w, stride, dtype=np.float32)
    vs = np.arange(0, h, stride, dtype=np.float32)
    uu, vv = np.meshgrid(us, vs)
    z = (1.0 - d) * depth_scale
    x = (uu - w / 2.0) * z / fx
    y = (vv - h / 2.0) * z / fx
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)

    idx = np.arange(gh * gw).reshape(gh, gw)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    e = idx[1:, 1:].ravel()
    tris = np.concatenate([np.stack([a, b, c], 1), np.stack([b, e, c], 1)], axis=0)

    dz = d.reshape(-1)
    jump = np.maximum(
        np.maximum(np.abs(dz[tris[:, 0]] - dz[tris[:, 1]]),
                   np.abs(dz[tris[:, 1]] - dz[tris[:, 2]])),
        np.abs(dz[tris[:, 0]] - dz[tris[:, 2]]),
    )
    faces = tris[jump < jump_threshold].astype(np.int32)

    colors = None
    if image_bgr is not None:
        colors = image_bgr[::stride, ::stride].reshape(-1, 3)[:, ::-1].copy()
    return verts, faces, colors


def cloud_is_heightfield(points: np.ndarray, grid: int = 48, spread_frac: float = 0.25,
                         cell_frac: float = 0.10) -> bool:
    """True when the cloud has essentially one surface sample per vertical column.

    Rasterizes xy at coarse resolution and measures the fraction of occupied cells
    whose z-extent exceeds spread_frac of the cloud's total z-span — closed or
    multi-view clouds (top AND bottom surfaces in the same column) blow past it.
    """
    pts = np.asarray(points)
    if len(pts) < 16:
        return True
    mn, mx = pts.min(0), pts.max(0)
    span = np.maximum(mx - mn, 1e-9)
    gx = np.clip(((pts[:, 0] - mn[0]) / span[0] * (grid - 1)).astype(int), 0, grid - 1)
    gy = np.clip(((pts[:, 1] - mn[1]) / span[1] * (grid - 1)).astype(int), 0, grid - 1)
    cell = gy * grid + gx
    z = pts[:, 2]
    zmin = np.full(grid * grid, np.inf)
    zmax = np.full(grid * grid, -np.inf)
    np.minimum.at(zmin, cell, z)
    np.maximum.at(zmax, cell, z)
    occ = np.isfinite(zmin)
    spread = (zmax[occ] - zmin[occ]) / span[2]
    return float((spread > spread_frac).mean()) < cell_frac


def surface_mesh_from_points(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    grid: int = 128,
    method: str = "auto",
    device=None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Cloud -> mesh with automatic method choice.

    method: 'heightfield' | 'indicator' | 'auto'. Auto picks heightfield for
    terrain-like clouds and the volumetric indicator level-set (tsdf.py) for
    everything else — the reference's Poisson path (depth_to_3d.py:377-422),
    smoothed on `device` (``cuda`` by default).
    """
    if method == "auto":
        method = "heightfield" if cloud_is_heightfield(points) else "indicator"
    if method == "indicator":
        from rtvm_tpu_torch.depth3d.tsdf import indicator_mesh_from_points

        return indicator_mesh_from_points(points, colors, grid=min(grid, 96), device=device)
    return heightfield_mesh_from_points(points, colors, grid=grid)


def heightfield_mesh_from_points(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    grid: int = 128,
    fill_iterations: int = 8,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Rasterize a cloud (viewed along -z) into a height grid and triangulate."""
    if len(points) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32), None
    mn = points.min(0)
    mx = points.max(0)
    span = np.maximum(mx[:2] - mn[:2], 1e-6)
    gx = np.clip(((points[:, 0] - mn[0]) / span[0] * (grid - 1)).astype(int), 0, grid - 1)
    gy = np.clip(((points[:, 1] - mn[1]) / span[1] * (grid - 1)).astype(int), 0, grid - 1)
    zsum = np.zeros((grid, grid))
    cnt = np.zeros((grid, grid))
    np.add.at(zsum, (gy, gx), points[:, 2])
    np.add.at(cnt, (gy, gx), 1.0)
    csum = None
    if colors is not None:
        csum = np.zeros((grid, grid, 3))
        np.add.at(csum, (gy, gx), colors.astype(np.float64))

    zmap = np.where(cnt > 0, zsum / np.maximum(cnt, 1), np.nan)
    # simple iterative hole fill from neighbours
    for _ in range(fill_iterations):
        holes = np.isnan(zmap)
        if not holes.any():
            break
        padded = np.pad(zmap, 1, constant_values=np.nan)
        stacks = np.stack([
            padded[:-2, 1:-1], padded[2:, 1:-1], padded[1:-1, :-2], padded[1:-1, 2:]
        ])
        # manual nan-mean: np.nanmean warns ("Mean of empty slice") on all-NaN
        # neighbourhoods, which interior holes always produce in round 1+
        valid = ~np.isnan(stacks)
        nbcnt = valid.sum(axis=0)
        nbsum = np.where(valid, stacks, 0.0).sum(axis=0)
        nb = np.where(nbcnt > 0, nbsum / np.maximum(nbcnt, 1), np.nan)
        zmap = np.where(holes & ~np.isnan(nb), nb, zmap)
    fallback = float(np.nanmean(zmap)) if not np.isnan(zmap).all() else 0.0
    zmap = np.nan_to_num(zmap, nan=fallback)

    ys, xs = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    vx = mn[0] + xs / (grid - 1) * span[0]
    vy = mn[1] + ys / (grid - 1) * span[1]
    verts = np.stack([vx, vy, zmap], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(grid * grid).reshape(grid, grid)
    a = idx[:-1, :-1].ravel(); b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel(); e = idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], 1), np.stack([b, e, c], 1)], 0).astype(np.int32)

    vcols = None
    if csum is not None:
        with np.errstate(all="ignore"):
            cmap = csum / np.maximum(cnt[..., None], 1)
        vcols = np.clip(np.nan_to_num(cmap, nan=128), 0, 255).reshape(-1, 3).astype(np.uint8)
    return verts, faces, vcols
