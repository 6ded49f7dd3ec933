"""Volumetric surface reconstruction: TSDF fusion and marching-tetrahedra
extraction (counterpart of ``rtvm_tpu/depth3d/tsdf.py``).

The reference reconstructs surfaces from fused point clouds with Open3D's screened
Poisson (depth-9, density culling) and ball-pivoting (depth_to_3d.py:377-422); its
multi-view 360-degree fusion (depth_to_3d.py:996-1175) produces clouds that are NOT
heightfields.

- ``fuse_tsdf``: projective truncated-signed-distance fusion of posed depth
  maps on a regular grid, on the card: a loop over frames, each a dense grid
  projection (one 4x4 product, float32 ``torch.linalg.inv`` of the pose,
  ``torch.round`` half to even as ``jnp.round``, a gather) and the
  Curless-Levoy weighted update. The JAX version is one jitted scan.
- ``indicator_from_points``: Poisson-like indicator field of an unorganized
  cloud: occupancy splat, morphological closing and exterior flood fill on
  the host (scipy, as in JAX), then the separable Gaussian smoothing on the
  card (``_smooth3d``: three zero-padded 1-D convolutions, JAX's "SAME").
- ``marching_tetrahedra``: vectorized iso-surface extraction (6-tet cube split,
  Bourke case table) with global edge dedup, numpy on the host as in JAX.

``marching_tetrahedra``, ``indicator_from_points``' host part,
``_nearest_point_colors``, ``make_tsdf`` and ``tsdf_mesh`` are copies.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rtvm_tpu_torch.device import resolve_device

# Canonical tetrahedron edges: index -> (local vertex a, local vertex b).
_TET_EDGES = np.array(
    [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], dtype=np.int64
)

# Bourke marching-tetrahedra case table remapped onto the canonical edge ids above.
# Row = 4-bit case (bit i set when vertex i is inside). Each row holds up to two
# triangles of edge ids; -1 marks an absent triangle.
_TRI_TABLE = -np.ones((16, 2, 3), dtype=np.int64)
_TRI_TABLE[0x01, 0] = (0, 1, 2)
_TRI_TABLE[0x0E, 0] = (0, 2, 1)
_TRI_TABLE[0x02, 0] = (0, 4, 3)
_TRI_TABLE[0x0D, 0] = (0, 3, 4)
_TRI_TABLE[0x03] = [(2, 1, 4), (4, 1, 3)]
_TRI_TABLE[0x0C] = [(2, 4, 1), (4, 3, 1)]
_TRI_TABLE[0x04, 0] = (1, 3, 5)
_TRI_TABLE[0x0B, 0] = (1, 5, 3)
_TRI_TABLE[0x05] = [(0, 5, 2), (0, 3, 5)]
_TRI_TABLE[0x0A] = [(0, 2, 5), (0, 5, 3)]
_TRI_TABLE[0x06] = [(0, 4, 5), (0, 5, 1)]
_TRI_TABLE[0x09] = [(0, 5, 4), (0, 1, 5)]
_TRI_TABLE[0x07, 0] = (2, 5, 4)
_TRI_TABLE[0x08, 0] = (2, 4, 5)

# 6-tet decomposition of a cube around the 0-6 main diagonal; cube corners are
# (dx, dy, dz) offsets in x-fastest order below.
_CUBE_CORNERS = np.array(
    [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
     (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], dtype=np.int64
)
_CUBE_TETS = np.array(
    [(0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
     (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6)], dtype=np.int64
)


def marching_tetrahedra(
    field: np.ndarray,
    iso: float = 0.0,
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    voxel: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of a 3-D scalar field.

    field: (nx, ny, nz) values sampled at grid vertices. Returns
    (vertices [N,3] float32 in world units, faces [M,3] int32) with shared
    vertices (each intersected grid edge contributes exactly one vertex).
    """
    f = np.asarray(field, np.float32)
    nx, ny, nz = f.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    # Nudge exact-iso samples so no interpolation t is degenerate.
    flat = f.reshape(-1).copy()
    eps = 1e-6 * max(1.0, float(np.abs(flat).max()))
    flat[flat == iso] += eps

    inside = (flat < iso)

    # Flat vertex index grid (x-major to match _CUBE_CORNERS offsets).
    def vid(ix, iy, iz):
        return (ix * ny + iy) * nz + iz

    cx, cy, cz = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij"
    )
    base = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], 1)  # (C, 3)

    # Cheap cull: keep only cells whose 8 corners straddle iso.
    corner_ids = (
        vid(base[:, None, 0] + _CUBE_CORNERS[None, :, 0],
            base[:, None, 1] + _CUBE_CORNERS[None, :, 1],
            base[:, None, 2] + _CUBE_CORNERS[None, :, 2])
    )  # (C, 8)
    corner_in = inside[corner_ids]
    active = corner_in.any(1) & ~corner_in.all(1)
    corner_ids = corner_ids[active]
    if corner_ids.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    tets = corner_ids[:, _CUBE_TETS]            # (C, 6, 4) global vertex ids
    tets = tets.reshape(-1, 4)                   # (T, 4)
    tin = inside[tets]                           # (T, 4)
    case = (tin * (1 << np.arange(4))).sum(1)    # (T,)

    tris_e = _TRI_TABLE[case]                    # (T, 2, 3) local edge ids
    valid = tris_e[..., 0] >= 0                  # (T, 2)
    tris_e = tris_e[valid]                       # (K, 3)
    tet_of = np.broadcast_to(np.arange(len(tets))[:, None], valid.shape)[valid]

    pair = _TET_EDGES[tris_e]                    # (K, 3, 2) local vertex pairs
    ga = tets[tet_of[:, None], pair[..., 0]]     # (K, 3)
    gb = tets[tet_of[:, None], pair[..., 1]]
    lo = np.minimum(ga, gb)
    hi = np.maximum(ga, gb)
    keys = lo.astype(np.int64) * (nx * ny * nz) + hi

    uniq, inv = np.unique(keys.reshape(-1), return_inverse=True)
    ua = (uniq // (nx * ny * nz)).astype(np.int64)
    ub = (uniq % (nx * ny * nz)).astype(np.int64)
    fa, fb = flat[ua], flat[ub]
    t = np.clip((iso - fa) / (fb - fa), 0.0, 1.0)[:, None]

    def coords(v):
        return np.stack([v // (ny * nz), (v // nz) % ny, v % nz], 1).astype(np.float32)

    verts = coords(ua) + t * (coords(ub) - coords(ua))
    verts = np.asarray(origin, np.float32)[None] + verts * float(voxel)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # Drop degenerate faces (two corners collapsed onto the same edge vertex).
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts.astype(np.float32), faces[good]


class IndicatorGrid(NamedTuple):
    field: np.ndarray          # (n, n, n) smoothed indicator, ~1 inside
    origin: np.ndarray         # (3,) world position of grid vertex (0,0,0)
    voxel: float


def indicator_from_points(
    points: np.ndarray,
    grid: int = 96,
    pad: float = 0.06,
    close_iters: int = 2,
    smooth_sigma: float = 1.2,
    device=None,
) -> IndicatorGrid:
    """Poisson-like smoothed indicator field of an unorganized cloud.

    Occupancy splat -> binary closing (bridges sampling gaps) -> exterior flood
    fill from the grid boundary -> Gaussian-smoothed interior indicator. The
    0.5-level set is the reconstructed surface. The smoothing, the only
    FLOP-heavy part, runs on `device` (``cuda`` by default).
    """
    from scipy import ndimage

    pts = np.asarray(points, np.float64)
    mn = pts.min(0)
    mx = pts.max(0)
    span = float((mx - mn).max())
    span = max(span, 1e-6)
    origin = mn - pad * span
    voxel = span * (1.0 + 2.0 * pad) / (grid - 1)

    ijk = np.clip(((pts - origin) / voxel).round().astype(np.int64), 0, grid - 1)
    occ = np.zeros((grid, grid, grid), bool)
    occ[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True

    # Seal sampling gaps of up to ~2*close_iters voxels BEFORE deciding what is
    # exterior: dilate, flood-fill the exterior on the dilated solid, then erode
    # the solid back. (Plain binary_closing erodes the thin shell before the fill
    # can see it sealed, so a sparse shell leaks.)
    st = ndimage.generate_binary_structure(3, 2)
    dil = ndimage.binary_dilation(occ, st, iterations=close_iters) if close_iters else occ
    free = ~dil
    lbl, _ = ndimage.label(free)
    border_labels = np.unique(
        np.concatenate([
            lbl[0].ravel(), lbl[-1].ravel(), lbl[:, 0].ravel(),
            lbl[:, -1].ravel(), lbl[:, :, 0].ravel(), lbl[:, :, -1].ravel(),
        ])
    )
    border_labels = border_labels[border_labels != 0]
    exterior = np.isin(lbl, border_labels)
    solid = ~exterior  # dilated interior (occupied + enclosed cavities)
    if close_iters:
        solid = ndimage.binary_erosion(
            solid, st, iterations=close_iters, border_value=0
        ) | occ
    interior = solid.astype(np.float32)

    dev = resolve_device(device)
    field = _smooth3d(torch.from_numpy(interior).to(dev), smooth_sigma).cpu().numpy()
    return IndicatorGrid(field=field, origin=origin.astype(np.float32), voxel=float(voxel))


def _smooth3d(vol: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable 3-D Gaussian smoothing of a [n, n, n] float32 volume on its
    device: three 1-D convolutions padded with zeros (JAX's "SAME"; not
    ``ops/filters.py``, which replicates the edge)."""
    r = max(1, int(np.ceil(2.5 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    kern = torch.from_numpy(k).to(vol.device).view(1, 1, -1)
    for ax in range(3):
        u = vol.movedim(ax, -1)
        shp = u.shape
        out = F.conv1d(u.reshape(-1, 1, shp[-1]), kern, padding=r)
        vol = out.reshape(shp).movedim(-1, ax)
    return vol


def indicator_mesh_from_points(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    grid: int = 96,
    iso: float = 0.5,
    device=None,
    **kw,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Cloud -> watertight-ish surface mesh via the smoothed-indicator level set.

    Replaces Open3D Poisson for closed/non-heightfield clouds (reference
    depth_to_3d.py:377-422, 996-1175). Vertex colors are taken from the nearest
    input point (voxel-hashed lookup).
    """
    pts = np.asarray(points, np.float32)
    if len(pts) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32), None
    ind = indicator_from_points(pts, grid=grid, device=device, **kw)
    # marching_tetrahedra treats "< iso" as inside; interior field is ~1 inside, so
    # extract on the negated field.
    verts, faces = marching_tetrahedra(-ind.field, -iso, tuple(ind.origin), ind.voxel)
    vcols = None
    if colors is not None and len(verts):
        vcols = _nearest_point_colors(verts, pts, np.asarray(colors), ind)
    return verts, faces, vcols


def _nearest_point_colors(
    verts: np.ndarray, pts: np.ndarray, colors: np.ndarray, ind: IndicatorGrid
) -> np.ndarray:
    """Mean point color per voxel, dilated to cover surface vertices."""
    from scipy import ndimage

    g = ind.field.shape[0]
    ijk = np.clip(((pts - ind.origin) / ind.voxel).round().astype(np.int64), 0, g - 1)
    csum = np.zeros((g, g, g, 3))
    cnt = np.zeros((g, g, g))
    np.add.at(csum, (ijk[:, 0], ijk[:, 1], ijk[:, 2]), colors[:, :3].astype(np.float64))
    np.add.at(cnt, (ijk[:, 0], ijk[:, 1], ijk[:, 2]), 1.0)
    cmap = csum / np.maximum(cnt[..., None], 1)
    have = cnt > 0
    # Propagate colors outward a few voxels so level-set vertices (offset ~1-2
    # voxels from samples) find a color.
    for _ in range(4):
        if have.all():
            break
        grown = ndimage.binary_dilation(have)
        ring = grown & ~have
        if not ring.any():
            break
        acc = np.zeros((g, g, g, 3))
        n = np.zeros((g, g, g))
        for ax in range(3):
            for sh in (1, -1):
                acc += np.roll(np.where(have[..., None], cmap, 0.0), sh, axis=ax)
                n += np.roll(have.astype(np.float64), sh, axis=ax)
        cmap = np.where(ring[..., None], acc / np.maximum(n[..., None], 1), cmap)
        have = grown
    vijk = np.clip(((verts - ind.origin) / ind.voxel).round().astype(np.int64), 0, g - 1)
    return np.clip(cmap[vijk[:, 0], vijk[:, 1], vijk[:, 2]], 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Projective TSDF fusion (Curless-Levoy) of posed depth maps.
# ---------------------------------------------------------------------------


class TSDFVolume(NamedTuple):
    tsdf: np.ndarray      # (n, n, n) in [-1, 1], +1 = empty space
    weight: np.ndarray    # (n, n, n) accumulation weights
    origin: np.ndarray    # (3,)
    voxel: float
    trunc: float


def make_tsdf(
    origin, size: float, grid: int = 96, trunc_voxels: float = 3.0
) -> TSDFVolume:
    voxel = float(size) / (grid - 1)
    return TSDFVolume(
        tsdf=np.ones((grid, grid, grid), np.float32),
        weight=np.zeros((grid, grid, grid), np.float32),
        origin=np.asarray(origin, np.float32),
        voxel=voxel,
        trunc=trunc_voxels * voxel,
    )


def fuse_tsdf(
    vol: TSDFVolume,
    depths: np.ndarray,        # (F, H, W) metric depth, <=0 = invalid
    intrinsics: np.ndarray,    # (3, 3) shared K
    poses_c2w: np.ndarray,     # (F, 4, 4) camera-to-world
    device=None,
) -> TSDFVolume:
    """Integrate posed depth maps into the TSDF on `device` (``cuda`` by
    default), one frame after another.

    Per frame: transform the whole voxel grid into the camera (one 4x4
    product), project with K, nearest-pixel depth lookup, truncated SDF
    update with weight accumulation. All dense, static-shape work.
    """
    dev = resolve_device(device)
    g = vol.tsdf.shape[0]
    ii = np.arange(g, dtype=np.float32)
    gx, gy, gz = np.meshgrid(ii, ii, ii, indexing="ij")
    world = vol.origin[None, :] + vol.voxel * np.stack(
        [gx.ravel(), gy.ravel(), gz.ravel()], 1
    )  # (V, 3)
    world_h = np.concatenate([world, np.ones((len(world), 1), np.float32)], 1)

    K = torch.from_numpy(np.asarray(intrinsics, np.float32)).to(dev)
    Wh = torch.from_numpy(world_h).to(dev)
    H, Wd = depths.shape[1:]
    trunc = vol.trunc
    tsdf = torch.from_numpy(vol.tsdf.ravel()).to(dev)
    weight = torch.from_numpy(vol.weight.ravel()).to(dev)
    depths_t = torch.from_numpy(np.asarray(depths, np.float32)).to(dev)
    poses_t = torch.from_numpy(np.asarray(poses_c2w, np.float32)).to(dev)
    for depth, pose in zip(depths_t, poses_t):
        w2c = torch.linalg.inv(pose)
        cam = Wh @ w2c.T                      # (V, 4)
        z = cam[:, 2]
        uvw = cam[:, :3] @ K.T
        u = uvw[:, 0] / torch.clamp(uvw[:, 2], min=1e-6)
        v = uvw[:, 1] / torch.clamp(uvw[:, 2], min=1e-6)
        # clamped before the integer cast: a point far outside the image
        # (masked below) must not overflow it
        ui = torch.clamp(torch.round(u), 0, Wd - 1).to(torch.int64)
        vi = torch.clamp(torch.round(v), 0, H - 1).to(torch.int64)
        dmeas = depth.reshape(-1)[vi * Wd + ui]
        in_img = (u >= 0) & (u <= Wd - 1) & (v >= 0) & (v <= H - 1)
        ok = in_img & (z > 1e-4) & (dmeas > 0)
        sdf = dmeas - z
        tsdf_new = torch.clamp(sdf / trunc, -1.0, 1.0)
        upd = ok & (sdf > -trunc)
        w_new = upd.to(torch.float32)
        tsdf = torch.where(
            upd,
            (tsdf * weight + tsdf_new * w_new) / torch.clamp(weight + w_new, min=1e-6),
            tsdf,
        )
        weight = weight + w_new
    return vol._replace(
        tsdf=tsdf.cpu().numpy().reshape(g, g, g),
        weight=weight.cpu().numpy().reshape(g, g, g),
    )


def tsdf_mesh(vol: TSDFVolume, min_weight: float = 1.0):
    """Extract the zero level set of a fused TSDF (unobserved voxels masked to
    empty so the surface closes at observation boundaries)."""
    field = np.where(vol.weight >= min_weight, vol.tsdf, 1.0)
    return marching_tetrahedra(field, 0.0, tuple(vol.origin), vol.voxel)
