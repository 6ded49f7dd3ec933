"""Offscreen 3-D rendering as a z-buffer splat rasterizer (counterpart of
``rtvm_tpu/viz/render.py``; the role of the reference's Open3D offscreen
renderer and PyVista screenshot at 1920x1080).

``splat`` runs on the device of its tensors: it projects the points, rounds
half to even, splats psize x psize squares, takes the nearest depth of each
pixel with ``scatter_reduce("amin")`` and then colours each pixel with one
splat that passes the depth test. Several splats of one surface can pass for
one pixel; the JAX colour pass is a scatter that lets the last update win
(XLA on the CPU applies updates in order), and on the card a scatter with
repeated indices has no order. So the winner is picked explicitly: the
passing splat with the largest flat index, point-major as JAX flattens
[N, psize^2] (a ``scatter_reduce("amax")`` of the index, then a gather of
the colours). JAX sends every splat off the picture, and in the colour pass
every losing splat, to one spare slot; on the card millions of atomics on
one address queue behind each other, so here each such splat goes to a
pixel of its own with a value that changes nothing. Meshes are
Lambert-shaded surfels sampled by area on the host, as in JAX. The PNG is
written with ``io/png.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from rtvm_tpu_torch.device import resolve_device

Z_NEAR = float(np.float32(1e-6))  # visible points have camera depth above this
Z_TIE = float(np.float32(1.0 + 1e-6))  # a splat within this factor of the pixel's depth passes
INF_BITS = int(np.float32(np.inf).view(np.int32))  # +inf's float32 bits read as int32


def _lookat(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """4x4 world->camera matrix (OpenGL convention: camera looks down -Z)."""
    f = center - eye
    f = f / max(np.linalg.norm(f), 1e-12)
    s = np.cross(f, up)
    s = s / max(np.linalg.norm(s), 1e-12)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def auto_camera(
    points: np.ndarray,
    direction: Tuple[float, float, float] = (0.35, -0.65, -1.0),
    fov_deg: float = 60.0,
    fill: float = 0.92,
) -> Tuple[np.ndarray, float]:
    """Look at the centroid from `direction`, pulled back so that the
    bounding sphere fills `fill` of the vertical field of view. Returns
    (view matrix 4x4, focal scale)."""
    pts = np.asarray(points, np.float32)
    ctr = pts.mean(0)
    radius = max(float(np.linalg.norm(pts - ctr, axis=1).max()), 1e-6)
    d = np.asarray(direction, np.float32)
    d = d / np.linalg.norm(d)
    half = np.deg2rad(fov_deg) / 2
    dist = radius / (fill * np.tan(half))
    eye = ctr - d * dist
    up = np.float32([0, -1, 0]) if abs(d[1]) < 0.95 else np.float32([0, 0, -1])
    return _lookat(eye, ctr, up), 1.0 / np.tan(half)


def splat(pts: torch.Tensor, rgb: torch.Tensor, view: torch.Tensor, focal: float,
          width: int, height: int, psize: int, bg: torch.Tensor) -> torch.Tensor:
    """Project pts [N, 3] (float32, world), splat psize x psize squares and
    resolve them by depth. rgb [N, 3] float32 in [0, 1]; view [4, 4];
    `focal` the vertical focal scale in NDC units; bg [3]. Returns the
    [height, width, 3] float32 image on the tensors' device."""
    n_pix = width * height
    cam = pts @ view[:3, :3].T + view[:3, 3]
    z = -cam[:, 2]  # the camera looks down -Z; visible points have z > 0
    zc = z.clamp(min=Z_NEAR)
    # XLA fuses the last product and sum into one multiply-add (one rounding);
    # a product of two float32 numbers is exact in float64, so float64 rounds
    # the same way on every device
    half_h, half_w = height / 2, width / 2
    px = (((cam[:, 0] / zc) * focal).double() * half_h + half_w).float()
    py = ((-(cam[:, 1] / zc) * focal).double() * half_h + half_h).float()
    ix = torch.round(px).to(torch.int64)  # half to even, as jnp.round
    iy = torch.round(py).to(torch.int64)

    r = psize // 2
    offs = torch.arange(-r, psize - r, device=pts.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    sx = ix[:, None] + ox.reshape(-1)[None, :]  # [N, psize^2]
    sy = iy[:, None] + oy.reshape(-1)[None, :]
    inside = ((z > Z_NEAR)[:, None] & (sx >= 0) & (sx < width) & (sy >= 0)
              & (sy < height)).reshape(-1)
    if inside.numel() >= 2**31:
        raise ValueError(f"{inside.numel()} splats: the colour pass indexes them in int32")
    order = torch.arange(inside.numel(), dtype=torch.int32, device=pts.device)
    # A splat off the picture goes to a pixel of its own choosing (its index
    # modulo the pixel count) carrying values that change nothing: sent to one
    # spare slot, millions of them would queue on one address. Both reductions
    # run on int32, which the card reduces with native atomics; a positive
    # float32 orders as its bits read as int32.
    idx = torch.where(inside, (sy * width + sx).reshape(-1), order % n_pix)
    depth = z[:, None].expand(sx.shape).reshape(-1)
    zbits = torch.full((n_pix,), INF_BITS, dtype=torch.int32, device=pts.device)
    zbits = zbits.scatter_reduce(0, idx, torch.where(inside, depth.view(torch.int32), INF_BITS),
                                 "amin", include_self=True)
    win = inside & (depth <= zbits.view(torch.float32)[idx] * Z_TIE)
    winner = torch.full((n_pix,), -1, dtype=torch.int32, device=pts.device)
    winner = winner.scatter_reduce(0, idx, torch.where(win, order, -1), "amax", include_self=True)
    col = rgb[(winner.clamp(min=0) // (psize * psize)).long()]
    img = torch.where((winner >= 0)[:, None], col, bg.to(torch.float32))
    return img.reshape(height, width, 3)


def render_points(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    width: int = 1920,
    height: int = 1080,
    point_size: int = 2,
    background=(1.0, 1.0, 1.0),
    view: Optional[np.ndarray] = None,
    focal: Optional[float] = None,
    device=None,
) -> np.ndarray:
    """Render a point cloud offscreen on `device` (``cuda`` unless given);
    returns uint8 [height, width, 3] RGB. colors: uint8 [N, 3] RGB, floats
    in [0, 1], or None (a ramp over z)."""
    dev = resolve_device(device)
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    if len(pts) == 0:
        bg = np.clip(np.asarray(background, np.float32) * 255.0, 0, 255)
        return np.broadcast_to(bg.astype(np.uint8), (height, width, 3)).copy()
    if view is None or focal is None:
        view, focal = auto_camera(pts)
    if colors is None:
        zn = pts[:, 2]
        t = (zn - zn.min()) / max(float(np.ptp(zn)), 1e-6)
        colors = np.stack([0.2 + 0.7 * t, 0.1 + 0.8 * (1 - np.abs(t - 0.5) * 2), 0.9 - 0.7 * t], 1)
    else:
        colors = np.asarray(colors)
        # integer dtype = 0..255 channel values; float = already normalised
        colors = (colors / 255.0 if np.issubdtype(colors.dtype, np.integer)
                  else colors).astype(np.float32)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    img = splat(on_dev(pts), on_dev(colors), on_dev(view), float(np.float32(focal)), width,
                height, int(point_size), on_dev(background))
    return (img * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()


def sample_mesh_surfels(
    vertices: np.ndarray,
    faces: np.ndarray,
    budget: int = 1_500_000,
    vertex_colors: Optional[np.ndarray] = None,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Area-proportional surface samples on the host: (points [M, 3],
    normals [M, 3], albedo [M, 3] in [0, 1]); the JAX function's arrays."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    cross = np.cross(b - a, c - a)
    area = 0.5 * np.linalg.norm(cross, axis=1)
    normals = cross / np.maximum(np.linalg.norm(cross, axis=1, keepdims=True), 1e-12)
    total = max(float(area.sum()), 1e-12)
    rng = np.random.RandomState(seed)
    counts = np.maximum(1, np.round(area / total * budget).astype(np.int64))
    fidx = np.repeat(np.arange(len(f)), counts)
    m = len(fidx)
    r1, r2 = rng.rand(m, 1).astype(np.float32), rng.rand(m, 1).astype(np.float32)
    s = np.sqrt(r1)
    w0, w1, w2 = 1 - s, s * (1 - r2), s * r2
    pts = w0 * a[fidx] + w1 * b[fidx] + w2 * c[fidx]
    if vertex_colors is not None:
        vc = np.asarray(vertex_colors)
        vc = (vc / 255.0 if np.issubdtype(vc.dtype, np.integer) else vc).astype(np.float32)
        albedo = (w0 * vc[f[fidx, 0]] + w1 * vc[f[fidx, 1]] + w2 * vc[f[fidx, 2]])
    else:
        albedo = np.full((m, 3), 0.62, np.float32)  # the reference paints gray
    return pts, normals[fidx], albedo


def render_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    vertex_colors: Optional[np.ndarray] = None,
    width: int = 1920,
    height: int = 1080,
    background=(1.0, 1.0, 1.0),
    budget: int = 1_500_000,
    device=None,
) -> np.ndarray:
    """Lambert-shaded (headlight, two-sided) surfel render of a mesh;
    returns uint8 RGB."""
    pts, normals, albedo = sample_mesh_surfels(vertices, faces, budget, vertex_colors)
    view, focal = auto_camera(pts)
    ldir = -view[2, :3]  # world-space camera forward
    lam = np.clip(normals @ ldir.astype(np.float32), 0, None)
    lam = np.maximum(lam, np.clip(normals @ (-ldir.astype(np.float32)), 0, None))
    shade = (0.35 + 0.65 * lam)[:, None] * albedo
    return render_points(pts, shade, width, height, point_size=2,
                         background=background, view=view, focal=focal, device=device)


def render_offscreen(path: str, save_path: Optional[str] = None,
                     width: int = 1920, height: int = 1080, device=None) -> str:
    """Load a .ply or .obj and write its render at width x height (PNG, or
    JPEG where `save_path` says .jpg); returns the path written, by default
    ``<path without extension>_render.png``."""
    from rtvm_tpu_torch.io.ply import read_obj_mesh, read_ply_points
    from rtvm_tpu_torch.io.png import imwrite

    if path.endswith(".obj"):
        v, f = read_obj_mesh(path)
        img = render_mesh(v, f, width=width, height=height, device=device)
    else:
        pts, cols = read_ply_points(path)
        img = render_points(pts, cols, width=width, height=height, device=device)
    out = save_path or os.path.splitext(path)[0] + "_render.png"
    imwrite(out, np.ascontiguousarray(img[..., ::-1]))
    return out
