"""The paint stage of the window step, plain: a frozen copy.

Copied from ``rtvm_tpu_torch/ops/warp.py`` (the weights, the coarse union,
the smoothed blend), ``rtvm_tpu_torch/ops/pallas_warp.py`` (``warp_plain``,
kernel A's plain version, op for op the kernel's arithmetic) and
``rtvm_tpu_torch/ops/filters.py`` (the banded Gaussian blur), as they stood
when the benchmark was written, and frozen: the port may change, this file
does not. ``paint_window`` is ``mosaic/stitcher.py:paint_band`` on the whole
canvas. It imports nothing of the port, and runs in float32 with TF32 off.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

CELL_PX = 4  # coarse union-occupancy cell size (px)
BLEND_SMOOTH_SIGMA = 5.0  # cv2.GaussianBlur((31, 31), sigmaX=0)
BLEND_SMOOTH_RADIUS = 15
CHAMFER_A = 0.955  # cv2.distanceTransform(DIST_L2, 3): axis step
CHAMFER_B = 1.3693  # diagonal step
UNION_CHUNK_BYTES = 256 << 20  # bound on the [Gh, Gh, Gw] column-combine transient


@functools.lru_cache(maxsize=64)
def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    """1-D Gaussian taps; matches cv2.getGaussianKernel for odd sizes."""
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def band_matrix(taps: np.ndarray, n: int) -> np.ndarray:
    """[n, n] float32 B with (B @ x)[i] = sum_t taps[t] * x[clip(i + t - r)]:
    a 1-D correlation with edge-replicate padding."""
    r = (taps.shape[0] - 1) // 2
    b = np.zeros((n, n), np.float32)
    rows = np.arange(n)
    for t in range(taps.shape[0]):
        np.add.at(b, (rows, np.clip(rows + t - r, 0, n - 1)), taps[t])
    return b


@functools.lru_cache(maxsize=64)
def _band_tensor(taps_key: tuple, n: int, device: torch.device) -> torch.Tensor:
    """band_matrix built on `device` itself: its float32 sums are the same,
    in the same order, and no host-to-device copy waits for the device (a
    canvas that grows meets new sizes mid-run)."""
    r = (len(taps_key) - 1) // 2
    b = torch.zeros((n, n), dtype=torch.float32, device=device)
    rows = torch.arange(n, device=device)
    for t, v in enumerate(taps_key):
        cols = torch.clamp(rows + (t - r), 0, n - 1)
        b.index_put_((rows, cols), torch.full((n,), v, dtype=torch.float32, device=device),
                     accumulate=True)
    return b


def conv1d_edge(img: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Correlate [..., H, W] along axis -1 or -2 with edge-replicate padding."""
    key = tuple(float(t) for t in taps)
    if axis == -1:
        b = _band_tensor(key, img.shape[-1], img.device).to(img.dtype)
        return torch.matmul(img, b.T)
    b = _band_tensor(key, img.shape[-2], img.device).to(img.dtype)
    return torch.matmul(b, img)


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur of a [..., H, W] float image."""
    taps = gaussian_kernel1d(sigma, radius)
    return conv1d_edge(conv1d_edge(img, taps, axis=-1), taps, axis=-2)


def inverse_maps(H: torch.Tensor) -> torch.Tensor:
    """G = H^-1 for [..., 3, 3] float32 homographies (frame -> canvas)."""
    return torch.linalg.inv_ex(H)[0]


def warp_plain(frames: torch.Tensor, G: torch.Tensor, out_h: int, out_w: int,
               row0: int = 0) -> torch.Tensor:
    """frames [B, C, Hf, Wf] float32, G [B, 3, 3] canvas -> frame maps ->
    [B, C, out_h, out_w]: canvas rows row0 .. row0 + out_h - 1. The
    arithmetic is op for op the kernel's."""
    b, c, hf, wf = frames.shape
    dev = frames.device
    ys = torch.arange(row0, row0 + out_h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    g = G.reshape(b, 9, 1, 1)
    den = g[:, 6] * xs + g[:, 7] * ys + g[:, 8]
    den = torch.where(den.abs() < 1e-9, torch.full_like(den, 1e-9), den)
    sx = (g[:, 0] * xs + g[:, 1] * ys + g[:, 2]) / den
    sy = (g[:, 3] * xs + g[:, 4] * ys + g[:, 5]) / den
    valid = (den > 0.0) & (sx > -1.0) & (sx < wf) & (sy > -1.0) & (sy < hf)
    sx = torch.where(valid, sx, torch.zeros_like(sx))
    sy = torch.where(valid, sy, torch.zeros_like(sy))
    fx0, fy0 = torch.floor(sx), torch.floor(sy)
    x0, y0 = fx0.to(torch.int64), fy0.to(torch.int64)
    fx, fy = sx - fx0, sy - fy0
    ax, ay = 1.0 - fx, 1.0 - fy
    flat = frames.reshape(b, c, hf * wf)

    def tap(yi, xi):
        inside = (yi >= 0) & (yi <= hf - 1) & (xi >= 0) & (xi <= wf - 1)
        idx = (yi.clamp(0, hf - 1) * wf + xi.clamp(0, wf - 1)).reshape(b, 1, -1)
        v = torch.gather(flat, 2, idx.expand(b, c, idx.shape[-1])).reshape(b, c, out_h, out_w)
        return torch.where(inside[:, None], v, torch.zeros_like(v))

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    ax, ay, fx, fy = ax[:, None], ay[:, None], fx[:, None], fy[:, None]
    top = v00 * ax + v01 * fx
    bot = v10 * ax + v11 * fx
    out = top * ay + bot * fy
    return torch.where(valid[:, None], out, torch.zeros_like(out))


def edge_distance_px(h: int, w: int) -> np.ndarray:
    """[H, W] float32 raw distance (px) to the frame border: the exact
    distanceTransform of a full-frame mask."""
    ys = np.arange(h, dtype=np.float32)
    xs = np.arange(w, dtype=np.float32)
    dy = np.minimum(ys + 1.0, h - ys)[:, None]
    dx = np.minimum(xs + 1.0, w - xs)[None, :]
    return np.minimum(dy, dx).astype(np.float32)


def _shift2d(d: torch.Tensor, dy: int, dx: int, fill: float) -> torch.Tensor:
    """out[..., y, x] = d[..., y - dy, x - dx], `fill` outside (no wrap)."""
    h, w = d.shape[-2], d.shape[-1]
    p = F.pad(d, (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)), value=fill)
    y0, x0 = max(-dy, 0), max(-dx, 0)
    return p[..., y0 : y0 + h, x0 : x0 + w]


def _chamfer_pt(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """cv2 chamfer-3x4 point metric: A*(max-min) + B*min of |dx|, |dy|."""
    ax, ay = dx.abs(), dy.abs()
    big, sml = torch.maximum(ax, ay), torch.minimum(ax, ay)
    return CHAMFER_A * (big - sml) + CHAMFER_B * sml


def _chamfer_row(d: torch.Tensor, dy: float) -> torch.Tensor:
    """_chamfer_pt(d, dy) for a scalar vertical offset dy >= 0."""
    ax = d.abs()
    big, sml = torch.clamp(ax, min=dy), torch.clamp(ax, max=dy)
    return CHAMFER_A * (big - sml) + CHAMFER_B * sml


def coarse_union_distance(union: torch.Tensor, cell_px: float = float(CELL_PX)) -> torch.Tensor:
    """Chamfer distance (px) from each cell of coarse occupancy grids
    union [..., Gh, Gw] (bool) to the nearest empty cell: an exact 1-D row
    transform by power-of-two min-plus steps, then a broadcast column combine."""
    gh, gw = union.shape[-2], union.shape[-1]
    big = float(4.0 * max(gh, gw))
    d = torch.where(union, torch.full(union.shape, big, device=union.device),
                    torch.zeros(union.shape, device=union.device))
    k = 1
    while k * 2 < gw:
        k *= 2
    while k >= 1:
        d = torch.minimum(d, _shift2d(d, 0, k, 0.0) + k)
        d = torch.minimum(d, _shift2d(d, 0, -k, 0.0) + k)
        k //= 2
    f = torch.clamp(d, max=big)  # [..., Gh, Gw] row distances (cells)
    v = torch.arange(gh, dtype=torch.float32, device=union.device)
    dy = (v[:, None] - v[None, :]).abs()[:, :, None]  # [Gh_y, Gh_v, 1]
    lead = f.shape[:-2]
    flat = f.reshape(-1, gh, gw)
    bs = max(1, UNION_CHUNK_BYTES // max(gh * gh * gw * 4, 1))
    out = [torch.amin(_chamfer_pt(flat[s : s + bs, None, :, :], dy), dim=2)
           for s in range(0, flat.shape[0], bs)]
    return (torch.cat(out) * cell_px).reshape(*lead, gh, gw)


def _seg_dist(px, py, x0, y0, x1, y1, valid):
    """Chamfer distance from grid points (px, py) to the segment (x0,y0)-(x1,y1);
    +inf where `valid` is False. Inside the segment's span it is the chamfer
    distance to the LINE (|signed distance| / octagon support); off the ends,
    the point metric to the nearest endpoint."""
    ex, ey = x1 - x0, y1 - y0
    l2 = ex * ex + ey * ey
    safe_l2 = torch.clamp(l2, min=1e-12)
    t = ((px - x0) * ex + (py - y0) * ey) / safe_l2
    tc = torch.clamp(t, 0.0, 1.0)
    d_end = _chamfer_pt(px - (x0 + tc * ex), py - (y0 + tc * ey))
    inv_len = torch.rsqrt(safe_l2)
    nx, ny = ey * inv_len, -ex * inv_len
    anx, any_ = nx.abs(), ny.abs()
    h_oct = torch.maximum(torch.maximum(anx, any_) / CHAMFER_A, (anx + any_) / CHAMFER_B)
    d_line = (nx * (px - x0) + ny * (py - y0)).abs() / torch.clamp(h_oct, min=1e-12)
    inside_seg = (t > 0.0) & (t < 1.0) & (l2 > 1e-12)
    d = torch.where(inside_seg, d_line, d_end)
    return torch.where(valid, d, torch.full_like(d, float("inf")))


@functools.lru_cache(maxsize=64)
def _const(value: float, device: torch.device) -> torch.Tensor:
    """A 0-dim float32 constant on `device`, built once (read only)."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def _where(c, a: float, b: float):
    return torch.where(c, _const(a, c.device), _const(b, c.device))


@functools.lru_cache(maxsize=32)
def _support_corners(hf: int, wf: int, device: torch.device) -> torch.Tensor:
    """[4, 3] homogeneous corners of the bilinear support rect (-1..wf,
    -1..hf), built once per device (read only)."""
    return torch.tensor(
        [[-1.0, -1.0, 1.0], [float(wf), -1.0, 1.0], [float(wf), float(hf), 1.0], [-1.0, float(hf), 1.0]],
        dtype=torch.float32, device=device,
    )


def frame_weight_params(H: torch.Tensor, hf: int, wf: int, hc: int, wc: int) -> tuple:
    """Scalar geometry of the analytic frame weight for H [B, 3, 3]: the 20
    candidate segments and 4 inside half-planes of the clipped warped quad.
    Returns (segs [B, 4, 20], seg_ok [B, 20], planes [B, 4, 4], ok_orient [B]).

    The quad is the bilinear-support-expanded source rect (-1..wf, -1..hf)
    mapped through H, inflated by half a pixel outward (mean raster phase);
    the segments are each edge's chord clipped to the canvas and the four
    canvas sides clipped to the edge's outside half-plane (see the JAX
    package's ``analytic_frame_weight`` for the derivation)."""
    corners = _support_corners(hf, wf, H.device)
    ch = torch.matmul(H, corners.T).transpose(-1, -2)  # [B, 4, 3]
    cq = ch[..., :2] / ch[..., 2:3]  # [B, 4, 2] canvas xy
    cen = torch.mean(cq, dim=-2)
    wlim, hlim = float(wc - 1.0), float(hc - 1.0)
    rect = [(0.0, 0.0), (wc - 1.0, 0.0), (wc - 1.0, hc - 1.0), (0.0, hc - 1.0)]

    seg_x0, seg_y0, seg_x1, seg_y1, seg_ok = [], [], [], [], []
    ins_nx, ins_ny, ins_px, ins_py = [], [], [], []
    for i in range(4):
        p0x, p0y = cq[..., i, 0], cq[..., i, 1]
        p1x, p1y = cq[..., (i + 1) % 4, 0], cq[..., (i + 1) % 4, 1]
        ex, ey = p1x - p0x, p1y - p0y
        # outward normal of edge i (away from the quad centroid)
        nx, ny = ey, -ex
        nn = torch.clamp(torch.sqrt(nx * nx + ny * ny), min=1e-12)
        nx, ny = nx / nn, ny / nn
        nd = nx * (cen[..., 0] - p0x) + ny * (cen[..., 1] - p0y)
        flip = nd > 0
        nx, ny = torch.where(flip, -nx, nx), torch.where(flip, -ny, ny)
        p0x, p0y = p0x + 0.5 * nx, p0y + 0.5 * ny
        ins_nx.append(nx); ins_ny.append(ny); ins_px.append(p0x); ins_py.append(p0y)

        def axis_range(o, d, lim):
            dd = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
            ta = (0.0 - o) / dd
            tb = (lim - o) / dd
            lo, hi = torch.minimum(ta, tb), torch.maximum(ta, tb)
            par = d.abs() < 1e-12
            ok = (o >= 0.0) & (o <= lim)
            lo = torch.where(par, _where(ok, -float("inf"), float("inf")), lo)
            hi = torch.where(par, _where(ok, float("inf"), -float("inf")), hi)
            return lo, hi

        lx, hx = axis_range(p0x, ex, wlim)
        ly, hy = axis_range(p0y, ey, hlim)
        t0 = torch.maximum(lx, ly)
        t1 = torch.minimum(hx, hy)
        t0c = torch.clamp(t0, -1e6, 1e6)
        t1c = torch.clamp(t1, -1e6, 1e6)
        seg_x0.append(p0x + t0c * ex); seg_y0.append(p0y + t0c * ey)
        seg_x1.append(p0x + t1c * ex); seg_y1.append(p0y + t1c * ey)
        seg_ok.append(t1 >= t0)
        for j in range(4):
            (r0x, r0y), (r1x, r1y) = rect[j], rect[(j + 1) % 4]
            a = nx * (r0x - p0x) + ny * (r0y - p0y)
            bcoef = nx * (r1x - r0x) + ny * (r1y - r0y)
            safe_b = torch.where(bcoef.abs() < 1e-12, torch.full_like(bcoef, 1e-12), bcoef)
            s_cross = -a / safe_b
            s0 = torch.where(bcoef >= 0, torch.clamp(s_cross, min=0.0), torch.zeros_like(s_cross))
            s1 = torch.where(bcoef >= 0, torch.ones_like(s_cross), torch.clamp(s_cross, max=1.0))
            par = bcoef.abs() < 1e-12
            s0 = torch.where(par, _where(a >= 0, 0.0, 1.0), s0)
            s1 = torch.where(par, _where(a >= 0, 1.0, 0.0), s1)
            seg_x0.append(r0x + s0 * (r1x - r0x)); seg_y0.append(r0y + s0 * (r1y - r0y))
            seg_x1.append(r0x + s1 * (r1x - r0x)); seg_y1.append(r0y + s1 * (r1y - r0y))
            seg_ok.append(s1 >= s0)

    segs = torch.stack([torch.stack(seg_x0, -1), torch.stack(seg_y0, -1),
                        torch.stack(seg_x1, -1), torch.stack(seg_y1, -1)], -2)
    planes = torch.stack([torch.stack(ins_nx, -1), torch.stack(ins_ny, -1),
                          torch.stack(ins_px, -1), torch.stack(ins_py, -1)], -2)
    ok_orient = torch.all(ch[..., 2] > 0.0, dim=-1)
    return segs, torch.stack(seg_ok, -1), planes, ok_orient


def _upsample2_aligned(a: torch.Tensor, hc: int, wc: int) -> torch.Tensor:
    """Grid-aligned 2x upsample of [..., gh, gw]: even taps copy, odd taps
    average with the next (edge-replicated) tap."""
    nxt = torch.cat([a[..., 1:, :], a[..., -1:, :]], dim=-2)
    a = torch.stack([a, 0.5 * (a + nxt)], dim=-2).flatten(-3, -2)
    nxt = torch.cat([a[..., 1:], a[..., -1:]], dim=-1)
    a = torch.stack([a, 0.5 * (a + nxt)], dim=-1).flatten(-2, -1)
    return a[..., :hc, :wc]


def frame_weight_eval(params: tuple, hc: int, wc: int, row0: int = 0,
                      rows: Optional[int] = None) -> torch.Tensor:
    """Analytic frame weights [B, rows, wc] of the canvas rows row0 .. row0 +
    rows - 1 (default: all hc) from frame_weight_params: the signed
    segment-distance field on a stride-2 grid (linear across the quad
    boundary, so the upsample keeps the zero crossing on the edge), upsampled,
    gated by the full-resolution inside mask. Every pixel is computed alone,
    so a band (row0 even) holds the same bits as the same rows of the full
    canvas."""
    if row0 % 2:
        raise ValueError(f"frame_weight_eval: row origin {row0} is not even")
    rows = hc - row0 if rows is None else rows
    segs, sok_v, planes, ok_orient = params
    dev = segs.device
    b, s = segs.shape[0], segs.shape[-1]
    sx0, sy0, sx1, sy1 = (segs[:, i].reshape(b, s, 1, 1) for i in range(4))
    sok = sok_v.reshape(b, s, 1, 1)
    inx, iny, ipx, ipy = (planes[:, i].reshape(b, 4, 1, 1) for i in range(4))

    st = 2
    gh, gw = -(-hc // st), -(-wc // st)
    # the stride-2 rows that the band's canvas rows read (the next one too)
    k0, k1 = row0 // st, min(gh, (row0 + rows) // st + 1)
    ys_lo = (torch.arange(k0, k1, dtype=torch.float32, device=dev) * st)[:, None]
    xs_lo = (torch.arange(gw, dtype=torch.float32, device=dev) * st)[None, :]
    dmin_lo = torch.amin(_seg_dist(xs_lo, ys_lo, sx0, sy0, sx1, sy1, sok), dim=1)
    dmin_lo = torch.where(torch.isfinite(dmin_lo), dmin_lo, torch.full_like(dmin_lo, 4.0 * (hc + wc)))
    inside_lo = torch.all(-(inx * (xs_lo - ipx) + iny * (ys_lo - ipy)) > 0.0, dim=1)
    signed_lo = torch.where(inside_lo, dmin_lo, -dmin_lo)
    up = _upsample2_aligned(signed_lo, rows, wc)

    ys = torch.arange(row0, row0 + rows, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(wc, dtype=torch.float32, device=dev)[None, :]
    inside = torch.all(-(inx * (xs - ipx) + iny * (ys - ipy)) > 0.0, dim=1)
    keep = inside & ok_orient[:, None, None]
    return torch.where(keep, torch.clamp(up, min=0.0), torch.zeros_like(up))


def hole_limited_distance(holes: torch.Tensor, radius: int = 16) -> torch.Tensor:
    """Chamfer distance (px) from every pixel of [..., H, W] to the nearest
    True pixel of `holes`, exact up to `radius`; ~1e9 beyond."""
    big = 1e9
    d = torch.where(holes, torch.zeros(holes.shape, device=holes.device),
                    torch.full(holes.shape, big, device=holes.device))
    k = 1
    while k < radius:
        k *= 2
    while k >= 1:
        d = torch.minimum(d, _shift2d(d, 0, k, big) + k)
        d = torch.minimum(d, _shift2d(d, 0, -k, big) + k)
        k //= 2
    out = _chamfer_row(d, 0.0)
    for dy in range(1, radius + 1):
        pair = torch.minimum(_shift2d(d, dy, 0, big), _shift2d(d, -dy, 0, big))
        out = torch.minimum(out, _chamfer_row(pair, float(dy)))
    return out


def hole_limited_distance_strided(holes: torch.Tensor, radius: int = 16) -> torch.Tensor:
    """hole_limited_distance on a stride-2 grid (holes any-pooled), upsampled;
    the beyond-coverage plateau (~1e9) is capped for the upsample and restored
    wherever all contributing coarse taps sit on it."""
    hc, wc = holes.shape[-2], holes.shape[-1]
    ph, pw = (-hc) % 2, (-wc) % 2
    h2 = F.pad(holes, (0, pw, 0, ph))
    lead = holes.shape[:-2]
    h_lo = h2.reshape(*lead, (hc + ph) // 2, 2, (wc + pw) // 2, 2).amax(dim=(-3, -1))
    d_lo = hole_limited_distance(h_lo, radius)
    cap = 2.0 * radius
    up = _upsample2_aligned(torch.clamp(d_lo, max=cap), hc, wc) * 2.0
    plateau = _upsample2_aligned((d_lo >= cap).to(torch.float32), hc, wc)
    return torch.where(plateau > 0.999, torch.full_like(up, 1e9), up)


def frame_weight_with_holes(new_px: torch.Tensor, w_quad: torch.Tensor, radius: int = 16) -> torch.Tensor:
    """w_new [..., Hc, Wc]: the analytic quad distance limited by the distance
    to black content pixels inside the footprint (the reference's mask is
    any(warped > 0), so black pixels are holes: never painted, and they pull
    the distance down around them). new_px is [..., 3, Hc, Wc]."""
    content = torch.amax(new_px, dim=-3) > 0.0
    holes = (w_quad > 0.0) & ~content
    d_holes = hole_limited_distance_strided(holes, radius)
    return torch.where(content, torch.minimum(w_quad, d_holes), torch.zeros_like(w_quad))


def coarse_footprint(w_new: torch.Tensor, cell: int = CELL_PX) -> torch.Tensor:
    """Any-pool [..., H, W] weights to a coarse bool occupancy grid."""
    h, w = w_new.shape[-2], w_new.shape[-1]
    gh, gw = -(-h // cell), -(-w // cell)
    p = F.pad(w_new, (0, gw * cell - w, 0, gh * cell - h))
    lead = w_new.shape[:-2]
    return p.reshape(*lead, gh, cell, gw, cell).amax(dim=(-3, -1)) > 0.0


def upsample_weight(coarse_px: torch.Tensor, hc: int, wc: int, cell: int = CELL_PX,
                    row0: int = 0, rows: Optional[int] = None) -> torch.Tensor:
    """Bilinear (half-pixel centers, edge-clamped) upsample of coarse distance
    maps [..., gh, gw] back to canvas resolution: [..., rows, wc], the canvas
    rows row0 .. row0 + rows - 1 (default: all hc). A band interpolates the
    coarse rows it reads with one more on each side, so that its rows take
    the same taps and weights as in the full upsample."""
    gh, gw = coarse_px.shape[-2], coarse_px.shape[-1]
    rows = hc - row0 if rows is None else rows
    c0 = max(0, row0 // cell - 1)
    c1 = min(gh, (row0 + rows - 1) // cell + 2)
    lead = coarse_px.shape[:-2]
    x = coarse_px[..., c0:c1, :].reshape(-1, 1, c1 - c0, gw)
    up = F.interpolate(x, size=((c1 - c0) * cell, gw * cell), mode="bilinear",
                       align_corners=False)
    off = row0 - c0 * cell
    return up.reshape(*lead, (c1 - c0) * cell, gw * cell)[..., off : off + rows, :wc]


def blend_weights_smoothed(w_new: torch.Tensor, w_old: torch.Tensor):
    """Reference blend weights: normalized distance weights smoothed with a
    31x31 Gaussian and used WITHOUT renormalizing (near the union boundary
    their sum dips below 1: reference behaviour, kept). beta_s is
    blur(union indicator) - alpha_s. Returns (alpha_s, beta_s)."""
    s = w_new + w_old + 1e-6
    alpha = w_new / s
    region = ((w_new > 0.0) | (w_old > 0.0)).to(torch.float32)
    alpha_s = gaussian_blur(alpha, BLEND_SMOOTH_SIGMA, BLEND_SMOOTH_RADIUS)
    beta_s = gaussian_blur(region, BLEND_SMOOTH_SIGMA, BLEND_SMOOTH_RADIUS) - alpha_s
    return alpha_s, beta_s


def blend_apply_cm(canvas, new_px, w_new, w_old, alpha_s, beta_s) -> torch.Tensor:
    """Elementwise composite of one frame: blend in the overlap, copy where only
    the new frame has content, keep the canvas elsewhere."""
    has_new = w_new > 0.0
    has_old = w_old > 0.0
    blended = alpha_s[None] * new_px + beta_s[None] * canvas
    return torch.where((has_new & has_old)[None], blended,
                       torch.where(has_new[None], new_px, canvas))


def paint_window(canvas: torch.Tensor, union_coarse: torch.Tensor, frames_cm: torch.Tensor,
                 H_abs: torch.Tensor, blended: torch.Tensor, frame_hw, canvas_hw):
    """One window's paint on the whole canvas: warp the frames [B, 3, H, W]
    by H_abs [B, 3, 3], weight them, and blend the `blended` ones into
    `canvas` [3, Hc, Wc] one after the other. Returns (canvas, union_coarse)."""
    hf, wf = frame_hw
    hc, wc = canvas_hw
    new = warp_plain(frames_cm, inverse_maps(H_abs), hc, wc)
    wq = frame_weight_eval(frame_weight_params(H_abs, hf, wf, hc, wc), hc, wc)
    wnew = frame_weight_with_holes(new, wq)
    wnew = torch.where(blended[:, None, None], wnew, torch.zeros_like(wnew))
    coarse = torch.cat([union_coarse[None], coarse_footprint(wnew)])
    union0, foot = coarse[0], coarse[1:]
    inc = torch.cumsum(foot.to(torch.int32), dim=0) > 0
    unions_before = torch.cat([union0[None], union0[None] | inc[:-1]], dim=0)
    ups = upsample_weight(coarse_union_distance(unions_before), hc, wc)
    cover0 = torch.amax(canvas, dim=0) > 0.0
    incc = torch.cumsum((wnew > 0.0).to(torch.int32), dim=0) > 0
    covers_before = torch.cat([cover0[None], cover0[None] | incc[:-1]], dim=0)
    wold = torch.where(covers_before, torch.clamp(ups - CELL_PX / 2.0, min=1.0),
                       torch.zeros_like(ups))
    alpha, beta = blend_weights_smoothed(wnew, wold)
    for i in range(frames_cm.shape[0]):
        canvas = blend_apply_cm(canvas, new[i], wnew[i], wold[i], alpha[i], beta[i])
    return canvas, union_coarse | inc[-1]


def seed_canvas(first_bgr: torch.Tensor, canvas_hw, offset):
    """The canvas [3, Hc, Wc] and coarse union of frame 0 placed at `offset`
    (row, col): ``VideMosaic._init_state``."""
    h, w = first_bgr.shape[:2]
    hc, wc = canvas_hw
    r0, c0 = offset
    dev = first_bgr.device
    canvas = torch.zeros((3, hc, wc), dtype=torch.float32, device=dev)
    canvas[:, r0 : r0 + h, c0 : c0 + w] = first_bgr.to(torch.float32).permute(2, 0, 1)
    seed_w = torch.zeros((hc, wc), dtype=torch.float32, device=dev)
    seed_w[r0 : r0 + h, c0 : c0 + w] = torch.from_numpy(edge_distance_px(h, w)).to(dev)
    return canvas, coarse_footprint(seed_w)
