"""The paint chain: frame weights, union distances and the feathered blend
(counterpart of ``rtvm_tpu/ops/warp.py``).

The reference blends each warped frame into the mosaic with weights taken from
two distance transforms (of the new frame's mask and of the mosaic's mask),
smoothed with a 31x31 Gaussian. The JAX package computes the new frame's
weight analytically from the warped quad (``frame_weight_params`` /
``frame_weight_eval``), limits it by the distance to black content holes,
keeps the mosaic mask as a coarse 4-px occupancy grid with an exact chamfer
transform, and applies the smoothed weights elementwise. All of it is the same
here, batched over a leading frame axis where the JAX stitcher vmaps it.

The warp itself is kernel A (``ops/kernel_warp.py``); the union distance is
kernel C (``csrc/union.cu``), the analytic frame weight kernel D
(``csrc/weight.cu``) and the blend weights' blur kernel E (``csrc/blend.cu``)
for CUDA tensors. ``_warp_gather_cm`` is
the JAX package's exact out-of-regime warp, kept as a reference for tests.

The standalone single-frame API of the JAX module is here too:
``warp_frame_cm`` (kernel A, then the analytic weight with its holes),
``union_weight``, ``_blend_cm``, ``warp_blend_fast``, ``warp_blend`` (HWC,
the running-max weight, its own gather) and ``warp_perspective`` (kernel A,
then the JAX function's strict in-frame mask).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from rtvm_tpu_torch import kernels
from rtvm_tpu_torch.ops.filters import gaussian_blur, gaussian_kernel1d
from rtvm_tpu_torch.ops.kernel_warp import inverse_maps, warp_batch
from rtvm_tpu_torch.ops.sampling import bilinear_sample

CELL_PX = 4  # coarse union-occupancy cell size (px)
# cv2.GaussianBlur((31, 31), sigmaX=0) resolves to sigma 5.0 (the reference's
# weight smoothing); radius 15 -> exactly 31 taps.
BLEND_SMOOTH_SIGMA = 5.0
BLEND_SMOOTH_RADIUS = 15
# cv2.distanceTransform(DIST_L2, maskSize=3) is a 3x4 chamfer: axis steps cost
# A, diagonal steps cost B.
CHAMFER_A = 0.955
CHAMFER_B = 1.3693
UNION_CHUNK_BYTES = 256 << 20  # bound on the plain version's [Gh, Gh, Gw] transient


class BlendedCanvas(NamedTuple):
    canvas: torch.Tensor  # the blended canvas, in the caller's layout
    weight: torch.Tensor  # [Hc, Wc] float32 feather weight at last write (0 = empty)


def edge_distance_map(h: int, w: int, feather_radius: float = 32.0) -> np.ndarray:
    """[H, W] float32 ramp: 0 at the frame border rising linearly to 1 at
    `feather_radius` px inside."""
    return np.minimum(edge_distance_px(h, w) / feather_radius, 1.0).astype(np.float32)


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


def coarse_union_distance_plain(union: torch.Tensor,
                                cell_px: float = float(CELL_PX)) -> torch.Tensor:
    """Chamfer distance (px) from each cell of coarse occupancy grids
    union [..., Gh, Gw] (bool) to the nearest empty cell: an exact 1-D row
    transform by power-of-two min-plus steps, then a broadcast column combine
    (kernel C's plain version)."""
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


_union = kernels.Entry("union", "rtvm_union_distance", "pppiiifff")


def coarse_union_distance(union: torch.Tensor, cell_px: float = float(CELL_PX)) -> torch.Tensor:
    """coarse_union_distance_plain's function: kernel C (``csrc/union.cu``)
    for a CUDA tensor, bitwise the plain version, one launch for all the
    grids of union [..., Gh, Gw] (bool or uint8, non-zero = occupied,
    contiguous); the plain version for a CPU tensor."""
    if union.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"coarse_union_distance wants bool or uint8, got {union.dtype}")
    if union.dim() < 2:
        raise ValueError(f"coarse_union_distance wants [..., Gh, Gw], got {tuple(union.shape)}")
    if not union.is_contiguous():
        raise ValueError("coarse_union_distance wants a contiguous grid")
    if union.device.type == "cpu":
        return coarse_union_distance_plain(union.to(torch.bool), cell_px)
    if union.device.type != "cuda":
        raise ValueError(f"coarse_union_distance: no kernel for device {union.device}")
    gh, gw = union.shape[-2], union.shape[-1]
    out = torch.empty(union.shape, dtype=torch.float32, device=union.device)
    if out.numel() == 0:
        return out
    scratch = torch.empty_like(out)
    _union(union.device, union.data_ptr(), scratch.data_ptr(), out.data_ptr(),
           out.numel() // (gh * gw), gh, gw, CHAMFER_A, CHAMFER_B, cell_px)
    return out


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


def frame_weight_eval_plain(params: tuple, hc: int, wc: int, row0: int = 0,
                            rows: Optional[int] = None) -> torch.Tensor:
    """Analytic frame weights [B, rows, wc] of the canvas rows row0 .. row0 +
    rows - 1 (default: all hc) from frame_weight_params: the signed
    segment-distance field on a stride-2 grid (linear across the quad
    boundary, so the upsample keeps the zero crossing on the edge), upsampled,
    gated by the full-resolution inside mask. Every pixel is computed alone,
    so a band (row0 even) holds the same bits as the same rows of the full
    canvas (kernel D's plain version)."""
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


# PyTorch's CUDA division of a tensor by a Python scalar is a product with the
# scalar's float32 reciprocal; kernel D takes these to match it bit for bit.
_INV_CHAMFER_A = float(np.float32(1.0) / np.float32(CHAMFER_A))
_INV_CHAMFER_B = float(np.float32(1.0) / np.float32(CHAMFER_B))
_WEIGHT_MAX_SEGMENTS = 32  # kernel D's shared-memory table (frame_weight_params makes 20)
_weight = kernels.Entry("weight", "rtvm_frame_weight", "pppppiiiiiiffff")


def frame_weight_eval(params: tuple, hc: int, wc: int, row0: int = 0,
                      rows: Optional[int] = None) -> torch.Tensor:
    """frame_weight_eval_plain's function: kernel D (``csrc/weight.cu``) for
    CUDA tensors, bitwise the plain version as it runs on the card, one
    launch for all B frames; the plain version for CPU tensors. The params
    are frame_weight_params' (segs [B, 4, S] and planes [B, 4, 4] float32,
    seg_ok [B, S] and ok_orient [B] bool, all contiguous, S <= 32), and
    row0 + rows <= hc."""
    if row0 % 2:
        raise ValueError(f"frame_weight_eval: row origin {row0} is not even")
    rows = hc - row0 if rows is None else rows
    segs, seg_ok, planes, ok_orient = params
    for name, x, dtype in (("segs", segs, torch.float32), ("seg_ok", seg_ok, torch.bool),
                           ("planes", planes, torch.float32), ("ok_orient", ok_orient, torch.bool)):
        if x.dtype != dtype:
            raise TypeError(f"frame_weight_eval wants {name} as {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"frame_weight_eval wants a contiguous {name}")
        if x.device != segs.device:
            raise ValueError(f"frame_weight_eval: {name} on {x.device}, segs on {segs.device}")
    b = segs.shape[0] if segs.dim() == 3 else -1
    s = segs.shape[-1]
    if (segs.shape != (b, 4, s) or seg_ok.shape != (b, s) or planes.shape != (b, 4, 4)
            or ok_orient.shape != (b,) or not 1 <= s <= _WEIGHT_MAX_SEGMENTS):
        raise ValueError(f"frame_weight_eval: params of shapes {[tuple(x.shape) for x in params]}")
    if row0 < 0 or rows < 0 or row0 + rows > hc:
        raise ValueError(f"frame_weight_eval: rows {row0} .. {row0 + rows} of a {hc}-row canvas")
    if segs.device.type == "cpu":
        return frame_weight_eval_plain(params, hc, wc, row0, rows)
    if segs.device.type != "cuda":
        raise ValueError(f"frame_weight_eval: no kernel for device {segs.device}")
    out = torch.empty((b, rows, wc), dtype=torch.float32, device=segs.device)
    if out.numel() == 0:
        return out
    _weight(segs.device, segs.data_ptr(), seg_ok.data_ptr(), planes.data_ptr(),
            ok_orient.data_ptr(), out.data_ptr(), b, s, hc, wc, row0, rows, CHAMFER_A, CHAMFER_B,
            _INV_CHAMFER_A, _INV_CHAMFER_B)
    return out


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


def blend_weights_smoothed_plain(w_new: torch.Tensor, w_old: torch.Tensor):
    """Reference blend weights: normalized distance weights smoothed with a
    31x31 Gaussian and used WITHOUT renormalizing (near the union boundary
    their sum dips below 1: reference behaviour, kept). beta_s is
    blur(union indicator) - alpha_s. Returns (alpha_s, beta_s) (kernel E's
    plain version)."""
    s = w_new + w_old + 1e-6
    alpha = w_new / s
    region = ((w_new > 0.0) | (w_old > 0.0)).to(torch.float32)
    alpha_s = gaussian_blur(alpha, BLEND_SMOOTH_SIGMA, BLEND_SMOOTH_RADIUS)
    beta_s = gaussian_blur(region, BLEND_SMOOTH_SIGMA, BLEND_SMOOTH_RADIUS) - alpha_s
    return alpha_s, beta_s


@functools.lru_cache(maxsize=1)
def blur_table() -> np.ndarray:
    """Kernel E's weights, float32 [4 r + 2] (read only), r the blend blur's
    radius: the 2 r + 1 taps of its gaussian_kernel1d; then for d < r the
    weight of source 0 at output d (the taps 0 .. r - d, which the
    edge-replicate padding sends there); then the weight of source n - 1 at
    output n - 1 - d (the taps d + r .. 2 r); then the weight of the one
    source of a line of length 1 (every tap). Each is summed in tap order
    from 0.0 in float32, as band_matrix and _band_tensor sum the band's
    entries."""
    r = BLEND_SMOOTH_RADIUS
    taps = gaussian_kernel1d(BLEND_SMOOTH_SIGMA, r)

    def folded(ts):
        acc = np.float32(0.0)
        for t in ts:
            acc = np.float32(acc + taps[t])
        return acc

    lo = [folded(range(0, r - d + 1)) for d in range(r)]
    hi = [folded(range(d + r, 2 * r + 1)) for d in range(r)]
    out = np.concatenate([taps, lo, hi, [folded(range(2 * r + 1))]]).astype(np.float32)
    out.flags.writeable = False
    return out


_blend = kernels.Entry("blend", "rtvm_blend_weights", "pppppiiiqqqq")


def blend_weights_smoothed(w_new: torch.Tensor, w_old: torch.Tensor):
    """blend_weights_smoothed_plain's function: kernel E (``csrc/blend.cu``)
    for CUDA tensors, one launch for all the maps of w_new and w_old
    [..., R, W] (float32, one shape, any batch and row strides, unit column
    stride); the plain version for CPU tensors. The kernel sums the band
    matrix's products in its own fixed order, so a band of rows holds the
    same bits as those rows of the whole map wherever its 15-row halo lies
    inside the band; the plain version's cuBLAS product may sum in another
    order (on an H100 the two have read bit for bit the same). Returns
    (alpha_s, beta_s), contiguous."""
    for name, x in (("w_new", w_new), ("w_old", w_old)):
        if x.dtype != torch.float32:
            raise TypeError(f"blend_weights_smoothed wants {name} as float32, got {x.dtype}")
    if w_old.device != w_new.device:
        raise ValueError(f"blend_weights_smoothed: w_new on {w_new.device}, w_old on {w_old.device}")
    if w_new.shape != w_old.shape or w_new.dim() < 2 or 0 in w_new.shape[-2:]:
        raise ValueError(f"blend_weights_smoothed wants two [..., R, W] maps of one shape with R, W "
                         f">= 1, got {tuple(w_new.shape)} and {tuple(w_old.shape)}")
    if w_new.device.type == "cpu":
        return blend_weights_smoothed_plain(w_new, w_old)
    if w_new.device.type != "cuda":
        raise ValueError(f"blend_weights_smoothed: no kernel for device {w_new.device}")
    if w_new.stride(-1) != 1 or w_old.stride(-1) != 1:
        raise ValueError("blend_weights_smoothed wants maps with unit column stride")
    rows, cols = w_new.shape[-2], w_new.shape[-1]
    alpha_s = torch.empty(w_new.shape, dtype=torch.float32, device=w_new.device)
    beta_s = torch.empty_like(alpha_s)
    if alpha_s.numel() == 0:
        return alpha_s, beta_s
    n = alpha_s.numel() // (rows * cols)
    wn, wo = (x.reshape(n, rows, cols) for x in (w_new, w_old))  # a view where the lead axes merge
    _blend(w_new.device, wn.data_ptr(), wo.data_ptr(), alpha_s.data_ptr(), beta_s.data_ptr(),
           blur_table().ctypes.data, n, rows, cols, wn.stride(0), wn.stride(1), wo.stride(0),
           wo.stride(1))
    return alpha_s, beta_s


def blend_apply_cm(canvas, new_px, w_new, w_old, alpha_s, beta_s) -> torch.Tensor:
    """Elementwise composite of one frame: blend in the overlap, copy where only
    the new frame has content, keep the canvas elsewhere."""
    has_new = w_new > 0.0
    has_old = w_old > 0.0
    blended = alpha_s[None] * new_px + beta_s[None] * canvas
    return torch.where((has_new & has_old)[None], blended,
                       torch.where(has_new[None], new_px, canvas))


def _warp_gather_cm(stack: torch.Tensor, H: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The JAX package's exact gather warp of a channel-major stack [C, Hf, Wf]
    (strict in-frame mask, clamped taps); a reference for kernel A's tests."""
    c, hf, wf = stack.shape
    hinv = torch.linalg.inv(H)
    ys = torch.arange(out_h, dtype=torch.float32, device=stack.device)[:, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=stack.device)[None, :]
    den = hinv[2, 0] * xs + hinv[2, 1] * ys + hinv[2, 2]
    den = torch.where(den.abs() < 1e-9, torch.full_like(den, 1e-9), den)
    sx = (hinv[0, 0] * xs + hinv[0, 1] * ys + hinv[0, 2]) / den
    sy = (hinv[1, 0] * xs + hinv[1, 1] * ys + hinv[1, 2]) / den
    inb = (sx >= 0.0) & (sx <= wf - 1.0) & (sy >= 0.0) & (sy <= hf - 1.0) & (den > 0.0)
    out = bilinear_sample(stack.permute(1, 2, 0), sx, sy).permute(2, 0, 1)
    return torch.where(inb[None], out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# The standalone single-frame API
# ---------------------------------------------------------------------------


def analytic_frame_weight(H: torch.Tensor, hf: int, wf: int, hc: int, wc: int) -> torch.Tensor:
    """w_new [hc, wc] of one frame warped by H [3, 3]: the distance transform
    of the warped frame mask, computed analytically (frame_weight_params and
    frame_weight_eval for one frame)."""
    return frame_weight_eval(frame_weight_params(H[None], hf, wf, hc, wc), hc, wc)[0]


def warp_frame_cm(frame: torch.Tensor, frame_weight: torch.Tensor, H: torch.Tensor,
                  hc: int, wc: int):
    """Warp a channel-major frame [3, Hf, Wf] (float32) onto the canvas grid
    with kernel A (its plain version for a CPU tensor). Returns (new_px
    [3, Hc, Wc], w_new [Hc, Wc]); the weight comes from the analytic inverse
    map (frame_weight is accepted for the JAX signature)."""
    hf, wf = frame.shape[1], frame.shape[2]
    H = H.to(device=frame.device, dtype=torch.float32)
    warped = warp_batch(frame[None].contiguous(), inverse_maps(H[None]), hc, wc)[0]
    return warped, frame_weight_with_holes(warped, analytic_frame_weight(H, hf, wf, hc, wc))


def union_weight(canvas: torch.Tensor, union_coarse: torch.Tensor, hc: int, wc: int) -> torch.Tensor:
    """w_old [hc, wc]: the coarse union's chamfer distance, upsampled, less
    the half cell of the any-pooled footprint, on the canvas's coverage."""
    up = upsample_weight(coarse_union_distance(union_coarse), hc, wc)
    cover = torch.amax(canvas, dim=0) > 0.0
    return torch.where(cover, torch.clamp(up - CELL_PX / 2.0, min=1.0), torch.zeros_like(up))


def _blend_cm(canvas, canvas_weight, new_px, w_new) -> BlendedCanvas:
    """Feathered composite of one warped frame into a channel-major canvas
    [3, Hc, Wc]: blend_weights_smoothed, then blend_apply_cm."""
    alpha_s, beta_s = blend_weights_smoothed(w_new, canvas_weight)
    out = blend_apply_cm(canvas, new_px, w_new, canvas_weight, alpha_s, beta_s)
    return BlendedCanvas(canvas=out, weight=torch.maximum(canvas_weight, w_new))


def warp_blend_fast(canvas, canvas_weight, frame, frame_weight, H) -> BlendedCanvas:
    """warp_frame_cm then _blend_cm (channel-major canvas [3, Hc, Wc] and
    frame [3, Hf, Wf]), keeping the running-max weight."""
    hc, wc = canvas.shape[1], canvas.shape[2]
    new_px, w_new = warp_frame_cm(frame, frame_weight, H, hc, wc)
    return _blend_cm(canvas, canvas_weight, new_px, w_new)


def _source_coords(H: torch.Tensor, out_h: int, out_w: int, device):
    """(sx, sy, den) [out_h, out_w]: each output pixel mapped back through
    H^-1, the denominator clamped away from 0 as the JAX functions clamp it."""
    hinv = torch.linalg.inv(H.to(device=device, dtype=torch.float32))
    ys = torch.arange(out_h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=device)[None, :]
    den = hinv[2, 0] * xs + hinv[2, 1] * ys + hinv[2, 2]
    den = torch.where(den.abs() < 1e-9, torch.full_like(den, 1e-9), den)
    sx = (hinv[0, 0] * xs + hinv[0, 1] * ys + hinv[0, 2]) / den
    sy = (hinv[1, 0] * xs + hinv[1, 1] * ys + hinv[1, 2]) / den
    return sx, sy, den


def warp_blend(canvas, canvas_weight, frame, frame_weight, H) -> BlendedCanvas:
    """Warp `frame` [Hf, Wf, 3] by H (frame -> canvas) and feather it into
    `canvas` [Hc, Wc, 3] with the weight w_new / (w_new + canvas_weight),
    keeping the running-max weight; the gather is the JAX function's own
    (strict in-frame mask, clamped taps)."""
    hc, wc = canvas.shape[0], canvas.shape[1]
    hf, wf = frame.shape[0], frame.shape[1]
    sx, sy, den = _source_coords(H, hc, wc, canvas.device)
    inb = (sx >= 0.0) & (sx <= wf - 1.0) & (sy >= 0.0) & (sy <= hf - 1.0) & (den > 0.0)
    new_px = bilinear_sample(frame, sx, sy)
    w_new = torch.where(inb, bilinear_sample(frame_weight, sx, sy), torch.zeros_like(sx))
    has_new = w_new > 0.0
    has_old = canvas_weight > 0.0
    alpha = (w_new / (w_new + canvas_weight + 1e-6))[..., None]
    blended = alpha * new_px + (1.0 - alpha) * canvas
    out = torch.where((has_new & has_old)[..., None], blended,
                      torch.where(has_new[..., None], new_px, canvas))
    return BlendedCanvas(canvas=out, weight=torch.maximum(canvas_weight, w_new))


def warp_perspective(frame: torch.Tensor, H: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.warpPerspective (INTER_LINEAR) of a [Hf, Wf] or [Hf, Wf, C] frame
    by H, as float32: kernel A (its plain version for a CPU tensor), then the
    JAX function's mask, which keeps only sample points inside [0, Wf-1] x
    [0, Hf-1]. cv2's zero border, which kernel A follows, also paints the
    ring of sample points up to one pixel outside the frame, blended with
    black; the JAX function and this one leave it at 0."""
    gray = frame.dim() == 2
    f = frame.to(torch.float32)
    f = (f[None] if gray else f.permute(2, 0, 1))[None].contiguous()  # [1, C, Hf, Wf]
    hf, wf = f.shape[2], f.shape[3]
    H = H.to(device=f.device, dtype=torch.float32)
    out = warp_batch(f, inverse_maps(H[None]), out_h, out_w)[0]
    sx, sy, _ = _source_coords(H, out_h, out_w, f.device)
    inb = (sx >= 0.0) & (sx <= wf - 1.0) & (sy >= 0.0) & (sy <= hf - 1.0)
    out = torch.where(inb[None], out, torch.zeros_like(out))
    return out[0] if gray else out.permute(1, 2, 0)
