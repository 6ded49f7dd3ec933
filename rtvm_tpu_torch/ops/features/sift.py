"""SIFT-style DoG features (counterpart of ``rtvm_tpu/ops/features/sift.py``).

The same detector and descriptor as the JAX package, written for PyTorch and
batched over frames: every function takes a leading batch axis B.

- Gaussian levels are blurred directly from each octave's base with dense
  band matrices (two float32 matrix products per octave).
- DoG extrema: 3x3x3 max/min test, contrast threshold, exact blocked top-k,
  a point-wise Hessian edge test and 2D subpixel refinement.
- Descriptor patches of every octave are cut by kernel B in one call
  (``ops/kernel_patches.py:extract_patches_octaves``).
- Orientation (36-bin histogram) and 4x4x8 descriptors use the JAX package's
  static rotated spatial weight tables. The JAX version rounds some operands to
  bfloat16 before its matrix products; the same roundings are reproduced here
  (``_bf``) and the products are taken in float32, which is what the JAX CPU
  backend computes.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rtvm_tpu_torch.ops.features.fast import topk2d_blocked
from rtvm_tpu_torch.ops.filters import band_matrix, gaussian_blur, gaussian_kernel1d, minmaxpool3x3
from rtvm_tpu_torch.ops.kernel_patches import extract_patches_octaves

PATCH = 32  # descriptor patch side (octave pixels)
N_ROT_BINS = 16  # quantized keypoint-angle bins for the spatial weight tables
N_SPATIAL = 4  # 4x4 spatial bins
N_ORI = 8  # orientation bins -> 128-d
DESC_CHUNK = 2048  # patches per orientation/descriptor pass (bounds the one-hot transients)
_TWO_PI = 2.0 * math.pi


def _octave_quotas(k: int, octaves: int, decay: float = 4.0) -> list[int]:
    """Geometric split of the keypoint budget across octaves (finest gets most)."""
    raw = np.array([float(decay) ** (-o) for o in range(octaves)])
    q = np.floor(k * raw / raw.sum()).astype(int)
    q[0] += k - q.sum()
    return [int(x) for x in q]


@functools.lru_cache(maxsize=32)
def _level_bands(deltas_key: tuple, h: int, w: int, device: torch.device):
    """By [L, H, H] and Bx^T [L, W, W]: per-level separable Gaussian blurs with
    edge-replicate padding, all levels sharing one radius (the largest)."""
    deltas = np.asarray(deltas_key, np.float64)
    rad = max(1, int(math.ceil(3.0 * float(deltas.max()))))
    by = np.stack([band_matrix(gaussian_kernel1d(float(d), rad), h) for d in deltas])
    bx = np.stack([band_matrix(gaussian_kernel1d(float(d), rad), w).T for d in deltas])
    return torch.from_numpy(by).to(device), torch.from_numpy(np.ascontiguousarray(bx)).to(device)


def _octave_levels(base: torch.Tensor, deltas: np.ndarray) -> torch.Tensor:
    """All Gaussian levels of one octave, each blurred directly from the base
    (Gaussian semigroup). base [B, H, W]; deltas[l] = sqrt(sigma_l^2 -
    sigma_base^2). Returns [B, L, H, W], a view whose rows are a multiple of
    4 floats apart: kernel B's TMA route needs that row stride, and an
    octave's width (W, ceil(W/2), ...) need not be one. The padding columns
    are never read."""
    b, h, w = base.shape
    nz = [i for i, d in enumerate(deltas) if float(d) > 1e-6]
    if not nz:
        return base[:, None].expand(b, len(deltas), h, w)
    # the JAX version keys (and builds) its band weights from 6-decimal deltas
    dk = tuple(round(float(deltas[i]), 6) for i in nz)
    by, bxt = _level_bands(dk, h, w, base.device)
    y = torch.matmul(by, torch.matmul(base[:, None], bxt))  # [B, len(nz), H, W]
    levels, j = [], 0
    for d in deltas:
        if float(d) > 1e-6:
            levels.append(y[:, j])
            j += 1
        else:
            levels.append(base)
    out = base.new_empty((b, len(deltas), h, -(-w // 4) * 4))[..., :w]
    return torch.stack(levels, dim=1, out=out)


def _detect_octave(dogs, quota, contrast_threshold, edge_r, border, overfetch=2):
    """Up to `quota` extrema of one octave's DoG stacks dogs [B, L-1, H, W].
    Returns (xy [B,Q,2] octave coords, level [B,Q] (1..s), score, valid)."""
    bsz, nl, h, w = dogs.shape
    mid = dogs[:, 1:-1]  # [B, S, H, W] candidate layers
    pmax, pmin = minmaxpool3x3(dogs)
    is_max = (mid >= pmax[:, :-2]) & (mid >= pmax[:, 2:]) & (mid >= pmax[:, 1:-1] - 1e-12) & (mid > 0)
    is_min = (mid <= pmin[:, :-2]) & (mid <= pmin[:, 2:]) & (mid <= pmin[:, 1:-1] + 1e-12) & (mid < 0)
    score = mid.abs()
    extremum = (is_max | is_min) & (score > contrast_threshold)

    yy = torch.arange(h, device=dogs.device)[:, None]
    xx = torch.arange(w, device=dogs.device)[None, :]
    inside = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    final = torch.where(extremum & inside, score, torch.zeros_like(score))

    k2 = overfetch * quota
    top, row, kx, valid = topk2d_blocked(final.reshape(bsz, -1, w), k2)
    lvl = row // h
    ky = row % h
    flat = mid.reshape(bsz, -1)

    def nb(dy, dx):
        yi = (ky + dy).clamp(0, h - 1)
        xi = (kx + dx).clamp(0, w - 1)
        return torch.gather(flat, 1, (lvl * h + yi) * w + xi)

    c0 = nb(0, 0)
    xp, xm, yp, ym = nb(0, 1), nb(0, -1), nb(1, 0), nb(-1, 0)
    hxx = xp + xm - 2 * c0
    hyy = yp + ym - 2 * c0
    hxy = 0.25 * (nb(1, 1) + nb(-1, -1) - nb(1, -1) - nb(-1, 1))
    tr = hxx + hyy
    det = hxx * hyy - hxy * hxy
    edge_ok = (det > 0) & (tr * tr * edge_r < (edge_r + 1.0) ** 2 * det)
    valid = valid & edge_ok

    g_x = 0.5 * (xp - xm)
    g_y = 0.5 * (yp - ym)
    deth = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    ox = torch.clamp(-(hyy * g_x - hxy * g_y) / deth, -0.5, 0.5)
    oy = torch.clamp(-(hxx * g_y - hxy * g_x) / deth, -0.5, 0.5)

    # compact the edge survivors into the fixed quota (rank by masked score)
    sc = torch.where(valid, top, torch.zeros_like(top))
    top_q, sel = torch.sort(sc, dim=1, descending=True, stable=True)
    top_q, sel = top_q[:, :quota], sel[:, :quota]

    def pick(a):
        return torch.gather(a, 1, sel)

    xy = torch.stack(
        [pick(kx).to(torch.float32) + pick(ox), pick(ky).to(torch.float32) + pick(oy)], dim=-1
    )
    return xy, (pick(lvl) + 1).to(torch.int32), top_q, top_q > 0.0


@functools.lru_cache(maxsize=8)
def _static_tables(sigma_desc: float):
    """Static weight tables:
    - ori window [P, P] Gaussian for the 36-bin orientation histogram;
    - per-rotation-bin spatial weights [N_ROT_BINS, P*P, 16] with the
      descriptor's Gaussian window folded in.
    """
    ctr = (PATCH - 1) / 2.0
    d = np.arange(PATCH, dtype=np.float32) - ctr
    yy, xx = np.meshgrid(d, d, indexing="ij")
    r2 = xx**2 + yy**2
    ori_win = np.exp(-r2 / (2.0 * (0.4 * PATCH / 2) ** 2)).astype(np.float32)

    R = sigma_desc  # descriptor support radius in patch pixels
    spatial = np.zeros((N_ROT_BINS, PATCH * PATCH, N_SPATIAL * N_SPATIAL), np.float32)
    for b in range(N_ROT_BINS):
        th = 2.0 * np.pi * b / N_ROT_BINS
        c, s = np.cos(th), np.sin(th)
        u = (c * xx + s * yy) / R
        v = (-s * xx + c * yy) / R
        bx = (u + 1.0) * 0.5 * N_SPATIAL - 0.5
        by = (v + 1.0) * 0.5 * N_SPATIAL - 0.5
        win = np.exp(-(u**2 + v**2) / (2.0 * 0.5**2))
        for iy in range(N_SPATIAL):
            wy = np.maximum(0.0, 1.0 - np.abs(by - iy))
            for ix in range(N_SPATIAL):
                wx = np.maximum(0.0, 1.0 - np.abs(bx - ix))
                spatial[b, :, iy * N_SPATIAL + ix] = (wy * wx * win).reshape(-1)
    return ori_win, spatial


@functools.lru_cache(maxsize=8)
def _static_tensors(sigma_desc: float, device: torch.device):
    ori_win, spatial = _static_tables(sigma_desc)
    return (torch.from_numpy(ori_win).to(device),
            _bf(torch.from_numpy(spatial).to(device)))


def _level_patch_origins(gauss_mid: torch.Tensor, xy: torch.Tensor, lvl: torch.Tensor):
    """Where each keypoint's [P, P] patch is cut from its own level.
    gauss_mid [B, S, H, W] holds levels 1..s; lvl in 1..s. The levels are
    stacked vertically so the level becomes part of the row origin. Returns
    (stack [B, S*H, W], a view of gauss_mid, and ys, xs [B, Q] int32)."""
    b, s, h, w = gauss_mid.shape
    half = PATCH // 2
    ys = torch.clamp(xy[..., 1].to(torch.int32) - half, 0, h - PATCH - 2) + (lvl - 1) * h
    xs = torch.clamp(xy[..., 0].to(torch.int32) - half, 0, w - PATCH)
    stack = gauss_mid.reshape(b, s * h, w)
    return stack, ys.to(torch.int32).contiguous(), xs.to(torch.int32).contiguous()


def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and keep float32 storage."""
    return x.to(torch.bfloat16).to(torch.float32)


def _two_hot(idx0: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor, n: int) -> torch.Tensor:
    """[..., n] with w0 at idx0 and w1 at (idx0 + 1) % n (distinct slots)."""
    out = torch.zeros(idx0.shape + (n,), dtype=torch.float32, device=idx0.device)
    out.scatter_(-1, idx0[..., None], w0[..., None])
    out.scatter_(-1, ((idx0 + 1) % n)[..., None], w1[..., None])
    return out


def _orientation_and_descriptors_chunk(patches, valid, ori_win, spatial):
    q = patches.shape[0]
    gx = 0.5 * (torch.roll(patches, -1, 2) - torch.roll(patches, 1, 2))
    gy = 0.5 * (torch.roll(patches, -1, 1) - torch.roll(patches, 1, 1))
    mag = torch.sqrt(gx * gx + gy * gy)
    ori = torch.atan2(gy, gx)  # [-pi, pi]
    wmag = _bf(mag * ori_win[None])

    # --- dominant orientation: 36-bin soft histogram ---
    bins36 = torch.remainder(ori, _TWO_PI) / _TWO_PI * 36.0
    fl = torch.floor(bins36)
    b0 = fl.to(torch.int64) % 36
    frac = bins36 - fl
    oh = _two_hot(b0, _bf(1 - frac), _bf(frac), 36).reshape(q, PATCH * PATCH, 36)
    hist = torch.bmm(wmag.reshape(q, 1, PATCH * PATCH), oh)[:, 0]  # [Q, 36]
    hist = hist + 0.5 * (torch.roll(hist, 1, 1) + torch.roll(hist, -1, 1))
    peak = torch.argmax(hist, dim=1)
    hl = torch.gather(hist, 1, ((peak - 1) % 36)[:, None])[:, 0]
    hr = torch.gather(hist, 1, ((peak + 1) % 36)[:, None])[:, 0]
    hp = torch.gather(hist, 1, peak[:, None])[:, 0]
    denom = hl - 2.0 * hp + hr
    off = torch.where(denom.abs() > 1e-12, 0.5 * (hl - hr) / denom, torch.zeros_like(denom))
    off = torch.clamp(off, -0.5, 0.5)
    theta = (peak.to(torch.float32) + 0.5 + off) * (_TWO_PI / 36.0)

    # --- descriptor: two-hot blend of rotated spatial tables x soft ori bins ---
    rb = torch.remainder(theta / _TWO_PI * N_ROT_BINS, N_ROT_BINS)
    rfl = torch.floor(rb)
    r0 = rfl.to(torch.int64) % N_ROT_BINS
    rfrac = _bf(rb - rfl)
    w0, w1 = _bf(1 - rfrac), rfrac
    r1 = (r0 + 1) % N_ROT_BINS
    wsel = _bf(w0[:, None, None] * spatial[r0] + w1[:, None, None] * spatial[r1])  # [Q, P*P, 16]

    rel = torch.remainder(ori - theta[:, None, None], _TWO_PI) / _TWO_PI * N_ORI
    ofl = torch.floor(rel)
    o0 = ofl.to(torch.int64) % N_ORI
    of = rel - ofl
    ooh = _two_hot(o0, _bf(1 - of), _bf(of), N_ORI)  # [Q, P, P, 8]
    contrib = _bf(_bf(mag)[..., None] * ooh).reshape(q, PATCH * PATCH, N_ORI)
    desc = torch.bmm(wsel.transpose(1, 2), contrib).reshape(q, N_SPATIAL * N_SPATIAL * N_ORI)

    norm = torch.sqrt(torch.sum(desc**2, dim=-1, keepdim=True)) + 1e-7
    desc = torch.clamp(desc / norm, max=0.2)
    norm = torch.sqrt(torch.sum(desc**2, dim=-1, keepdim=True)) + 1e-7
    desc = desc / norm
    return theta, desc * valid[:, None].to(desc.dtype)


def _orientation_and_descriptors(patches: torch.Tensor, valid: torch.Tensor, sigma_desc: float):
    """patches [Q, P, P] float32, valid [Q] -> (theta [Q], desc [Q, 128])."""
    ori_win, spatial = _static_tensors(float(sigma_desc), patches.device)
    thetas, descs = [], []
    for s in range(0, patches.shape[0], DESC_CHUNK):
        t, d = _orientation_and_descriptors_chunk(
            patches[s : s + DESC_CHUNK], valid[s : s + DESC_CHUNK], ori_win, spatial
        )
        thetas.append(t)
        descs.append(d)
    if not descs:
        return patches.new_zeros((0,)), patches.new_zeros((0, 128))
    return torch.cat(thetas), torch.cat(descs)


def detect_pyramid(gray: torch.Tensor, cfg):
    """The detector half of detect_and_describe: gray [B, H, W] float
    (0..255) -> (xy [B, K, 2] full-res coords, valid [B, K], and per octave
    the patch inputs of kernel B: stacks [B, S*H_o, W_o], ys, xs [B, Q_o]
    int32, and the descriptor's support radius sigma_desc)."""
    s = cfg.sift_scales
    octaves = cfg.sift_octaves
    sigma0 = cfg.sift_sigma
    quotas = _octave_quotas(cfg.max_keypoints, octaves, getattr(cfg, "sift_octave_decay", 4.0))

    img = gray / 255.0
    kfac = 2.0 ** (1.0 / s)
    sigmas = np.array([sigma0 * kfac**l for l in range(s + 3)], dtype=np.float32)
    deltas = np.sqrt(np.maximum(sigmas**2 - sigmas[0] ** 2, 0.0))

    xs_all, valid_all, stacks, ys_o, xs_o = [], [], [], [], []
    base = gaussian_blur(img, float(np.sqrt(max(sigma0**2 - 0.25, 0.01))))
    for o in range(octaves):
        gauss = _octave_levels(base, deltas)  # [B, s+3, H, W]
        dogs = gauss[:, 1:] - gauss[:, :-1]  # [B, s+2, H, W]
        xy, lvl, _, valid = _detect_octave(
            dogs, quotas[o], cfg.sift_contrast_threshold, 10.0, cfg.border_margin
        )
        stack, ys, xs = _level_patch_origins(gauss[:, 1 : s + 1], xy, lvl)
        stacks.append(stack)
        ys_o.append(ys)
        xs_o.append(xs)
        xs_all.append(xy * float(2**o))
        valid_all.append(valid)
        if o + 1 < octaves:
            base = gauss[:, s, ::2, ::2].contiguous()
    sigma_desc = 6.0 * float(sigmas[s // 2 + 1])
    return torch.cat(xs_all, dim=1), torch.cat(valid_all, dim=1), stacks, ys_o, xs_o, sigma_desc


def detect_and_describe(gray: torch.Tensor, cfg):
    """gray [B, H, W] float (0..255) -> (xy [B, K, 2] full-res coords,
    desc [B, K, 128] float32, valid [B, K]). cfg is a FeatureConfig."""
    bsz = gray.shape[0]
    xy, valid, stacks, ys, xs, sigma_desc = detect_pyramid(gray, cfg)
    patches = extract_patches_octaves(stacks, ys, xs, PATCH)  # [B, K, P, P], one launch
    _theta, desc = _orientation_and_descriptors(
        patches.reshape(-1, PATCH, PATCH), valid.reshape(-1), sigma_desc=sigma_desc,
    )
    xy = torch.where(valid[..., None], xy, torch.zeros_like(xy))
    return xy, desc.reshape(bsz, -1, 128), valid
