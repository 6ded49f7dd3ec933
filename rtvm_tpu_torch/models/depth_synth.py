"""Synthetic aerial terrain scenes with ground-truth depth: the port's copy
of ``rtvm_tpu/models/depth_synth.py`` (pure numpy, the same draws in the
same order, so a seed gives the same batch).

Training data for DepthNet (``models/depthnet.py``): a smooth terrain
heightfield plus box buildings and blob trees, rendered top-down with
Lambertian shading from the surface normals and cast shadows. The same
generator makes the evaluation set. It runs on the host while the card
trains.
"""

from __future__ import annotations

import numpy as np


def _smooth_noise(rng, h, w, scale: int, amp: float) -> np.ndarray:
    """Low-frequency value noise via bilinear-upsampled random grid."""
    gh, gw = max(h // scale, 2), max(w // scale, 2)
    g = rng.rand(gh, gw).astype(np.float32)
    ys = np.linspace(0, gh - 1, h, dtype=np.float32)
    xs = np.linspace(0, gw - 1, w, dtype=np.float32)
    y0 = np.clip(ys.astype(np.int32), 0, gh - 2)
    x0 = np.clip(xs.astype(np.int32), 0, gw - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    a = g[y0][:, x0]
    b = g[y0][:, x0 + 1]
    c = g[y0 + 1][:, x0]
    d = g[y0 + 1][:, x0 + 1]
    return amp * ((1 - fy) * ((1 - fx) * a + fx * b) + fy * ((1 - fx) * c + fx * d))


def _cast_shadows(height: np.ndarray, lx: float, ly: float, lz: float,
                  scale: float = 60.0) -> np.ndarray:
    """Binary cast-shadow mask for a heightfield lit by a distant sun.

    A pixel is shadowed when marching toward the sun (image-plane direction
    (lx, ly) normalised, climbing lz per horizontal unit) hits a higher
    surface: the cue that makes absolute structure height observable from a
    top-down image. `scale` matches the shading exaggeration."""
    hgt, wid = height.shape
    hz = height * scale
    hn = float(np.hypot(lx, ly)) + 1e-9
    dx, dy = lx / hn, ly / hn
    rise = lz / hn  # height (in hz units) gained per pixel toward the sun
    ys, xs = np.mgrid[0:hgt, 0:wid]
    shadow = np.zeros_like(height, dtype=bool)
    # every pixel near, strided far: the tallest occluder over the least rise
    # reaches about 76 px
    for t in list(range(1, 13)) + list(range(14, 80, 4)):
        sy = np.clip(np.round(ys + dy * t).astype(np.int32), 0, hgt - 1)
        sx = np.clip(np.round(xs + dx * t).astype(np.int32), 0, wid - 1)
        shadow |= hz[sy, sx] > hz + rise * t + 0.75
    return shadow


def make_depth_scene(rng: np.random.RandomState, h: int = 240, w: int = 320):
    """One scene -> (image [H, W, 3] float 0..1, nearness [H, W] float 0..1);
    nearness is the normalised height (1 = near), DepthNet's convention."""
    height = _smooth_noise(rng, h, w, 64, 0.15) + _smooth_noise(rng, h, w, 24, 0.06)
    veg = _smooth_noise(rng, h, w, 32, 1.0)

    albedo = np.zeros((h, w, 3), np.float32)
    ground = np.array([0.45, 0.42, 0.36]) + 0.2 * rng.rand(3) - 0.1
    green = np.array([0.20, 0.45, 0.22])
    vmask = (veg > 0.55).astype(np.float32)[..., None]
    tex = _smooth_noise(rng, h, w, 4, 0.25)[..., None]
    albedo = (ground * (1 - vmask) + green * vmask) * (0.8 + tex)

    # trees: small round bumps inside vegetation
    n_trees = rng.randint(5, 25)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(n_trees):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        r = rng.randint(4, 12)
        bump = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * (r / 2.0) ** 2))
        height += 0.12 * bump
        albedo = albedo * (1 - 0.6 * bump[..., None]) + 0.6 * bump[..., None] * green * (
            0.7 + 0.5 * rng.rand()
        )

    # buildings: boxes with flat roofs (sharp depth steps)
    n_b = rng.randint(2, 9)
    for _ in range(n_b):
        bw, bh = rng.randint(18, 70), rng.randint(18, 70)
        y0 = rng.randint(0, max(h - bh, 1))
        x0 = rng.randint(0, max(w - bw, 1))
        hgt = 0.15 + 0.35 * rng.rand()
        roof = np.array(
            [[0.55, 0.35, 0.30], [0.6, 0.6, 0.62], [0.35, 0.3, 0.3], [0.7, 0.45, 0.2]]
        )[rng.randint(4)] * (0.7 + 0.6 * rng.rand())
        height[y0 : y0 + bh, x0 : x0 + bw] = hgt + height[y0 : y0 + bh, x0 : x0 + bw] * 0.1
        albedo[y0 : y0 + bh, x0 : x0 + bw] = roof

    # Lambertian shading from the heightfield normals, random sun
    gy, gx = np.gradient(height * 60.0)  # exaggerated slopes for visible shading
    az = rng.rand() * 2 * np.pi
    el = 0.5 + 0.8 * rng.rand()
    lx, ly, lz = np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)
    norm = np.sqrt(gx**2 + gy**2 + 1.0)
    shade = np.clip((-gx * lx - gy * ly + lz) / norm, 0.15, 1.0)

    shadow = _cast_shadows(height, lx, ly, lz)
    ambient = 0.30 + 0.15 * rng.rand()
    light = shade * np.where(shadow, ambient, 1.0)
    # 3x3 box soften so shadow edges are not aliased single-pixel steps
    pad = np.pad(light, 1, mode="edge")
    light = sum(
        pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
    ) / 9.0

    img = np.clip(albedo * light[..., None], 0.0, 1.0)
    img += rng.randn(h, w, 3).astype(np.float32) * 0.015  # sensor noise
    img = np.clip(img, 0.0, 1.0).astype(np.float32)

    rng_span = height.max() - height.min()
    near = (height - height.min()) / max(rng_span, 1e-6)
    return img, near.astype(np.float32)


def make_depth_batch(rng: np.random.RandomState, n: int, h: int = 240, w: int = 320):
    imgs = np.zeros((n, h, w, 3), np.float32)
    deps = np.zeros((n, h, w), np.float32)
    for i in range(n):
        imgs[i], deps[i] = make_depth_scene(rng, h, w)
    return imgs, deps
