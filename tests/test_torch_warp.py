"""Kernel A's plain version and the paint chain of the PyTorch port, held
against cv2 and the JAX package (CPU). The CUDA kernels are held against
these plain versions on the card by chip_smoke.py."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvm_tpu.ops import warp as JW
from rtvm_tpu.ops.pallas_warp import warp_two_pass_pallas
from rtvm_tpu_torch.ops import warp as TW
from rtvm_tpu_torch.ops.kernel_warp import (TILE_H, TILE_W, inverse_maps, tile_is_empty, warp_batch,
                                            warp_plain)

torch.set_num_threads(1)  # tier 1 runs several test workers at once

HF, WF, HC, WC = 96, 160, 192, 256
CASES = {  # tests/test_pallas.py's cases, plus the 30-degree turn the Pallas kernel refuses
    "translate": [[1, 0, 20.3], [0, 1, 33.7], [0, 0, 1]],
    "scale_down": [[0.93, 0, 25], [0, 0.93, 30], [0, 0, 1]],
    "rot2_persp": [
        [0.98 * np.cos(0.03), -0.98 * np.sin(0.03), 30],
        [0.98 * np.sin(0.03), 0.98 * np.cos(0.03), 40],
        [1e-5, -8e-6, 1],
    ],
    "rot30": [
        [np.cos(np.radians(30)), -np.sin(np.radians(30)), 50],
        [np.sin(np.radians(30)), np.cos(np.radians(30)), 10],
        [0, 0, 1],
    ],
}
CASES = {k: np.array(v, np.float32) for k, v in CASES.items()}
PALLAS_CASES = ["translate", "scale_down", "rot2_persp"]
MIN_PSNR_DB = 55.0
MAX_ABS_CV2 = 20.0
GATHER_TOL = 1e-3  # same f32 math as the JAX gather warp away from the edge ring
OWN_INVERSE_TOL = 5e-3  # the same, each package inverting H itself
CHAIN_TOL = 1e-4  # paint chain: |d| <= CHAIN_TOL * max(1, |ref|) (px-valued maps)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def small_image():
    r = np.random.RandomState(7)
    img = r.randint(0, 255, (HF, WF, 3)).astype(np.uint8)
    return cv2.GaussianBlur(img, (0, 0), 1.0)


def _cm(img):
    return np.ascontiguousarray(np.moveaxis(img.astype(np.float32), -1, 0))


def _psnr(a, b):
    mse = float(((a.astype(np.float64) - b) ** 2).mean())
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


def _port_warp(stack, Hm):
    return warp_plain(_t(stack)[None], inverse_maps(_t(Hm)[None]), HC, WC)[0].numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_warp_plain_matches_cv2(small_image, name):
    Hm = CASES[name]
    out = _port_warp(_cm(small_image), Hm)
    ref = np.moveaxis(cv2.warpPerspective(small_image.astype(np.float32), Hm.astype(np.float64), (WC, HC)), -1, 0)
    mask = ref.sum(0) > 0
    for sh in (2, -2):
        mask &= np.roll(mask, sh, 0) & np.roll(mask, sh, 1)
    assert _psnr(out[:, mask], ref[:, mask]) > MIN_PSNR_DB, name
    # the zero-blend border matches too: the full-image error stays small
    assert float(np.abs(out - ref).max()) < MAX_ABS_CV2, name


@pytest.mark.parametrize("name", list(CASES))
def test_warp_plain_matches_jax_gather_away_from_edge_ring(small_image, name):
    stack = _cm(small_image)
    Hm = CASES[name]
    ref = np.asarray(jax.jit(lambda s, h: JW._warp_gather_cm(s, h, HC, WC))(jnp.asarray(stack), jnp.asarray(Hm)))
    G = np.asarray(jnp.linalg.inv(jnp.asarray(Hm)))  # the inverse the JAX warp uses
    out = warp_plain(_t(stack)[None], _t(G)[None], HC, WC)[0].numpy()
    # sample points at least 2 px inside the frame: off the 1-px ring where the
    # strict gather mask and the zero-border hat weights differ by design
    ys, xs = np.mgrid[0:HC, 0:WC].astype(np.float64)
    den = G[2, 0] * xs + G[2, 1] * ys + G[2, 2]
    sx = (G[0, 0] * xs + G[0, 1] * ys + G[0, 2]) / den
    sy = (G[1, 0] * xs + G[1, 1] * ys + G[1, 2]) / den
    inner = (sx >= 2) & (sx <= WF - 3) & (sy >= 2) & (sy <= HF - 3)
    outer = (sx < -1.5) | (sx > WF + 0.5) | (sy < -1.5) | (sy > HF + 0.5)
    assert inner.sum() > 1000
    assert float(np.abs(out - ref)[:, inner].max()) <= GATHER_TOL, name
    # the port's own gather warp inverts H with torch.linalg.inv: float32
    # inverses that differ in the last bits move sample points ~1e-5 px
    port_gather = TW._warp_gather_cm(_t(stack), _t(Hm), HC, WC).numpy()
    assert float(np.abs(port_gather - ref)[:, inner].max()) <= OWN_INVERSE_TOL, name
    assert not np.any(out[:, outer]) and not np.any(ref[:, outer])


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_warp_plain_matches_pallas_interpret(small_image, name):
    stack = _cm(small_image)
    Hm = CASES[name]
    ref = np.asarray(warp_two_pass_pallas(jnp.asarray(stack), jnp.asarray(Hm), HC, WC, interpret=True))
    out = _port_warp(stack, Hm)
    assert _psnr(out, ref) >= MIN_PSNR_DB, name


def test_warp_batch_on_cpu_is_the_plain_version_and_checks_inputs(small_image):
    stack = np.stack([_cm(small_image)] * len(CASES))
    Hs = np.stack(list(CASES.values()))
    G = inverse_maps(_t(Hs))
    out = warp_batch(_t(stack), G, HC, WC)
    assert torch.equal(out, warp_plain(_t(stack), G, HC, WC))
    for i, Hm in enumerate(CASES.values()):  # batching changes nothing per frame
        assert torch.equal(out[i], warp_plain(_t(stack[i : i + 1]), G[i : i + 1], HC, WC)[0])
    with pytest.raises(TypeError):
        warp_batch(_t(stack).double(), G, HC, WC)
    with pytest.raises(ValueError):
        warp_batch(_t(stack), G[:2], HC, WC)
    with pytest.raises(ValueError):
        warp_batch(_t(stack).transpose(2, 3), G, HC, WC)


# ------------------------------------------------------------------ tile skip

SKIP_HF, SKIP_WF, SKIP_HC, SKIP_WC = 60, 100, 120, 202  # canvas width not a multiple of 4 or 128
HULL_MARGIN_PX = 1e-3  # the hull must clear the region by this: float32 rounding of a sample point


def _random_h(kind, rng):
    t = [[1, 0, rng.uniform(-60, 160)], [0, 1, rng.uniform(-40, 100)], [0, 0, 1]]
    if kind == "near_identity":
        a = np.eye(3) + np.diag([1, 1, 0]) @ rng.normal(0, 2e-3, (3, 3))
    elif kind == "scaled":
        a = np.diag([rng.uniform(0.5, 1.6)] * 2 + [1.0])
    elif kind == "rotated":
        th = rng.uniform(-np.pi, np.pi)
        a = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    else:  # perspective, strong enough that some tiles see a non-positive denominator
        a = np.eye(3)
        a[2, :2] = rng.uniform(-1.2e-2, 1.2e-2, 2)
    return (np.array(t) @ a).astype(np.float32)


def _hull_misses(g, xa, ya, xb, yb, margin):
    """Positive denominators at the tile's corners, and the convex hull of the
    mapped corners separated from (-1, wf) x (-1, hf), grown by `margin`, by
    an axis of the region or an edge of the hull (separating axes)."""
    g = np.asarray(g, np.float64).reshape(3, 3)
    c = np.array([[xa, ya, 1], [xb, ya, 1], [xb, yb, 1], [xa, yb, 1]], np.float64) @ g.T
    if not np.all(c[:, 2] > 0):
        return False
    quad = c[:, :2] / c[:, 2:]
    rect = np.array([[-1 - margin, -1 - margin], [SKIP_WF + margin, -1 - margin],
                     [SKIP_WF + margin, SKIP_HF + margin], [-1 - margin, SKIP_HF + margin]])
    edges = np.roll(quad, -1, 0) - quad
    axes = [np.array([1.0, 0.0]), np.array([0.0, 1.0])] + [np.array([-e[1], e[0]]) for e in edges]
    for ax in axes:
        pq, pr = quad @ ax, rect @ ax
        if pq.max() <= pr.min() or pr.max() <= pq.min():
            return True
    return False


@pytest.mark.parametrize("kind", ["near_identity", "scaled", "rotated", "perspective"])
def test_tile_skip_rule_is_sound(kind):
    rng = np.random.RandomState(["near_identity", "scaled", "rotated", "perspective"].index(kind))
    frame = _t(rng.rand(1, 1, SKIP_HF, SKIP_WF).astype(np.float32) + 0.5)  # > 0 wherever sampled
    skipped = missed = tiles = 0
    for _ in range(12):
        G = inverse_maps(_t(_random_h(kind, rng))[None])
        out = warp_plain(frame, G, SKIP_HC, SKIP_WC)[0, 0].numpy()
        g = G[0].reshape(9).numpy()
        for ya in range(0, SKIP_HC, TILE_H):
            for xa in range(0, SKIP_WC, TILE_W):
                xb, yb = min(xa + TILE_W, SKIP_WC) - 1, min(ya + TILE_H, SKIP_HC) - 1
                tile = out[ya : yb + 1, xa : xb + 1]
                tiles += 1
                if _hull_misses(g, xa, ya, xb, yb, HULL_MARGIN_PX):
                    missed += 1
                    assert not np.any(tile), (kind, xa, ya)
                if tile_is_empty(g, xa, ya, xb, yb, SKIP_HF, SKIP_WF):
                    skipped += 1
                    assert not np.any(tile), (kind, xa, ya)
                    assert _hull_misses(g, xa, ya, xb, yb, 0.0), (kind, xa, ya)
    # the rule takes the tiles beyond one edge of the region: most that miss
    assert 0 < skipped <= missed < tiles
    assert skipped >= 0.6 * missed, (skipped, missed)


BANDS = [(0, HC), (0, 1), (37, 50), (96, 96), (191, 1), (8, 184)]  # (row0, rows)


@pytest.mark.parametrize("name", list(CASES))
def test_warp_band_is_the_full_warp_s_rows(small_image, name):
    """Kernel A with a row origin (the tp-sharded step paints a band): the
    plain version's band is bitwise the same rows of the full warp, and the
    wrapper passes the origin through and checks it."""
    frames = _t(_cm(small_image))[None]
    G = inverse_maps(_t(CASES[name])[None])
    full = warp_plain(frames, G, HC, WC)
    for row0, rows in BANDS:
        band = warp_batch(frames, G, rows, WC, row0=row0)
        assert band.shape == (1, 3, rows, WC)
        assert torch.equal(band, full[:, :, row0 : row0 + rows]), (row0, rows)
    with pytest.raises(ValueError, match="row origin"):
        warp_batch(frames, G, 8, WC, row0=-1)


def test_weight_and_upsample_bands_are_the_full_maps_rows():
    """frame_weight_eval (even row origins) and upsample_weight: every band
    holds the same bits as the same rows of the full canvas."""
    Hs = np.stack([CASES["rot2_persp"], CASES["rot30"],
                   np.array([[1, 0, 150.0], [0, 1, -20.0], [0, 0, 1]], np.float32)])
    params = TW.frame_weight_params(_t(Hs), HF, WF, HC, WC)
    full = TW.frame_weight_eval(params, HC, WC)
    assert torch.equal(TW.frame_weight_eval(params, HC, WC, row0=0, rows=HC), full)
    for row0, rows in BANDS:
        row0 -= row0 % 2
        band = TW.frame_weight_eval(params, HC, WC, row0=row0, rows=rows)
        assert torch.equal(band, full[:, row0 : row0 + rows]), (row0, rows)
    with pytest.raises(ValueError, match="not even"):
        TW.frame_weight_eval(params, HC, WC, row0=3, rows=8)
    coarse = _t(np.random.RandomState(9).rand(2, HC // 4, WC // 4).astype(np.float32) * 40)
    up = TW.upsample_weight(coarse, HC, WC)
    for row0, rows in ((0, HC), (37, 50), (96, 96), (8, 184), (101, 91)):
        band = TW.upsample_weight(coarse, HC, WC, row0=row0, rows=rows)
        assert torch.equal(band, up[:, row0 : row0 + rows]), (row0, rows)


# ------------------------------------------------------------------ paint chain


def _chain_close(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max()) <= CHAIN_TOL, float(err.max())


def test_edge_distance_and_regime_flags_match_jax():
    """The edge distance; the JAX package's two-pass regime flag has no
    counterpart, since kernel A has no regime limit."""
    np.testing.assert_array_equal(TW.edge_distance_px(HF, WF), JW.edge_distance_px(HF, WF))
    assert not hasattr(TW, "two_pass_regime_ok")


def test_frame_weights_match_jax():
    # canvas-sized cases: one clipped by the canvas edge, one with perspective
    Hs = np.stack([CASES["rot2_persp"], CASES["rot30"],
                   np.array([[1, 0, 150.0], [0, 1, -20.0], [0, 0, 1]], np.float32)])
    jq = np.asarray(jax.jit(jax.vmap(lambda h: JW.frame_weight_eval(
        JW.frame_weight_params(h, HF, WF, HC, WC), HC, WC)))(jnp.asarray(Hs)))
    tq = TW.frame_weight_eval(TW.frame_weight_params(_t(Hs), HF, WF, HC, WC), HC, WC).numpy()
    assert (jq > 0).mean() > 0.1
    _chain_close(tq, jq)


def test_holes_footprint_and_union_distance_match_jax(small_image):
    rng = np.random.RandomState(8)
    Hm = CASES["rot2_persp"]
    new_px = _port_warp(_cm(small_image), Hm)
    new_px[:, 60:70, 80:95] = 0.0  # a black content hole inside the footprint
    new_px[:, rng.rand(HC, WC) < 0.01] = 0.0
    wq = TW.frame_weight_eval(TW.frame_weight_params(_t(Hm)[None], HF, WF, HC, WC), HC, WC)[0].numpy()
    jw = np.asarray(jax.jit(JW.frame_weight_with_holes)(jnp.asarray(new_px), jnp.asarray(wq)))
    tw = TW.frame_weight_with_holes(_t(new_px), _t(wq)).numpy()
    _chain_close(tw, jw)
    holes = rng.rand(2, HC, WC) < 0.002
    _chain_close(TW.hole_limited_distance_strided(_t(holes)).numpy(),
                 np.asarray(jax.jit(jax.vmap(JW.hole_limited_distance_strided))(jnp.asarray(holes))))
    foot_j = np.asarray(JW.coarse_footprint(jnp.asarray(jw)))
    foot_t = TW.coarse_footprint(_t(tw)).numpy()
    np.testing.assert_array_equal(foot_t, foot_j)
    union = foot_j.copy()
    union[5:20, 10:40] = True
    jd = np.asarray(jax.jit(JW.coarse_union_distance)(jnp.asarray(union)))
    td = TW.coarse_union_distance(_t(union)).numpy()
    _chain_close(td, jd)
    _chain_close(TW.upsample_weight(_t(td), HC, WC).numpy(),
                 np.asarray(JW.upsample_weight(jnp.asarray(jd), HC, WC)))


def test_blend_weights_and_apply_match_jax():
    rng = np.random.RandomState(9)
    w_new = np.maximum(rng.rand(HC, WC).astype(np.float32) * 40 - 10, 0)
    w_old = np.maximum(rng.rand(HC, WC).astype(np.float32) * 40 - 20, 0)
    ja, jb = (np.asarray(a) for a in JW.blend_weights_smoothed(jnp.asarray(w_new), jnp.asarray(w_old)))
    ta, tb = (a.numpy() for a in TW.blend_weights_smoothed(_t(w_new), _t(w_old)))
    _chain_close(ta, ja)
    _chain_close(tb, jb)
    canvas = (rng.rand(3, HC, WC) * 255).astype(np.float32)
    new_px = (rng.rand(3, HC, WC) * 255).astype(np.float32)
    jo = np.asarray(JW.blend_apply_cm(*(jnp.asarray(a) for a in (canvas, new_px, w_new, w_old, ja, jb))))
    to = TW.blend_apply_cm(*(_t(a) for a in (canvas, new_px, w_new, w_old, ja, jb))).numpy()
    _chain_close(to, jo)
