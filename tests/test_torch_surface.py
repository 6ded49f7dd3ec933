"""The rest of the VideMosaic surface and the standalone warp API of the
port, against the JAX package on the same numpy inputs (CPU: kernel A takes
its plain version): warp_frame_cm, analytic_frame_weight, union_weight,
_blend_cm, warp_blend, warp_perspective, and VideMosaic's findHomography,
match, validate_homography, smooth_homography, process_first_frame, warp,
render_matches and matches.jpg."""

import inspect

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvm_tpu.config import FeatureConfig, MosaicConfig
from rtvm_tpu.mosaic.stitcher import VideMosaic as JaxMosaic
from rtvm_tpu.ops import warp as jwarp
from rtvm_tpu_torch.config import FeatureConfig as TFeatureConfig
from rtvm_tpu_torch.config import MosaicConfig as TMosaicConfig
from rtvm_tpu_torch.io.imread import imread
from rtvm_tpu_torch.io.jpeg import encode_jpg
from rtvm_tpu_torch.mosaic.stitcher import VideMosaic
from rtvm_tpu_torch.ops import warp as twarp

torch.set_num_threads(1)  # tier 1 runs several test workers at once

MIN_PSNR_DB = 50.0  # the JAX CPU tier warps in bf16 (two-pass), the port in f32
EDGE_BAND = 34  # ROADMAP.md Queue 3 items 2 and 9: 3 + 16 + 15 px around a frame edge
# The two packages' warps differ on the 1-px ring of sample points at a
# frame's border (the JAX two-pass tier paints some of them, kernel A
# others; Queue 3 items 2 and 9). A ring pixel painted by one package only
# is a content hole for the other, and a hole limits w_new as far as the
# hole distance reaches: hole_limited_distance_strided caps at 2 * 16 px on
# a half-resolution grid, 64 px. Measured on the rot_scale case: weights off
# by 2.5% at 35 px from the edge, by 4.7e-7 beyond 60 px.
WEIGHT_BAND = 66
WEIGHT_TOL = 1e-4  # relative, on distances of up to ~100 px
BLEND_TOL = 1e-5
# grey levels, warp_blend and warp_perspective (asked: 1e-3). Each package
# inverts H in float32 with its own LU routine; on the rot_scale case the two
# inverses differ by one ulp of a translation entry (7.6e-6 of 81), which
# moves a sample point by 7.6e-6 px and, on a rectangle's 255-level edge,
# the output by up to 2.0e-3 (warp_blend) and 4.4e-3 (warp_perspective)
# levels. Elsewhere the outputs agree to float32 rounding: LEVEL_MEAN_TOL.
LEVEL_TOL = 5e-3
LEVEL_MEAN_TOL = 1e-4
H_TOL = 1e-4
SMOOTH_TOL = 1e-6
HF, WF, HC, WC = 160, 256, 320, 480


@pytest.fixture(scope="module")
def scene():
    """tests/test_stitcher.py's scene."""
    rng = np.random.RandomState(7)
    img = rng.randint(0, 255, (600, 800, 3)).astype(np.uint8)
    img = cv2.GaussianBlur(img, (0, 0), 1.0)
    for _ in range(120):
        x, y = rng.randint(20, 780), rng.randint(20, 580)
        c = tuple(int(v) for v in rng.randint(0, 255, 3))
        cv2.rectangle(img, (x, y), (x + rng.randint(6, 30), y + rng.randint(6, 30)), c, -1)
    return img


def _frames(scene, n, dx=6, dy=-4):
    return [scene[300 + i * dy : 300 + i * dy + HF, 100 + i * dx : 100 + i * dx + WF] for i in range(n)]


def _cfgs(detector):
    kw = dict(window_size=4)
    return (MosaicConfig(features=FeatureConfig(detector_type=detector, max_keypoints=256,
                                                sift_octaves=3), **kw),
            TMosaicConfig(features=TFeatureConfig(detector_type=detector, max_keypoints=256,
                                                  sift_octaves=3), **kw))


H_CASES = {
    "subpixel": [[1.0, 0.0, 60.3], [0.0, 1.0, 70.6], [0.0, 0.0, 1.0]],
    "rot_scale": [[0.99 * np.cos(0.02), -0.99 * np.sin(0.02), 80.2],
                  [0.99 * np.sin(0.02), 0.99 * np.cos(0.02), 50.7], [2e-5, -1e-5, 1.0]],
    "off_right": [[1.0, 0.0, 300.4], [0.0, 1.0, 90.2], [0.0, 0.0, 1.0]],  # crosses the canvas edge
}


def _band_free(H, hf, wf, hc, wc, band=EDGE_BAND):
    """bool [hc, wc]: canvas pixels whose source point under H^-1 lies more
    than `band` px from the frame's border (inside or out), and more than
    `band` px from the canvas's right and bottom edges."""
    G = np.linalg.inv(np.asarray(H, np.float64))
    ys, xs = np.mgrid[0:hc, 0:wc].astype(np.float64)
    d = G[2, 0] * xs + G[2, 1] * ys + G[2, 2]
    sx = (G[0, 0] * xs + G[0, 1] * ys + G[0, 2]) / d
    sy = (G[1, 0] * xs + G[1, 1] * ys + G[1, 2]) / d
    inside = np.minimum(np.minimum(sx, wf - 1 - sx), np.minimum(sy, hf - 1 - sy))
    return (np.abs(inside) > band) & (xs < wc - band) & (ys < hc - band)


def _psnr(a, b):
    mse = float(((np.asarray(a, np.float64) - b) ** 2).mean())
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


@pytest.mark.parametrize("case", list(H_CASES))
def test_warp_frame_cm_matches_jax_off_the_edge_band(scene, case):
    frame = _frames(scene, 1)[0]
    H = np.asarray(H_CASES[case], np.float32)
    fcm = np.moveaxis(frame.astype(np.float32), -1, 0)
    fw = twarp.edge_distance_px(HF, WF)
    jp, jw = jwarp.warp_frame_cm(jnp.asarray(fcm), jnp.asarray(fw), jnp.asarray(H), HC, WC)
    tp, tw = twarp.warp_frame_cm(torch.from_numpy(fcm), torch.from_numpy(fw), torch.from_numpy(H), HC, WC)
    keep = _band_free(H, HF, WF, HC, WC)
    assert keep.mean() > 0.3
    jp, jw, tp, tw = np.asarray(jp), np.asarray(jw), tp.numpy(), tw.numpy()
    assert _psnr(tp[:, keep], jp[:, keep]) >= MIN_PSNR_DB
    wkeep = _band_free(H, HF, WF, HC, WC, WEIGHT_BAND)
    assert (jw[wkeep] > 0).sum() > 1000 and _rel(tw[wkeep], jw[wkeep]) <= WEIGHT_TOL
    # the content masks differ only on the ring of sample points at the border
    differ = (jp.max(0) > 0) != (tp.max(0) > 0)
    assert not np.any(differ & _band_free(H, HF, WF, HC, WC, band=1.5))
    assert tw.shape == (HC, WC) and tp.shape == (3, HC, WC)


@pytest.mark.parametrize("case", list(H_CASES))
def test_analytic_frame_weight_matches_jax(case):
    H = np.asarray(H_CASES[case], np.float32)
    j = np.asarray(jwarp.analytic_frame_weight(jnp.asarray(H), HF, WF, HC, WC))
    t = twarp.analytic_frame_weight(torch.from_numpy(H), HF, WF, HC, WC).numpy()
    assert j.max() > 50 and _rel(t, j) <= WEIGHT_TOL


def _canvas_and_union(scene):
    """A canvas with one frame painted, its coarse union, a warped second
    frame and its weight, all from the JAX package."""
    f0, f1 = _frames(scene, 2, 40, 10)
    canvas = np.zeros((3, HC, WC), np.float32)
    canvas[:, 100 : 100 + HF, 80 : 80 + WF] = np.moveaxis(f0, -1, 0)
    seed_w = np.zeros((HC, WC), np.float32)
    seed_w[100 : 100 + HF, 80 : 80 + WF] = jwarp.edge_distance_px(HF, WF)
    union = np.asarray(jwarp.coarse_footprint(jnp.asarray(seed_w)))
    H = np.array([[1, 0, 120.3], [0, 1, 110.6], [0, 0, 1]], np.float32)
    new_px, w_new = jwarp.warp_frame_cm(jnp.asarray(np.moveaxis(f1.astype(np.float32), -1, 0)),
                                        jnp.asarray(jwarp.edge_distance_px(HF, WF)), jnp.asarray(H),
                                        HC, WC)
    return canvas, union, np.asarray(new_px), np.asarray(w_new)


def test_union_weight_and_blend_match_jax(scene):
    canvas, union, new_px, w_new = _canvas_and_union(scene)
    jw = np.asarray(jwarp.union_weight(jnp.asarray(canvas), jnp.asarray(union), HC, WC))
    tw = twarp.union_weight(torch.from_numpy(canvas), torch.from_numpy(union), HC, WC).numpy()
    assert jw.max() > 20 and _rel(tw, jw) <= WEIGHT_TOL
    # the same inputs (JAX's weights) into both blends
    jb = jwarp._blend_cm(jnp.asarray(canvas), jnp.asarray(jw), jnp.asarray(new_px), jnp.asarray(w_new))
    tb = twarp._blend_cm(torch.from_numpy(canvas), torch.from_numpy(jw), torch.from_numpy(new_px),
                         torch.from_numpy(w_new))
    assert isinstance(tb, twarp.BlendedCanvas)
    assert _rel(tb.canvas.numpy(), np.asarray(jb.canvas)) <= BLEND_TOL
    np.testing.assert_array_equal(tb.weight.numpy(), np.asarray(jb.weight))


def test_warp_blend_fast_is_warp_frame_cm_then_blend(scene):
    canvas, union, _, _ = _canvas_and_union(scene)
    f1 = _frames(scene, 2, 40, 10)[1]
    fcm = torch.from_numpy(np.moveaxis(f1.astype(np.float32), -1, 0).copy())
    fw = torch.from_numpy(twarp.edge_distance_px(HF, WF))
    H = torch.tensor([[1, 0, 120.3], [0, 1, 110.6], [0, 0, 1]], dtype=torch.float32)
    cw = twarp.union_weight(torch.from_numpy(canvas), torch.from_numpy(union), HC, WC)
    got = twarp.warp_blend_fast(torch.from_numpy(canvas), cw, fcm, fw, H)
    new_px, w_new = twarp.warp_frame_cm(fcm, fw, H, HC, WC)
    want = twarp._blend_cm(torch.from_numpy(canvas), cw, new_px, w_new)
    assert torch.equal(got.canvas, want.canvas) and torch.equal(got.weight, want.weight)


def test_warp_blend_matches_jax(scene):
    f0, f1 = _frames(scene, 2, 40, 10)
    canvas = np.zeros((HC, WC, 3), np.float32)
    canvas[100 : 100 + HF, 80 : 80 + WF] = f0
    cw = np.zeros((HC, WC), np.float32)
    cw[100 : 100 + HF, 80 : 80 + WF] = jwarp.edge_distance_map(HF, WF)
    fw = jwarp.edge_distance_map(HF, WF)
    np.testing.assert_array_equal(twarp.edge_distance_map(HF, WF), fw)
    H = np.asarray(H_CASES["rot_scale"], np.float32)
    j = jwarp.warp_blend(jnp.asarray(canvas), jnp.asarray(cw), jnp.asarray(f1.astype(np.float32)),
                         jnp.asarray(fw), jnp.asarray(H))
    t = twarp.warp_blend(torch.from_numpy(canvas), torch.from_numpy(cw),
                         torch.from_numpy(f1.astype(np.float32)), torch.from_numpy(fw),
                         torch.from_numpy(H))
    d = np.abs(t.canvas.numpy() - np.asarray(j.canvas))
    assert float(d.max()) <= LEVEL_TOL and float(d.mean()) <= LEVEL_MEAN_TOL
    assert float(np.abs(t.weight.numpy() - np.asarray(j.weight)).max()) <= 1e-5


@pytest.mark.parametrize("case", list(H_CASES))
def test_warp_perspective_matches_jax_and_cv2_off_its_border_ring(scene, case):
    """The JAX function keeps only sample points inside the frame; kernel A
    (like cv2's zero border) also paints a 1-px ring blended with black,
    which the port masks to the JAX rule. Away from that ring both are
    cv2.warpPerspective."""
    frame = _frames(scene, 1)[0]
    H = np.asarray(H_CASES[case], np.float32)
    j = np.asarray(jwarp.warp_perspective(jnp.asarray(frame.astype(np.float32)), jnp.asarray(H), HC, WC))
    t = twarp.warp_perspective(torch.from_numpy(frame), torch.from_numpy(H), HC, WC).numpy()
    d = np.abs(t - j)
    assert t.shape == (HC, WC, 3) and float(d.max()) <= LEVEL_TOL and float(d.mean()) <= LEVEL_MEAN_TOL
    g = twarp.warp_perspective(torch.from_numpy(frame[..., 0]), torch.from_numpy(H), HC, WC).numpy()
    np.testing.assert_array_equal(g, t[..., 0])
    ref = cv2.warpPerspective(frame, H.astype(np.float64), (WC, HC), flags=cv2.INTER_LINEAR)
    away = _band_free(H, HF, WF, HC, WC, band=2)
    assert float(np.abs(np.rint(t[away]) - ref[away]).max()) <= 1.0


def _correspondences(rng, n=120, outliers=30):
    H = np.array([[1.02, 0.03, 14.0], [-0.02, 0.98, -7.5], [1e-4, -5e-5, 1.0]])
    src = rng.uniform(0, 300, (n, 2))
    p = np.c_[src, np.ones(n)] @ H.T
    dst = p[:, :2] / p[:, 2:] + rng.randn(n, 2) * 0.3
    dst[:outliers] = rng.uniform(0, 300, (outliers, 2))
    return src.astype(np.float32), dst.astype(np.float32), H


@pytest.mark.parametrize("seed", [0, 3])
def test_find_homography_fed_the_jax_draws(seed):
    rng = np.random.RandomState(seed)
    src, dst, H_true = _correspondences(rng)
    jH, jinl = JaxMosaic.findHomography(src, dst, seed=seed)
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (512, src.shape[0])))
    samples = jax.lax.top_k(jnp.asarray(u), 4)[1]
    tH, tinl = VideMosaic.findHomography(src, dst, seed=seed, samples=np.asarray(samples), device="cpu")
    np.testing.assert_array_equal(tinl, np.asarray(jinl))
    assert np.abs(tH / tH[2, 2] - jH / jH[2, 2]).max() <= H_TOL
    assert tinl.sum() >= 85
    # its own draws (a CPU generator from the seed) find the model too: the
    # corners of the points' square within 1 px of the true model's
    oH, oinl = VideMosaic.findHomography(src, dst, seed=seed, device="cpu")
    sq = np.array([[0, 0, 1], [300, 0, 1], [300, 300, 1], [0, 300, 1]], np.float64).T
    p, q = oH.astype(np.float64) @ sq, H_true @ sq
    assert oinl.sum() >= 85 and np.abs(p[:2] / p[2] - q[:2] / q[2]).max() < 1.0


@pytest.fixture(scope="module")
def mosaics(scene):
    out = {}
    for det in ("orb", "sift"):
        jc, tc = _cfgs(det)
        f0 = _frames(scene, 1)[0]
        out[det] = (JaxMosaic(f0, detector_type=det, config=jc),
                    VideMosaic(f0, detector_type=det, config=tc, device="cpu"))
    return out


@pytest.mark.parametrize("det", ["orb", "sift"])
def test_match_indices_identical_on_the_same_descriptors(scene, mosaics, det):
    jm, tm = mosaics[det]
    f = _frames(scene, 2)
    _, dc, vc = jm._feature_fn(jnp.asarray(f[1]))
    _, dp, vp = jm._feature_fn(jnp.asarray(f[0]))
    jmt = jm.match(dc, dp, vc, vp)
    tmt = tm.match(np.asarray(dc), np.asarray(dp), np.asarray(vc), np.asarray(vp))
    np.testing.assert_array_equal(tmt.valid.numpy(), np.asarray(jmt.valid))
    v = np.asarray(jmt.valid)
    assert v.sum() > 30
    np.testing.assert_array_equal(tmt.train_idx.numpy()[v], np.asarray(jmt.train_idx)[v])
    # without flags every descriptor counts as valid, in both
    np.testing.assert_array_equal(tm.match(np.asarray(dc), np.asarray(dp)).valid.numpy(),
                                  np.asarray(jm.match(dc, dp).valid))


def _validation_cases():
    """H's around each threshold of the default stabilisation settings
    (translation 50 px, scale 0.3, perspective 1e-3), and broken ones."""
    hs = [np.eye(3)]
    for t in (49.9, 50.0, 50.0001, 50.1, 30.0 * np.sqrt(2)):
        hs.append(np.array([[1, 0, t], [0, 1, 0], [0, 0, 1]]))
        hs.append(np.array([[1, 0, t / np.sqrt(2)], [0, 1, t / np.sqrt(2)], [0, 0, 1]]))
    for s in (0.69, 0.7, 0.71, 1.29, 1.3, 1.31):
        hs.append(np.array([[s, 0, 1], [0, s, 1], [0, 0, 1]]))
    for p in (9.99e-4, 1e-3, 1.001e-3, -1e-3):
        hs.append(np.array([[1, 0, 0], [0, 1, 0], [p, 0, 1]]))
        hs.append(np.array([[1, 0, 0], [0, 1, 0], [0, p, 1]]))
    hs.append(np.array([[-1, 0, 0], [0, 1, 0], [0, 0, 1]]))  # reflection: det < 0
    hs.append(np.array([[np.nan, 0, 0], [0, 1, 0], [0, 0, 1]]))
    hs.append(np.array([[1, 0, np.inf], [0, 1, 0], [0, 0, 1]]))
    return [h.astype(np.float32) for h in hs]


def test_validate_homography_identical_at_each_threshold(mosaics):
    jm, tm = mosaics["orb"]
    cases = _validation_cases()
    assert len(cases) >= 20
    got = [tm.validate_homography(h) for h in cases]
    want = [jm.validate_homography(h) for h in cases]
    assert got == want and all(type(g) is bool for g in got)
    assert 0 < sum(got) < len(got)


def test_smooth_homography_over_8_calls(scene):
    jc, tc = _cfgs("orb")
    f0 = _frames(scene, 1)[0]
    jm = JaxMosaic(f0, detector_type="orb", config=jc)
    tm = VideMosaic(f0, detector_type="orb", config=tc, device="cpu")
    rng = np.random.RandomState(5)
    for _ in range(8):
        H = (np.eye(3) + rng.randn(3, 3) * [[0.01, 0.01, 2], [0.01, 0.01, 2], [1e-5, 1e-5, 0]])
        H = H.astype(np.float32)
        j, t = jm.smooth_homography(H), tm.smooth_homography(H)
        assert np.abs(t - np.asarray(j)).max() <= SMOOTH_TOL
        np.testing.assert_array_equal(tm.state.hbuf.numpy(), np.asarray(jm.state.hbuf))
        assert int(tm.state.hcount) == int(jm.state.hcount)
    assert int(tm.state.hcount) == jc.stabilization.history_size


def _jax_uniforms(jm, b):
    cfg = jm.config
    f0 = int(np.asarray(jm.state.frame_idx))
    keys = [jax.random.fold_in(jm._key, f0 + i) for i in range(b)]
    shape = (cfg.ransac.num_hypotheses, cfg.features.max_keypoints)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, shape)) for k in keys]))


def test_process_first_frame_then_a_window_match_jax(scene):
    """Both re-seeded with frame 1's features (SIFT), then frames 2-5 as one
    window, the port fed JAX's draws: held as test_torch_stitcher.py holds
    a window inside the canvas."""
    jc, tc = _cfgs("sift")
    f = _frames(scene, 6, 5, 3)
    jm = JaxMosaic(f[0], detector_type="sift", config=jc)
    tm = VideMosaic(f[0], detector_type="sift", config=tc, device="cpu")
    tm.restore(jm.checkpoint())
    jm.process_first_frame(f[1])
    tm.process_first_frame(f[1])
    assert float(np.abs(tm.state.kp.numpy() - np.asarray(jm.state.kp)).max()) < 1e-2
    u = _jax_uniforms(jm, 4)
    ja = jm.process_window(np.stack(f[2:6]))
    ta = tm.process_window(np.stack(f[2:6]), uniforms=u)
    np.testing.assert_array_equal(ta.ok.numpy(), np.asarray(ja.ok))
    np.testing.assert_array_equal(ta.blended.numpy(), np.asarray(ja.blended))
    assert np.asarray(ja.ok).all()
    assert np.abs(ta.H_abs.numpy() - np.asarray(ja.H_abs)).max() <= 1e-3
    assert _psnr(tm.output_img, jm.output_img) >= MIN_PSNR_DB


@pytest.mark.parametrize("case", ["subpixel", "rot_scale"])
def test_videmosaic_warp_matches_jax(scene, case):
    jc, tc = _cfgs("orb")
    f = _frames(scene, 2, 40, 10)
    jm = JaxMosaic(f[0], detector_type="orb", config=jc)
    tm = VideMosaic(f[0], detector_type="orb", config=tc, device="cpu")
    H = np.asarray(H_CASES[case], np.float32) @ np.asarray(jm.H_old, np.float32)
    H[:2, 2] -= [60.0, 140.0]  # overlap the first frame
    j = jm.warp(f[1], H)
    t = tm.warp(f[1], H)
    hc, wc = tm.canvas_shape[:2]
    keep = _band_free(H, HF, WF, hc, wc) & _band_free(np.asarray(jm.H_old), HF, WF, hc, wc)
    assert keep.mean() > 0.1 and _psnr(t[keep], j[keep]) >= MIN_PSNR_DB
    np.testing.assert_array_equal(tm.state.union_coarse.numpy(), np.asarray(jm.state.union_coarse))
    assert t.shape == j.shape and (t > 0).mean() > 0.3


def test_render_matches_pixel_identical_to_jax(scene, mosaics):
    """ORB: the features of both packages are identical on these frames."""
    jm, tm = mosaics["orb"]
    f = _frames(scene, 2)
    j = jm.render_matches(f[0], f[1])
    t = tm.render_matches(f[0], f[1])
    assert t.shape == j.shape == (HF, 2 * WF, 3) and t.dtype == np.uint8
    assert (t != np.concatenate([f[1], f[0]], axis=1)).any(axis=-1).sum() > 500
    np.testing.assert_array_equal(t, j)


def test_visualize_writes_matches_jpg(scene, tmp_path):
    jc, tc = _cfgs("orb")
    f = _frames(scene, 5)
    m = VideMosaic(f[0], detector_type="orb", config=tc, show_intermediate=False, visualize=True,
                   output_dir=str(tmp_path), device="cpu")
    m.process_window(np.stack(f[1:5]))
    img = imread(str(tmp_path / "matches.jpg"))
    assert img is not None and img.shape == (HF, 2 * WF, 3)
    want = m.render_matches(f[3], f[4])  # the window's last pair, as the JAX class
    assert (tmp_path / "matches.jpg").read_bytes() == encode_jpg(want)
    assert not (tmp_path / "mosaic_progress.jpg").exists()


def test_every_public_member_of_the_jax_class_is_here():
    public = {n for n in dir(JaxMosaic) if not n.startswith("_")}
    missing = public - set(dir(VideMosaic))
    assert not missing, missing
    for n in sorted(public):
        j, t = getattr(JaxMosaic, n), getattr(VideMosaic, n)
        if callable(j):
            jp = list(inspect.signature(j).parameters)
            tp = list(inspect.signature(t).parameters)
            assert tp[: len(jp)] == jp, (n, jp, tp)


def test_the_jax_warp_api_is_here():
    """Every public function of the JAX ops/warp.py but the XLA two-pass
    tier and its regime flags (TPU layout, not carried over) has a
    counterpart."""
    tpu_layout = {"warp_two_pass", "pallas_regime_ok", "two_pass_regime_ok"}
    public = {n for n, v in vars(jwarp).items() if inspect.isfunction(v) and not n.startswith("_")
              and v.__module__ == jwarp.__name__}
    missing = public - tpu_layout - set(dir(twarp))
    assert not missing, missing
