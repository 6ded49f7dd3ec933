"""Parity of the port's stereo/ (SGM, refinement, the estimator and the
terrain mapper) with the JAX package, both on the CPU, on seeded numpy
inputs at the demo's 120x160."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvm_tpu.ops import color as jcolor
from rtvm_tpu.stereo import depth as jdepth
from rtvm_tpu.stereo import refine as jrefine
from rtvm_tpu.stereo import sgm as jsgm
from rtvm_tpu_torch.stereo import depth as tdepth
from rtvm_tpu_torch.stereo import refine as trefine
from rtvm_tpu_torch.stereo import sgm as tsgm
from rtvm_tpu_torch.utils.colormap import JET_BGR, MAGMA_BGR, apply_colormap

torch.set_num_threads(1)  # tier 1 runs several test workers at once

SUBPIXEL_TOL = 1e-5  # px: the parabola's float32 quotient
GUIDED_TOL = 1e-4  # px: XLA fuses products and sums of the guided filter into multiply-adds


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def demo():
    """The JAX demo's pair and disparity."""
    return jdepth.demo_stereo_depth()


def _slanted_plane_pair(h=96, w=160, d0=4.0, d1=18.0, seed=5):
    """tests/test_stereo.py's slanted plane: the disparity ramps from d0 to
    d1 across the image."""
    rng = np.random.RandomState(seed)
    tex = cv2.GaussianBlur(rng.randint(0, 255, (h, w + 64), np.uint8).astype(np.float32),
                           (0, 0), 1.2)
    xs = np.arange(w, dtype=np.float32)
    s = (d1 - d0) / (w - 1)
    src = 32 + ((xs + d0) / (1.0 - s))[None, :]
    x0 = np.floor(src).astype(int)
    frac = src - x0
    rows = np.arange(h)[:, None]
    right = tex[rows, x0] * (1 - frac) + tex[rows, x0 + 1] * frac
    return tex[:, 32 : 32 + w], right.astype(np.float32)


def _grays(left, right):
    return (np.asarray(jcolor.bgr2gray(jnp.asarray(left))),
            np.asarray(jcolor.bgr2gray(jnp.asarray(right))))


@pytest.fixture(scope="module")
def pairs(demo):
    left, right, _ = demo
    return {"demo": _grays(left, right), "slanted": _slanted_plane_pair()}


@pytest.mark.parametrize("name", ["demo", "slanted"])
def test_census_and_cost_volume_equal(pairs, name):
    gl, gr = pairs[name]
    want = np.asarray(jsgm.census_transform(jnp.asarray(gl)))
    got = tsgm.census_transform(_t(gl))
    assert got.dtype == torch.int32 and int(got.max()) < 1 << 24
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(
        tsgm.build_cost_volume(_t(gl), _t(gr), 32).numpy(),
        np.asarray(jsgm.build_cost_volume(jnp.asarray(gl), jnp.asarray(gr), 32)))


def test_popcount_is_exact_on_24_bits():
    x = np.random.RandomState(0).randint(0, 1 << 24, 4096).astype(np.int32)
    want = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(tsgm.popcount24(_t(x)).numpy(), want)


@pytest.mark.parametrize("axis,reverse", [(0, False), (0, True), (1, False), (1, True)])
def test_each_aggregation_direction_equal(pairs, axis, reverse):
    gl, gr = pairs["demo"]
    cost = np.asarray(jsgm.build_cost_volume(jnp.asarray(gl), jnp.asarray(gr), 32))
    want = np.asarray(jsgm._aggregate_dir(jnp.asarray(cost), 8.0, 96.0, axis, reverse))
    np.testing.assert_array_equal(tsgm._aggregate_dir(_t(cost), 8.0, 96.0, axis, reverse).numpy(),
                                  want)


@pytest.mark.parametrize("name", ["demo", "slanted"])
def test_sgm_disparity_matches_jax(pairs, name):
    gl, gr = pairs[name]
    want = jsgm.sgm_disparity(jnp.asarray(gl), jnp.asarray(gr), 32)
    got = tsgm.sgm_disparity(_t(gl), _t(gr), 32)
    np.testing.assert_array_equal(got.cost_volume.numpy(), np.asarray(want.cost_volume))
    np.testing.assert_array_equal(got.cost_volume.argmin(-1).numpy(),
                                  np.asarray(want.cost_volume).argmin(-1))
    wd, gd = np.asarray(want.disparity), got.disparity.numpy()
    np.testing.assert_array_equal(gd >= 0, wd >= 0)
    assert (gd >= 0).mean() > 0.1  # the demo's background is unmatched noise at disparity 0
    np.testing.assert_allclose(gd, wd, rtol=0, atol=SUBPIXEL_TOL)


@pytest.mark.parametrize("name", ["demo", "slanted"])
def test_speckle_and_guided_filter_match_jax(pairs, name):
    gl, gr = pairs[name]
    raw = np.asarray(jsgm.sgm_disparity(jnp.asarray(gl), jnp.asarray(gr), 32).disparity)
    want_s = np.asarray(jrefine.speckle_suppress(jnp.asarray(raw)))
    got_s = trefine.speckle_suppress(_t(raw)).numpy()
    np.testing.assert_array_equal(got_s, want_s)
    want = np.asarray(jrefine.guided_refine(jnp.asarray(want_s), jnp.asarray(gl)))
    got = trefine.guided_refine(_t(want_s), _t(gl)).numpy()
    np.testing.assert_array_equal(got >= 0, want >= 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=GUIDED_TOL)


def test_speckle_suppress_removes_the_isolated_blob_as_jax():
    d = np.full((64, 64), 10.0, np.float32)
    d[20:23, 30:33] = 25.0  # a 9-px speckle
    d[40:60, 5:25] = 24.0  # a 400-px region that stays
    d[0:2, 0:2] = -1.0
    got = trefine.speckle_suppress(_t(d)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrefine.speckle_suppress(jnp.asarray(d))))
    assert (got[20:23, 30:33] < 0).all() and (got[45:55, 10:20] == 24.0).all()


@pytest.mark.parametrize("n", [1, 5, 16, 17, 177, 300])
def test_cumsum_blocked_is_xla_s_order(n):
    x = (np.random.RandomState(n).rand(n, 3) * 65025).astype(np.float32)
    np.testing.assert_array_equal(trefine.cumsum_blocked(_t(x), 0).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(x), axis=0)))
    np.testing.assert_array_equal(trefine.cumsum_blocked(_t(x.T.copy()), 1).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(x.T), axis=1)))


def test_demo_matches_jax(demo):
    left, right, want = demo
    tl, tr, got = tdepth.demo_stereo_depth(device="cpu")
    np.testing.assert_array_equal(tl, left)
    np.testing.assert_array_equal(tr, right)
    np.testing.assert_array_equal(got >= 0, want >= 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=GUIDED_TOL)
    far, near = got[28:44, 96:124], got[78:98, 48:84]
    assert abs(np.median(far[far > 0]) - 5) <= 1.5 and abs(np.median(near[near > 0]) - 20) <= 1.5


def test_terrain_mapper_products_match_jax(demo):
    left, right, _ = demo
    jm = jdepth.StereoTerrainMapper(jdepth.StereoDepthEstimator(num_disparities=32))
    tm = tdepth.StereoTerrainMapper(tdepth.StereoDepthEstimator(num_disparities=32, device="cpu"))
    want, got = jm.process_stereo_frame(left, right), tm.process_stereo_frame(left, right)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["disparity"], want["disparity"], rtol=0, atol=GUIDED_TOL)
    # depth f*B/d and the cloud carry the disparity's rounding
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-4, atol=0)
    assert got["cloud"].shape == want["cloud"].shape
    np.testing.assert_allclose(got["cloud"], want["cloud"], rtol=1e-4, atol=1e-4)
    for k in ("disparity_vis", "depth_vis"):  # a 1e-4 disparity gap can move a level by one
        lv = np.abs(got[k].astype(int) - want[k].astype(int))
        assert got[k].shape == want[k].shape and (lv.max(-1) > 4).mean() < 1e-3
    np.testing.assert_array_equal(tm.depth_profile(got["depth"]), got["depth"][60])
    for dist in (1.0, 5.0):
        np.testing.assert_array_equal(tm.obstacle_mask(want["depth"], dist),
                                      jm.obstacle_mask(want["depth"], dist))


def test_colourings_are_cv2_s():
    g = np.random.RandomState(0).randint(0, 256, (40, 50)).astype(np.uint8)
    np.testing.assert_array_equal(apply_colormap(g, "jet"), cv2.applyColorMap(g, cv2.COLORMAP_JET))
    np.testing.assert_array_equal(apply_colormap(g, "magma"),
                                  cv2.applyColorMap(g, cv2.COLORMAP_MAGMA))
    lut = np.arange(256, dtype=np.uint8)[:, None]
    np.testing.assert_array_equal(JET_BGR, cv2.applyColorMap(lut, cv2.COLORMAP_JET)[:, 0])
    np.testing.assert_array_equal(MAGMA_BGR, cv2.applyColorMap(lut, cv2.COLORMAP_MAGMA)[:, 0])
    d = np.random.RandomState(1).rand(30, 40).astype(np.float32) * 40 - 5
    np.testing.assert_array_equal(tdepth.StereoDepthEstimator.colorize_disparity(d),
                                  jdepth.StereoDepthEstimator.colorize_disparity(d))
    np.testing.assert_array_equal(tdepth.StereoDepthEstimator.colorize_depth(d),
                                  jdepth.StereoDepthEstimator.colorize_depth(d))
    with pytest.raises(ValueError, match="no colour map"):
        apply_colormap(g, "viridis")


def test_obstacle_mask_is_cv2_s_morphology():
    """Blobs of every size and ones touching the border: cv2's opening and
    closing with a 5x5 square, the border as cv2 treats it."""
    rng = np.random.RandomState(2)
    depth = np.where(rng.rand(60, 80) < 0.5, rng.rand(60, 80) * 4, 0).astype(np.float32)
    depth[:9, :9] = 1.0
    depth[30:33, 70:] = 1.0
    est = tdepth.StereoTerrainMapper(device="cpu")
    want = jdepth.StereoTerrainMapper.obstacle_mask(depth, 2.0)
    np.testing.assert_array_equal(est.obstacle_mask(depth, 2.0), want)
    assert 0 < want.mean() < 1


def test_depth_and_point_cloud_are_the_jax_functions(demo):
    left, _, disp = demo
    np.testing.assert_array_equal(tsgm.disparity_to_depth(disp, 700.0, 0.12),
                                  jsgm.disparity_to_depth(disp, 700.0, 0.12))
    te = tdepth.StereoDepthEstimator(num_disparities=32, device="cpu")
    je = jdepth.StereoDepthEstimator(num_disparities=32)
    np.testing.assert_array_equal(te.create_point_cloud(disp, left),
                                  je.create_point_cloud(disp, left))


def test_cv2_routes_are_cv2_and_others_need_none(demo, tmp_path, monkeypatch):
    left, right, disp = demo
    te = tdepth.StereoDepthEstimator(num_disparities=32, device="cpu")
    je = jdepth.StereoDepthEstimator(num_disparities=32)
    a, b = te.rectify_images(left, right)
    assert a is left and b is right
    h, w = left.shape[:2]
    mx, my = np.meshgrid(np.arange(w, dtype=np.float32) + 0.5, np.arange(h, dtype=np.float32))
    te.maps = je.maps = ((mx, my), (mx - 1.25, my + 0.5))
    for g, want in zip(te.rectify_images(left, right), je.rectify_images(left, right)):
        np.testing.assert_array_equal(g, want)
    assert te.calibrate_stereo_cameras([left] * 3, [right] * 3) is False  # no chessboard
    te.save_point_cloud(te.create_point_cloud(disp, left), str(tmp_path / "c.ply"))
    je.save_point_cloud(je.create_point_cloud(disp, left), str(tmp_path / "j.ply"))
    assert (tmp_path / "c.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError, match="rectify_images"):
        te.rectify_images(left, right)
    with pytest.raises(ImportError, match="calibrate_stereo_cameras"):
        te.calibrate_stereo_cameras([left], [right])


def test_stereo_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdepth.StereoDepthEstimator()
