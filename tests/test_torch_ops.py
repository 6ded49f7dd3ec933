"""Parity of the PyTorch port's basic ops, matching and homography code with
the JAX package (both on the CPU; the port with its plain versions).

Inputs are made with numpy from a seed and handed to both packages.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvm_tpu.geometry import homography as JG
from rtvm_tpu.ops import clahe as JCL
from rtvm_tpu.ops import color as JC
from rtvm_tpu.ops import filters as JF
from rtvm_tpu.ops import match as JM
from rtvm_tpu.ops import sampling as JS
from rtvm_tpu.ops.features import fast as JFAST
from rtvm_tpu_torch.geometry import homography as TG
from rtvm_tpu_torch.ops import clahe as TCL
from rtvm_tpu_torch.ops import color as TC
from rtvm_tpu_torch.ops import filters as TF
from rtvm_tpu_torch.ops import match as TM
from rtvm_tpu_torch.ops import sampling as TS
from rtvm_tpu_torch.ops.features import fast as TFAST

torch.set_num_threads(1)  # tier 1 runs several test workers at once

REPO = Path(__file__).resolve().parents[1]
OPS_TOL = 1e-5  # float32 ops on [0, 1] images: only the summation order differs
H_RTOL = 1e-4  # homographies: float32 LU solves and 3x3 products in another order


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit_image(seed, shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


# ------------------------------------------------------------------ color, filters, sampling


def test_bgr2gray_matches_jax():
    img = np.random.RandomState(0).randint(0, 256, (3, 37, 53, 3)).astype(np.uint8)
    ref = np.asarray(JC.bgr2gray(jnp.asarray(img)))
    out = TC.bgr2gray(_t(img)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=OPS_TOL * 255)


@pytest.mark.parametrize("sigma,radius", [(1.0, None), (1.52, None), (4.82, 15), (5.0, 15)])
def test_gaussian_blur_matches_jax(sigma, radius):
    img = _unit_image(1, (2, 45, 70))
    np.testing.assert_array_equal(TF.gaussian_kernel1d(sigma, radius), JF.gaussian_kernel1d(sigma, radius))
    ref = np.asarray(JF.gaussian_blur(jnp.asarray(img), sigma, radius))
    out = TF.gaussian_blur(_t(img), sigma, radius).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=OPS_TOL)


def test_max_and_minmax_pools_match_jax():
    img = _unit_image(2, (3, 31, 40)) - 0.5
    np.testing.assert_allclose(TF.maxpool3x3(_t(img)).numpy(),
                               np.asarray(JF.maxpool3x3(jnp.asarray(img))), rtol=0, atol=OPS_TOL)
    jmx, jmn = JF.minmaxpool3x3(jnp.asarray(img))
    tmx, tmn = TF.minmaxpool3x3(_t(img))
    np.testing.assert_allclose(tmx.numpy(), np.asarray(jmx), rtol=0, atol=OPS_TOL)
    np.testing.assert_allclose(tmn.numpy(), np.asarray(jmn), rtol=0, atol=OPS_TOL)


@pytest.mark.parametrize("channels", [None, 3])
def test_bilinear_sample_matches_jax(channels):
    shape = (40, 60) if channels is None else (40, 60, channels)
    img = _unit_image(3, shape)
    rng = np.random.RandomState(4)
    xs = rng.uniform(-3, 63, (17, 23)).astype(np.float32)
    ys = rng.uniform(-3, 43, (17, 23)).astype(np.float32)
    ref = np.asarray(JS.bilinear_sample(jnp.asarray(img), jnp.asarray(xs), jnp.asarray(ys)))
    out = TS.bilinear_sample(_t(img), _t(xs), _t(ys)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=OPS_TOL)


def test_topk2d_blocked_same_indices_as_jax():
    rng = np.random.RandomState(5)
    score = rng.rand(3 * 90, 160).astype(np.float32)
    score[rng.rand(*score.shape) < 0.9] = 0.0  # sparse, like a DoG extremum map
    k = 300
    jt, jy, jx, jv = (np.asarray(a) for a in JFAST.topk2d_blocked(jnp.asarray(score), k))
    tt, ty, tx, tv = (a.numpy() for a in TFAST.topk2d_blocked(_t(score)[None], k))
    np.testing.assert_array_equal(tv[0], jv)
    # the same indices in the same order wherever a keypoint exists
    np.testing.assert_array_equal(ty[0][jv], jy[jv])
    np.testing.assert_array_equal(tx[0][jv], jx[jv])
    np.testing.assert_array_equal(tt[0][jv], jt[jv])


# ------------------------------------------------------------------ HSV, filters, morphology, CLAHE
# (detection on the mosaic and the navigation map, BASELINE config 4)

HSV_TOL = 1e-4  # OpenCV 8-bit ranges (H 0..180, S and V 0..255)
FILTER_TOL = 1e-4 * 255  # 0..255 images; the band products sum in another order
CLAHE_TOL = 1e-3  # float CLAHE on 0..255
CLAHE_U8_EQUAL = 0.995  # enhance_for_detection truncated to uint8: least equal share
CLAHE_U8_MAX = 1  # ... and largest difference in levels


def _bgr_scene(seed, h=150, w=230):
    """uint8 BGR with flat gray patches (exact HSV ties at S = 50) over noise."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    for _ in range(12):
        y, x = rng.randint(0, h - 20), rng.randint(0, w - 20)
        g = rng.randint(60, 220)
        img[y : y + 20, x : x + 20] = (g, g, g + rng.randint(-10, 10))
    return img


@pytest.mark.parametrize("jit", [False, True])
def test_bgr2hsv_matches_jax(jit):
    """Within HSV_TOL of the JAX function; equal to the jitted one, which
    XLA compiles with a product by 1/255 that the port reproduces."""
    img = _bgr_scene(0)
    fn = jax.jit(JC.bgr2hsv) if jit else JC.bgr2hsv
    ref = np.asarray(fn(jnp.asarray(img)))
    out = TC.bgr2hsv(_t(img)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=HSV_TOL)
    if jit:
        np.testing.assert_array_equal(out, ref)
    gray = img[..., 0].astype(np.float32)
    np.testing.assert_array_equal(TC.gray2bgr(_t(gray)).numpy(), np.asarray(JC.gray2bgr(jnp.asarray(gray))))


@pytest.mark.parametrize("size", [3, 11])
def test_box_blur_and_sobel_match_jax(size):
    img = np.random.RandomState(1).uniform(0, 255, (2, 61, 83)).astype(np.float32)
    np.testing.assert_allclose(TF.box_blur(_t(img), size).numpy(),
                               np.asarray(JF.box_blur(jnp.asarray(img), size)), rtol=0, atol=FILTER_TOL)
    for got, want in zip(TF.sobel(_t(img)), JF.sobel(jnp.asarray(img))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FILTER_TOL)


@pytest.mark.parametrize("iterations", [1, 2, 3])
@pytest.mark.parametrize("size", [3, 5, 11, 15])
def test_morphology_matches_jax_exactly(size, iterations):
    rng = np.random.RandomState(size * 10 + iterations)
    mask = (rng.rand(2, 47, 66) > 0.8).astype(np.float32)
    mask[0, :3] = 1.0  # a full border row: the border must not erode
    for name in ("dilate", "erode", "morph_open", "morph_close"):
        got = getattr(TF, name)(_t(mask), size, iterations).numpy()
        want = np.asarray(getattr(JF, name)(jnp.asarray(mask), size, iterations))
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("shape", [(37, 53), (64, 64), (203, 311)])
def test_clahe_matches_jax(shape):
    gray = np.random.RandomState(shape[0]).uniform(0, 255, shape).astype(np.float32)
    np.testing.assert_allclose(TCL.clahe(_t(gray)).numpy(), np.asarray(JCL.clahe(jnp.asarray(gray))),
                               rtol=0, atol=CLAHE_TOL)


def test_enhance_for_detection_matches_jax(textured_image):
    ref = np.asarray(JCL.enhance_for_detection(jnp.asarray(textured_image))).astype(np.uint8)
    got = TCL.enhance_for_detection(_t(textured_image)).to(torch.uint8).numpy()
    d = np.abs(got.astype(int) - ref.astype(int))
    assert (d == 0).mean() >= CLAHE_U8_EQUAL and d.max() <= CLAHE_U8_MAX, ((d == 0).mean(), d.max())


# ------------------------------------------------------------------ matching


def _descriptor_pair(seed, k=120, noise=0.03):
    rng = np.random.RandomState(seed)
    a = rng.rand(k, 128).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    perm = rng.permutation(k)
    b = a[perm] + noise * rng.randn(k, 128).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    va = rng.rand(k) > 0.1
    vb = rng.rand(k) > 0.1
    return b.astype(np.float32), vb, a, va


def test_match_l2_ratio_same_matches_as_jax():
    dq, vq, dt, vt = _descriptor_pair(6)
    jm = JM.match_l2_ratio(jnp.asarray(dq), jnp.asarray(vq), jnp.asarray(dt), jnp.asarray(vt), 0.7)
    tm = TM.match_l2_ratio(_t(dq), _t(vq), _t(dt), _t(vt), 0.7)
    jv = np.asarray(jm.valid)
    assert jv.sum() > 50
    np.testing.assert_array_equal(tm.valid.numpy(), jv)
    np.testing.assert_array_equal(tm.train_idx.numpy()[jv], np.asarray(jm.train_idx)[jv])
    np.testing.assert_allclose(tm.distance.numpy()[jv], np.asarray(jm.distance)[jv], rtol=0, atol=1e-4)


def test_gather_correspondences_matches_jax():
    dq, vq, dt, vt = _descriptor_pair(7)
    rng = np.random.RandomState(8)
    kq = rng.rand(len(dq), 2).astype(np.float32) * 300
    kt = rng.rand(len(dt), 2).astype(np.float32) * 300
    jm = JM.match_l2_ratio(jnp.asarray(dq), jnp.asarray(vq), jnp.asarray(dt), jnp.asarray(vt))
    tm = TM.match_l2_ratio(_t(dq), _t(vq), _t(dt), _t(vt))
    js, jd, jv = JM.gather_correspondences(jnp.asarray(kq), jnp.asarray(kt), jm)
    ts, td, tv = TM.gather_correspondences(_t(kq), _t(kt), tm)
    jv = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(td.numpy()[jv], np.asarray(jd)[jv])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ------------------------------------------------------------------ homography

H_TRUE = np.array([[0.98, -0.05, 12.0], [0.04, 1.01, -7.5], [2e-5, -1e-5, 1.0]], np.float32)


def _correspondences(seed, k=200, outliers=0.3, noise=0.3):
    rng = np.random.RandomState(seed)
    src = rng.uniform(0, 400, (k, 2)).astype(np.float32)
    dst = np.asarray(JG.project(jnp.asarray(H_TRUE), jnp.asarray(src)))
    dst = dst + noise * rng.randn(k, 2).astype(np.float32)
    bad = rng.rand(k) < outliers
    dst[bad] = rng.uniform(0, 400, (int(bad.sum()), 2))
    valid = rng.rand(k) > 0.05
    return src, dst.astype(np.float32), valid, ~bad


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def test_project_dlt_and_validation_match_jax():
    src, dst, _, good = _correspondences(9, outliers=0.0, noise=0.0)
    np.testing.assert_allclose(TG.project(_t(H_TRUE), _t(src)).numpy(),
                               np.asarray(JG.project(jnp.asarray(H_TRUE), jnp.asarray(src))),
                               rtol=H_RTOL, atol=1e-3)
    j4 = JG.dlt_homography_4pt(jnp.asarray(src[:4]), jnp.asarray(dst[:4]))
    t4 = TG.dlt_homography_4pt(_t(src[:4]), _t(dst[:4]))
    assert _rel_err(t4.numpy(), j4) < H_RTOL
    w = (np.random.RandomState(10).rand(len(src)) > 0.3).astype(np.float32)
    jw = JG.dlt_homography_weighted(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    tw = TG.dlt_homography_weighted(_t(src), _t(dst), _t(w))
    assert _rel_err(tw.numpy(), jw) < H_RTOL
    for H in (H_TRUE, np.array([[1, 0, 60.0], [0, 1, 0], [0, 0, 1]], np.float32),
              np.array([[1.5, 0, 0], [0, 1.5, 0], [0, 0, 1]], np.float32)):
        assert bool(TG.validate_homography(_t(H))) == bool(JG.validate_homography(jnp.asarray(H)))
    np.testing.assert_allclose(TG.transform_corners(640, 360, _t(H_TRUE)).numpy(),
                               np.asarray(JG.transform_corners(640, 360, jnp.asarray(H_TRUE))),
                               rtol=H_RTOL, atol=1e-3)


def test_smoothing_matches_jax():
    np.testing.assert_array_equal(TG.smoothing_weights(5, "cpu").numpy(), np.asarray(JG.smoothing_weights(5)))
    rng = np.random.RandomState(11)
    jb, tb = jnp.tile(jnp.eye(3)[None], (5, 1, 1)), torch.eye(3).repeat(5, 1, 1)
    jc, tc = jnp.int32(0), torch.zeros((), dtype=torch.int64)
    jt, tt = JG.smoothing_weights(5), TG.smoothing_weights(5, "cpu")
    for _ in range(7):
        H = (np.eye(3) + 0.01 * rng.randn(3, 3)).astype(np.float32)
        jb, jc, jh = JG.smooth_homography_step(jb, jc, jnp.asarray(H), jt)
        tb, tc, th = TG.smooth_homography_step(tb, tc, _t(H), tt)
        assert int(tc) == int(jc)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=H_RTOL, atol=1e-6)


def _jax_samples(key, valid, num_hypotheses):
    """The JAX package's hypothesis indices for `key` (homography.py:174-176)."""
    u = jax.random.uniform(key, (num_hypotheses, valid.shape[0]))
    scores = jnp.where(jnp.asarray(valid)[None, :], u, -1.0)
    return np.asarray(jax.lax.top_k(scores, 4)[1]), np.asarray(u)


@pytest.mark.parametrize("seed", [12, 13])
def test_ransac_with_jax_samples_gives_jax_h(seed):
    src, dst, valid, _ = _correspondences(seed)
    key = jax.random.PRNGKey(seed)
    jr = JG.ransac_homography(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), key,
                              num_hypotheses=256, refine_iterations=2)
    samp, u = _jax_samples(key, valid, 256)
    np.testing.assert_array_equal(TG.sample_indices(_t(u), _t(valid)).numpy(), samp)
    tr = TG.ransac_homography(_t(src), _t(dst), _t(valid), samples=_t(samp),
                              num_hypotheses=256, refine_iterations=2)
    assert bool(tr.ok) and bool(jr.ok)
    assert _rel_err(tr.H.numpy(), jr.H) < H_RTOL
    assert int(tr.num_inliers) == int(jr.num_inliers)
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))


def test_ransac_own_draws_finds_the_model():
    src, dst, valid, good = _correspondences(14)
    g = torch.Generator().manual_seed(0)
    tr = TG.ransac_homography(_t(src), _t(dst), _t(valid), generator=g, num_hypotheses=256)
    assert bool(tr.ok)
    true_inl = int((valid & good).sum())
    assert int(tr.num_inliers) >= 0.95 * true_inl
    corners = np.array([[0, 0], [400, 0], [400, 400], [0, 400]], np.float32)
    got = TG.project(tr.H, _t(corners)).numpy()
    want = np.asarray(JG.project(jnp.asarray(H_TRUE), jnp.asarray(corners)))
    assert np.abs(got - want).max() < 1.0


def test_ransac_fails_cleanly_with_too_few_matches():
    src, dst, valid, _ = _correspondences(15)
    valid[:] = False
    valid[:3] = True
    tr = TG.ransac_homography(_t(src), _t(dst), _t(valid), generator=torch.Generator().manual_seed(0),
                              num_hypotheses=64)
    assert not bool(tr.ok)
    np.testing.assert_array_equal(tr.H.numpy(), np.eye(3, dtype=np.float32))


# ------------------------------------------------------------------ package boundary

_IMPORT_PROBE = """
import sys
for name in ("jax", "jaxlib", "cv2", "PIL", "rtvm_tpu", "matplotlib", "plotly", "open3d",
             "tkinter", "ui"):
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib, os, py_compile
mods = ["rtvm_tpu_torch", "rtvm_tpu_torch.config", "rtvm_tpu_torch.device",
        "rtvm_tpu_torch.kernels", "rtvm_tpu_torch.ops.color", "rtvm_tpu_torch.ops.filters",
        "rtvm_tpu_torch.ops.sampling", "rtvm_tpu_torch.ops.features.fast",
        "rtvm_tpu_torch.ops.features.sift", "rtvm_tpu_torch.ops.kernel_patches",
        "rtvm_tpu_torch.ops.kernel_warp", "rtvm_tpu_torch.ops.match",
        "rtvm_tpu_torch.ops.warp", "rtvm_tpu_torch.geometry.homography",
        "rtvm_tpu_torch.mosaic.stitcher", "rtvm_tpu_torch.ops.features.orb",
        "rtvm_tpu_torch.entry", "rtvm_tpu_torch.detect.classes",
        "rtvm_tpu_torch.detect.detector", "rtvm_tpu_torch.utils.checkpoint",
        "rtvm_tpu_torch.models.yolo.modules", "rtvm_tpu_torch.models.yolo.model",
        "rtvm_tpu_torch.models.yolo.convert", "rtvm_tpu_torch.models.yolo.postprocess",
        "rtvm_tpu_torch.utils.timing", "rtvm_tpu_torch.utils.image", "rtvm_tpu_torch.utils.draw",
        "rtvm_tpu_torch.io.jpeg", "rtvm_tpu_torch.io.video", "rtvm_tpu_torch.mosaic.prescan",
        "rtvm_tpu_torch.pipelines.mosaic_pipeline", "rtvm_tpu_torch.cli",
        "rtvm_tpu_torch.__main__", "rtvm_tpu_torch.ops.clahe",
        "rtvm_tpu_torch.models.yolo.world", "rtvm_tpu_torch.utils.contours",
        "rtvm_tpu_torch.detect.classical", "rtvm_tpu_torch.navigate.native",
        "rtvm_tpu_torch.navigate.obstacles", "rtvm_tpu_torch.navigate.astar",
        "rtvm_tpu_torch.navigate.mapping", "rtvm_tpu_torch.io.imread",
        "rtvm_tpu_torch.pipelines.images_pipeline", "rtvm_tpu_torch.slam.flow",
        "rtvm_tpu_torch.slam.epipolar", "rtvm_tpu_torch.slam.vo", "rtvm_tpu_torch.slam.runner",
        "rtvm_tpu_torch.slam.terrain", "rtvm_tpu_torch.io.ply", "rtvm_tpu_torch.io.png",
        "rtvm_tpu_torch.models.depthnet", "rtvm_tpu_torch.depth3d.estimator",
        "rtvm_tpu_torch.depth3d.pointcloud", "rtvm_tpu_torch.depth3d.icp",
        "rtvm_tpu_torch.depth3d.tsdf", "rtvm_tpu_torch.depth3d.mesh",
        "rtvm_tpu_torch.depth3d.pipeline", "rtvm_tpu_torch.ops.smooth",
        "rtvm_tpu_torch.utils.colormap", "rtvm_tpu_torch.stereo.sgm",
        "rtvm_tpu_torch.stereo.refine", "rtvm_tpu_torch.stereo.depth",
        "rtvm_tpu_torch.viz.render", "rtvm_tpu_torch.viz.html3d",
        "rtvm_tpu_torch.viz.pointcloud_viewer", "rtvm_tpu_torch.menus",
        "rtvm_tpu_torch.ui.web_app", "rtvm_tpu_torch.ui.gui", "rtvm_tpu_torch.models.optim",
        "rtvm_tpu_torch.models.yolo.eval", "rtvm_tpu_torch.models.yolo.synth",
        "rtvm_tpu_torch.models.yolo.train", "rtvm_tpu_torch.models.yolo.train_synth",
        "rtvm_tpu_torch.models.yolo.train_world", "rtvm_tpu_torch.models.depth_synth",
        "rtvm_tpu_torch.models.train_depth", "rtvm_tpu_torch.parallel",
        "rtvm_tpu_torch.parallel.mesh", "rtvm_tpu_torch.parallel.collectives",
        "rtvm_tpu_torch.models.yolo.weights", "rtvm_tpu_torch.entry"]
for m in mods:
    importlib.import_module(m)
py_compile.compile("chip_smoke.py", doraise=True)
# the synthetic scenes and a trainer's step, eval and checkpoints run without cv2
import tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from rtvm_tpu_torch.models.yolo import synth, train_synth
rng = np.random.RandomState(0)
imgs = synth.make_batch(rng, synth.BackgroundPool(64, rng=rng), 2, 64)[0]
assert imgs.shape == (2, 64, 64, 3) and imgs.std() > 0
with tempfile.TemporaryDirectory() as out:
    train_synth.train(steps=1, batch=1, imgsz=64, out_dir=out, device="cpu")
    assert sorted(os.listdir(out)) == ["yolov8n_aerial.json", "yolov8n_aerial.npz",
                                       "yolov8n_aerial_trainstate.npz"]
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "cv2", "PIL", "rtvm_tpu", "matplotlib", "plotly", "open3d", "tkinter", "ui") and sys.modules[n] is not None)
assert not bad, bad
import rtvm_tpu_torch
assert all(callable(getattr(rtvm_tpu_torch, n)) for n in ("MosaicConfig", "PipelineConfig",
                                                          "VideMosaic", "main"))
print("OK", len(mods))
"""


@pytest.mark.parametrize("n", [5, 240, 1280])
def test_band_tensor_is_band_matrix_built_on_the_device(n):
    """The blur's band matrices are built with device ops (a grown canvas
    needs new sizes mid-run, and a host-to-device copy would wait for the
    card); the float32 sums equal band_matrix's bit for bit."""
    for sigma, radius in ((5.0, 15), (1.0, None), (2.0, None)):
        taps = TF.gaussian_kernel1d(sigma, radius)
        got = TF._band_tensor(tuple(float(t) for t in taps), n, torch.device("cpu"))
        np.testing.assert_array_equal(got.numpy(), TF.band_matrix(taps, n))


def test_port_imports_without_jax_cv2_or_reference_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "OK 81"


def test_port_root_has_the_jax_root_s_public_names():
    import types

    import rtvm_tpu
    import rtvm_tpu_torch
    from rtvm_tpu_torch.config import MosaicConfig
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic

    public = {n for n, v in vars(rtvm_tpu).items()
              if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert public == {"MosaicConfig", "PipelineConfig", "VideMosaic", "main"}
    assert public <= set(vars(rtvm_tpu_torch))
    assert rtvm_tpu_torch.VideMosaic is VideMosaic and rtvm_tpu_torch.MosaicConfig is MosaicConfig
    assert rtvm_tpu_torch.__version__ == rtvm_tpu.__version__


def test_default_device_is_cuda_and_never_falls_back():
    from rtvm_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            TG.smoothing_weights(5)
