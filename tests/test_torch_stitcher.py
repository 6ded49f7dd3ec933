"""The PyTorch port's SIFT window step: against the JAX stitcher from one state
carried across (CPU), and the port's own versions of tests/test_stitcher.py's
window, clip and checkpoint tests."""

import cv2
import jax
import numpy as np
import pytest
import torch

from rtvm_tpu.config import FeatureConfig, MosaicConfig
from rtvm_tpu.mosaic.stitcher import VideMosaic as JaxMosaic
from rtvm_tpu_torch.config import FeatureConfig as TFeatureConfig
from rtvm_tpu_torch.config import MosaicConfig as TMosaicConfig
from rtvm_tpu_torch.mosaic.stitcher import VideMosaic, state_from_numpy

torch.set_num_threads(1)  # tier 1 runs several test workers at once

H_ABS_TOL = 1e-3
MIN_CANVAS_PSNR_DB = 50.0  # the JAX CPU tier warps in bf16 (two-pass), the port in f32
TWO_PASS_DEAD_COLS = 3
EDGE_BAND = TWO_PASS_DEAD_COLS + 16 + 15  # + hole-distance radius + weight-blur radius


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


def _frames(scene, n, dx=5, dy=3):
    h, w = 160, 256
    return [scene[300 + i * dy : 300 + i * dy + h, 100 + i * dx : 100 + i * dx + w] for i in range(n)]


def _jax_config():
    return MosaicConfig(window_size=4, features=FeatureConfig(detector_type="sift", max_keypoints=256, sift_octaves=3))


def _config():
    return TMosaicConfig(window_size=4, features=TFeatureConfig(detector_type="sift", max_keypoints=256, sift_octaves=3))


def _jax_uniforms(jm, b):
    """The RANSAC draws the JAX window step makes for its next b pairs."""
    cfg = jm.config
    f0 = int(np.asarray(jm.state.frame_idx))
    keys = [jax.random.fold_in(jm._key, f0 + i) for i in range(b)]
    shape = (cfg.ransac.num_hypotheses, cfg.features.max_keypoints)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, shape)) for k in keys]))


def _psnr(a, b):
    mse = float(((a.astype(np.float64) - b) ** 2).mean())
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


@pytest.fixture(scope="module")
def both_runs(scene):
    """Two 4-frame windows through each package, the port restored from the
    JAX package's state after frame 0 and fed its RANSAC draws."""
    frames = _frames(scene, 9)
    jm = JaxMosaic(frames[0], detector_type="sift", config=_jax_config())
    tm = VideMosaic(frames[0], detector_type="sift", config=_config(), device="cpu")
    tm.restore(jm.checkpoint())
    out = []
    for w in (frames[1:5], frames[5:9]):
        u = _jax_uniforms(jm, 4)
        ja = jm.process_window(np.stack(w))
        ta = tm.process_window(np.stack(w), uniforms=u)
        out.append((ja, ta, jm.output_img, tm.output_img))
    return jm, tm, out


def test_window_step_matches_jax_from_a_carried_state(both_runs):
    jm, tm, windows = both_runs
    for ja, ta, _, _ in windows:
        np.testing.assert_array_equal(ta.ok.numpy(), np.asarray(ja.ok))
        np.testing.assert_array_equal(ta.blended.numpy(), np.asarray(ja.blended))
        np.testing.assert_array_equal(ta.two_pass.numpy(), np.asarray(ja.two_pass))
        np.testing.assert_array_equal(ta.num_matches.numpy(), np.asarray(ja.num_matches))
        assert np.abs(ta.H_abs.numpy() - np.asarray(ja.H_abs)).max() <= H_ABS_TOL
    assert np.asarray(windows[-1][0].ok).all()
    # window 1 stays inside the canvas: the whole canvas agrees
    _, _, j1, t1 = windows[0]
    assert _psnr(t1, j1) >= MIN_CANVAS_PSNR_DB
    # window 2 runs off the canvas's right edge. There the JAX XLA two-pass
    # warp leaves the last TWO_PASS_DEAD_COLS columns unpainted (its tap
    # window runs out; its own gather tier paints them, as the port does), and
    # the weights spread that over EDGE_BAND columns. Elsewhere they agree.
    _, _, j2, t2 = windows[1]
    assert _psnr(t2[:, :-EDGE_BAND], j2[:, :-EDGE_BAND]) >= MIN_CANVAS_PSNR_DB
    dead = (slice(None), slice(-TWO_PASS_DEAD_COLS, None))
    reached = t2[dead].max(-1) > 0
    assert reached.sum() > 100 and not np.any(j2[dead][reached])
    js, ts = jm.checkpoint(), tm.checkpoint()
    # coverage agrees but for the coarse cells of the unpainted columns, which
    # only the port covers
    dead_cells = -(-TWO_PASS_DEAD_COLS // 4)
    np.testing.assert_array_equal(ts["union_coarse"][:, :-dead_cells], js["union_coarse"][:, :-dead_cells])
    assert np.all(ts["union_coarse"][:, -dead_cells:] >= js["union_coarse"][:, -dead_cells:])
    assert int(ts["frame_idx"]) == int(js["frame_idx"]) == 9
    assert int(ts["hcount"]) == int(js["hcount"])
    assert np.abs(ts["H_old"] - js["H_old"]).max() <= H_ABS_TOL


def test_state_from_numpy_round_trips(both_runs):
    _, tm, _ = both_runs
    snap = tm.checkpoint()
    st = state_from_numpy(snap, "cpu")
    for k, v in st._asdict().items():
        np.testing.assert_array_equal(np.asarray(v.numpy(), dtype=np.float64),
                                      np.asarray(snap[k], dtype=np.float64), err_msg=k)
    assert st.union_coarse.dtype == torch.bool and st.frame_idx.device.type == "cpu"


def test_sift_path_stitches(scene):
    frames = _frames(scene, 3)
    m = VideMosaic(frames[0], detector_type="sift", config=_config(), device="cpu")
    aux = m.process_window(np.stack(frames[1:]))
    assert aux.ok.all()
    H = m.H_old
    assert abs(H[0, 2] - (m.h_offset + 2 * 5)) < 2.5
    assert abs(H[1, 2] - (m.w_offset + 2 * 3)) < 2.5


def test_window_equivalent_to_single_frames(scene):
    frames = _frames(scene, 5)
    m1 = VideMosaic(frames[0], detector_type="sift", config=_config(), device="cpu")
    for i, f in enumerate(frames[1:]):
        m1.process_frame(f, i + 1)
    m2 = VideMosaic(frames[0], detector_type="sift", config=_config(), device="cpu")
    m2.process_window(np.stack(frames[1:]))
    assert np.abs(m1.H_old - m2.H_old).max() < 0.05
    assert np.abs(m1.output_img - m2.output_img).mean() < 0.5


def test_process_clip_matches_sequential_windows(scene):
    frames = _frames(scene, 9)
    m1 = VideMosaic(frames[0], detector_type="sift", config=_config(), device="cpu")
    m1.process_window(np.stack(frames[1:5]))
    m1.process_window(np.stack(frames[5:9]))
    m2 = VideMosaic(frames[0], detector_type="sift", config=_config(), device="cpu")
    aux = m2.process_clip(np.stack([np.stack(frames[1:5]), np.stack(frames[5:9])]))
    assert tuple(aux.ok.shape) == (2, 4)
    assert aux.ok.all()
    assert np.abs(m1.H_old - m2.H_old).max() < 0.05
    assert np.abs(m1.output_img - m2.output_img).mean() < 0.5
    assert int(m2.state.frame_idx) == 9


def test_checkpoint_restore_roundtrip(scene):
    frames = _frames(scene, 4)
    m = VideMosaic(frames[0], detector_type="sift", config=_config(), device="cpu")
    m.process_window(np.stack(frames[1:3]))
    snap = m.checkpoint()
    m.process_frame(frames[3], 3)
    after = m.output_img.copy()
    m.restore(snap)
    m.process_frame(frames[3], 3)
    assert np.abs(m.output_img - after).max() < 1e-3


def test_orb_names_the_next_slice(scene):
    with pytest.raises(NotImplementedError, match="next slice"):
        VideMosaic(_frames(scene, 1)[0], detector_type="orb", device="cpu")
