"""The PyTorch port's window step, SIFT and ORB: against the JAX stitcher from
one state carried across (CPU), the port's own versions of
tests/test_stitcher.py's window, clip and checkpoint tests, checkpoints
between the packages, the constructor's arguments and the entry point."""

import contextlib

import cv2
import jax
import numpy as np
import pytest
import torch

from rtvm_tpu.config import FeatureConfig, MosaicConfig
from rtvm_tpu.mosaic.stitcher import VideMosaic as JaxMosaic
from rtvm_tpu_torch.config import FeatureConfig as TFeatureConfig
from rtvm_tpu_torch.config import MosaicConfig as TMosaicConfig
from rtvm_tpu_torch.mosaic import stitcher
from rtvm_tpu_torch.mosaic.stitcher import VideMosaic, state_from_numpy
from rtvm_tpu_torch.ops import warp as warp_ops
from torch.utils._python_dispatch import TorchDispatchMode

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


@pytest.fixture(scope="module")
def clip_detectors():
    """The port's YOLOv8n detector on the CPU and a float32 JAX counterpart of
    its _infer_fn (the JAX package's own pieces, un-jitted; the checkpoint
    restored against an abstract init, so nothing is compiled)."""
    from rtvm_tpu.models.yolo import postprocess as JP
    from rtvm_tpu.models.yolo.model import YOLOv8 as JaxYOLO, YoloConfig
    from rtvm_tpu.utils.checkpoint import load_pytree_npz
    from rtvm_tpu_torch.detect.detector import ObjectDetector

    td = ObjectDetector("yolov8n", load_world=False, device="cpu")
    jm = JaxYOLO(YoloConfig("yolov8n", num_classes=len(td.class_names)))
    like = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jax.numpy.zeros((1, 64, 64, 3))))
    variables = load_pytree_npz(td.weights_source, dict(like))

    def jax_det_fn(frames):
        x, scale, py, px = JP.preprocess_frames(jax.numpy.asarray(frames), CLIP_IMGSZ)
        box_l, cls_l = jm.apply(variables, x)
        boxes, scores = JP.decode_predictions(box_l, cls_l)
        dets = [JP.nms_fixed(b, s, CLIP_CONF, 0.45) for b, s in zip(boxes, scores)]
        dets = [d._replace(boxes=JP.unletterbox_boxes(d.boxes, scale, py, px)) for d in dets]
        return [torch.from_numpy(np.stack([np.asarray(getattr(d, f)) for d in dets]))
                for f in ("boxes", "scores", "classes", "valid")]

    return td._infer_fn(CLIP_IMGSZ, CLIP_CONF, 0.45, torch.float32), jax_det_fn


CLIP_IMGSZ, CLIP_CONF = 128, 0.01  # 160x256 frames -> 80x128, padded to 128x128


def test_process_clip_with_det_fn_leaves_the_stitch_as_the_window_loop(scene, clip_detectors):
    det_fn, _ = clip_detectors
    frames = _frames(scene, 9)
    windows = np.stack([np.stack(frames[1:5]), np.stack(frames[5:9])])
    m1 = VideMosaic(frames[0], detector_type="sift", config=_config(), device="cpu")
    auxs = [m1.process_window(w) for w in windows]
    m2 = VideMosaic(frames[0], detector_type="sift", config=_config(), device="cpu")
    aux, dets = m2.process_clip(windows, det_fn=det_fn)
    for name, got in aux._asdict().items():
        assert torch.equal(got, torch.stack([getattr(a, name) for a in auxs])), name
    for name, got in m2.state._asdict().items():
        assert torch.equal(got, getattr(m1.state, name)), name
    assert tuple(dets.boxes.shape) == (2, 4, 300, 4) and tuple(dets.valid.shape) == (2, 4, 300)


def test_clip_detections_are_det_fn_over_the_flat_clip_and_match_jax(scene, clip_detectors):
    from rtvm_tpu_torch.models.yolo.postprocess import Detections, match_detections

    det_fn, jax_det_fn = clip_detectors
    frames = _frames(scene, 9)
    windows = np.stack([np.stack(frames[1:5]), np.stack(frames[5:9])])
    calls = []

    def counting_det_fn(flat):
        calls.append(tuple(flat.shape))
        return det_fn(flat)

    m = VideMosaic(frames[0], detector_type="sift", config=_config(), device="cpu")
    _, dets = m.process_clip(windows, det_fn=counting_det_fn)
    assert calls == [(8, 160, 256, 3)]  # once, over all W*B frames
    flat = np.stack(frames[1:9])
    direct = det_fn(flat)
    for name, got in dets._asdict().items():
        assert torch.equal(got.reshape((8,) + got.shape[2:]), getattr(direct, name)), name
    want = Detections(*jax_det_fn(flat))
    got = Detections(*(t.reshape((8,) + t.shape[2:]) for t in dets))
    agree = match_detections(want, got)
    assert agree["n_ref"] > 0 and agree["share"] == 1.0, agree
    assert agree["max_score_gap"] <= 1e-4, agree


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



# ------------------------------------------------------------------ the ORB path


def _orb_frames(scene, n, dx=6, dy=-4):
    """tests/test_stitcher.py's _synthetic_frames: a camera panning right and up."""
    h, w = 160, 256
    return [scene[300 + i * dy : 300 + i * dy + h, 100 + i * dx : 100 + i * dx + w] for i in range(n)]


def _jax_orb_config():
    return MosaicConfig(window_size=4, features=FeatureConfig(detector_type="orb", max_keypoints=256, sift_octaves=3))


def _orb_config():
    return TMosaicConfig(window_size=4, features=TFeatureConfig(detector_type="orb", max_keypoints=256, sift_octaves=3))


MIN_IDENTICAL_DESC = 0.95  # of the carried ORB words; 1.0 measured on these frames
# ORB keypoints lie on the pixel grid, so the pairs' homographies are integer
# translations to ~1e-5 px, and a frame's last column and row sample the
# source at w-1 (h-1) plus or minus a rounding. The JAX XLA two-pass warp
# leaves such a sample black, the port (cv2's INTER_LINEAR with a zero border)
# paints it, and the blend weights spread that over EDGE_BAND pixels around
# every frame edge. Measured whole-canvas PSNR: 32.68 dB (window 1), 27.30 dB
# (window 2, which also crosses the canvas edge).
MIN_ORB_CANVAS_PSNR_DB = 25.0


def _away_from_frame_edges(H_abs, hf, wf, hc, wc, band=EDGE_BAND):
    """bool [Hc, Wc]: pixels farther than `band` from every edge of every
    frame's warped rectangle (and from the canvas's right edge)."""
    ys, xs = np.mgrid[0:hc, 0:wc]
    keep = xs < wc - band
    for H in np.asarray(H_abs, np.float64):
        c = H @ np.array([[0, wf - 1, wf - 1, 0], [0, 0, hf - 1, hf - 1], [1, 1, 1, 1]], np.float64)
        x0, x1 = (c[0] / c[2]).min(), (c[0] / c[2]).max()
        y0, y1 = (c[1] / c[2]).min(), (c[1] / c[2]).max()
        in_x = (xs > x0 - band) & (xs < x1 + band)
        in_y = (ys > y0 - band) & (ys < y1 + band)
        near = ((np.abs(xs - x0) <= band) | (np.abs(xs - x1) <= band)) & in_y
        near |= ((np.abs(ys - y0) <= band) | (np.abs(ys - y1) <= band)) & in_x
        keep &= ~near
    return keep


@pytest.fixture(scope="module")
def orb_runs(scene):
    """Two 4-frame ORB windows through each package, the port restored from
    the JAX package's state after frame 0 and fed its RANSAC draws."""
    frames = _orb_frames(scene, 9)
    jm = JaxMosaic(frames[0], detector_type="orb", config=_jax_orb_config())
    tm = VideMosaic(frames[0], detector_type="orb", config=_orb_config(), device="cpu")
    js0 = jm.checkpoint()
    # the first frame's features, each package on its own
    first = (tm.state.kp.numpy(), tm.state.desc.numpy(), js0["kp"], js0["desc"])
    tm.restore(js0)
    out = []
    for w in (frames[1:5], frames[5:9]):
        u = _jax_uniforms(jm, 4)
        ja = jm.process_window(np.stack(w))
        ta = tm.process_window(np.stack(w), uniforms=u)
        out.append((ja, ta, jm.output_img, tm.output_img))
    return jm, tm, frames, first, out


def test_orb_window_step_matches_jax_from_a_carried_state(orb_runs):
    jm, tm, _, (kp0, desc0, jkp0, jdesc0), windows = orb_runs
    np.testing.assert_array_equal(kp0, jkp0)
    assert (desc0 == jdesc0.view(np.int32)).all(-1).mean() >= MIN_IDENTICAL_DESC
    for ja, ta, _, _ in windows:
        np.testing.assert_array_equal(ta.ok.numpy(), np.asarray(ja.ok))
        np.testing.assert_array_equal(ta.blended.numpy(), np.asarray(ja.blended))
        np.testing.assert_array_equal(ta.num_matches.numpy(), np.asarray(ja.num_matches))
        assert np.abs(ta.H_abs.numpy() - np.asarray(ja.H_abs)).max() <= H_ABS_TOL
        assert np.asarray(ja.ok).all()
    for ja, _, jc, tc in windows:
        assert _psnr(tc, jc) >= MIN_ORB_CANVAS_PSNR_DB
        keep = _away_from_frame_edges(ja.H_abs, 160, 256, jc.shape[0], jc.shape[1])
        assert keep.mean() > 0.25
        assert _psnr(tc[keep], jc[keep]) >= MIN_CANVAS_PSNR_DB
    js, ts = jm.checkpoint(), tm.checkpoint()
    assert ts["desc"].dtype == js["desc"].dtype == np.uint32
    assert (ts["desc"] == js["desc"]).all(-1).mean() >= MIN_IDENTICAL_DESC
    np.testing.assert_array_equal(ts["kp"], js["kp"])
    assert int(ts["frame_idx"]) == int(js["frame_idx"]) == 9
    assert np.abs(ts["H_old"] - js["H_old"]).max() <= H_ABS_TOL


def test_orb_process_frame_accepts_and_updates_state(scene):
    frames = _orb_frames(scene, 3)
    m = VideMosaic(frames[0], detector_type="orb", config=_orb_config(), device="cpu")
    assert int(m.state.frame_idx) == 1
    assert m.process_frame(frames[1], 1)
    assert int(m.state.frame_idx) == 2
    H = m.H_old
    assert abs(H[0, 2] - (m.h_offset + 6)) < 2.0
    assert abs(H[1, 2] - (m.w_offset - 4)) < 2.0


def test_orb_window_equivalent_to_single_frames(scene):
    frames = _orb_frames(scene, 5)
    m1 = VideMosaic(frames[0], detector_type="orb", config=_orb_config(), device="cpu")
    for i, f in enumerate(frames[1:]):
        m1.process_frame(f, i + 1)
    m2 = VideMosaic(frames[0], detector_type="orb", config=_orb_config(), device="cpu")
    m2.process_window(np.stack(frames[1:]))
    assert np.abs(m1.H_old - m2.H_old).max() < 0.05
    assert np.abs(m1.output_img - m2.output_img).mean() < 0.5


def test_orb_mosaic_grows_and_matches_scene(scene):
    frames = _orb_frames(scene, 8)
    m = VideMosaic(frames[0], detector_type="orb", config=_orb_config(), device="cpu")
    aux = m.process_window(np.stack(frames[1:]))
    assert aux.ok.all()
    out = m.output_img_u8
    covered = int(m.state.union_coarse.sum()) * warp_ops.CELL_PX**2
    assert covered > 1.15 * 160 * 256
    seed = out[m.w_offset : m.w_offset + 160, m.h_offset : m.h_offset + 256]
    d = np.abs(seed.astype(np.float32) - frames[0].astype(np.float32))
    assert d[40:-40, 60:-60].mean() < 12.0


def test_orb_checkpoint_restore_roundtrip(scene):
    frames = _orb_frames(scene, 4)
    m = VideMosaic(frames[0], detector_type="orb", config=_orb_config(), device="cpu")
    m.process_window(np.stack(frames[1:3]))
    snap = m.checkpoint()
    m.process_frame(frames[3], 3)
    after = m.output_img.copy()
    m.restore(snap)
    m.process_frame(frames[3], 3)
    assert np.abs(m.output_img - after).max() < 1e-3


def test_orb_process_clip_matches_sequential_windows(scene):
    frames = _orb_frames(scene, 9)
    m1 = VideMosaic(frames[0], detector_type="orb", config=_orb_config(), device="cpu")
    m1.process_window(np.stack(frames[1:5]))
    m1.process_window(np.stack(frames[5:9]))
    m2 = VideMosaic(frames[0], detector_type="orb", config=_orb_config(), device="cpu")
    aux = m2.process_clip(np.stack([np.stack(frames[1:5]), np.stack(frames[5:9])]))
    assert tuple(aux.ok.shape) == (2, 4)
    assert aux.ok.all()
    assert np.abs(m1.H_old - m2.H_old).max() < 0.05
    assert np.abs(m1.output_img - m2.output_img).mean() < 0.5
    assert int(m2.state.frame_idx) == 9


def test_jax_orb_checkpoint_round_trips_through_the_port(orb_runs):
    jm, _, frames, _, _ = orb_runs
    js = jm.checkpoint()
    tm = VideMosaic(frames[0], detector_type="orb", config=_orb_config(), device="cpu")
    tm.restore(js)
    assert tm.state.desc.dtype == torch.int32 and tuple(tm.state.desc.shape) == (256, 8)
    np.testing.assert_array_equal(tm.state.desc.numpy(), js["desc"].view(np.int32))
    ts = tm.checkpoint()
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    assert ts["desc"].dtype == np.uint32
    # and back into the JAX package, word for word
    jm2 = JaxMosaic(frames[0], detector_type="orb", config=_jax_orb_config())
    jm2.restore(ts)
    np.testing.assert_array_equal(np.asarray(jm2.state.desc), js["desc"])
    assert np.asarray(jm2.state.desc).dtype == np.uint32


# ------------------------------------------------------------------ the entry points


def test_jax_style_positional_arguments_land_in_place(scene):
    f0 = _orb_frames(scene, 1)[0]
    cfg = _orb_config()
    # (first_image, output_height_times, output_width_times, detector_type,
    #  show_intermediate, output_dir, visualize, config, seed), then device
    m = VideMosaic(f0, 2.0, 1.2, "orb", False, None, False, cfg, 7, "cpu")
    assert m.config == cfg and m.seed == 7 and m.device == torch.device("cpu")
    assert m.show_intermediate is False and m.output_dir is None and m.visualize is False
    assert VideMosaic(f0, detector_type="orb", config=cfg, device="cpu").show_intermediate is True


@pytest.mark.parametrize("show_intermediate,visualize", [(True, False), (False, True)])
def test_debug_artifacts_are_refused_not_ignored(scene, tmp_path, show_intermediate, visualize):
    frames = _orb_frames(scene, 3)
    f0 = frames[0]
    m = VideMosaic(frames[0], detector_type="orb", config=_orb_config(),
                   show_intermediate=show_intermediate, visualize=visualize,
                   output_dir=str(tmp_path), device="cpu")
    m.process_window(np.stack(frames[1:]))
    if visualize:  # matches.jpg: the window's last frame pair, side by side
        img = cv2.imread(str(tmp_path / "matches.jpg"))
        h, w = f0.shape[:2]
        assert img is not None and img.shape == (h, 2 * w, 3)
        assert not (tmp_path / "mosaic_progress.jpg").exists()
    else:  # mosaic_progress.jpg is written, after the first window
        img = cv2.imread(str(tmp_path / "mosaic_progress.jpg"))
        assert img is not None and img.shape == m.output_img_u8.shape
        assert not (tmp_path / "matches.jpg").exists()
    # no output_dir, or nothing asked of it: no artifacts to write, no error
    VideMosaic(f0, detector_type="orb", config=_orb_config(), show_intermediate=show_intermediate,
               visualize=visualize, device="cpu")
    VideMosaic(f0, detector_type="orb", config=_orb_config(), show_intermediate=False,
               visualize=False, output_dir=str(tmp_path), device="cpu")


class _ScalarReads(TorchDispatchMode):
    """Counts reads of a tensor's value into Python (on a card, each one
    waits for the device)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("detector", ["sift", "orb"])
def test_window_step_reads_one_host_scalar(scene, detector):
    """The only value a window step reads into Python is the host tensor
    state.frame_idx, which seeds the RANSAC draws."""
    frames = _orb_frames(scene, 5)
    cfg = _orb_config() if detector == "orb" else _config()
    m = VideMosaic(frames[0], detector_type=detector, config=cfg, device="cpu")
    window = torch.from_numpy(np.stack(frames[1:]))
    m.process_window(window[:2])  # build the cached constants
    assert m.state.frame_idx.device.type == "cpu"
    with _ScalarReads() as reads:
        aux = m.process_window(window[2:])
    assert aux.ok.all()
    assert reads.n == 1


class _OpsOutsideSpans(TorchDispatchMode):
    """Counts the aten ops dispatched while no ``window.*`` span is open (on
    a card most of them are one kernel launch each, host time that the
    spans' device metrics never see)."""

    def __init__(self):
        super().__init__()
        self.open = self.spans = self.outside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.outside += not self.open
        return func(*args, **(kwargs or {}))


MAX_OPS_OUTSIDE_SPANS = 64  # the frames' layout, the new state and the aux


def test_window_step_dispatches_little_outside_its_spans(scene, monkeypatch):
    """A 16-frame SIFT window step does its work inside its four window.*
    spans; outside them it only lays out the frames and gathers the state
    and the aux (a JAX-only regime flag there once cost 521 ops)."""
    frames = _frames(scene, 17)
    cfg = TMosaicConfig(window_size=16, features=TFeatureConfig(detector_type="sift",
                                                                max_keypoints=256, sift_octaves=3))
    m = VideMosaic(frames[0], detector_type="sift", config=cfg, device="cpu")
    window = torch.from_numpy(np.stack(frames[1:]))
    ops = _OpsOutsideSpans()
    outer = stitcher.span

    @contextlib.contextmanager
    def span(name, device_range=False):
        inner = name.startswith("window.")
        with outer(name, device_range) as rec:
            ops.open += inner
            ops.spans += inner
            try:
                yield rec
            finally:
                ops.open -= inner

    monkeypatch.setattr(stitcher, "span", span)
    with ops:
        aux = m.process_window(window)
    assert ops.spans == 4 and aux.ok.shape == (16,)
    assert ops.outside < MAX_OPS_OUTSIDE_SPANS, ops.outside


def test_port_entry_runs_on_cpu():
    from rtvm_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    state, aux = fn(*args)
    assert tuple(aux.H_abs.shape) == (2, 3, 3) and bool(torch.isfinite(aux.H_abs).all())
    assert tuple(state.desc.shape) == (128, 8) and state.desc.dtype == torch.int32
    assert int(state.frame_idx) == 3 and tuple(state.canvas.shape) == (3, 256, 307)


def test_ransac_draws_depend_on_the_seed_and_the_frame_only():
    """Pair f draws from (seed, f): another seed gives other draws on the CPU
    too (whose generator keeps only the low 32 bits of its seed), and a pair
    draws the same whichever window it falls in."""
    from rtvm_tpu_torch.mosaic.stitcher import pair_uniforms

    cfg, cpu = TMosaicConfig(window_size=4), torch.device("cpu")
    a, b = pair_uniforms(0, 5, 3, cfg, cpu), pair_uniforms(1, 5, 3, cfg, cpu)
    assert tuple(a.shape) == (3, cfg.ransac.num_hypotheses, cfg.features.max_keypoints)
    assert all(not torch.equal(a[i], b[i]) for i in range(3))
    assert not torch.equal(a[0], a[1])
    torch.testing.assert_close(pair_uniforms(0, 6, 1, cfg, cpu)[0], a[1], rtol=0, atol=0)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
