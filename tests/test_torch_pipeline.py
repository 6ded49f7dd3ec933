"""The PyTorch port's pipeline driver against the JAX package's on the CPU:
the frame reader, the motion pre-scan, the canvas growth, run_mosaic
(windowed and fused), main and the CLI, on small synthetic clips."""

import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from rtvm_tpu.config import FeatureConfig as JFeatureConfig
from rtvm_tpu.config import MosaicConfig as JMosaicConfig
from rtvm_tpu.config import PipelineConfig as JPipelineConfig
from rtvm_tpu.detect import detector as JDET
from rtvm_tpu.io.video import VideoReader as JaxReader
from rtvm_tpu.mosaic import prescan as JP
from rtvm_tpu.mosaic.stitcher import VideMosaic as JaxMosaic
from rtvm_tpu.mosaic.stitcher import WindowAux as JaxAux
from rtvm_tpu.pipelines import mosaic_pipeline as JPL
from rtvm_tpu_torch import cli
from rtvm_tpu_torch.config import FeatureConfig, MosaicConfig, PipelineConfig
from rtvm_tpu_torch.io import jpeg as J
from rtvm_tpu_torch.io.video import VideoReader
from rtvm_tpu_torch.mosaic import prescan as TP
from rtvm_tpu_torch.mosaic import stitcher as TS
from rtvm_tpu_torch.mosaic.stitcher import VideMosaic, WindowAux
from rtvm_tpu_torch.pipelines import mosaic_pipeline as TPL
from rtvm_tpu_torch.utils.image import crop_black_areas, psnr

torch.set_num_threads(1)  # tier 1 runs several test workers at once

REPO = Path(__file__).resolve().parents[1]
H_OLD_TOL = 1e-3
MIN_CANVAS_PSNR_DB = 25.0  # whole canvas (ROADMAP Queue 3 item 9: JAX's two-pass warp edges)
MIN_INNER_PSNR_DB = 50.0  # farther than EDGE_BAND px from every frame edge
EDGE_BAND = 34
CROP_TOL_PX = 2
PRESCAN_TOL_PX = 4.0


# ------------------------------------------------------------------ clips


def _scene(seed, h, w, n_rects):
    rng = np.random.RandomState(seed)
    img = cv2.GaussianBlur(rng.randint(0, 255, (h, w, 3)).astype(np.uint8), (0, 0), 1.0)
    for _ in range(n_rects):
        x, y = rng.randint(10, w - 20), rng.randint(10, h - 20)
        cv2.rectangle(img, (x, y), (x + rng.randint(8, 30), y + rng.randint(8, 30)),
                      tuple(int(v) for v in rng.randint(0, 255, 3)), -1)
    return img


def _write_mp4(path, frames, fps=10):
    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        vw.write(np.ascontiguousarray(f))
    vw.release()
    return str(path)


@pytest.fixture(scope="module")
def pan(tmp_path_factory):
    """tests/test_pipeline.py's clip: 21 frames of 200x320 panning +5 px/frame."""
    scene = _scene(11, 500, 700, 80)
    frames = np.stack([scene[120:320, 60 + 5 * i : 60 + 5 * i + 320] for i in range(21)])
    d = tmp_path_factory.mktemp("pan")
    return frames, _write_mp4(d / "pan.mp4", frames, 15)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """tests/test_pipeline.py's fused-vs-windowed clip: 9 frames of 120x200
    moving (+2, +2) px/frame, as frames decoded from its mp4."""
    rng = np.random.RandomState(5)
    h, w, n = 120, 200, 9
    base = cv2.GaussianBlur(rng.randint(0, 255, (h + 2 * n, w + 2 * n, 3), dtype=np.uint8),
                            (0, 0), 1.0)
    for _ in range(30):
        x, y = rng.randint(10, w), rng.randint(10, h)
        cv2.rectangle(base, (x, y), (x + 14, y + 10), tuple(int(v) for v in rng.randint(0, 255, 3)), -1)
    d = tmp_path_factory.mktemp("small")
    path = _write_mp4(d / "clip.mp4", np.stack([base[2 * i : 2 * i + h, 2 * i : 2 * i + w]
                                                 for i in range(n)]))
    cap = cv2.VideoCapture(path)
    decoded = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        decoded.append(f)
    return np.stack(decoded), path, d


def _windows(reader):
    return [(f.copy(), n) for f, n in reader.windows()]


# ------------------------------------------------------------------ the reader


@pytest.mark.parametrize("window,max_frames", [(4, None), (4, 10), (16, None), (3, 1)])
def test_reader_matches_jax_on_an_mp4(small, window, max_frames):
    _, path, _ = small
    jr = JaxReader(path, window=window, max_frames=max_frames)
    tr = VideoReader(path, window=window, max_frames=max_frames)
    np.testing.assert_array_equal(tr.first_frame, jr.first_frame)
    assert tr.frame_count_hint == jr.frame_count_hint == 9 and tr.fps == jr.fps
    jw, tw = _windows(jr), _windows(tr)
    assert [n for _, n in tw] == [n for _, n in jw]
    for (a, _), (b, _) in zip(tw, jw):
        np.testing.assert_array_equal(a, b)


def test_reader_routes_agree(small, tmp_path):
    """The video path, the array of its frames, a .npy file of them and an
    iterable of them give the same first frame, windows and padding."""
    frames, path, _ = small
    npy = tmp_path / "clip.npy"
    np.save(npy, frames)
    runs = [VideoReader(src, window=4) for src in (path, frames, str(npy), list(frames),
                                                   (f for f in frames))]
    ref = _windows(runs[0])
    assert [n for _, n in ref] == [4, 4]
    for r in runs[1:]:
        np.testing.assert_array_equal(r.first_frame, runs[0].first_frame)
        got = _windows(r)
        assert [n for _, n in got] == [n for _, n in ref]
        for (a, _), (b, _) in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    assert runs[1].frame_count_hint == runs[2].frame_count_hint == 9
    assert runs[4].frame_count_hint == 0  # a generator has no length
    last = _windows(VideoReader(frames[:7], window=4))[-1]
    assert last[1] == 2 and (last[0][2:] == frames[6]).all()


def test_reader_on_a_video_path_without_cv2_raises(small, monkeypatch):
    _, path, _ = small
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=r"\.npy"):
        VideoReader(path)
    VideoReader(small[0])  # the array route needs no decoder


def test_reader_passes_a_worker_error_on():
    def broken():
        yield np.zeros((8, 8, 3), np.uint8)
        yield np.zeros((8, 8, 3), np.uint8)
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        _windows(VideoReader(broken(), window=4))


# ------------------------------------------------------------------ the pre-scan


@pytest.mark.parametrize("extent", [
    (0.0, -0.47, 419.73, 199.09),
    (-130.2, -12.5, 300.0, 480.9),
    (0.0, 0.0, 3000.0, 3000.0),  # more than max_area_times the frame: None
    None,
])
def test_prescan_canvas_is_the_jax_arithmetic(extent, monkeypatch):
    monkeypatch.setattr(JP, "prescan_extent", lambda *a, **k: extent)
    monkeypatch.setattr(TP, "prescan_extent", lambda *a, **k: extent)
    for hw in ((200, 320), (360, 640)):
        assert TP.prescan_canvas([], hw, device="cpu") == JP.prescan_canvas([], hw)


def test_prescan_extent_within_4px_of_jax_and_the_truth(pan):
    """Measured: the port 0.0, 0.0, 419.0, 199.0 (to 3e-5 px), JAX (cv2's
    ORB) 0.0, -0.47, 419.73, 199.09; the truth 0, 0, 419, 199."""
    frames, _ = pan
    got = np.array(TP.prescan_extent(frames, stride=4, device="cpu"))
    ref = np.array(JP.prescan_extent(iter(frames), stride=4))
    truth = np.array([0.0, 0.0, 319.0 + 100.0, 199.0])
    assert np.abs(got - ref).max() <= PRESCAN_TOL_PX
    assert np.abs(got - truth).max() <= PRESCAN_TOL_PX


def test_prescan_from_each_source_and_untrackable_clips(pan, tmp_path):
    frames, path = pan
    npy = tmp_path / "pan.npy"
    np.save(npy, frames)
    want = TP.prescan_canvas(frames, (200, 320), stride=4, device="cpu")
    assert want == ((328, 640), (64, 64))
    for src in (frames, str(npy), path):
        got = TP.prescan_canvas_from_video(src, stride=4, device="cpu")
        assert got[0] == want[0] and np.abs(np.subtract(got[1], want[1])).max() <= 1
    # max_frames: only the first 9 frames (2 strided pairs) are read
    short = TP.prescan_canvas_from_video(frames, stride=4, max_frames=9, device="cpu")
    assert short == TP.prescan_canvas(frames[:9], (200, 320), stride=4, device="cpu")
    assert short[0][1] < want[0][1]
    flat = np.zeros((9, 64, 96, 3), np.uint8)  # no keypoints: cannot be tracked
    assert TP.prescan_extent(flat, stride=4, device="cpu") is None
    assert TP.prescan_extent([], device="cpu") is None


# ------------------------------------------------------------------ canvas growth


def _grow_cfgs():
    kw = dict(window_size=4, auto_grow=True)
    return (JMosaicConfig(features=JFeatureConfig(detector_type="orb", max_keypoints=128), **kw),
            MosaicConfig(features=FeatureConfig(detector_type="orb", max_keypoints=128), **kw))


@pytest.fixture(scope="module")
def grow_pair(small):
    """One JAX and one port stitcher, the port restored from the JAX state."""
    frames = small[0]
    jcfg, tcfg = _grow_cfgs()
    jm = JaxMosaic(frames[0], detector_type="orb", config=jcfg)
    snap = jm.checkpoint()
    return jm, snap, frames[0], tcfg


def _shift(dx, dy, b=4, step=(5.0, -3.0)):
    return np.stack([np.array([[1, 0, dx + i * step[0]], [0, 1, dy + i * step[1]], [0, 0, 1]],
                              np.float32) for i in range(b)])


@pytest.mark.parametrize("H_abs,blended", [
    (_shift(60, 130), [True] * 4),  # inside the 240x240 canvas, drifting right: right pad
    (_shift(-20, -10), [True] * 4),  # off the left and top edges
    (_shift(20, 100, step=(0.5, 0.5)), [True] * 4),  # well inside: no growth
    (_shift(100, 100, step=(40, 0)), [True, False, True, False]),  # skipped frames ignored
    (_shift(0, 0), [False] * 4),  # nothing painted: no growth
])
def test_maybe_grow_matches_jax(grow_pair, H_abs, blended):
    jm, snap, first, tcfg = grow_pair
    jm.restore(snap)
    jm.canvas_shape, jm.w_offset, jm.h_offset = (240, 240, 3), 120, 20
    tm = VideMosaic(first, detector_type="orb", config=tcfg, device="cpu")
    tm.restore(snap)
    assert (tm.canvas_shape, tm.w_offset, tm.h_offset) == (jm.canvas_shape, jm.w_offset, jm.h_offset)
    b = len(blended)
    jaux = JaxAux(*(np.zeros(b, np.int32),) * 2, H_abs, np.ones(b, bool), np.array(blended),
                  np.ones(b, bool))
    taux = WindowAux(*(torch.zeros(b, dtype=torch.int64),) * 2, torch.from_numpy(H_abs),
                     torch.ones(b, dtype=torch.bool), torch.tensor(blended))
    pad_j, pad_t = jm._maybe_grow(jaux), tm._maybe_grow(taux)
    assert pad_t == pad_j
    assert (tm.canvas_shape, tm.w_offset, tm.h_offset) == (jm.canvas_shape, jm.w_offset, jm.h_offset)
    js, ts = jm.checkpoint(), tm.checkpoint()
    np.testing.assert_array_equal(ts["canvas"], js["canvas"])
    np.testing.assert_array_equal(ts["union_coarse"], js["union_coarse"])
    assert np.abs(ts["H_old"] - js["H_old"]).max() <= 1e-6


def test_auto_grow_window_loop_follows_a_pan_off_the_canvas(pan):
    """The +5 px/frame pan leaves the 400x384 canvas on the right: the
    windowed run grows it, keeps every frame and paints past the old edge."""
    frames, _ = pan
    cfg = MosaicConfig(window_size=4, auto_grow=True,
                       features=FeatureConfig(detector_type="orb", max_keypoints=256))
    m, stats = TPL.run_mosaic(frames, config=cfg, detector_type="orb", device="cpu")
    assert stats["frames"] == 21 and stats["accepted"] >= 19
    assert m.canvas_shape[1] > 384 and m.canvas_shape[1] % 256 == 384 % 256
    painted = m.output_img_u8.sum(-1) > 0
    xs = np.flatnonzero(painted.any(0))
    assert xs.max() - xs.min() >= 410
    assert abs(float(m.H_old[0, 2]) - (m.h_offset + 100)) <= 2.0


def test_fused_auto_grow_uses_the_prescan(pan):
    """As tests/test_pipeline.py::test_fused_auto_grow_uses_prescan holds the
    JAX driver: the fused path is taken, on a pre-scanned canvas."""
    frames, _ = pan
    cfg = MosaicConfig(window_size=4, auto_grow=True,
                       features=FeatureConfig(detector_type="orb", max_keypoints=256))
    m, stats = TPL.run_mosaic(frames, config=cfg, detector_type="orb", fused=True, device="cpu")
    assert stats["fused_windows"] == 5 and stats["accepted"] >= 19
    assert m.canvas_shape[:2] == (328, 640) and m.config.auto_grow is False
    xs = np.flatnonzero((m.output_img_u8.sum(-1) > 0).any(0))
    assert xs.max() - xs.min() >= 410


# ------------------------------------------------------------------ run_mosaic and main


def _away_from_frame_edges(Hs, hf, wf, hc, wc, band=EDGE_BAND):
    ys, xs = np.mgrid[0:hc, 0:wc]
    keep = xs < wc - band
    for H in Hs:
        c = H @ np.array([[0, wf - 1, wf - 1, 0], [0, 0, hf - 1, hf - 1], [1, 1, 1, 1]], float)
        x0, x1, y0, y1 = c[0].min(), c[0].max(), c[1].min(), c[1].max()
        in_x = (xs > x0 - band) & (xs < x1 + band)
        in_y = (ys > y0 - band) & (ys < y1 + band)
        near = ((np.abs(xs - x0) <= band) | (np.abs(xs - x1) <= band)) & in_y
        near |= ((np.abs(ys - y0) <= band) | (np.abs(ys - y1) <= band)) & in_x
        keep &= ~near
    return keep


def _crop_box(img):
    gray = img.mean(axis=2)
    rows, cols = np.flatnonzero((gray > 80).any(1)), np.flatnonzero((gray > 80).any(0))
    return np.array([rows[0], rows[-1], cols[0], cols[-1]])


def _jax_draws(seed, first_frame, b, cfg, device):
    """The RANSAC draws the JAX window step makes for pairs first_frame.. of a
    run with `seed` (in place of the port's torch.Generator draws)."""
    key = jax.random.PRNGKey(seed)
    shape = (cfg.ransac.num_hypotheses, cfg.features.max_keypoints)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(jax.random.fold_in(key, first_frame + i), shape))
        for i in range(b)])).to(device)


@pytest.fixture(scope="module")
def both_mains(small):
    """Each package's main on the 9-frame ORB clip, window 4, no progress
    image, no detection, no navigation. The port replays the JAX run's
    RANSAC draws (ROADMAP ground rules, "RANSAC randomness"): on this clip
    about a third of the seeds, in either package, pick for some pair a
    distorted 4-point hypothesis that keeps one more inlier than the
    least-squares refit (ROADMAP Queue 3 item 16), so with draws of their
    own the two runs can end at different H_old."""
    _, path, d = small
    mp = pytest.MonkeyPatch()
    mp.setattr(TS, "pair_uniforms", _jax_draws)
    out_j, out_t = d / "jax", d / "port"
    kw = dict(output_dir=None, detector_type="orb", show_intermediate=False,
              enable_detection=False, enable_navigation=False)
    jm, js = JPL.main(path, config=JPipelineConfig(mosaic=JMosaicConfig(window_size=4)),
                      **{**kw, "output_dir": str(out_j)})
    try:
        tm, ts = TPL.main(path, config=PipelineConfig(mosaic=MosaicConfig(window_size=4)),
                          device="cpu", **{**kw, "output_dir": str(out_t)})
    finally:
        mp.undo()
    return jm, js, tm, ts, out_j, out_t


def test_main_matches_jax_main(both_mains):
    jm, js, tm, ts, out_j, out_t = both_mains
    assert (ts["frames"], ts["accepted"]) == (js["frames"], js["accepted"]) == (9, 8)
    assert np.abs(tm.H_old - jm.H_old).max() <= H_OLD_TOL
    jc, tc = jm.output_img, tm.output_img
    assert jc.shape == tc.shape and (tm.w_offset, tm.h_offset) == (jm.w_offset, jm.h_offset)
    assert psnr(tc, jc) >= MIN_CANVAS_PSNR_DB
    # the clip moves (+2, +2) px a frame; frames sit at the seed offset plus that
    Hs = [np.array([[1, 0, jm.h_offset + 2 * i], [0, 1, jm.w_offset + 2 * i], [0, 0, 1]], float)
          for i in range(9)]
    keep = _away_from_frame_edges(Hs, 120, 200, *jc.shape[:2])
    assert keep.mean() > 0.2
    assert psnr(tc[keep], jc[keep]) >= MIN_INNER_PSNR_DB
    # mosaic.jpg: cropped at the same box, the same size, decodable
    assert np.abs(_crop_box(tm.output_img_u8) - _crop_box(jm.output_img_u8)).max() <= CROP_TOL_PX
    mine, ref = cv2.imread(str(out_t / "mosaic.jpg")), cv2.imread(str(out_j / "mosaic.jpg"))
    assert abs(mine.shape[0] - ref.shape[0]) <= CROP_TOL_PX and abs(mine.shape[1] - ref.shape[1]) <= CROP_TOL_PX
    assert mine.shape == crop_black_areas(tm.output_img_u8, 80, 30).shape
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == ["mosaic.jpg"]


@pytest.mark.parametrize("chunk", ["1", "6"])
def test_fused_equals_windowed_and_calls_back_per_chunk(small, chunk, monkeypatch):
    """The port's own runs, as tests/test_pipeline.py::
    test_run_mosaic_fused_matches_windowed holds the JAX driver's."""
    frames = small[0]
    cfg = MosaicConfig(window_size=4)
    m1, s1 = TPL.run_mosaic(frames, config=cfg, detector_type="orb", device="cpu")
    calls = []
    monkeypatch.setenv("RTVM_CLIP_CHUNK", chunk)
    m2, s2 = TPL.run_mosaic(frames, config=cfg, detector_type="orb", fused=True, device="cpu",
                            update_callback=lambda fc, img, pct: calls.append((fc, img.shape, pct)))
    assert s2["frames"] == s1["frames"] == 9 and s2["fused_windows"] == 2
    assert s2["accepted"] == s1["accepted"]
    torch.testing.assert_close(m2.state.canvas, m1.state.canvas, rtol=0, atol=0)
    assert len(calls) == 2 // int(min(int(chunk), 2)) + 1
    fcs = [c[0] for c in calls]
    assert fcs == sorted(fcs) and calls[-1][2] == 100.0
    assert all(c[1][2] == 3 and 0 <= c[2] <= 100 for c in calls)


def test_windowed_callback_and_progress_lines(pan, capsys):
    frames, _ = pan
    cfg = MosaicConfig(window_size=4, features=FeatureConfig(detector_type="orb", max_keypoints=256))
    calls = []
    TPL.run_mosaic(frames, config=cfg, detector_type="orb", device="cpu", callback_every=2,
                   update_callback=lambda fc, img, pct: calls.append((fc, img.shape, pct)))
    assert [c[0] for c in calls] == [9, 17]
    assert all(c[1] == (400, 384, 3) and 0 <= c[2] <= 100 for c in calls)
    assert calls[-1][2] == pytest.approx(100.0 * 17 / 21)
    TPL.run_mosaic(np.concatenate([frames] * 3), config=cfg, detector_type="orb", device="cpu")
    out = capsys.readouterr().out
    # every window that ends within `window` frames past a multiple of 50
    assert "Обработан кадр 53/63 (84.1%)" in out and "Processed frame 53/63 (84.1%)" in out
    assert "кадр 49/" not in out


class _StubDetector:
    """Finds one box in the frames whose mean is above the clip's median."""

    def __init__(self, threshold):
        self.threshold = threshold
        self.passes = []

    def _run_pass(self, images, imgsz, conf, iou):
        self.passes.append((len(images), imgsz, conf, iou))
        return [[{"bbox": [5.0, 15.0, 60.0, 50.0], "class": "car", "confidence": 0.9,
                  "source": "yolo"}] if float(im.float().mean()) > self.threshold else []
                for im in images]

    draw_detections = staticmethod(__import__(
        "rtvm_tpu_torch.detect.detector", fromlist=["ObjectDetector"]).ObjectDetector.draw_detections)


def test_detections_dir_gets_one_file_per_frame_with_a_detection(pan, tmp_path):
    frames, _ = pan
    means = frames[1:].reshape(20, -1).mean(1)
    stub = _StubDetector(float(np.median(means)))
    cfg = MosaicConfig(window_size=8, features=FeatureConfig(detector_type="orb", max_keypoints=256))
    out = tmp_path / "Detections"
    _, stats = TPL.run_mosaic(frames, config=cfg, detector_type="orb", device="cpu",
                              per_frame_detector=stub, detections_dir=str(out))
    assert stub.passes == [(8, 640, 0.25, 0.45), (8, 640, 0.25, 0.45), (4, 640, 0.25, 0.45)]
    want = [f"frame_{i:05d}_detected.jpg" for i in range(1, 21) if means[i - 1] > stub.threshold]
    assert sorted(os.listdir(out)) == want and stats["per_frame_detections"] == len(want)
    first = out / want[0]
    assert J.jpeg_size(first.read_bytes()) == (200, 320)
    img = cv2.imread(str(first))
    assert (np.abs(img[15, 10:55].astype(int) - (0, 255, 0)).max(-1) < 60).mean() > 0.9  # the car's box


def test_show_intermediate_writes_the_progress_image_with_the_border(small, tmp_path):
    frames = small[0]
    cfg = PipelineConfig(mosaic=MosaicConfig(window_size=4))
    m, _ = TPL.main(frames, output_dir=str(tmp_path), detector_type="orb", config=cfg,
                    enable_detection=False, enable_navigation=False, device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["mosaic.jpg", "mosaic_progress.jpg"]
    prog = cv2.imread(str(tmp_path / "mosaic_progress.jpg"))
    assert prog.shape == m.output_img_u8.shape
    # window 1 is the one written (windows 1, 5, 9, ...): frame 4's border in black
    y, x = m.w_offset + 8, m.h_offset + 8 + 100
    assert prog[y - 2 : y + 3, x].max() < 40 and m.output_img_u8[y - 2 : y + 3, x].max() > 40


def test_not_ported_parts_raise_before_any_work(tmp_path, small):
    """Every route of main is ported now: images_dir goes to the image
    route (no stitching: an empty directory gives an empty result and no
    mosaic), and run_mosaic's visualize writes matches.jpg."""
    frames = np.zeros((3, 32, 32, 3), np.uint8)
    out = tmp_path / "never"
    (tmp_path / "empty").mkdir()
    assert TPL.main(frames, output_dir=str(out), device="cpu",
                    images_dir=str(tmp_path / "empty")) == []
    assert os.listdir(out) == ["Detections"] and not os.listdir(out / "Detections")
    viz = tmp_path / "viz"
    TPL.run_mosaic(small[0][:5], config=MosaicConfig(window_size=4), detector_type="orb",
                   visualize=True, viz_dir=str(viz), device="cpu")
    assert os.listdir(viz) == ["matches.jpg"]
    h, w = small[0].shape[1:3]
    assert J.jpeg_size((viz / "matches.jpg").read_bytes()) == (h, 2 * w)


@pytest.fixture(scope="module")
def images_dirs(tmp_path_factory):
    """Three images of test_torch_world.py's aerial kind (two JPEGs and a
    PNG, written by cv2) through JAX's process_images_dir and the port's
    main(images_dir=...), each package's navigation maps kept in memory.
    The JAX world detector is built with the repository as the working
    directory (it looks only at the relative weights/ path)."""
    import rtvm_tpu.navigate.mapping as jmap
    import rtvm_tpu_torch.navigate.mapping as tmap
    from rtvm_tpu.pipelines.images_pipeline import process_images_dir
    from test_torch_world import mosaic_like

    d = tmp_path_factory.mktemp("images")
    src = d / "in"
    src.mkdir()
    imgs = {"a": mosaic_like(1)[:300, :420], "b": mosaic_like(2)[280:560, 540:900],
            "c": mosaic_like(3)[:256, 400:800]}
    cv2.imwrite(str(src / "a.jpg"), imgs["a"], [cv2.IMWRITE_JPEG_QUALITY, 95])
    cv2.imwrite(str(src / "b.png"), imgs["b"])
    cv2.imwrite(str(src / "c.jpeg"), imgs["c"], [cv2.IMWRITE_JPEG_QUALITY, 90])
    (src / "notes.txt").write_text("not an image")
    maps = {"jax": [], "port": []}

    def keep(key, fn):
        def run(img, dets, *a, **k):
            out = fn(img, dets, *a, **k)
            maps[key].append((np.array(out), [dict(x) for x in dets]))
            return out
        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(jmap, "analyze_for_navigation", keep("jax", jmap.analyze_for_navigation))
    mp.setattr(tmap, "analyze_for_navigation", keep("port", tmap.analyze_for_navigation))
    mp.chdir(REPO)
    try:
        jres = process_images_dir(str(src), str(d / "jax"), JPipelineConfig())
        tres = TPL.main(images_dir=str(src), output_dir=str(d / "port"), device="cpu")
    finally:
        mp.undo()
    return imgs, jres, tres, maps, d


def test_images_dir_matches_jax_process_images_dir(images_dirs):
    from test_torch_navigate import MIN_MAP_EQUAL, _text_boxes
    from test_torch_world import MIN_E2E_SHARE, _both_ways

    imgs, jres, tres, maps, d = images_dirs
    assert [r["image"] for r in tres] == [r["image"] for r in jres]
    assert [os.path.basename(r["image"]) for r in tres] == ["a.jpg", "b.png", "c.jpeg"]
    names = sorted(os.listdir(d / "jax" / "Detections"))
    assert sorted(os.listdir(d / "port" / "Detections")) == names and len(names) == 6
    for n in names:
        want = cv2.imread(str(d / "jax" / "Detections" / n)).shape[:2]
        assert J.jpeg_size((d / "port" / "Detections" / n).read_bytes()) == want, n
    assert _both_ways([r["detections"] for r in jres], [r["detections"] for r in tres]) >= MIN_E2E_SHARE
    assert sum(len(r["detections"]) for r in tres) >= 10
    for (jm, jd), (tm, td) in zip(maps["jax"], maps["port"]):
        assert tm.shape == jm.shape
        keep = _text_boxes(jd, jm.shape[:2]) & _text_boxes(td, jm.shape[:2])
        assert (tm == jm).all(-1)[keep].mean() >= MIN_MAP_EQUAL


def test_the_cli_images_dir_route(tmp_path, monkeypatch):
    got = []
    monkeypatch.setattr(TPL, "main", lambda **kw: got.append(kw) or ["done"])
    assert cli.main(["mosaic", "--images-dir", "imgs", "--output-dir", "out"]) == ["done"]
    assert got[0]["images_dir"] == "imgs" and got[0]["video_path"] is None
    assert got[0]["output_dir"] == "out"


OUTPUTS = ["debug_texture_mask.jpg", "debug_watershed.jpg", "mosaic.jpg", "mosaic_progress.jpg",
           "navigation_map.jpg"]


@pytest.fixture(scope="module")
def both_default_mains(small):
    """Each package's main with its defaults (progress image, detection on
    the mosaic, navigation map) on the 9-frame ORB clip, window 4, the port
    replaying JAX's RANSAC draws. The JAX world detector looks for its
    checkpoint at the relative path weights/..., so JAX's main runs with the
    repository as the working directory."""
    _, path, d = small
    mp = pytest.MonkeyPatch()
    mp.setattr(TS, "pair_uniforms", _jax_draws)
    mp.chdir(REPO)
    made = []
    real_det = JDET.ObjectDetector

    def jax_detector(**kw):
        made.append(real_det(**kw))
        return made[-1]

    mp.setattr(JDET, "ObjectDetector", jax_detector)
    out_j, out_t = d / "jax_defaults", d / "port_defaults"
    try:
        jm, js = JPL.main(path, output_dir=str(out_j), detector_type="orb",
                          config=JPipelineConfig(mosaic=JMosaicConfig(window_size=4)))
        tm, ts = TPL.main(path, output_dir=str(out_t), detector_type="orb",
                          config=PipelineConfig(mosaic=MosaicConfig(window_size=4)), device="cpu")
    finally:
        mp.undo()
    assert len(made) == 1 and made[0].model_world is not None  # JAX loaded YOLOv8n-world
    return js, ts, out_j, out_t


def test_main_with_its_defaults_writes_what_jax_main_writes(both_default_mains):
    js, ts, out_j, out_t = both_default_mains
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == OUTPUTS
    for name in OUTPUTS:
        mine = J.jpeg_size((out_t / name).read_bytes())
        ref = cv2.imread(str(out_j / name)).shape[:2]
        assert abs(mine[0] - ref[0]) <= CROP_TOL_PX and abs(mine[1] - ref[1]) <= CROP_TOL_PX, name
    mosaic = J.jpeg_size((out_t / "mosaic.jpg").read_bytes())
    for name in ("navigation_map.jpg", "debug_texture_mask.jpg", "debug_watershed.jpg"):
        assert J.jpeg_size((out_t / name).read_bytes()) == mosaic
    assert (ts["frames"], ts["accepted"]) == (js["frames"], js["accepted"])
    assert ts["detections"] >= 1 and abs(ts["detections"] - js["detections"]) <= max(1, js["detections"] // 10)


def test_main_stage_failures_are_not_caught(small, tmp_path, monkeypatch):
    """Unlike the JAX driver, main lets a failure of the detection on the
    mosaic or of the navigation map raise (ROADMAP Queue 3)."""
    import rtvm_tpu_torch.detect.detector as det_mod
    import rtvm_tpu_torch.navigate.mapping as nav_mod

    frames = small[0][:5]
    kw = dict(output_dir=str(tmp_path), detector_type="orb", show_intermediate=False,
              config=PipelineConfig(mosaic=MosaicConfig(window_size=4)), device="cpu")

    def broken(*a, **k):
        raise RuntimeError("broken stage")

    monkeypatch.setattr(det_mod.ObjectDetector, "detect_objects", broken)
    with pytest.raises(RuntimeError, match="broken stage"):
        TPL.main(frames, **kw)
    monkeypatch.undo()
    monkeypatch.setattr(nav_mod, "analyze_for_navigation", broken)
    with pytest.raises(RuntimeError, match="broken stage"):
        TPL.main(frames, enable_detection=False, **kw)


def test_main_builds_the_frame_detector_without_the_open_vocabulary_model(small, tmp_path,
                                                                         monkeypatch, capsys):
    import rtvm_tpu_torch.detect.detector as det_mod

    made = []

    class Refuses:
        def __init__(self, **kw):
            made.append(kw)
            raise NotImplementedError("not ported (ROADMAP.md, Queue 1 item 5)")

    frames = small[0]
    kw = dict(output_dir=str(tmp_path), detector_type="orb", show_intermediate=False,
              per_frame_detection=True, enable_detection=False, enable_navigation=False,
              config=PipelineConfig(mosaic=MosaicConfig(window_size=4)), device="cpu")
    monkeypatch.setattr(det_mod, "ObjectDetector", Refuses)
    with pytest.raises(NotImplementedError):  # never caught
        TPL.main(frames, **kw)
    assert made == [dict(model="yolo11n", load_world=False, device=torch.device("cpu"))]

    class Broken(Refuses):
        def __init__(self, **kw):
            raise RuntimeError("no weights")

    monkeypatch.setattr(det_mod, "ObjectDetector", Broken)
    _, stats = TPL.main(frames, **kw)  # the JAX driver's warning, and no Detections/
    assert "покадровая детекция недоступна: no weights" in capsys.readouterr().out
    assert "per_frame_detections" not in stats and not (tmp_path / "Detections").exists()


def test_cli_passes_the_jax_flags_to_main(monkeypatch):
    got = []
    monkeypatch.setattr(TPL, "main", lambda **kw: got.append(kw) or "done")
    assert cli.main(["clip.npy", "--no-detect", "--no-nav", "--per-frame-detect", "--hide",
                     "--window", "8", "--detector", "orb", "--max-frames", "30",
                     "--output-dir", "out"]) == "done"
    kw = got[0]
    assert kw["video_path"] == "clip.npy" and kw["output_dir"] == "out"
    assert (kw["enable_detection"], kw["enable_navigation"], kw["per_frame_detection"]) == (False, False, True)
    assert (kw["show_intermediate"], kw["detector_type"], kw["max_frames"]) == (False, "orb", 30)
    assert kw["config"].mosaic.window_size == 8 and kw["images_dir"] is None
    cli.main(["mosaic", "clip.npy"])
    assert got[1]["enable_detection"] and got[1]["show_intermediate"]
    assert got[1]["config"].mosaic.window_size == 16
    from rtvm_tpu import cli as jcli

    def commands(parser):
        return set(next(a for a in parser._actions if a.dest == "cmd").choices)

    # every command of the JAX CLI, each run by the port
    assert commands(cli.build_parser()) == commands(jcli.build_parser()) == set(cli.COMMANDS)


def test_module_entry_runs_the_cli():
    proc = subprocess.run([sys.executable, "-m", "rtvm_tpu_torch", "view", "--help"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "usage: rtvm_tpu_torch view" in proc.stdout
    assert "--backend {auto,matplotlib,offscreen}" in proc.stdout
