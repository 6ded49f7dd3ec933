"""A configuration's optional keys (``lib/harness.py``): weights drawn from
the seed and written as a checkpoint in the port's format, which both sides
read as a bundled one; and, with every new key absent, the harness of the
bundled cells as it was."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_port.run as bench_run
from bench_port.lib import harness, traffic, weights, yardstick
from bench_port.reference import yolo

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 977
IMGSZ = (96, 160)
NEW_KEYS = {"reference", "classes"}


def yolo_block(variant, nc):
    cfg = json.loads((ROOT / "bench_port/configs/orb1080-yolov8l.json").read_text())["yolo"]
    if variant == "yolov8n":
        cfg.update(depth_multiple=0.33, width_multiple=0.25, max_channels=1024)
    return dict(cfg, variant=variant, nc=nc, weights="seeded")


@pytest.fixture(scope="module")
def frames():
    mix = json.loads((ROOT / "bench_port/traffic/fused.json").read_text())
    orbit = traffic.make_orbit(SEED, (135, 240), dict(mix, window_size=16, period_windows=1))
    return torch.from_numpy(orbit["frames"][::4])


def test_the_writer_round_trips_and_the_port_loads_it(frames, tmp_path):
    from rtvm_tpu_torch.detect.detector import ObjectDetector
    from rtvm_tpu_torch.models.yolo.convert import flax_to_state_dict
    from rtvm_tpu_torch.models.yolo.model import build_yolo
    from rtvm_tpu_torch.utils.checkpoint import load_pytree_npz

    yc = yolo_block("yolov8l", 80)
    flat = yolo.draw(yc, SEED, frames, IMGSZ)
    path = str(tmp_path / "yolov8l_seeded.npz")
    weights.write_checkpoint(path, flat, weights.class_names(yc))
    back = yolo.read_npz(path)
    assert set(back) == set(flat)
    assert all(back[k].dtype == np.float32 and np.array_equal(back[k], flat[k]) for k in flat)
    model = build_yolo("yolov8l", num_classes=80, device="cpu")
    missing, extra = model.load_state_dict(flax_to_state_dict(load_pytree_npz(path), "yolov8l"),
                                           strict=False)
    assert missing == [] and extra == []
    det = ObjectDetector(model="yolov8l", weights_path=path, load_world=False, device="cpu")
    assert det.weights_loaded and det.class_names == [f"class_{i}" for i in range(80)]


@pytest.mark.parametrize("variant", ["yolov8n", "yolov8l"])
def test_a_draw_is_named_and_shaped_as_the_bundled_checkpoint(variant, frames):
    bundled = yolo.read_npz(str(ROOT / f"weights/{variant}_aerial.npz"))
    flat = yolo.draw(yolo_block(variant, 8), SEED, frames, IMGSZ)
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in bundled.items()}


def test_a_draw_is_the_seeds(frames):
    yc = yolo_block("yolov8n", 80)
    a, b = yolo.draw(yc, SEED, frames, IMGSZ), yolo.draw(yc, SEED, frames, IMGSZ)
    c = yolo.draw(yc, SEED + 1, frames, IMGSZ)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    kernel = "params/ConvBnSiLU_0/Conv_0/kernel"
    assert not np.array_equal(a[kernel], c[kernel])


def test_a_draws_logits_vary_and_some_reach_conf(frames):
    """The seeded model is no tie of anchors: its logits vary over the
    frames it was drawn on, and about CANDIDATES anchors a frame reach
    CALIB_CONF, far from none and from MAX_DET."""
    yc = yolo_block("yolov8n", 80)
    w = yolo.Weights(yolo.draw(yc, SEED, frames, IMGSZ), "cpu")
    dets, (box, cls) = yolo.detect(w, yc, frames, IMGSZ, yolo.CALIB_CONF, yc["iou"])
    assert all(float(c.std()) > 0.5 for c in box + cls)
    n = [len(d) for d in dets]
    assert 0 < sum(n) / len(n) < yolo.MAX_DET / 4



def test_every_calibration_frame_keeps_candidates(frames):
    """The class bias is set by the sparsest frame of the pass: each frame
    it was drawn on has CANDIDATES anchors or more at CALIB_CONF (one short
    where the quantile falls between two anchors), and no BatchNorm's
    variance is under its layer's (lower) median."""
    yc = yolo_block("yolov8l", 80)
    flat = yolo.draw(yc, SEED, frames, IMGSZ)
    _, (box, cls) = yolo.detect(yolo.Weights(flat, "cpu"), yc, frames, IMGSZ, yolo.CALIB_CONF,
                                yc["iou"])
    best = torch.cat([c.amax(1).flatten(1) for c in cls], 1)
    at_conf = (best >= np.log(yolo.CALIB_CONF / (1 - yolo.CALIB_CONF))).sum(1)
    assert int(at_conf.min()) >= yolo.CANDIDATES - 1
    for k, v in flat.items():
        if k.endswith("/var"):
            assert v.min() >= np.sort(v)[(len(v) - 1) // 2] * (1 - 1e-6), k  # the lower median

def test_class_names():
    assert weights.class_names({"nc": 3}) == ["class_0", "class_1", "class_2"]
    assert weights.class_names({"nc": 2, "classes": ["car", "person"]}) == ["car", "person"]


@pytest.mark.parametrize("cell", CELLS)
def test_without_the_new_keys_the_harness_is_as_it_was(cell, monkeypatch):
    """The bundled cells name none of the new keys: the harness builds the
    port's ObjectDetector as it always did, takes the YOLOv8 reference, and
    step_mfu counts YOLOv8's FLOPs."""
    from rtvm_tpu_torch.detect import detector

    yc = bench_run.load_cell(cell)["config"]["yolo"]
    assert not NEW_KEYS & set(yc) and yc["weights"].endswith(".npz")
    calls = []
    monkeypatch.setattr(detector, "ObjectDetector", lambda **kw: calls.append(kw))
    harness.build_detector(yc, "w.npz", "cpu")
    assert calls == [dict(model=yc["variant"], load_world=False, weights_path="w.npz",
                          device="cpu")]
    assert harness.reference_of(yc) is yolo
    ctx = {"config": {"yolo": yc}, "reference": yolo, "frames_per_s": 10.0}
    hw = (yc["imgsz"],) * 2 if isinstance(yc["imgsz"], int) else tuple(yc["imgsz"])
    want = 100.0 * yolo.flops(yc, hw) * 10.0 / yardstick.BF16_FLOPS_PER_S
    assert bench_run.read_metric("step_mfu", ctx) == want

