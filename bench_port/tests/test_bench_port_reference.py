"""The plain references against the port on the CPU, at small sizes: the
same semantics give the same answers (the port runs its plain versions
here, float32 throughout)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port.lib import traffic
from bench_port.reference import chain, paint, yolo

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / "bench_port/configs/sift360-yolov8n.json").read_text())
STAB = CFG["stitch"]["stabilization"]


@pytest.fixture(scope="module")
def clip():
    mix = json.loads((ROOT / "bench_port/traffic/live.json").read_text())
    return traffic.make_orbit(2**31 + 5, (180, 320), dict(mix, window_size=16, period_windows=2))


def test_yolo_matches_the_ports_float32_model(clip):
    from rtvm_tpu_torch.detect.detector import ObjectDetector

    det = ObjectDetector("yolov8n", weights_path=str(ROOT / CFG["yolo"]["weights"]),
                         load_world=False, device="cpu")
    frames = torch.from_numpy(clip["frames"][[3, 17]])
    (pb, pc), (scale, py, px) = det.head_logits(frames, 320, torch.float32)
    w = yolo.Weights(yolo.read_npz(str(ROOT / CFG["yolo"]["weights"])), "cpu")
    dets, (rb, rc) = yolo.detect(w, CFG["yolo"], frames, 320, 0.25, 0.45)
    for a, b in zip(pb + pc, rb + rc):
        assert torch.allclose(a, b, rtol=0, atol=2e-4 * float(b.abs().max()))
    got = det._infer_fn(320, 0.25, 0.45, torch.float32)(frames)
    for f in range(2):
        boxes = got.boxes[f][got.valid[f]].numpy()
        assert len(boxes) == len(dets[f])
        np.testing.assert_allclose(boxes, np.array([d["box"] for d in dets[f]]), atol=1e-2)
        assert [int(c) for c in got.classes[f][got.valid[f]]] == [d["cls"] for d in dets[f]]


def test_letterbox_resize_matches_the_port():
    from rtvm_tpu_torch.models.yolo.postprocess import preprocess_frames

    rng = np.random.RandomState(0)
    frames = torch.from_numpy(rng.randint(0, 256, (2, 270, 480, 3), dtype=np.uint8))
    a, *geo_a = preprocess_frames(frames, (192, 320))
    b, *geo_b = yolo.letterbox(frames, (192, 320))
    assert geo_a == geo_b
    assert float((a - b).abs().max()) < 1e-5


def test_truth_chain_matches_the_ports_chain(clip):
    from rtvm_tpu_torch.config import MosaicConfig, StabilizationConfig
    from rtvm_tpu_torch.geometry.homography import smoothing_weights
    from rtvm_tpu_torch.mosaic.stitcher import MosaicState, compose_chain

    off = clip["offsets"]
    n = 2 * len(off)
    H_ref, ok_ref, _ = chain.truth_chain(off, n, (32, 180), STAB)
    rel = np.stack([chain.translation(*(off[k % len(off)] - off[(k - 1) % len(off)]))
                    for k in range(1, n + 1)]).astype(np.float32)
    cfg = MosaicConfig(stabilization=StabilizationConfig(**STAB))
    state = MosaicState(canvas=None, union_coarse=None,
                        H_old=torch.tensor(chain.translation(32, 180), dtype=torch.float32),
                        kp=None, desc=None, kp_valid=None,
                        hbuf=torch.eye(3).repeat(5, 1, 1), hcount=torch.zeros((), dtype=torch.int64),
                        frame_idx=torch.ones((), dtype=torch.int64))
    ok, H_abs, *_ = compose_chain(state, torch.from_numpy(rel), torch.ones(n, dtype=torch.bool),
                                  smoothing_weights(5, "cpu"), cfg)
    assert ok.numpy().tolist() == ok_ref.tolist()
    assert chain.corner_gap(H_abs.numpy(), H_ref, 180, 320).max() < 1e-2


def test_paint_matches_the_ports_paint(clip):
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic, paint_band

    frames = clip["frames"]
    m = VideMosaic(frames[0], detector_type="orb", device="cpu")
    hc, wc = m.canvas_shape[:2]
    off = clip["offsets"]
    H = torch.stack([torch.tensor(chain.translation(m.h_offset + off[k][0], m.w_offset + off[k][1]),
                                  dtype=torch.float32) for k in range(1, 5)])
    fr = torch.from_numpy(frames[1:5]).float().permute(0, 3, 1, 2).contiguous()
    blended = torch.tensor([True, True, False, True])
    c0, u0 = paint.seed_canvas(torch.from_numpy(frames[0]), (hc, wc), (m.w_offset, m.h_offset))
    assert torch.equal(c0, m.state.canvas) and torch.equal(u0, m.state.union_coarse)
    want, wu = paint_band(m.state.canvas, m.state.union_coarse, fr, H, blended, (180, 320), (hc, wc))
    got, gu = paint.paint_window(c0, u0, fr, H, blended, (180, 320), (hc, wc))
    assert torch.equal(got, want) and torch.equal(gu, wu)
