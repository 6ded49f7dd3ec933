"""The port's YOLO pre- and post-processing and its ObjectDetector
(rtvm_tpu_torch.models.yolo.postprocess, rtvm_tpu_torch.detect) against the
JAX package's, on the CPU.

Tolerances: letterbox geometry exact; preprocessing max |d| <= 1e-6 on 0..1
pixels (the antialiased bilinear resize agrees to ~1e-7); decode boxes max
|d| <= 1e-4 px and scores <= 1e-6; NMS exact (same kept slots, boxes,
classes, scores; ties kept at JAX's index). Inference end to end: float32 on
both sides, every detection matched (IoU >= 0.9, same class) with score gap
<= 1e-4; bfloat16 on both sides (each rounds in its own places), >= 90% of
the detections matched at conf 0.01, where the NMS has work, and >= 95% at
conf 0.25, each with score gap <= 0.06 (measured: all matched, gaps up to
0.032); and on chip_smoke.py's frames at 640, the port's bf16 no farther
from its float32 run than the JAX bf16 detector is (share within 0.03, gap
within 1.25x)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvm_tpu.detect.detector import ObjectDetector as JaxDetector
from rtvm_tpu.models.yolo import postprocess as JP
from rtvm_tpu.models.yolo.train_synth import make_eval_set
from rtvm_tpu.detect import classical as JCL
from rtvm_tpu_torch.detect import classes as C
from rtvm_tpu_torch.detect import classical as TCL
from rtvm_tpu_torch.detect import detector as TD
from rtvm_tpu_torch.detect.detector import ObjectDetector
from rtvm_tpu_torch.models.yolo import postprocess as TP

torch.set_num_threads(1)  # tier 1 runs several test workers at once

PRE_TOL = 1e-6
BOX_TOL = 1e-4
SCORE_TOL = 1e-6
F32_SCORE_GAP = 1e-4
BF16 = {0.01: (0.90, 0.06), 0.25: (0.95, 0.06)}  # conf: (least share matched, largest score gap)
IMGSZ = 256  # on 240x320 scenes: resized by 0.8 and padded


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


@pytest.fixture(scope="module")
def scenes():
    """Synthetic aerial scenes with objects of the checkpoints' classes, cut
    to 240x320 so that the letterbox resizes and pads."""
    imgs, _, _ = make_eval_set(n=4, size=320, seed=424242)
    return np.ascontiguousarray(imgs[:, 40:280])


@pytest.mark.parametrize("h,w,imgsz", [(360, 640, 640), (360, 640, 320), (360, 640, (384, 640)),
                                       (1080, 1920, 1280), (480, 640, (480, 640)), (37, 91, 64),
                                       (1080, 1920, (768, 1280))])  # BASELINE config 5
def test_letterbox_params_match_jax(h, w, imgsz):
    assert TP.letterbox_params(h, w, imgsz) == JP.letterbox_params(h, w, imgsz)


@pytest.mark.parametrize("imgsz", [640, 320, (384, 640)])
def test_preprocess_frames_matches_jax(imgsz):
    frames = np.random.RandomState(5).randint(0, 256, (2, 360, 640, 3), dtype=np.uint8)
    want, *geo_want = JP.preprocess_frames(jnp.asarray(frames), imgsz)
    got, *geo_got = TP.preprocess_frames(torch.from_numpy(frames), imgsz)
    assert geo_got == [float(geo_want[0]), int(geo_want[1]), int(geo_want[2])]
    assert got.shape == _nchw(want).shape
    err = float((got - _nchw(want)).abs().max())
    assert err <= PRE_TOL, f"imgsz {imgsz}: max |d| {err}"


def test_unletterbox_boxes_matches_jax():
    boxes = np.random.RandomState(2).uniform(0, 640, (3, 300, 4)).astype(np.float32)
    want = JP.unletterbox_boxes(jnp.asarray(boxes), 0.5, 140, 7)
    got = TP.unletterbox_boxes(torch.from_numpy(boxes), 0.5, 140, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7, atol=0)


def test_config5_letterbox_matches_jax():
    """BASELINE config 5: 1080x1920 frames at the non-square (768, 1280)
    letterbox (pad rows, no pad columns), into the network and back."""
    frames = np.random.RandomState(6).randint(0, 256, (2, 1080, 1920, 3), dtype=np.uint8)
    want, *geo_want = JP.preprocess_frames(jnp.asarray(frames), (768, 1280))
    got, scale, py, px = TP.preprocess_frames(torch.from_numpy(frames), (768, 1280))
    assert (scale, py, px) == (float(geo_want[0]), int(geo_want[1]), int(geo_want[2])) == (2 / 3, 24, 0)
    assert float((got - _nchw(want)).abs().max()) <= PRE_TOL
    boxes = np.random.RandomState(3).uniform(0, 1280, (2, 300, 4)).astype(np.float32)
    np.testing.assert_allclose(TP.unletterbox_boxes(torch.from_numpy(boxes), scale, py, px).numpy(),
                               np.asarray(JP.unletterbox_boxes(jnp.asarray(boxes), scale, py, px)),
                               rtol=1e-7, atol=0)


def test_decode_predictions_matches_jax():
    rng = np.random.RandomState(4)
    shapes = [(2, 8, 10), (2, 4, 5), (2, 2, 3)]  # a 64x80 input at strides 8/16/32
    box = [(3 * rng.randn(b, h, w, 64)).astype(np.float32) for b, h, w in shapes]
    cls = [(2 * rng.randn(b, h, w, 8)).astype(np.float32) for b, h, w in shapes]
    wb, ws = JP.decode_predictions([jnp.asarray(a) for a in box], [jnp.asarray(a) for a in cls])
    gb, gs = TP.decode_predictions([_nchw(a) for a in box], [_nchw(a) for a in cls])
    assert gb.shape == wb.shape == (2, 80 + 20 + 6, 4) and gs.shape == ws.shape
    assert float((gb - torch.from_numpy(np.array(wb))).abs().max()) <= BOX_TOL
    assert float((gs - torch.from_numpy(np.array(ws))).abs().max()) <= SCORE_TOL


def _jax_nms_batch(boxes, scores, **kw):
    return [JP.nms_fixed(jnp.asarray(b), jnp.asarray(s), **kw) for b, s in zip(boxes, scores)]


def _assert_nms_equal(got, want):
    for f, w in enumerate(want):
        np.testing.assert_array_equal(got.valid[f].numpy(), np.asarray(w.valid),
                                      err_msg=f"frame {f}")
        np.testing.assert_array_equal(got.classes[f].numpy(), np.asarray(w.classes))
        np.testing.assert_array_equal(got.boxes[f].numpy(), np.asarray(w.boxes))
        np.testing.assert_array_equal(got.scores[f].numpy(), np.asarray(w.scores))


def test_nms_matches_jax_on_overlapping_boxes():
    """Four frames of 500 clustered boxes of 3 classes, batched in one call."""
    rng = np.random.RandomState(6)
    n, c = 500, 3
    xy = rng.uniform(0, 100, (4, n, 2))
    wh = rng.uniform(5, 30, (4, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (4, n, c)).astype(np.float32) ** 3
    for conf in (0.01, 0.25):
        got = TP.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), conf, 0.45)
        assert got.boxes.shape == (4, 300, 4)
        _assert_nms_equal(got, _jax_nms_batch(boxes, scores, conf_threshold=conf,
                                              iou_threshold=0.45))
        assert int(got.valid.sum()) > 20


def test_nms_alternating_chains_match_greedy_and_jax():
    """tests/test_detect.py::test_nms_fixpoint_matches_sequential_greedy's
    20 trials, as 20 frames of one batched call: the sequential greedy
    oracle and the JAX function, slot for slot."""
    rng = np.random.RandomState(0)
    n = 64
    boxes, scores, oracle = [], [], []
    for _ in range(20):
        cx, cy = rng.rand(n) * 40, rng.rand(n) * 40
        w = 8 + rng.rand(n) * 10
        b = np.stack([cx, cy, cx + w, cy + w], -1).astype(np.float32)
        conf = rng.rand(n).astype(np.float32)
        cls = rng.randint(0, 2, n)
        s = np.zeros((n, 2), np.float32)
        s[np.arange(n), cls] = conf
        boxes.append(b)
        scores.append(s)
        order = np.argsort(-np.where(conf >= 0.2, conf, 0.0), kind="stable")
        ob, ocls = b[order], cls[order]
        okeep = np.where(conf >= 0.2, conf, 0.0)[order] > 0
        area = (ob[:, 2] - ob[:, 0]) * (ob[:, 3] - ob[:, 1])
        for i in range(n):
            for j in range(i):
                if not okeep[i] or not okeep[j] or ocls[j] != ocls[i]:
                    continue
                ix = max(0, min(ob[i, 2], ob[j, 2]) - max(ob[i, 0], ob[j, 0]))
                iy = max(0, min(ob[i, 3], ob[j, 3]) - max(ob[i, 1], ob[j, 1]))
                if ix * iy / max(area[i] + area[j] - ix * iy, 1e-9) > 0.45:
                    okeep[i] = False
        oracle.append(okeep)
    boxes, scores = np.stack(boxes), np.stack(scores)
    got = TP.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), 0.2, 0.45, n)
    np.testing.assert_array_equal(got.valid.numpy(), np.stack(oracle))
    _assert_nms_equal(got, _jax_nms_batch(boxes, scores, conf_threshold=0.2, iou_threshold=0.45,
                                          max_detections=n))


def test_nms_equal_scores_keep_jax_index():
    """Scores on a coarse grid, so most candidates tie with others, some of
    them overlapping: the candidates taken, their order and the one kept of
    two equal overlapping boxes are JAX's (lower index first)."""
    rng = np.random.RandomState(8)
    n = 400
    xy = rng.uniform(0, 60, (3, n, 2))
    boxes = np.concatenate([xy, xy + 12], -1).astype(np.float32)
    scores = (rng.randint(1, 5, (3, n, 2)) / 4).astype(np.float32)
    got = TP.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), 0.25, 0.45)
    want = _jax_nms_batch(boxes, scores, conf_threshold=0.25, iou_threshold=0.45)
    _assert_nms_equal(got, want)
    kept_top = got.scores[got.valid] == 1.0
    assert int(kept_top.sum()) > 5  # ties at the top score were resolved, not avoided


# ------------------------------------------------------------------ detector


@pytest.fixture(scope="module", params=["yolov8n", "yolo11n"])
def detectors(request):
    jd = JaxDetector(request.param, load_world=False)
    td = ObjectDetector(request.param, load_world=False, device="cpu")
    return jd, td


def _jax_f32_infer(jd, frames, imgsz, conf, iou):
    """The JAX detector's _infer_fn with the model in float32 (its own
    pieces, un-jitted)."""
    x, scale, py, px = JP.preprocess_frames(jnp.asarray(frames), imgsz)
    box_l, cls_l = jd.model.apply(jd.variables, x, train=False)
    boxes, scores = JP.decode_predictions(box_l, cls_l, jd.model.cfg.strides, jd.model.cfg.reg_max)
    dets = [JP.nms_fixed(b, s, conf, iou) for b, s in zip(boxes, scores)]
    return TP.Detections(*(torch.from_numpy(np.stack([np.asarray(getattr(d, f)) for d in dets]))
                           for f in ("boxes", "scores", "classes", "valid")))._replace(
        boxes=torch.from_numpy(np.stack([np.asarray(JP.unletterbox_boxes(d.boxes, scale, py, px))
                                         for d in dets])))


def _from_jax(det):
    return TP.Detections(*(torch.from_numpy(np.array(a)) for a in det))


def test_detector_loads_the_checkpoint(detectors):
    jd, td = detectors
    assert td.weights_loaded and td.weights_source == jd.weights_source
    assert td.class_names == jd.class_names
    assert td.model.cfg.variant == jd.model.cfg.variant
    assert td.model.cfg.num_classes == jd.model.cfg.num_classes == 8


def test_infer_fn_float32_matches_jax_float32(detectors, scenes):
    jd, td = detectors
    want = _jax_f32_infer(jd, scenes, IMGSZ, 0.01, 0.45)
    got = td._infer_fn(IMGSZ, 0.01, 0.45, torch.float32)(scenes)
    assert got.boxes.shape == (4, 300, 4) and got.valid.dtype == torch.bool
    m = TP.match_detections(want, got)
    assert m["n_ref"] >= 10, m
    assert m["share"] == 1.0 and m["max_score_gap"] <= F32_SCORE_GAP, m


@pytest.mark.parametrize("conf", sorted(BF16))
def test_infer_fn_bfloat16_matches_jax_bfloat16(detectors, scenes, conf):
    jd, td = detectors
    want = _from_jax(jd._infer_fn(IMGSZ, conf, 0.45)(scenes))
    got = td._infer_fn(IMGSZ, conf, 0.45)(scenes)
    assert td.model_as(torch.bfloat16).DetectHead_0.Conv_0.weight.dtype == torch.bfloat16
    m = TP.match_detections(want, got)
    share, gap = BF16[conf]
    assert m["n_ref"] >= 10, m
    assert m["share"] >= share and m["max_score_gap"] <= gap, m


def test_bfloat16_is_no_farther_from_float32_than_the_reference(detectors):
    """chip_smoke.py's frames at config 3's 640x640 (many scores near 0.5):
    the port's bf16 detections, against its float32 ones, agree at least as
    well as the JAX package's bf16 detector does against the same float32
    run, within 0.03 of matched share and 25% of the largest score gap. This
    is what bounds chip_smoke.py's bf16 check (DET_BOUNDS)."""
    import chip_smoke

    jd, td = detectors
    frames, _ = chip_smoke.make_clip(np.random.RandomState(chip_smoke.SEED), 49, 360, 640)
    four = frames[1:][chip_smoke.DET_FRAMES]
    f32 = td._infer_fn(640, 0.25, 0.45, torch.float32)(four)
    ours = TP.match_detections(f32, td._infer_fn(640, 0.25, 0.45)(four))
    ref = TP.match_detections(f32, _from_jax(jd._infer_fn(640, 0.25, 0.45)(four)))
    assert ref["n_ref"] > 200, ref
    assert ours["share"] >= ref["share"] - 0.03, (ours, ref)
    assert ours["max_score_gap"] <= 1.25 * ref["max_score_gap"], (ours, ref)


def test_run_pass_and_detect_people(detectors, scenes):
    _, td = detectors
    per_image = td._run_pass(scenes, IMGSZ, 0.25, 0.45)
    det = td._infer_fn(IMGSZ, 0.25, 0.45)(scenes)
    assert [len(d) for d in per_image] == det.valid.sum(1).tolist()
    for d in sum(per_image, []):
        assert set(d) == {"bbox", "class", "confidence", "source"} and d["source"] == "yolo"
        assert d["class"] in td.class_names and 0.25 <= d["confidence"] <= 1.0
    people = td.detect_people(scenes[0])
    assert all(len(b) == 4 and all(isinstance(v, int) for v in b) for b in people)


def test_detector_surface_not_ported_raises(tmp_path):
    """Every route of the constructor is ported: the open-vocabulary
    companion (load_world=True, the JAX default) and detect_objects
    (tests/test_torch_world.py), the ultralytics .pt route
    (tests/test_torch_weights.py), which raises on a checkpoint it cannot
    read where the JAX class warns and keeps random weights."""
    td = ObjectDetector("yolov8n", device="cpu")
    assert td.model_world is not None and td.model_world.is_open_vocab
    assert td.model_world.classes == [C.normalize_class_name(c) for c in C.AERIAL_CLASSES]
    with pytest.raises(FileNotFoundError):  # no yolo11s_aerial.npz: the .pt is read
        ObjectDetector("yolo11s", weights_path=str(tmp_path / "yolo11s.pt"), load_world=False,
                       device="cpu")
    # as in the JAX class, a bundled npz is preferred to a .pt path
    assert ObjectDetector("yolov8n", weights_path="yolov8n.pt", load_world=False,
                          device="cpu").weights_source.endswith("yolov8n_aerial.npz")
    td = ObjectDetector("yolov8n", load_world=False, device="cpu")
    assert td.model_world is None
    # a small blank image: no tiles, no detections, nothing classical
    assert td.detect_objects(np.zeros((64, 64, 3), np.uint8)) == []
    # draw_detections is ported now: with no detections it returns an unchanged copy
    blank = np.zeros((64, 64, 3), np.uint8)
    drawn = td.draw_detections(blank, [])
    assert drawn is not blank and np.array_equal(drawn, blank)
    bad = tmp_path / "broken.npz"
    bad.write_bytes(b"not an npz")
    with pytest.raises(Exception):
        ObjectDetector("yolov8n", weights_path=str(bad), load_world=False, device="cpu")


def test_weight_search_is_the_jax_list_without_the_home_directory():
    """The port looks for a checkpoint where the JAX class does, except in
    ~/.rtvm_weights: it reads nothing outside the working directory and its
    checkout (ROADMAP.md, Queue 3 item 10)."""
    from rtvm_tpu.detect import detector as jax_detector
    from rtvm_tpu_torch.detect import detector as port_detector

    home = [p for p in jax_detector._WEIGHT_SEARCH_PATHS if p.startswith(os.path.expanduser("~"))]
    assert home and not set(home) & set(port_detector._WEIGHT_SEARCH_PATHS)
    assert [p for p in jax_detector._WEIGHT_SEARCH_PATHS if p not in home] == \
        port_detector._WEIGHT_SEARCH_PATHS[:-1]
    assert os.path.samefile(port_detector._WEIGHT_SEARCH_PATHS[-1],
                            os.path.join(os.path.dirname(os.path.dirname(__file__)), "weights"))


def test_random_weights_without_a_checkpoint_are_seeded():
    """No yolo11s checkpoint is bundled: the detector keeps seeded random
    weights, as the JAX class does."""
    a = ObjectDetector("yolo11s", num_classes=80, seed=3, load_world=False, device="cpu")
    b = ObjectDetector("yolo11s", num_classes=80, seed=3, load_world=False, device="cpu")
    assert not a.weights_loaded and a.weights_source == "random" and len(a.class_names) == 80
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_detector_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        td = ObjectDetector("yolov8n", load_world=False)
        assert next(td.model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ObjectDetector("yolov8n", load_world=False)


# ------------------------------------------------------------------ the detection on the mosaic's parts


def _dets(seed, n=120):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        x, y = rng.uniform(0, 400, 2)
        w, h = rng.choice([3.0, 8.0, 30.0, 60.0]) * rng.uniform(0.5, 2, 2)
        out.append({"bbox": [x, y, x + w, y + h],
                    "class": ["car", "building", "person", "boat"][i % 4],
                    "confidence": float(rng.choice([0.5, rng.uniform(0, 1)]))})
        if i % 5 == 0:  # near duplicates
            out.append(dict(out[-1], bbox=[v + rng.uniform(-6, 6) for v in out[-1]["bbox"]]))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_dedup_and_area_filter_identical(seed):
    dets = _dets(seed)
    want = JaxDetector._dedup([dict(d) for d in dets], center_px=40.0, iou_th=0.5)
    got = ObjectDetector._dedup([dict(d) for d in dets], center_px=40.0, iou_th=0.5)
    assert got == want and len(want) < len(dets)
    assert ObjectDetector._area_filter(got, 420, 430) == JaxDetector._area_filter(want, 420, 430)
    a, b = dets[0]["bbox"], dets[1]["bbox"]
    from rtvm_tpu.detect import detector as jax_detector

    assert TD._iou(a, b) == jax_detector._iou(a, b)
    assert TD._center_dist(a, b) == jax_detector._center_dist(a, b)


@pytest.mark.parametrize("dim,starts", [(600, [0]), (640, [0]), (900, [0, 260]),
                                        (1041, [0, 400, 401]), (1300, [0, 400, 660]),
                                        (1280, [0, 400, 640])])
def test_tile_grid_anchors_a_last_tile_at_dim_minus_640(dim, starts):
    """The JAX detector's grid (every 400 px, plus a tile at dim - 640)."""
    assert TD.tile_starts(dim) == starts


def classical_scene(seed, h=600, w=900):
    """Greenish ground with flat gray roofs (some touching) and bright cars."""
    import cv2

    rng = np.random.RandomState(seed)
    img = cv2.GaussianBlur(rng.randint(40, 200, (h, w, 3)).astype(np.uint8), (0, 0), 3)
    img = (img * 0.5 + np.array([40, 90, 60]) * 0.5).astype(np.uint8)
    for _ in range(14):
        x, y = rng.randint(0, w - 80), rng.randint(0, h - 80)
        g = rng.randint(90, 200)
        cv2.rectangle(img, (x, y), (x + rng.randint(25, 90), y + rng.randint(25, 90)),
                      (g, g, g + rng.randint(-8, 8)), -1)
    for _ in range(12):
        x, y = rng.randint(0, w - 40), rng.randint(0, h - 40)
        cv2.rectangle(img, (x, y), (x + rng.randint(10, 30), y + rng.randint(10, 22)),
                      (235, 235, 240), -1)
    return img


def _box_share(want, got, iou_min):
    def iou(a, b):
        ix1, iy1, ix2, iy2 = max(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), min(a[3], b[3])
        inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
        return inter / ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter)

    hit = sum(any(iou(w["bbox"], g["bbox"]) >= iou_min for g in got) for w in want)
    return hit / max(len(want), 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classical_detectors_match_jax(seed, tmp_path):
    """Vehicle boxes identical. Buildings (watershed, chamfer distance,
    Douglas-Peucker; ROADMAP Queue 3) matched at IoU >= 0.8 on at least 90%
    both ways (measured: identical, with the masks equal pixel for pixel)."""
    import jax.numpy as jnp

    img = classical_scene(seed)
    jv, tv = JCL.detect_vehicles_classical(img), TCL.detect_vehicles_classical(img, device="cpu")
    assert len(jv) >= 5 and tv == jv
    jb = JCL.detect_buildings_classical(img)
    tb = TCL.detect_buildings_classical(img, debug_path=str(tmp_path / "ws.jpg"), device="cpu")
    assert len(jb) >= 5
    assert _box_share(jb, tb, 0.8) >= 0.9 and _box_share(tb, jb, 0.8) >= 0.9
    for (want, got) in zip(JCL._building_masks(jnp.asarray(img)),
                           TCL._building_masks(torch.from_numpy(img))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(TCL._vehicle_mask(torch.from_numpy(img)).numpy(),
                                  np.asarray(JCL._vehicle_mask(jnp.asarray(img))))
    from rtvm_tpu_torch.io.jpeg import jpeg_size

    assert jpeg_size((tmp_path / "ws.jpg").read_bytes()) == img.shape[:2]
