"""The port's open-vocabulary YOLO (rtvm_tpu_torch.models.yolo.world) and the
multi-pass detection on the mosaic (ObjectDetector.detect_objects) against
the JAX package's, on the CPU, with the bundled weights/yolov8n_world.npz.

Tolerances: trigram ids identical; text embeddings within 1e-6; float32
head logits at 320 within 1e-4 of their largest magnitude; detections
matched (same class, IoU >= 0.9, score gap <= 1e-3) at 99% or more for the
world model, which runs in float32 in both packages; the letterbox resize
equal to cv2.resize byte for byte; _merge_tta identical. detect_objects end
to end on a 600x900 mosaic-like image (the tile pass runs): 90% or more of
the detections matched, with the score gap of the closed-set tile
detections, which both packages run in bfloat16 (each rounding in its own
places), bounded by tests/test_torch_detect.py's 0.06; the world's and the
classical detectors' by 1e-3.
"""

import os
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvm_tpu.detect.classes import AERIAL_CLASSES
from rtvm_tpu.detect.detector import ObjectDetector as JaxDetector
from rtvm_tpu.models.yolo import world as JW
from rtvm_tpu.models.yolo.train_synth import make_eval_set
from rtvm_tpu_torch.detect.detector import ObjectDetector
from rtvm_tpu_torch.models.yolo import world as TW
from rtvm_tpu_torch.models.yolo.convert import flax_to_state_dict
from rtvm_tpu_torch.utils.checkpoint import load_pytree_npz

torch.set_num_threads(1)  # tier 1 runs several test workers at once

REPO = Path(__file__).resolve().parents[1]
WORLD_NPZ = REPO / "weights" / "yolov8n_world.npz"
TEXT_TOL = 1e-6
LOGIT_RTOL = 1e-4  # of the largest |logit| of each output
MATCH_IOU, WORLD_GAP, MIN_WORLD_SHARE = 0.9, 1e-3, 0.99
BF16_GAP = 0.06  # closed-set detections in bfloat16 (tests/test_torch_detect.py's BF16)
MIN_E2E_SHARE = 0.90


@pytest.fixture(scope="module")
def worlds():
    """Each package's world detector over the aerial vocabulary; the JAX one
    looks for its checkpoint at the relative path weights/..., so it is built
    with the repository as the working directory."""
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        jw = JW.YoloWorldDetector(classes=AERIAL_CLASSES)
    finally:
        os.chdir(cwd)
    tw = TW.YoloWorldDetector(classes=AERIAL_CLASSES, device="cpu")
    assert jw.is_open_vocab and tw.is_open_vocab
    assert os.path.samefile(tw.weights_source, WORLD_NPZ)
    return jw, tw


@pytest.fixture(scope="module")
def scenes():
    imgs, _, _ = make_eval_set(n=3, size=320, seed=424242)
    return imgs


def _iou(a, b):
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
    return inter / max((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter, 1e-9)


def _gap(d):
    return BF16_GAP if d.get("source") == "yolo" else WORLD_GAP


def _matched(ref, got):
    """Share of `ref`'s detections with a detection in `got` of the same
    class and source at IoU >= MATCH_IOU, within the source's score gap."""
    if not ref:
        return 1.0
    hit = sum(any(g["class"] == d["class"] and g.get("source") == d.get("source")
                  and _iou(g["bbox"], d["bbox"]) >= MATCH_IOU
                  and abs(g["confidence"] - d["confidence"]) <= _gap(d) for g in got)
              for d in ref)
    return hit / len(ref)


def _both_ways(ref_lists, got_lists):
    n = sum(len(r) for r in ref_lists)
    assert n == 0 or n >= 5, n
    shares = [min(_matched(r, g), _matched(g, r)) for r, g in zip(ref_lists, got_lists)]
    return min(shares)


# ------------------------------------------------------------------ text side


@pytest.mark.parametrize("names", [AERIAL_CLASSES, ["car", "Cars", " carpark ", "x", "", "машина"]])
def test_tokenize_names_identical(names):
    for got, want in zip(TW.tokenize_names(names), JW.tokenize_names(names)):
        np.testing.assert_array_equal(got, want)


def test_text_embeddings_match_jax(worlds):
    jw, tw = worlds
    want = JW.TextEncoder().apply({"params": jw.variables["params"]["TextEncoder_0"]},
                                  jw._text_ids, jw._text_mask)
    with torch.inference_mode():
        got = tw.model.TextEncoder_0(tw._text_ids, tw._text_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TEXT_TOL)


def test_world_checkpoint_converts_leaf_for_leaf():
    tree = load_pytree_npz(str(WORLD_NPZ))
    sd = flax_to_state_dict(tree, "yolov8n")
    assert len(sd) == len(tree) and sd["WorldHead_0.logit_scale"].shape == ()
    np.testing.assert_array_equal(sd["TextEncoder_0.Dense_0.weight"].numpy(),
                                  tree["params/TextEncoder_0/Dense_0/kernel"].T)
    np.testing.assert_array_equal(sd["TextEncoder_0.Embed_0.embedding"].numpy(),
                                  tree["params/TextEncoder_0/Embed_0/embedding"])


# ------------------------------------------------------------------ the model


def test_head_logits_match_jax_in_float32(worlds, scenes):
    jw, tw = worlds
    x = scenes[..., ::-1].astype(np.float32) / 255.0
    jb, jc = jw.model.apply(jw.variables, jnp.asarray(x), jw._text_ids, jw._text_mask, train=False)
    tb, tc = tw.head_logits(torch.from_numpy(scenes))
    for want, got in zip(list(jb) + list(jc), list(tb) + list(tc)):
        want = np.moveaxis(np.asarray(want), -1, 1)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= LOGIT_RTOL * np.abs(want).max()


def test_run_world_matches_jax(worlds, scenes):
    jw, tw = worlds
    assert _both_ways(jw._run_world(scenes, 0.02, 0.5), tw._run_world(scenes, 0.02, 0.5)) \
        >= MIN_WORLD_SHARE


@pytest.mark.parametrize("hw", [(240, 320), (333, 250)])
def test_predict_with_tta_matches_jax(worlds, scenes, hw):
    """predict letterboxes to 1280 (an upscale here) with cv2's INTER_LINEAR
    on uint8 and merges the flipped pass."""
    jw, tw = worlds
    img = np.ascontiguousarray(cv2.resize(scenes[1], hw[::-1], interpolation=cv2.INTER_AREA))
    want = jw.predict(img, conf=0.02, iou=0.5, augment=True)
    got = tw.predict(img, conf=0.02, iou=0.5, augment=True)
    assert _both_ways([want], [got]) >= MIN_WORLD_SHARE


def test_predict_batch_matches_jax(worlds, scenes):
    jw, tw = worlds
    tiles = np.ascontiguousarray(scenes[:, :300, :310])  # padded to 320 inside
    assert _both_ways(jw.predict_batch(tiles, conf=0.03), tw.predict_batch(tiles, conf=0.03)) \
        >= MIN_WORLD_SHARE


@pytest.mark.parametrize("hw,size", [((600, 900), (1280, 853)), ((360, 640), (1280, 720)),
                                     ((1000, 1300), (1280, 985)), ((900, 601), (855, 1280)),
                                     ((50, 37), (947, 1280)), ((1080, 1920), (1280, 720))])
def test_letterbox_resize_is_cv2_inter_linear_byte_for_byte(hw, size):
    rng = np.random.RandomState(hw[0])
    img = cv2.GaussianBlur(rng.randint(0, 256, hw + (3,)).astype(np.uint8), (0, 0), 1.0)
    want = cv2.resize(img, size)
    got = TW.resize_linear_u8(torch.from_numpy(img), *size).numpy()
    np.testing.assert_array_equal(got, want)


def test_merge_tta_identical():
    rng = np.random.RandomState(3)
    dets = []
    for i in range(40):
        x, y = rng.uniform(0, 200, 2)
        w, h = rng.uniform(5, 40, 2)
        dets.append({"bbox": [x, y, x + w, y + h], "class": ["car", "building"][i % 2],
                     "confidence": float(rng.choice([0.3, 0.5, rng.uniform(0, 1)]))})
        if i % 3 == 0:  # a near duplicate
            dets.append(dict(dets[-1], bbox=[v + rng.uniform(-2, 2) for v in dets[-1]["bbox"]]))
    assert TW._merge_tta([dict(d) for d in dets]) == JW._merge_tta([dict(d) for d in dets])


def test_missing_checkpoint_falls_back_to_the_closed_set_detector(tmp_path, scenes):
    base = ObjectDetector("yolov8n", load_world=False, device="cpu")
    tw = TW.YoloWorldDetector(base_detector=base, classes=["car", "building"],
                              weights_path=str(tmp_path / "none.npz"), device="cpu")
    assert not tw.is_open_vocab and tw.base is base
    dets = tw.predict(scenes[0], conf=0.05, imgsz=320)
    every = base._run_pass(scenes[:1], imgsz=320, conf=0.05, iou=0.5)[0]
    assert dets == [d for d in every if d["class"] in ("car", "building")]


# ------------------------------------------------------------------ detection on the mosaic


def mosaic_like(seed=0, h=600, w=900):
    """A 600x900 aerial-looking image: blurred ground, gray roofs, bright
    cars, and three synthetic aerial scenes with the checkpoints' objects."""
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
    scenes, _, _ = make_eval_set(n=3, size=320, seed=7)
    img[:320, :320] = scenes[0]
    img[280:600, 580:900] = scenes[1]
    img[0:320, 450:770] = scenes[2]
    return img


def test_detect_objects_matches_jax(worlds, tmp_path):
    jw, _ = worlds
    jd = JaxDetector("yolo11n", load_world=False)
    jd.model_world = jw  # what ObjectDetector("yolo11n") loads, built once here
    td = ObjectDetector("yolo11n", device="cpu")
    assert td.model_world is not None and td.model_world.is_open_vocab
    img = mosaic_like()
    tiles = []
    real = td._run_pass

    def run_pass(images, imgsz, conf, iou):
        tiles.append(len(images))
        return real(images, imgsz, conf, iou)

    td._run_pass = run_pass
    want = jd.detect_objects(img, debug_dir=None)
    got = td.detect_objects(img, debug_dir=str(tmp_path))
    assert tiles == [2]  # one closed-set call on the 2 tiles (starts 0 and 260 across)
    assert len(want) >= 20 and {d.get("source", "world") for d in want} == {"world", "yolo", "classical"}
    assert _both_ways([want], [got]) >= MIN_E2E_SHARE
    world_w = [d for d in want if "source" not in d]
    world_g = [d for d in got if "source" not in d]
    assert _both_ways([world_w], [world_g]) >= MIN_WORLD_SHARE
    assert (tmp_path / "debug_watershed.jpg").exists()


def test_videmosaic_detects_through_its_default_detector(scenes):
    """VideMosaic's detect_people and detect_objects go to an ObjectDetector
    with its defaults (YOLOv8n and the world model) on the stitcher's
    device, as the JAX class's do."""
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic

    m = VideMosaic(scenes[0], device="cpu")
    ref = ObjectDetector(device="cpu")
    assert m._detector is m._detector and m._detector.model_world is not None
    assert m.detect_objects(scenes[1]) == ref.detect_objects(scenes[1])
    assert m.detect_people(scenes[2]) == ref.detect_people(scenes[2])
