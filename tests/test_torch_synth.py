"""The port's training data against the JAX package's: the synthetic aerial
scenes of ``models/yolo/synth.py`` (drawn without cv2 by ``utils/draw.py``),
the depth scenes of ``models/depth_synth.py`` and the mAP of
``models/yolo/eval.py``.

Tolerances: boxes, classes, ``valid`` and every random draw identical (the
generator's state after the batch equal); the images within 1 grey level on
at least 0.99 of the pixels (measured: every pixel equal on 24 scenes at
320 and 24 at 64); the depth batch and the mAP report identical. The
drawing primitives against cv2: ``ellipse``, ``line`` (thicknesses 1-25,
ends inside and outside the image), ``gaussian_blur_u8`` and
``add_weighted`` pixel for pixel; ``fill_poly`` pixel for pixel on
polygons inside the image, and on polygons that leave it on at least 0.999
of the pixels on average and 0.99 of each (measured 0.999992 and 0.99972:
5 of 100 such polygons differ on a few border pixels, ROADMAP Queue 3
item 47)."""

import cv2
import numpy as np
import pytest
import torch

from rtvm_tpu.models import depth_synth as JD
from rtvm_tpu.models.yolo import eval as JE
from rtvm_tpu.models.yolo import synth as JS
from rtvm_tpu_torch.models import depth_synth as TD
from rtvm_tpu_torch.models.yolo import eval as TE
from rtvm_tpu_torch.models.yolo import synth as TS
from rtvm_tpu_torch.utils import draw as D

torch.set_num_threads(1)  # tier 1 runs several test workers at once

MIN_WITHIN_ONE_LEVEL = 0.99
MIN_BORDER_POLY_SHARE = 0.999


@pytest.mark.parametrize("size,n,seed", [(320, 24, 5), (64, 24, 6)])
def test_make_batch_matches_jax(size, n, seed):
    rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
    ij, bj, cj, vj = JS.make_batch(rj, JS.BackgroundPool(size, rng=rj), n, size)
    it, bt, ct, vt = TS.make_batch(rt, TS.BackgroundPool(size, rng=rt), n, size)
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(vt, vj)
    assert vj.sum() >= n  # the scenes hold objects
    d = np.abs(it.astype(np.int16) - ij)
    assert (d <= 1).mean() >= MIN_WITHIN_ONE_LEVEL, (d <= 1).mean()
    # and every draw was made, in the same order
    np.testing.assert_array_equal(rt.get_state()[1], rj.get_state()[1])


def test_eval_set_and_scenes_without_clips_match_jax():
    """make_scene at the default size through the procedural pool, the
    pool drawing nothing when no clip is found."""
    rj, rt = np.random.RandomState(9999), np.random.RandomState(9999)
    pj, pt = JS.BackgroundPool(320, rng=rj), TS.BackgroundPool(320, rng=rt)
    assert pj.frames == [] and pt.frames == []
    np.testing.assert_array_equal(rt.get_state()[1], rj.get_state()[1])
    for _ in range(3):
        a, ba, ca = JS.make_scene(rj, pj, 320)
        b, bb, cb = TS.make_scene(rt, pt, 320)
        np.testing.assert_array_equal(bb, ba)
        np.testing.assert_array_equal(cb, ca)
        assert (np.abs(b.astype(np.int16) - a) <= 1).mean() >= MIN_WITHIN_ONE_LEVEL


def _rot_rect(rng, lo, hi, w, h):
    cx, cy = rng.uniform(lo, w + hi), rng.uniform(lo, h + hi)
    return JS._rot_rect_pts(cx, cy, rng.uniform(3, 60), rng.uniform(3, 50), rng.rand() * np.pi)


def test_fill_poly_is_cv2s():
    rng = np.random.RandomState(11)
    h, w = 90, 120
    shares = []
    for t in range(200):
        inside = t % 2 == 0
        pts = _rot_rect(rng, 40, -40, w, h) if inside else _rot_rect(rng, -10, 10, w, h)
        if inside and not ((pts >= 0).all() and (pts[:, 0] < w).all() and (pts[:, 1] < h).all()):
            continue
        a = np.zeros((h, w, 3), np.uint8)
        b = a.copy()
        cv2.fillPoly(a, [pts], (10, 200, 30))
        D.fill_poly(b, [pts], (10, 200, 30))
        if inside:
            np.testing.assert_array_equal(b, a, err_msg=str(pts.tolist()))
        else:
            shares.append((a == b).all(-1).mean())
    assert min(shares) >= 0.99 and np.mean(shares) >= MIN_BORDER_POLY_SHARE, np.mean(shares)


@pytest.mark.parametrize("thickness", [-1, 1])
def test_ellipse_is_cv2s(thickness):
    rng = np.random.RandomState(12 + thickness)
    h, w = 90, 120
    for _ in range(150):
        axes = (int(rng.randint(1, 40)), int(rng.randint(1, 30)))
        ang = rng.rand() * 360 if thickness < 0 else float(rng.randint(0, 360))
        center = (int(rng.randint(-5, w + 5)), int(rng.randint(-5, h + 5)))
        a = np.zeros((h, w, 3), np.uint8)
        b = a.copy()
        cv2.ellipse(a, center, axes, ang, 0, 360, (1, 2, 3), thickness)
        D.ellipse(b, center, axes, ang, 0, 360, (1, 2, 3), thickness)
        np.testing.assert_array_equal(b, a, err_msg=f"{center} {axes} {ang}")


@pytest.mark.parametrize("thickness", [1, 2, 5, 17, 25])
def test_line_is_cv2s_inside_and_across_the_border(thickness):
    rng = np.random.RandomState(20 + thickness)
    h, w = 64, 80
    for _ in range(120):
        p1 = (int(rng.randint(-30, w + 30)), int(rng.randint(-30, h + 30)))
        p2 = (int(rng.randint(-30, w + 30)), int(rng.randint(-30, h + 30)))
        a = np.zeros((h, w, 3), np.uint8)
        b = a.copy()
        cv2.line(a, p1, p2, (5, 6, 7), thickness)
        D.line(b, p1, p2, (5, 6, 7), thickness)
        np.testing.assert_array_equal(b, a, err_msg=f"{p1} -> {p2}")


def test_gaussian_blur_and_add_weighted_are_cv2s():
    rng = np.random.RandomState(13)
    for shape in ((64, 64, 3), (37, 90, 3), (320, 320, 3)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(D.gaussian_blur_u8(img, 1.5), cv2.GaussianBlur(img, (0, 0), 1.5))
    x = np.arange(256, dtype=np.uint8)
    a, b = (np.repeat(g[..., None], 3, -1) for g in np.meshgrid(x, x))
    want = b.copy()
    cv2.addWeighted(a, 0.35, b, 0.65, 0, want)  # every pair of values
    np.testing.assert_array_equal(D.add_weighted(a, 0.35, b, 0.65, 0), want)


def test_depth_batch_is_identical():
    rj, rt = np.random.RandomState(3), np.random.RandomState(3)
    ij, nj = JD.make_depth_batch(rj, 3, 48, 64)
    it, nt = TD.make_depth_batch(rt, 3, 48, 64)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(nt, nj)


def test_evaluate_map_is_identical_on_seeded_detections():
    rng = np.random.RandomState(14)
    names = JS.AERIAL_CLASSES
    gtb, gtc, dets = [], [], []
    for _ in range(12):
        m = rng.randint(0, 6)
        xy = rng.uniform(0, 200, (m, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (m, 2))], 1).astype(np.float32)
        cls = rng.randint(0, len(names), m).astype(np.int32)
        gtb.append(boxes)
        gtc.append(cls)
        d = []
        for b, c in zip(boxes, cls):  # a jittered hit, a wrong class, a miss
            if rng.rand() < 0.8:
                d.append({"bbox": list(b + rng.normal(0, 4, 4)), "class": names[c],
                          "confidence": float(rng.rand())})
            if rng.rand() < 0.3:
                d.append({"bbox": list(b), "class": names[(c + 1) % len(names)],
                          "confidence": float(rng.rand())})
        d.append({"bbox": [0.0, 0.0, 10.0, 10.0], "class": names[rng.randint(len(names))],
                  "confidence": 0.5})
        dets.append(d)
    want = JE.evaluate_map(dets, gtb, gtc, names)
    assert TE.evaluate_map(dets, gtb, gtc, names) == want
    assert 0.0 < want["mAP50"] < 1.0
