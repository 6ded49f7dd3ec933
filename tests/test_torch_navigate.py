"""The port's host contour algorithms (rtvm_tpu_torch.utils.contours, the C++
of csrc_host/) against cv2, its drawing against cv2, and its navigation
stage (rtvm_tpu_torch.navigate) against the JAX package's, on the CPU.

Tolerances: connected components, external contours (points and order),
bounding rects, Douglas-Peucker vertices and the watershed labels identical
to cv2's on seeded blobs and on the textured_image fixture; the distance
transform within one float32 ulp of cv2's and equal on at least 99.9% of
pixels; contour areas within 1e-6 and arc lengths within 1e-6 relative.
Thick contours and filled circles drawn as cv2 draws them; polylines equal
on 99.5% of pixels, the outline of a circle on 90% of the union of the two
(cv2 draws it as a sub-pixel polygon). Obstacle weights within 1e-6 and
nav_blocked equal on at least 99.9% of pixels (measured: equal); occupancy grid, clearance and
smoothing exact; native and Python A* paths identical to JAX's; the
navigation map identical to JAX's on at least 99% of the pixels outside the
label and legend text boxes (JAX writes text with PIL's DejaVuSans, the port
with its bitmap font).
"""

from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import ImageFont

from rtvm_tpu.navigate import astar as JA
from rtvm_tpu.navigate import mapping as JM
from rtvm_tpu.navigate import native as JN
from rtvm_tpu.navigate import obstacles as JO
from rtvm_tpu_torch.navigate import astar as TA
from rtvm_tpu_torch.navigate import mapping as TM
from rtvm_tpu_torch.navigate import native as TN
from rtvm_tpu_torch.navigate import obstacles as TO
from rtvm_tpu_torch.utils import contours as TC
from rtvm_tpu_torch.utils import draw
from rtvm_tpu_torch.utils.image import draw_dotted_line

torch.set_num_threads(1)  # tier 1 runs several test workers at once

REPO = Path(__file__).resolve().parents[1]
AREA_TOL = 1e-6
ARC_RTOL = 1e-6
WEIGHT_TOL = 1e-6
MIN_NAV_EQUAL = 0.999
MIN_MAP_EQUAL = 0.99
DIST_MAX_ULP, DIST_MIN_EQUAL = 1, 0.999  # the chamfer distance against cv2's


def blobs(seed, h=160, w=230):
    """Seeded binary masks: thresholded noise, rings with blobs inside
    (holes, nested and touching components) and one-pixel features."""
    rng = np.random.RandomState(seed)
    m = (cv2.GaussianBlur(rng.rand(h, w).astype(np.float32), (0, 0), 1 + seed % 4) > 0.5)
    m = m.astype(np.uint8)
    for _ in range(4):
        c = (int(rng.randint(20, w - 20)), int(rng.randint(20, h - 20)))
        r = int(rng.randint(6, 20))
        cv2.circle(m, c, r, 1, int(rng.choice([1, 2, 3])))
        cv2.circle(m, c, max(r // 3, 1), 1, -1)
    m[rng.randint(0, h, 20), rng.randint(0, w, 20)] = 1
    m[0, :] = 1 if seed % 2 else m[0, :]  # a component along the border
    return m


def _masks(textured_image):
    out = [blobs(s) for s in range(6)]
    gray = cv2.cvtColor(textured_image, cv2.COLOR_BGR2GRAY)
    out += [(gray > t).astype(np.uint8) for t in (60, 128, 200)]
    return out


# ------------------------------------------------------------------ contours against cv2


def test_connected_components_identical(textured_image):
    for m in _masks(textured_image):
        n, want = cv2.connectedComponents(m)
        got_n, got = TC.connected_components(m)
        assert got_n == n
        np.testing.assert_array_equal(got, want)


def test_external_contours_and_their_statistics_identical(textured_image):
    n_cnt = 0
    for m in _masks(textured_image):
        want, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        got = TC.find_external_contours(m)
        assert len(got) == len(want)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w.reshape(-1, 2))
            assert TC.bounding_rect(g) == cv2.boundingRect(w)
            assert abs(TC.contour_area(g) - cv2.contourArea(w)) <= AREA_TOL
            la = cv2.arcLength(w, True)
            assert abs(TC.arc_length(g) - la) <= ARC_RTOL * max(la, 1.0)
            for f in (0.02, 0.05):
                want_dp = cv2.approxPolyDP(w, f * la, True).reshape(-1, 2)
                np.testing.assert_array_equal(TC.approx_poly_dp(g, f * la), want_dp)
        n_cnt += len(got)
    assert n_cnt > 300


def test_distance_transform_and_watershed_identical(textured_image):
    """The building detector's flooding, step by step as cv2 runs it. The
    chamfer distance: on the fixture's darkest threshold (a region up to 216
    px from the nearest zero) 32 of 140800 pixels came out one float32 ulp
    below cv2's (ROADMAP Queue 3), every other pixel equal; the watershed,
    fed cv2's own markers, identical."""
    for m in _masks(textured_image):
        mask = m * 255
        dist = cv2.distanceTransform(mask, cv2.DIST_L2, 5)
        got = TC.distance_transform(mask)
        np.testing.assert_array_max_ulp(got, dist, maxulp=DIST_MAX_ULP)
        assert (got == dist).mean() >= DIST_MIN_EQUAL
        fg = (dist > 0.3 * max(dist.max(), 1e-6)).astype(np.uint8)
        bg = cv2.dilate(mask, np.ones((3, 3), np.uint8), iterations=3)
        unknown = cv2.subtract(bg, fg * 255)
        _, markers = cv2.connectedComponents(fg)
        markers = markers + 1
        markers[unknown > 0] = 0
        img = cv2.cvtColor(mask, cv2.COLOR_GRAY2BGR)
        got = TC.watershed(img, markers)
        cv2.watershed(img, markers)
        np.testing.assert_array_equal(got, markers)


# ------------------------------------------------------------------ drawing against cv2


def test_contours_circles_and_polylines_draw_as_cv2(textured_image):
    for m in _masks(textured_image)[:4]:
        cnts = TC.find_external_contours(m)
        want = np.zeros(m.shape + (3,), np.uint8)
        got = want.copy()
        cv2.drawContours(want, [c.reshape(-1, 1, 2) for c in cnts], -1, (0, 0, 255), 2)
        draw.draw_contours(got, cnts, (0, 0, 255), 2)
        np.testing.assert_array_equal(got, want)
    want = np.zeros((120, 160, 3), np.uint8)
    got = want.copy()
    cv2.circle(want, (80, 60), 10, (255, 255, 255), -1)
    draw.circle(got, (80, 60), 10, (255, 255, 255), -1)
    np.testing.assert_array_equal(got, want)
    pts = np.array([[5, 5], [40, 90], [100, 30], [150, 110]], np.int32)
    cv2.polylines(want, [pts], False, (0, 255, 0), 2)
    draw.polylines(got, [pts], False, (0, 255, 0), 2)
    assert (got == want).all(-1).mean() >= 0.995
    # the outline of the start marker: cv2's sub-pixel polygon against whole-pixel vertices
    a, b = np.zeros((40, 40, 3), np.uint8), np.zeros((40, 40, 3), np.uint8)
    cv2.circle(a, (20, 20), 10, (255, 255, 255), 2)
    draw.circle(b, (20, 20), 10, (255, 255, 255), 2)
    pa, pb = a[..., 0] > 0, b[..., 0] > 0
    assert (pa & pb).sum() >= 0.9 * (pa | pb).sum()


def test_dotted_line_draws_as_jax():
    from rtvm_tpu.utils.image import draw_dotted_line as jax_dotted

    a, b = np.zeros((100, 140, 3), np.uint8), np.zeros((100, 140, 3), np.uint8)
    jax_dotted(a, (5, 90), (130, 8), (0, 255, 0), 2)
    draw_dotted_line(b, (5, 90), (130, 8), (0, 255, 0), 2)
    assert (a == b).all(-1).mean() >= 0.995 and b.any()


# ------------------------------------------------------------------ obstacles and routing


def nav_scene(seed=0, h=360, w=480):
    """Flat ground (little texture), gray roofs, a red fire-coloured patch,
    and a wall that forces a detour between the start and two roofs."""
    rng = np.random.RandomState(seed)
    img = np.full((h, w, 3), (70, 110, 80), np.uint8)
    img = np.clip(img + rng.randint(-2, 3, img.shape), 0, 255).astype(np.uint8)
    for x, y in ((60, 40), (300, 50), (380, 200)):
        cv2.rectangle(img, (x, y), (x + 50, y + 40), (150, 150, 152), -1)
    cv2.rectangle(img, (200, 120), (230, 140), (30, 60, 230), -1)  # fire-like
    cv2.rectangle(img, (120, 230), (420, 245), (240, 240, 240), -1)  # a bright wall
    dets = [{"bbox": [60, 40, 110, 80], "class": "building", "confidence": 0.8},
            {"bbox": [300, 50, 350, 90], "class": "building", "confidence": 0.7},
            {"bbox": [380, 200, 430, 240], "class": "building", "confidence": 0.6},
            {"bbox": [150, 300, 175, 315], "class": "car", "confidence": 0.5},
            {"bbox": [250, 160, 262, 172], "class": "person", "confidence": 0.5},
            {"bbox": [130, 232, 410, 244], "class": "truck", "confidence": 0.5}]
    return img, dets


def test_obstacle_masks_match_jax(textured_image):
    for img, dets in (nav_scene(), (textured_image, nav_scene()[1])):
        jw, jn = JO.build_obstacle_masks(img, dets)
        tw, tn = TO.build_obstacle_masks(img, dets, device="cpu")
        np.testing.assert_allclose(tw, np.asarray(jw), rtol=0, atol=WEIGHT_TOL)
        assert (tn == np.asarray(jn)).mean() >= MIN_NAV_EQUAL
        np.testing.assert_array_equal(TO.detection_obstacle_mask(img.shape[:2], dets),
                                      JO.detection_obstacle_mask(img.shape[:2], dets))
        for got, want in zip(TO.color_texture_masks(torch.from_numpy(img)),
                             JO.color_texture_masks(jnp.asarray(img))):
            assert (got.numpy() == np.asarray(want)).mean() >= MIN_NAV_EQUAL


def test_grid_clearance_and_smoothing_exact():
    rng = np.random.RandomState(0)
    mask = (rng.rand(203, 298) > 0.93).astype(np.uint8)
    for scale, frac in ((4, 0.3), (3, 0.1)):
        np.testing.assert_array_equal(TA.occupancy_grid(mask, scale, frac),
                                      JA.occupancy_grid(mask, scale, frac))
    for p1, p2 in (((0, 0), (297, 202)), ((10, 150), (250, 20)), ((5, 5), (5, 5)), ((-3, 40), (400, 40))):
        assert TA.is_path_clear(mask, p1, p2) == JA.is_path_clear(mask, p1, p2)
    path = [(int(x), int(y)) for x, y in rng.randint(0, 300, (23, 2))]
    assert TA.smooth_path(path) == JA.smooth_path(path)
    assert TA.smooth_path(path[:4]) == JA.smooth_path(path[:4])


def _grid(seed):
    rng = np.random.RandomState(seed)
    grid = rng.rand(60, 90) > 0.72
    grid[30, 5:85] = True  # a wall with a gap
    grid[30, 44:46] = False
    return grid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_astar_paths_identical_to_jax(seed):
    grid = _grid(seed)
    starts = [((55, 10), (2, 80)), ((59, 89), (0, 0)), ((40, 40), (20, 60))]
    before = TN.calls["astar"]
    for s, g in starts:
        assert TA.astar(grid, s, g, use_native=False) == JA.astar(grid, s, g, use_native=False)
        if JN.available():
            assert TA.astar(grid, s, g) == JA.astar(grid, s, g)
    assert TN.available() and TN.calls["astar"] >= before + len(starts)
    mask = np.kron(grid, np.ones((4, 4), np.uint8))
    assert TA.find_path_astar(mask, (40, 220), (330, 10)) == JA.find_path_astar(mask, (40, 220), (330, 10))


def test_host_library_is_keyed_by_its_sources():
    path = TN.build()
    assert path == TN.library_path() and path.exists()
    assert path.parent == REPO / "rtvm_tpu_torch" / "_build"
    assert "librtvm_host_" in path.name


# ------------------------------------------------------------------ the navigation map


def _text_boxes(dets, shape):
    """Where either package may write text: the label of each building and
    the legend, PIL's DejaVuSans box (the wider) plus the shadow."""
    font = ImageFont.truetype("DejaVuSans.ttf", 16)
    keep = np.ones(shape, bool)
    places = [(d["class"], int(d["bbox"][0]), max(int(d["bbox"][1]) - 18, 0))
              for d in dets if d["class"] == "building"]
    places += [(label, 32, 12 + 22 * i) for i, (label, _) in enumerate(TM.LEGEND)]
    for text, x, y in places:
        _, _, x1, y1 = font.getbbox(text)
        keep[max(y - 1, 0) : y + y1 + 3, max(x - 1, 0) : x + x1 + 3] = False
    return keep


def test_navigation_map_matches_jax(tmp_path):
    img, dets = nav_scene()
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = JM.analyze_for_navigation(img, dets, debug_dir=str(tmp_path / "jax"))
    before = TN.calls["astar"]
    got = TM.analyze_for_navigation(img, dets, debug_dir=str(tmp_path / "port"), device="cpu")
    assert TN.calls["astar"] > before  # a route went through the native router
    assert got.shape == want.shape and got.dtype == np.uint8
    keep = _text_boxes(dets, img.shape[:2])
    same = (got == want).all(-1)
    assert same[keep].mean() >= MIN_MAP_EQUAL, same[keep].mean()
    assert not same[~keep].all()  # the text itself differs (another font)
    j = cv2.imread(str(tmp_path / "jax" / "debug_texture_mask.jpg"))
    t = cv2.imread(str(tmp_path / "port" / "debug_texture_mask.jpg"))
    assert t.shape == j.shape


def test_navigation_on_a_tensor_uses_its_device_and_copies_once():
    img, dets = nav_scene(1, 120, 160)
    a = TM.analyze_for_navigation(torch.from_numpy(img), dets)
    b = TM.analyze_for_navigation(img, dets, device="cpu")
    np.testing.assert_array_equal(a, b)
