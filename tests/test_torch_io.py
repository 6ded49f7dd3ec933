"""The PyTorch port's stand-ins for cv2 on the driver's path, held against cv2
and the JAX package on the CPU: the numpy JPEG writer (io/jpeg.py), the
drawing calls (utils/draw.py, draw_border, draw_detections), the image
utilities (utils/image.py) and the stage timer (utils/timing.py)."""

import json

import cv2
import numpy as np
import pytest
import torch

from rtvm_tpu.detect.detector import ObjectDetector as JaxDetector
from rtvm_tpu.mosaic.stitcher import VideMosaic as JaxMosaic
from rtvm_tpu.utils import image as JI
from rtvm_tpu_torch.detect import classes as C
from rtvm_tpu_torch.detect.detector import ObjectDetector
from rtvm_tpu_torch.io import jpeg as J
from rtvm_tpu_torch.mosaic.stitcher import VideMosaic
from rtvm_tpu_torch.utils import draw as D
from rtvm_tpu_torch.utils import image as TI
from rtvm_tpu_torch.utils.timing import StageTimer

torch.set_num_threads(1)  # tier 1 runs several test workers at once

PSNR_GAP_DB = 0.5  # the writer's PSNR against the source, beside cv2's own at quality 95
MIN_PSNR_VS_CV2_DB = 40.0  # the writer's decoded image against cv2's decoded image
SIZE_RATIO = 0.25  # the file size within 25% of cv2's
MIN_SHARE = 0.95  # painted pixels both agree on, over the union painted by either


def _blurred_noise(shape, sigma, seed=0):
    img = np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)
    return cv2.GaussianBlur(img, (0, 0), sigma)


def _decode(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def _segments(data: bytes):
    """The marker segments of a JPEG up to and including SOS."""
    out, i = [], 2
    while True:
        marker, length = data[i + 1], int.from_bytes(data[i + 2 : i + 4], "big")
        out.append((marker, data[i + 4 : i + 2 + length]))
        if marker == 0xDA:
            return out
        i += 2 + length


# ------------------------------------------------------------------ JPEG


@pytest.mark.parametrize("hw", [(16, 16), (37, 53), (360, 640)])
def test_jpeg_headers_are_cv2s(hw):
    """APP0, both quantisation tables at quality 95, SOF0, the four Annex K
    Huffman tables and SOS: byte for byte what cv2.imwrite writes."""
    img = _blurred_noise(hw + (3,), 1.0)
    ok, ref = cv2.imencode(".jpg", img)
    assert ok
    assert _segments(J.encode_jpg(img)) == _segments(ref.tobytes())


@pytest.mark.parametrize("sigma", [1.0, 4.0])
def test_jpeg_quality_and_size_match_cv2(sigma):
    """A 360x640 frame of blurred noise. Measured (sigma 1, 4): PSNR 29.73
    and 47.94 dB against cv2's 29.76 and 48.08; 44.3 and 49.3 dB against
    cv2's decoded image; sizes within 1.5% of cv2's."""
    img = _blurred_noise((360, 640, 3), sigma)
    data = J.encode_jpg(img, quality=95)
    ok, ref = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    mine, theirs = _decode(data), _decode(ref.tobytes())
    assert mine.shape == img.shape
    assert abs(TI.psnr(img, mine) - TI.psnr(img, theirs)) <= PSNR_GAP_DB
    assert TI.psnr(mine, theirs) >= MIN_PSNR_VS_CV2_DB
    assert abs(len(data) / len(ref) - 1.0) <= SIZE_RATIO


@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (17, 33), (250, 130)])
def test_jpeg_partial_blocks_decode_at_their_size(hw, tmp_path):
    img = _blurred_noise(hw + (3,), 2.0, seed=hw[0])
    path = tmp_path / "x.jpg"
    assert J.imwrite_jpg(str(path), img)
    data = path.read_bytes()
    assert J.jpeg_size(data) == hw
    mine = cv2.imread(str(path))
    theirs = _decode(cv2.imencode(".jpg", img)[1].tobytes())
    assert mine.shape == img.shape
    assert TI.psnr(mine, theirs) >= 30.0


def test_jpeg_stuffs_ff_bytes_and_codes_long_zero_runs():
    """Saturated colours give coefficients whose codes hold 0xFF bytes, and a
    lone high-frequency coefficient a run of more than 16 zeros (ZRL)."""
    img = np.zeros((64, 64, 3), np.uint8)
    img[::2, ::7] = 255
    img[20:40, 20:40] = (0, 0, 255)
    data = J.encode_jpg(img)
    scan = data[data.index(b"\xff\xda") + 14 : -2]
    ff = [i for i in range(len(scan) - 1) if scan[i] == 0xFF]
    assert ff and all(scan[i + 1] == 0 for i in ff)
    assert TI.psnr(_decode(data), _decode(cv2.imencode(".jpg", img)[1].tobytes())) >= 35.0


def test_jpeg_rejects_what_it_cannot_write():
    with pytest.raises(ValueError):
        J.encode_jpg(np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError):
        J.encode_jpg(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError):
        J.jpeg_size(b"\xff\xd8\xff\xd9")


def test_quant_tables_follow_libjpeg_scaling():
    assert J.quant_table(J._LUMA_Q, 50).tolist() == J._LUMA_Q.tolist()
    assert J.quant_table(J._LUMA_Q, 100).max() == 1
    assert J.quant_table(J._CHROMA_Q, 1).max() == 255
    assert sorted(J.ZIGZAG.tolist()) == list(range(64)) and J.ZIGZAG[:6].tolist() == [0, 1, 8, 16, 9, 2]


# ------------------------------------------------------------------ drawing


def _share(a: np.ndarray, b: np.ndarray) -> float:
    pa, pb = a.any(-1) if a.ndim == 3 else a > 0, b.any(-1) if b.ndim == 3 else b > 0
    return float((pa & pb).sum() / max((pa | pb).sum(), 1))


@pytest.mark.parametrize("seed", [0, 1])
def test_thin_line_is_cv2s_pixel_for_pixel(seed):
    rng = np.random.RandomState(seed)
    for _ in range(200):
        p1 = tuple(int(v) for v in rng.randint(0, [120, 90]))
        p2 = tuple(int(v) for v in rng.randint(0, [120, 90]))
        a = np.zeros((90, 120, 3), np.uint8)
        b = a.copy()
        cv2.line(a, p1, p2, (255, 30, 7), 1)
        D.line(b, p1, p2, (255, 30, 7), 1)
        np.testing.assert_array_equal(b, a, err_msg=f"{p1} -> {p2}")


def test_rectangle_thickness_2_agrees_with_cv2():
    """Measured share: 1.0 (axis-aligned edges)."""
    rng = np.random.RandomState(2)
    a = np.zeros((200, 300, 3), np.uint8)
    b = a.copy()
    for _ in range(60):
        p1 = tuple(int(v) for v in rng.randint(-10, [290, 190]))
        p2 = (p1[0] + int(rng.randint(1, 80)), p1[1] + int(rng.randint(1, 60)))
        c = tuple(int(v) for v in rng.randint(1, 256, 3))
        cv2.rectangle(a, p1, p2, c, 2)
        D.rectangle(b, p1, p2, c, 2)
    assert _share(a, b) >= MIN_SHARE
    assert (a == b).all(-1).mean() >= 0.999


def test_draw_border_thickness_5_agrees_with_jax():
    """The warped frame's border as the JAX class draws it with cv2.line at
    thickness 5, on frames under small rotations, scales and perspective.
    Measured share: 0.981 for the least of the 20 quads, 0.991 on average."""
    rng = np.random.RandomState(3)
    shares = []
    for _ in range(20):
        ang, s = rng.uniform(-0.3, 0.3), rng.uniform(0.8, 1.2)
        H = np.array([[s * np.cos(ang), -s * np.sin(ang), rng.uniform(50, 150)],
                      [s * np.sin(ang), s * np.cos(ang), rng.uniform(50, 150)],
                      [rng.uniform(-4e-4, 4e-4), rng.uniform(-4e-4, 4e-4), 1.0]])
        p = H @ np.array([[0, 160, 160, 0], [0, 0, 120, 120], [1, 1, 1, 1]], float)
        corners = (p[:2] / p[2]).T
        a = np.full((400, 400, 3), 255, np.uint8)
        b = a.copy()
        JaxMosaic.draw_border(a, corners)  # black, thickness 5: the defaults
        VideMosaic.draw_border(b, corners)
        shares.append(_share(255 - a, 255 - b))
    assert min(shares) >= MIN_SHARE, shares


@pytest.mark.parametrize("conf", [0.87, 1.0, 0.05])
def test_labels_lie_inside_cv2s_text_box(conf):
    """Every class name of both class lists, labelled as draw_detections
    labels it, at scale 0.45: no pixel outside the box cv2.getTextSize gives
    at the same origin (x from org.x over the width, y from org.y - height
    to org.y + baseline)."""
    for cls in C.SYNTH_AERIAL_CLASSES + C.COCO_CLASSES:
        txt = f"{cls} {conf:.2f}"
        (w, h), base = cv2.getTextSize(txt, cv2.FONT_HERSHEY_SIMPLEX, 0.45, 1)
        img = np.zeros((60, 300, 3), np.uint8)
        org = (20, 40)
        D.put_text(img, txt, org, 0.45, (255, 255, 255))
        ys, xs = np.nonzero(img.any(-1))
        assert len(xs) > 0, txt
        assert xs.min() >= org[0] and xs.max() < org[0] + w, (txt, xs.max() - org[0], w)
        assert ys.min() >= org[1] - h and ys.max() <= org[1] + base, (txt, ys.min(), ys.max())


def test_every_printable_character_has_a_glyph():
    for code in range(32, 127):
        g = D._glyph(chr(code))
        assert g.shape[0] == 9 and 1 <= g.shape[1] <= 5
        assert g.any() or chr(code) == " "


def test_draw_detections_boxes_agree_with_jax():
    """The port's draw_detections against the JAX class's on the same
    detections: the same copy semantics, and the boxes' pixels (the labels
    masked out, their glyphs differ) agree on >= 95% of the union."""
    rng = np.random.RandomState(4)
    img = _blurred_noise((240, 320, 3), 2.0)
    dets = []
    for cls in ("person", "car", "building", "boat"):
        x, y = int(rng.randint(0, 250)), int(rng.randint(15, 200))
        dets.append({"bbox": [x + 0.4, y + 0.7, x + 40.2, y + 30.9], "class": cls,
                     "confidence": float(rng.uniform(0.25, 1.0)), "source": "yolo"})
    a = JaxDetector.draw_detections(img, dets)
    b = ObjectDetector.draw_detections(img, dets)
    assert b is not img and np.array_equal(img, _blurred_noise((240, 320, 3), 2.0))
    labels = np.zeros(img.shape[:2], bool)
    for d in dets:
        x1, y1 = int(d["bbox"][0]), int(d["bbox"][1])
        org = (x1, max(y1 - 4, 10))
        (w, h), base = cv2.getTextSize(f"{d['class']} {d['confidence']:.2f}",
                                       cv2.FONT_HERSHEY_SIMPLEX, 0.45, 1)
        labels[max(org[1] - h, 0) : org[1] + base + 1, org[0] : org[0] + w + 1] = True
    da, db = (a != img).any(-1) & ~labels, (b != img).any(-1) & ~labels
    assert (da & db).sum() / (da | db).sum() >= MIN_SHARE
    assert (a[da & db] == b[da & db]).all()


# ------------------------------------------------------------------ image utilities


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crop_black_areas_is_the_jax_function(seed):
    rng = np.random.RandomState(seed)
    img = np.zeros((200, 260, 3), np.uint8)
    y, x = rng.randint(0, 100), rng.randint(0, 130)
    img[y : y + rng.randint(5, 100), x : x + rng.randint(5, 130)] = rng.randint(60, 255, 3)
    img[rng.randint(0, 200), rng.randint(0, 260)] = 255
    for th, mg in ((80, 30), (15, 5)):
        np.testing.assert_array_equal(TI.crop_black_areas(img, th, mg), JI.crop_black_areas(img, th, mg))
    blank = np.zeros((10, 10, 3), np.uint8)
    assert TI.crop_black_areas(blank) is blank


@pytest.mark.parametrize("scale", [0.5, 0.6])
def test_scale_to_screen_within_one_level_of_cv2_inter_area(scale):
    img = _blurred_noise((203, 311, 3), 1.0)
    screen = (int(round(311 * scale)), 10**6)
    out = TI.scale_to_screen(img, screen)
    ref = JI.scale_to_screen(img, screen)  # cv2.resize(..., INTER_AREA)
    assert out.shape == ref.shape == (int(203 * screen[0] / 311), screen[0], 3)
    assert np.abs(out.astype(int) - ref).max() <= 1


def test_scale_to_screen_never_upscales_and_keeps_the_aspect():
    img = _blurred_noise((50, 80, 3), 1.0)
    assert TI.scale_to_screen(img, (1920, 1080)) is img
    assert TI.scale_to_screen(img, (40, 1000)).shape == (25, 40, 3)
    assert TI.get_screen_size() == JI.get_screen_size()
    np.testing.assert_allclose(TI.area_weights(311, 187).sum(axis=1), 1.0, atol=1e-9)


def test_psnr_is_the_jax_function():
    a, b = _blurred_noise((20, 30, 3), 1.0, 1), _blurred_noise((20, 30, 3), 1.0, 2)
    assert TI.psnr(a, b) == JI.psnr(a, b) and TI.psnr(a, a) == float("inf")


def test_stage_timer_reports_and_writes_a_chrome_trace(tmp_path):
    t = StageTimer(max_spans=3)
    for name in ("window", "window", "export", "detect"):
        with t.stage(name, sync=True):  # no card: nothing to wait for
            pass
    assert t.counts == {"window": 2, "export": 1, "detect": 1} and len(t.spans) == 3
    assert t.report().splitlines()[0].split()[0] in ("window", "export", "detect")
    trace = json.loads(open(t.write_chrome_trace(str(tmp_path / "t.json"))).read())
    assert [e["name"] for e in trace["traceEvents"]] == ["process_name", "window", "export", "detect"]
