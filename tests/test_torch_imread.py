"""The port's image reader (io/imread.py) against cv2.imread on files that
cv2 (and PIL, for palette PNGs) writes, and on the port's own JPEGs."""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from rtvm_tpu_torch.io.imread import imdecode, imread
from rtvm_tpu_torch.io.jpeg import encode_jpg


def _image(h=136, w=205, seed=0):
    """Blurred noise with filled rectangles: flat areas, edges and texture;
    sizes not multiples of 8 or 16, so partial blocks and MCUs occur."""
    rng = np.random.RandomState(seed)
    img = cv2.GaussianBlur(rng.randint(0, 255, (h, w, 3)).astype(np.uint8), (0, 0), 1.5)
    for _ in range(12):
        x, y = rng.randint(0, w - 10), rng.randint(0, h - 10)
        cv2.rectangle(img, (x, y), (x + rng.randint(5, 40), y + rng.randint(5, 30)),
                      tuple(int(v) for v in rng.randint(0, 255, 3)), -1)
    return img


JPEG_CASES = {
    "q75_420": [cv2.IMWRITE_JPEG_QUALITY, 75],
    "q95_420": [cv2.IMWRITE_JPEG_QUALITY, 95],
    "q90_444": [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    "q90_422": [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    "restart": [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
}


@pytest.mark.parametrize("case", list(JPEG_CASES))
@pytest.mark.parametrize("size", [(136, 205), (64, 64), (17, 23)])
def test_jpeg_decodes_as_cv2_byte_for_byte(tmp_path, case, size):
    p = str(tmp_path / "a.jpg")
    assert cv2.imwrite(p, _image(*size), JPEG_CASES[case])
    got = imread(p)
    assert got.dtype == np.uint8 and got.shape == size + (3,)
    np.testing.assert_array_equal(got, cv2.imread(p))


def test_gray_jpeg_decodes_as_cv2(tmp_path):
    p = str(tmp_path / "g.jpg")
    cv2.imwrite(p, cv2.cvtColor(_image(), cv2.COLOR_BGR2GRAY), [cv2.IMWRITE_JPEG_QUALITY, 80])
    np.testing.assert_array_equal(imread(p), cv2.imread(p))


@pytest.mark.parametrize("size", [(360, 640), (101, 157)])
def test_the_ports_own_jpeg_decodes_as_cv2(size):
    data = encode_jpg(_image(*size, seed=3))
    np.testing.assert_array_equal(imdecode(data), cv2.imdecode(np.frombuffer(data, np.uint8), 1))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_decodes_as_cv2(tmp_path, mode):
    img = _image()
    p = str(tmp_path / f"{mode}.png")
    if mode == "P":
        Image.fromarray(img[..., ::-1]).quantize(colors=37).save(p)
    elif mode in ("L", "LA"):
        g = Image.fromarray(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
        (g if mode == "L" else Image.merge("LA", [g, g.point(lambda v: 255 - v)])).save(p)
    else:
        rgb = Image.fromarray(img[..., ::-1])
        (rgb if mode == "RGB" else Image.merge("RGBA", [*rgb.split(), rgb.split()[0]])).save(p)
    np.testing.assert_array_equal(imread(p), cv2.imread(p))


def _png(px: np.ndarray, filters, interlace: int = 0) -> bytes:
    """An RGB PNG whose rows use the given filter types (0-4), cycling (the
    header may claim Adam7 interlacing; the rows are not interlaced)."""
    h, w, _ = px.shape
    raw = px.astype(np.int64).reshape(h, w * 3)
    rows = []
    prev = np.zeros(w * 3, np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = raw[y]
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        ul = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        if f == 0:
            out = cur
        elif f == 1:
            out = cur - left
        elif f == 2:
            out = cur - prev
        elif f == 3:
            out = cur - (left + prev) // 2
        else:
            pa, pb, pc = np.abs(prev - ul), np.abs(left - ul), np.abs(left + prev - 2 * ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
            out = cur - pred
        rows.append(bytes([f]) + (out % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_every_png_row_filter():
    img = _image(40, 53, seed=5)
    data = _png(img[..., ::-1], [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), 1), img)
    np.testing.assert_array_equal(imdecode(data), img)


def test_what_it_does_not_read(tmp_path):
    img = _image()
    p = str(tmp_path / "p.jpg")
    cv2.imwrite(p, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="progressive"):
        imread(p)
    with pytest.raises(NotImplementedError, match="Adam7"):
        imdecode(_png(img, [0], interlace=1))
    r = str(tmp_path / "16.png")
    cv2.imwrite(r, img.astype(np.uint16) * 257)
    with pytest.raises(NotImplementedError, match="16-bit"):
        imread(r)
    # unreadable files give None, as cv2
    (tmp_path / "junk.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a jpeg")
    (tmp_path / "text.png").write_bytes(b"hello")
    (tmp_path / "cut.png").write_bytes(_png(img, [0])[:60])
    for name in ("junk.jpg", "text.png", "cut.png", "missing.jpg"):
        assert imread(str(tmp_path / name)) is None
        assert cv2.imread(str(tmp_path / name)) is None
