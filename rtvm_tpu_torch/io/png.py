"""PNG writer in numpy and the standard library (``zlib``), the port's
stand-in for ``cv2.imwrite`` of a ``.png`` (the card has no cv2).

It writes 8-bit gray [H, W], BGR [H, W, 3] and BGRA [H, W, 4] images,
non-interlaced, every row with the "Up" filter (the row minus the one above,
one array operation), the data in one IDAT chunk. The bytes differ from
cv2's (libpng chooses a filter per row), not the pixels: ``cv2.imread`` and
``io/imread.py`` decode them to the same array.

``imwrite`` picks the writer from the file name, as cv2 does, for the two
formats the port writes.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type (gray, RGB, RGBA)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 gray [H, W], BGR [H, W, 3] or BGRA [H, W, 4]
    image (zlib's default compression)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png writes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOUR_TYPE or 0 in img.shape[:2]:
        raise ValueError(f"encode_png wants [H, W], [H, W, 3] or [H, W, 4], got {img.shape}")
    h, w, ch = img.shape
    px = img if ch == 1 else img[..., [2, 1, 0, 3][:ch]]  # BGR(A) -> RGB(A)
    rows = px.reshape(h, w * ch)
    up = rows.copy()
    up[1:] -= rows[:-1]  # filter 2 (Up), modulo 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[ch], 0, 0, 0)
    return b"".join([PNG_SIGNATURE, _chunk(b"IHDR", ihdr),
                     _chunk(b"IDAT", zlib.compress(raw.tobytes())), _chunk(b"IEND", b"")])


def imwrite_png(path: str, img: np.ndarray) -> bool:
    """Write `img` (see encode_png) to `path` as PNG. Returns True."""
    data = encode_png(img)
    with open(os.fspath(path), "wb") as f:
        f.write(data)
    return True


def imwrite(path: str, img: np.ndarray) -> bool:
    """``cv2.imwrite`` for the formats the port writes: ``.png`` (any image
    encode_png takes) and ``.jpg``/``.jpeg`` (BGR, io/jpeg.py). Raises
    ValueError for another extension."""
    ext = os.path.splitext(os.fspath(path))[1].lower()
    if ext == ".png":
        return imwrite_png(path, img)
    if ext in (".jpg", ".jpeg"):
        from rtvm_tpu_torch.io.jpeg import imwrite_jpg

        return imwrite_jpg(path, img)
    raise ValueError(f"the port writes PNG and JPEG files; {os.fspath(path)!r} names another "
                     "format")
