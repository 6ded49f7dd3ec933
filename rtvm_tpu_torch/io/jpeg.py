"""Baseline JPEG writer in numpy, the port's stand-in for ``cv2.imwrite`` of a
``.jpg`` (the card has no cv2).

It writes what cv2 writes by default: quality 95 with the IJG tables scaled as
libjpeg scales them, 4:2:0 chroma, the standard Huffman tables of ITU T.81
Annex K, a JFIF APP0 segment, no restart markers. The bytes differ from cv2's
(float DCT and rounding, edge padding of partial blocks), not the format.

Every stage is an array operation over all blocks at once: the colour
transform, the DCT as two 8x8 products, quantisation, the run lengths and
code words of every symbol, and the bit packing (a cumulative sum gives each
code word its bit offset), so no Python loop runs per block or per symbol.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np

# ITU T.81 Annex K.1, natural (row-major) order
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64).reshape(8, 8)
_CHROMA_Q = np.full((8, 8), 99, np.int64)
_CHROMA_Q[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]

# ITU T.81 Annex K.3: (code counts for lengths 1..16, symbols)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _zigzag() -> np.ndarray:
    """[64] natural-order index of each zigzag position."""
    order = sorted(((y, x) for y in range(8) for x in range(8)),
                   key=lambda p: (p[0] + p[1], p[1] if (p[0] + p[1]) % 2 == 0 else p[0]))
    return np.array([y * 8 + x for y, x in order], np.int64)


ZIGZAG = _zigzag()


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling and jpeg_add_quant_table (baseline:
    entries clamped to 1..255)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c  # orthonormal: the JPEG FDCT is C @ block @ C.T


_DCT = _dct_matrix()


@functools.lru_cache(maxsize=None)
def _huffman(counts: Tuple[int, ...], symbols: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """(code [256], length [256]) of a table given as in a DHT segment
    (ITU T.81 Annex C)."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, i = 0, 0
    for n_bits, n in enumerate(counts, start=1):
        for _ in range(n):
            code[symbols[i]] = c
            length[symbols[i]] = n_bits
            c += 1
            i += 1
        c <<= 1
    return code, length


def _table(spec) -> Tuple[np.ndarray, np.ndarray]:
    return _huffman(tuple(spec[0]), bytes(spec[1]))


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] (multiples of 8) -> [H/8, W/8, 8, 8]."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _quantised_zigzag(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
    """[..., 8, 8] level-shifted samples -> [..., 64] int64 quantised
    coefficients in zigzag order."""
    coef = _DCT @ blocks @ _DCT.T
    return np.rint(coef / q).astype(np.int64).reshape(*blocks.shape[:-2], 64)[..., ZIGZAG]


def _bit_size(v: np.ndarray) -> np.ndarray:
    """Number of bits of |v| (JPEG's magnitude category SSSS)."""
    a = np.abs(v)
    size = np.zeros(a.shape, np.int64)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return size


def _extra_bits(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The SSSS low bits that follow a code word: v, or v - 1 for v < 0."""
    return np.where(v >= 0, v, v + (1 << size) - 1)


def _entropy_code(coef: np.ndarray, comp: np.ndarray) -> bytes:
    """Huffman-coded scan of blocks [N, 64] (zigzag, in scan order) whose
    component is comp [N] (0 = Y, 1 = Cb, 2 = Cr), with 0xFF stuffing."""
    n = coef.shape[0]
    # [luma, chroma] x 256 symbols
    dc_code, dc_bits = (np.stack(t) for t in zip(_table(_DC_LUMA), _table(_DC_CHROMA)))
    ac_code, ac_bits = (np.stack(t) for t in zip(_table(_AC_LUMA), _table(_AC_CHROMA)))
    chroma = (comp > 0).astype(np.int64)

    # DC: the difference to the previous block of the same component
    dc = coef[:, 0]
    diff = np.empty(n, np.int64)
    for c in range(3):
        idx = np.flatnonzero(comp == c)
        diff[idx] = np.diff(dc[idx], prepend=0)
    dsize = _bit_size(diff)
    ev_blk = [np.arange(n)]
    ev_pos = [np.zeros(n, np.int64)]
    ev_val = [(dc_code[chroma, dsize] << dsize) | _extra_bits(diff, dsize)]
    ev_len = [dc_bits[chroma, dsize] + dsize]

    # AC: each nonzero coefficient, preceded by one ZRL per 16 zeros of its run
    blk, pos = np.nonzero(coef[:, 1:])
    pos = pos + 1
    v = coef[blk, pos]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], pos[:-1]]))
    run = pos - prev - 1
    size = _bit_size(v)
    sym = ((run % 16) << 4) | size
    ch = chroma[blk]
    ev_blk.append(blk)
    ev_pos.append(2 * pos + 1)
    ev_val.append((ac_code[ch, sym] << size) | _extra_bits(v, size))
    ev_len.append(ac_bits[ch, sym] + size)

    zi = np.repeat(np.arange(len(blk)), run // 16)
    ev_blk.append(blk[zi])
    ev_pos.append(2 * pos[zi])
    ev_val.append(ac_code[ch[zi], 0xF0])
    ev_len.append(ac_bits[ch[zi], 0xF0])

    # EOB after the last nonzero coefficient, unless it is the 63rd
    last = np.zeros(n, np.int64)
    last[blk] = pos  # the last write of each block is its largest position
    eob = np.flatnonzero(last < 63)
    ev_blk.append(eob)
    ev_pos.append(np.full(len(eob), 2 * 64, np.int64))
    ev_val.append(ac_code[chroma[eob], 0x00])
    ev_len.append(ac_bits[chroma[eob], 0x00])

    key = np.concatenate(ev_blk) * 256 + np.concatenate(ev_pos)
    order = np.argsort(key, kind="stable")
    val = np.concatenate(ev_val)[order]
    length = np.concatenate(ev_len)[order]

    # bit packing: a cumulative sum gives each code word its bit offset; the
    # word (at most 27 bits) lands in the 5 bytes from offset // 8 on, and
    # since words own disjoint bits, summing their bytes ORs them
    pad = (-int(length.sum())) % 8  # the last byte is filled with 1-bits
    val = np.append(val, (1 << pad) - 1)
    length = np.append(length, pad)
    start = np.cumsum(length) - length
    n_bytes = int(start[-1] + length[-1]) // 8
    window = val << (40 - start % 8 - length)
    k = start // 8
    idx = np.concatenate([k + i for i in range(5)])
    part = np.concatenate([(window >> (32 - 8 * i)) & 0xFF for i in range(5)])
    data = np.bincount(idx, weights=part, minlength=n_bytes + 5)[:n_bytes].astype(np.uint8)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _dht(tc_th: int, spec) -> bytes:
    return _segment(0xC4, bytes([tc_th]) + bytes(spec[0]) + bytes(spec[1]))


def encode_jpg(img_bgr_u8: np.ndarray, quality: int = 95) -> bytes:
    """A [H, W, 3] BGR uint8 image as baseline JPEG bytes (YCbCr 4:2:0)."""
    img = np.asarray(img_bgr_u8)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"expected a [H, W, 3] uint8 BGR image, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"JPEG cannot hold a {h}x{w} image")
    # pad to whole 16x16 MCUs by repeating the last row and column
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    px = np.pad(img, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge").astype(np.float64)
    b, g, r = px[..., 0], px[..., 1], px[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    y, cb, cr = (np.clip(np.rint(p), 0, 255) for p in (y, cb, cr))

    def down(p):  # 2x2 box average, as libjpeg's h2v2 downsampling
        return np.floor(p.reshape(hp // 2, 2, wp // 2, 2).sum(axis=(1, 3)) / 4.0 + 0.5)

    qy = quant_table(_LUMA_Q, quality)
    qc = quant_table(_CHROMA_Q, quality)
    ty = _quantised_zigzag(_blocks(y - 128.0), qy)  # [hp/8, wp/8, 64]
    tcb = _quantised_zigzag(_blocks(down(cb) - 128.0), qc)  # [hp/16, wp/16, 64]
    tcr = _quantised_zigzag(_blocks(down(cr) - 128.0), qc)
    my, mx = hp // 16, wp // 16
    # MCU order: Y00, Y01, Y10, Y11, Cb, Cr
    y4 = ty.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
    mcus = np.concatenate([y4, tcb[:, :, None], tcr[:, :, None]], axis=2).reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    scan = _entropy_code(mcus, comp)

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
           _segment(0xDB, bytes([0]) + bytes(qy.reshape(64)[ZIGZAG].astype(np.uint8))),
           _segment(0xDB, bytes([1]) + bytes(qc.reshape(64)[ZIGZAG].astype(np.uint8))),
           _segment(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                    + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])),
           _dht(0x00, _DC_LUMA), _dht(0x10, _AC_LUMA), _dht(0x01, _DC_CHROMA),
           _dht(0x11, _AC_CHROMA),
           _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
           scan, b"\xff\xd9"]
    return b"".join(out)


def imwrite_jpg(path: str, img_bgr_u8: np.ndarray, quality: int = 95) -> bool:
    """Write a [H, W, 3] BGR uint8 image to `path` as baseline JPEG, as
    ``cv2.imwrite(path, img)`` writes a ``.jpg``. Returns True."""
    data = encode_jpg(img_bgr_u8, quality)
    with open(os.fspath(path), "wb") as f:
        f.write(data)
    return True


def jpeg_size(data: bytes) -> Tuple[int, int]:
    """(height, width) from the SOF0 segment of baseline JPEG bytes; raises
    ValueError when the bytes lack SOI, EOI or a SOF0 segment."""
    if data[:2] != b"\xff\xd8" or data[-2:] != b"\xff\xd9":
        raise ValueError("not a JPEG: no SOI or no EOI marker")
    i = 2
    while i + 4 <= len(data) and data[i] == 0xFF:
        marker = data[i + 1]
        length = int.from_bytes(data[i + 2 : i + 4], "big")
        if marker == 0xC0:
            return (int.from_bytes(data[i + 5 : i + 7], "big"),
                    int.from_bytes(data[i + 7 : i + 9], "big"))
        if marker == 0xDA:
            break
        i += 2 + length
    raise ValueError("no SOF0 segment before the scan")
