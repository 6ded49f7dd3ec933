"""Image files without cv2: the port's ``cv2.imread(path)`` (IMREAD_COLOR) for
JPEG and PNG, in numpy and the standard library (``zlib``, ``struct``).

``imread`` returns BGR uint8 [H, W, 3], or None for a file it cannot read, as
cv2 does. What it reads:

- **JPEG**, baseline and extended sequential Huffman at 8 bits (SOF0, SOF1):
  1 or 3 components, any sampling factors, restart intervals, several scans.
  Decoded as libjpeg-turbo decodes it for cv2: the integer IDCT of
  ``jidctint.c`` with its range-limit table, "fancy" upsampling of 4:2:2
  (h2v1) and 4:2:0 (h2v2) chroma with libjpeg's rounding biases and edge
  rows and columns, and the integer YCbCr -> BGR tables of ``jdcolor.c``.
  Other sampling ratios are upsampled by replication (libjpeg's
  ``int_upsample``). Progressive, lossless, hierarchical and arithmetic-coded
  files, 12-bit samples and CMYK raise NotImplementedError.
- **PNG**, bit depth 8, not interlaced: gray, gray + alpha, RGB, RGBA and
  palette, all five row filters. Alpha is dropped, as IMREAD_COLOR drops it.
  16-bit, sub-byte depths and Adam7 files raise NotImplementedError.

The entropy decoder is the hot spot in Python: it looks up 16 bits at a time
in per-table arrays that give the code length, the run and the coefficient
together, over a list of 24-bit words (one per byte), so a coefficient costs
one lookup.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from rtvm_tpu_torch.io.jpeg import ZIGZAG  # zigzag position -> natural (row-major) index

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def imread(path: str) -> Optional[np.ndarray]:
    """BGR uint8 [H, W, 3] of a JPEG or PNG file, or None when the file is
    missing, of another format or damaged."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return imdecode(data)


def imdecode(data: bytes) -> Optional[np.ndarray]:
    """imread of the bytes of a file."""
    try:
        if data[:8] == PNG_SIGNATURE:
            return decode_png(data)
        if data[:2] == b"\xff\xd8":
            return decode_jpeg(data)
    except (ValueError, IndexError, KeyError, struct.error, zlib.error):
        return None
    return None


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

# jidctint.c: CONST_BITS 13, PASS1_BITS 2, FIX(x) = round(x * 2^13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F = {name: int(v * (1 << _CONST_BITS) + 0.5) for name, v in {
    "0_298631336": 0.298631336, "0_390180644": 0.390180644, "0_541196100": 0.541196100,
    "0_765366865": 0.765366865, "0_899976223": 0.899976223, "1_175875602": 1.175875602,
    "1_501321110": 1.501321110, "1_847759065": 1.847759065, "1_961570560": 1.961570560,
    "2_053119869": 2.053119869, "2_562915447": 2.562915447, "3_072711026": 3.072711026,
}.items()}


def _idct_1d(x, shift: int):
    """jpeg_idct_islow's 1-D pass on x[0..7] (int64 arrays): the even part,
    the odd part and DESCALE by `shift`."""
    f = _F
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * f["0_541196100"]
    tmp2 = z1 - z3 * f["1_847759065"]
    tmp3 = z1 + z2 * f["0_765366865"]
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * f["1_175875602"]
    o0 = o0 * f["0_298631336"]
    o1 = o1 * f["2_053119869"]
    o2 = o2 * f["3_072711026"]
    o3 = o3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    r = 1 << (shift - 1)
    return [(t10 + o3 + r) >> shift, (t11 + o2 + r) >> shift, (t12 + o1 + r) >> shift,
            (t13 + o0 + r) >> shift, (t13 - o0 + r) >> shift, (t12 - o1 + r) >> shift,
            (t11 - o2 + r) >> shift, (t10 - o3 + r) >> shift]


def _range_limit() -> np.ndarray:
    """jdmaster.c's post-IDCT range-limit table, indexed by value & 1023."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)  # 0..127 -> 128..255
    t[128:512] = 255
    t[896:] = np.arange(0, 128)  # -128..-1 -> 0..127
    return t


_RANGE_LIMIT = _range_limit()


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg's islow IDCT of blocks coef [N, 64] (natural order) with the
    quantisation table q [64] (natural order) -> [N, 8, 8] uint8."""
    c = (coef.astype(np.int64) * q.astype(np.int64)).reshape(-1, 8, 8)
    cols = _idct_1d([c[:, k, :] for k in range(8)], _CONST_BITS - _PASS1_BITS)
    ws = np.stack(cols, axis=1)  # [N, row, col]
    rows = _idct_1d([ws[:, :, k] for k in range(8)], _CONST_BITS + _PASS1_BITS + 3)
    return _RANGE_LIMIT[np.stack(rows, axis=2) & 1023]


def _huffman_tables(counts, symbols):
    """Lookup over every 16-bit peek: (code length, symbol) of the code it
    starts with; length 0 for a peek that starts no code."""
    length = np.zeros(1 << 16, np.int64)
    symbol = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for bits in range(1, 17):
        for _ in range(counts[bits - 1]):
            lo = code << (16 - bits)
            hi = (code + 1) << (16 - bits)
            length[lo:hi] = bits
            symbol[lo:hi] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return length, symbol


def _extend(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """JPEG's EXTEND: s-bit magnitude category v -> the signed value."""
    return np.where((s > 0) & (v < (1 << np.maximum(s - 1, 0))), v - (1 << s) + 1, v)


class _Huffman:
    """A DHT table as lists over every 16-bit peek. ``total`` is the bits the
    code and its value take together (0: the value bits run past the peek,
    or no code starts there), ``rs`` its symbol, ``value`` the extended
    value; ``length`` and ``symbol`` serve the rare long case."""

    def __init__(self, counts, symbols):
        length, symbol = _huffman_tables(counts, symbols)
        s = symbol & 15
        fits = (length > 0) & (length + s <= 16)
        shift = np.where(fits, 16 - length - s, 0)
        raw = (np.arange(1 << 16) >> shift) & ((1 << s) - 1)
        self.total = np.where(fits, length + s, 0).tolist()
        self.rs = symbol.tolist()
        self.value = np.where(fits, _extend(raw, s), 0).tolist()
        self.length = length.tolist()


def _segments(data: bytes, start: int):
    """The entropy-coded data of a scan from `start`, split at its RSTn
    markers and unstuffed, and the offset of the marker that ends it."""
    segs, seg_start, i = [], start, start
    n = len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            end = n
            break
        nb = data[j + 1]
        if nb == 0x00:
            i = j + 2
        elif 0xD0 <= nb <= 0xD7:
            segs.append(data[seg_start:j])
            seg_start = i = j + 2
        elif nb == 0xFF:
            i = j + 1
        else:
            end = j
            break
    segs.append(data[seg_start:end])
    return [s.replace(b"\xff\x00", b"\xff") for s in segs], end


def _words(seg: bytes) -> list:
    """One 24-bit big-endian word per byte of `seg` (zeros past its end, as
    libjpeg inserts zeros when the data runs out)."""
    a = np.frombuffer(seg + b"\x00" * 4, np.uint8).astype(np.int64)
    return ((a[:-2] << 16) | (a[1:-1] << 8) | a[2:]).tolist()


def _decode_scan(segs, blocks, mcu_blocks: int, restart: int, coefs, n_comp: int):
    """Huffman-decode the blocks of one scan. blocks: (flat block index,
    component slot, dc table, ac table) in scan order; mcu_blocks blocks form
    one MCU, and every `restart` MCUs start a new segment. Writes the
    coefficients (zigzag order) into coefs [N, 64]."""
    idx, vals = [], []
    seg_i, p, pred = 0, 0, [0] * n_comp
    words = _words(segs[0])
    per_seg = restart * mcu_blocks if restart else len(blocks)
    for bi, (blk, slot, dct, act) in enumerate(blocks):
        if bi and bi % per_seg == 0:
            seg_i += 1
            if seg_i >= len(segs):
                raise ValueError("fewer restart intervals than MCUs")
            words, p, pred = _words(segs[seg_i]), 0, [0] * n_comp
        base = blk * 64
        v = (words[p >> 3] >> (8 - (p & 7))) & 0xFFFF
        t = dct.total[v]
        if t:
            p += t
            diff = dct.value[v]
        else:
            diff, p = _slow_value(words, p, dct, v)
        pred[slot] += diff
        idx.append(base)
        vals.append(pred[slot])
        k = 1
        total, rs_l, value = act.total, act.rs, act.value
        while k < 64:
            v = (words[p >> 3] >> (8 - (p & 7))) & 0xFFFF
            t = total[v]
            rs = rs_l[v]
            if t:
                p += t
                val = value[v]
            else:
                val, p = _slow_value(words, p, act, v)
            if rs & 15 == 0:
                if rs == 0xF0:
                    k += 16
                    continue
                break
            k += rs >> 4
            if k > 63:
                raise ValueError("coefficient index past 63")
            idx.append(base + k)
            vals.append(val)
            k += 1
    flat = coefs.reshape(-1)
    flat[np.asarray(idx, np.int64)] = np.asarray(vals, np.int64)


def _slow_value(words, p: int, tab: _Huffman, v: int):
    """A code whose value bits run past the 16-bit peek: the code, then its
    value bits from a second peek."""
    ln = tab.length[v]
    if ln == 0:
        raise ValueError("corrupt Huffman code")
    p += ln
    s = tab.rs[v] & 15
    if s == 0:
        return 0, p
    w = (words[p >> 3] >> (8 - (p & 7))) & 0xFFFF
    raw = w >> (16 - s)
    return (raw - (1 << s) + 1 if raw < (1 << (s - 1)) else raw), p + s


def _upsample_h2v1(c: np.ndarray) -> np.ndarray:
    """jdsample.c h2v1_fancy_upsample: outputs 3/4 nearer + 1/4 further
    sample, biases 1 and 2, edge samples repeated."""
    c = c.astype(np.int32)
    left = np.concatenate([c[:, :1], c[:, :-1]], axis=1)
    right = np.concatenate([c[:, 1:], c[:, -1:]], axis=1)
    out = np.empty((c.shape[0], 2 * c.shape[1]), np.int32)
    out[:, 0::2] = (3 * c + left + 1) >> 2
    out[:, 1::2] = (3 * c + right + 2) >> 2
    return out.astype(np.uint8)


def _upsample_h2v2(c: np.ndarray) -> np.ndarray:
    """jdsample.c h2v2_fancy_upsample: a vertical 3:1 column sum with the
    nearer context row (the first and last rows repeated), then the
    horizontal 3:1 blend with biases 8 and 7, edge columns repeated."""
    c = c.astype(np.int32)
    above = np.concatenate([c[:1], c[:-1]], axis=0)
    below = np.concatenate([c[1:], c[-1:]], axis=0)
    out = np.empty((2 * c.shape[0], 2 * c.shape[1]), np.int32)
    for r, near in ((0, above), (1, below)):
        s = 3 * c + near
        left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        out[r::2, 0::2] = (3 * s + left + 8) >> 4
        out[r::2, 1::2] = (3 * s + right + 7) >> 4
    return out.astype(np.uint8)


def _ycc_tables():
    """jdcolor.c's integer YCbCr -> RGB tables (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """uint8 planes -> BGR uint8 [H, W, 3] with libjpeg's tables."""
    yi = y.astype(np.int64)
    r = yi + _CR_R[cr]
    g = yi + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = yi + _CB_B[cb]
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


_UNSUPPORTED_SOF = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical progressive",
    0xC7: "hierarchical lossless", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical progressive",
    0xCF: "arithmetic-coded hierarchical lossless",
}


def decode_jpeg(data: bytes) -> np.ndarray:
    """BGR uint8 [H, W, 3] of a baseline or extended sequential Huffman JPEG
    (see the module's note). Raises ValueError for a damaged file and
    NotImplementedError for a kind of JPEG it does not read."""
    qt, dc_t, ac_t = {}, {}, {}
    frame, restart, adobe_transform, coefs = None, 0, None, None
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"no marker at byte {pos}")
        while data[pos + 1] == 0xFF:
            pos += 1
        m = data[pos + 1]
        if m == 0xD9:
            break
        if m == 0xD8 or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        (seglen,) = struct.unpack(">H", data[pos + 2 : pos + 4])
        seg = data[pos + 4 : pos + 2 + seglen]
        nxt = pos + 2 + seglen
        if m == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(seg[i + 1 : i + 1 + n], ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = vals
                qt[tq] = q
                i += 1 + n
        elif m == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1 : i + 17])
                syms = list(seg[i + 17 : i + 17 + sum(counts)])
                (ac_t if tc else dc_t)[th] = _Huffman(counts, syms)
                i += 17 + sum(counts)
        elif m in (0xC0, 0xC1):
            prec, h, w, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise NotImplementedError(f"{prec}-bit JPEG samples are not read (8 only)")
            if nc not in (1, 3):
                raise NotImplementedError(f"a {nc}-component JPEG is not read (1 or 3: no CMYK)")
            if h == 0:
                raise NotImplementedError("a JPEG whose height comes in a DNL marker is not read")
            comps = [(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                     for i in range(nc)]
            frame = _frame_layout(h, w, comps)
            coefs = [np.zeros((c["bh"] * c["bw"], 64), np.int64) for c in frame["comps"]]
        elif m in _UNSUPPORTED_SOF:
            raise NotImplementedError(f"{_UNSUPPORTED_SOF[m]} JPEG (SOF{m - 0xC0}) is not read: "
                                      "baseline and extended sequential Huffman only")
        elif m == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif m == 0xDA:
            if frame is None:
                raise ValueError("SOS before SOF")
            ns = seg[0]
            sel = [(seg[1 + 2 * i], seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15) for i in range(ns)]
            segs, nxt = _segments(data, nxt)
            _decode_one_scan(frame, sel, segs, restart, dc_t, ac_t, coefs)
        pos = nxt
    if frame is None:
        raise ValueError("no frame header")
    planes = []
    for c, co in zip(frame["comps"], coefs):
        if c["tq"] not in qt:
            raise ValueError(f"missing quantisation table {c['tq']}")
        px = idct_islow(co, qt[c["tq"]]).reshape(c["bh"], c["bw"], 8, 8)
        px = px.transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        px = px[: c["dh"], : c["dw"]]
        planes.append(_upsample(px, frame["hmax"] // c["h"], frame["vmax"] // c["v"],
                                frame["height"], frame["width"]))
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    ids = tuple(c["id"] for c in frame["comps"])
    if adobe_transform == 0 or ids == (ord("R"), ord("G"), ord("B")):
        return np.stack(planes[::-1], axis=-1)  # stored as RGB
    return ycc_to_bgr(*planes)


def _frame_layout(h: int, w: int, comps) -> dict:
    """Block grids of each component: (downsampled) sizes as libjpeg
    computes them, and grids padded to whole MCUs."""
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    out = []
    for cid, hs, vs, tq in comps:
        out.append({"id": cid, "h": hs, "v": vs, "tq": tq, "bw": mx * hs, "bh": my * vs,
                    "dw": -(-w * hs // hmax), "dh": -(-h * vs // vmax)})
    return {"height": h, "width": w, "hmax": hmax, "vmax": vmax, "mx": mx, "my": my, "comps": out}


def _decode_one_scan(frame, sel, segs, restart, dc_t, ac_t, coefs) -> None:
    slots = {c["id"]: i for i, c in enumerate(frame["comps"])}
    comps = [(slots[cid], frame["comps"][slots[cid]], dc_t[td], ac_t[ta]) for cid, td, ta in sel]
    blocks = []
    if len(comps) == 1:  # non-interleaved: the component's own blocks in raster order
        ci, c, dct, act = comps[0]
        bw, bh = -(-c["dw"] // 8), -(-c["dh"] // 8)
        for by in range(bh):
            for bx in range(bw):
                blocks.append((ci, by * c["bw"] + bx, dct, act))
        mcu_blocks = 1
    else:
        for my in range(frame["my"]):
            for mx in range(frame["mx"]):
                for ci, c, dct, act in comps:
                    for v in range(c["v"]):
                        for u in range(c["h"]):
                            blocks.append((ci, (my * c["v"] + v) * c["bw"] + mx * c["h"] + u, dct, act))
        mcu_blocks = sum(c["h"] * c["v"] for _, c, _, _ in comps)
    # decode into one array over the scan's components, then scatter back
    offs, n = {}, 0
    for ci, c, _, _ in comps:
        offs[ci] = n
        n += c["bh"] * c["bw"]
    buf = np.zeros((n, 64), np.int64)
    order = {ci: k for k, (ci, _, _, _) in enumerate(comps)}
    _decode_scan(segs, [(offs[ci] + b, order[ci], dct, act) for ci, b, dct, act in blocks],
                 mcu_blocks, restart, buf, len(comps))
    for ci, c, _, _ in comps:
        zz = buf[offs[ci] : offs[ci] + c["bh"] * c["bw"]]
        nat = np.zeros_like(zz)
        nat[:, ZIGZAG] = zz
        coefs[ci] += nat


def _upsample(px: np.ndarray, fx: int, fy: int, h: int, w: int) -> np.ndarray:
    """A component plane at its downsampled size -> [h, w]: fancy h2v1 and
    h2v2 as libjpeg (when the plane is wider than 2 samples), replication
    otherwise."""
    if (fx, fy) == (1, 1):
        return px[:h, :w]
    if (fx, fy) == (2, 1) and px.shape[1] > 2:
        return _upsample_h2v1(px)[:h, :w]
    if (fx, fy) == (2, 2) and px.shape[1] > 2:
        return _upsample_h2v2(px)[:h, :w]
    return np.repeat(np.repeat(px, fy, axis=0), fx, axis=1)[:h, :w]


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth_row(raw: list, prev: list, bpp: int) -> list:
    out = raw[:]
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 255
    return out


def _average_row(raw: list, prev: list, bpp: int) -> list:
    out = raw[:]
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prev[i]) >> 1)) & 255
    return out


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters: None, Sub, Up, Average, Paeth."""
    rows = raw[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, r = int(rows[y, 0]), rows[y, 1:]
        if f == 0:
            cur = r.copy()
        elif f == 1:
            cur = np.cumsum(r.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:
            cur = r + prev
        elif f == 3:
            cur = np.array(_average_row(r.tolist(), prev.tolist(), bpp), np.uint8)
        elif f == 4:
            cur = np.array(_paeth_row(r.tolist(), prev.tolist(), bpp), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter {f}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """BGR uint8 [H, W, 3] of an 8-bit, non-interlaced PNG (see the module's
    note). Raises ValueError for a damaged file and NotImplementedError for
    a kind of PNG it does not read."""
    pos, idat, palette, ihdr = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("no IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8:
        raise NotImplementedError(f"{depth}-bit PNG is not read (8-bit only)")
    if interlace:
        raise NotImplementedError("an interlaced (Adam7) PNG is not read")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"unknown PNG colour type {ctype}")
    ch = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (w * ch + 1):
        raise ValueError("PNG image data is short")
    px = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[px[..., 0]][..., ::-1].copy()
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return px[..., 2::-1].copy()
