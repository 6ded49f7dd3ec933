"""Numpy counterparts of the cv2 drawing calls on the host paths the card
runs without cv2 (the pipeline's export, the navigation map, the synthetic
training scenes of ``models/yolo/synth.py``): ``line``, ``rectangle``,
``circle``, ``polylines``, ``draw_contours``, ``put_text``, ``fill_poly``
and ``ellipse``, each drawing in place on a [H, W, 3] uint8 image and
returning it, as cv2 does; and ``add_weighted`` and ``gaussian_blur_u8``.
The rules of cv2 5.0 below were measured against it, pixel for pixel
(tests/test_torch_synth.py).

- ``line`` at thickness 1 is cv2's ``LINE_8``: the line clipped to the image
  as ``cv2.clipLine`` clips it, then the same Bresenham walk from the left
  end point. A thicker line is cv2's ``ThickLine``: clipped to the image
  grown by the thickness, the band between the end points offset by the
  half width in 16.16 fixed point, filled by cv2's ``FillConvexPoly``
  (``_fill_convex``, with its sub-pixel outline ``Line2``), and a filled
  circle at each end.
- ``fill_poly`` is cv2's edge-collection scan of integer polygons (see its
  docstring); it differs from cv2 only at a few border pixels of polygons
  that leave the image. ``ellipse`` builds cv2's polygon of the ellipse
  (its table of sines, whole degrees) and fills it with ``FillConvexPoly``
  or draws its outline.
- ``add_weighted`` is cv2's float32 blend of uint8 images, rounded half to
  even; ``gaussian_blur_u8`` is cv2's bit-exact 8-bit Gaussian blur.
- ``rectangle`` is cv2's: the closed polyline of its four corners, or filled
  for a negative thickness.
- ``circle`` filled, and its outline at thickness 1, are cv2's midpoint
  circle, pixel for pixel; an outline thicker than 1 is cv2's polygon of the circle (a vertex every 18 degrees
  up to radius 14), here with its vertices rounded to whole pixels and its
  sides drawn by ``line``.
- ``polylines`` draws each side with ``line`` (cv2 caps every vertex too,
  so the union is the same shape); ``draw_contours`` does so too, but at
  thickness 2 draws a contour of horizontal, vertical and diagonal runs at
  once, with the same pixels.
- ``put_text`` draws with an embedded 5x7 bitmap font (two more rows for
  descenders) scaled to the cap height of cv2's ``FONT_HERSHEY_SIMPLEX`` at
  the same scale, on the same baseline origin (``org`` is the bottom-left of
  the text). The glyphs are not Hershey's: cv2's stroke data is not
  available to the port. The font has the Cyrillic alphabet, upper and
  lower case; ``put_text_top`` places text by its top-left corner as PIL
  does, with a one-pixel black shadow.
"""

from __future__ import annotations

import functools

import numpy as np

_FONT = {  # rows top to bottom, "#" inked; rows 7-8 (when given) hang below the baseline
    " ": "...../...../...../...../...../...../.....",
    "!": "..#../..#../..#../..#../..#../...../..#..",
    '"': ".#.#./.#.#./.#.#./...../...../...../.....",
    "#": ".#.#./.#.#./#####/.#.#./#####/.#.#./.#.#.",
    "$": "..#../.####/#.#../.###./..#.#/####./..#..",
    "%": "##.../##..#/...#./..#../.#.../#..##/...##",
    "&": ".##../#..#./#.#../.#.../#.#.#/#..#./.##.#",
    "'": "..#../..#../.#.../...../...../...../.....",
    "(": "...#./..#../.#.../.#.../.#.../..#../...#.",
    ")": ".#.../..#../...#./...#./...#./..#../.#...",
    "*": "...../..#../#.#.#/.###./#.#.#/..#../.....",
    "+": "...../..#../..#../#####/..#../..#../.....",
    ",": "...../...../...../...../...../.##../.##../..#../.#...",
    "-": "...../...../...../#####/...../...../.....",
    ".": "...../...../...../...../...../.##../.##..",
    "/": "...../....#/...#./..#../.#.../#..../.....",
    "0": ".###./#...#/#..##/#.#.#/##..#/#...#/.###.",
    "1": "..#../.##../..#../..#../..#../..#../.###.",
    "2": ".###./#...#/....#/...#./..#../.#.../#####",
    "3": "#####/...#./..#../...#./....#/#...#/.###.",
    "4": "...#./..##./.#.#./#..#./#####/...#./...#.",
    "5": "#####/#..../####./....#/....#/#...#/.###.",
    "6": "..##./.#.../#..../####./#...#/#...#/.###.",
    "7": "#####/....#/...#./..#../.#.../.#.../.#...",
    "8": ".###./#...#/#...#/.###./#...#/#...#/.###.",
    "9": ".###./#...#/#...#/.####/....#/...#./.##..",
    ":": "...../.##../.##../...../.##../.##../.....",
    ";": "...../.##../.##../...../.##../.##../..#../.#...",
    "<": "...#./..#../.#.../#..../.#.../..#../...#.",
    "=": "...../...../#####/...../#####/...../.....",
    ">": ".#.../..#../...#./....#/...#./..#../.#...",
    "?": ".###./#...#/....#/...#./..#../...../..#..",
    "@": ".###./#...#/....#/.##.#/#.#.#/#.#.#/.###.",
    "A": ".###./#...#/#...#/#####/#...#/#...#/#...#",
    "B": "####./#...#/#...#/####./#...#/#...#/####.",
    "C": ".###./#...#/#..../#..../#..../#...#/.###.",
    "D": "###../#..#./#...#/#...#/#...#/#..#./###..",
    "E": "#####/#..../#..../####./#..../#..../#####",
    "F": "#####/#..../#..../####./#..../#..../#....",
    "G": ".###./#...#/#..../#.###/#...#/#...#/.####",
    "H": "#...#/#...#/#...#/#####/#...#/#...#/#...#",
    "I": ".###./..#../..#../..#../..#../..#../.###.",
    "J": "..###/...#./...#./...#./...#./#..#./.##..",
    "K": "#...#/#..#./#.#../##.../#.#../#..#./#...#",
    "L": "#..../#..../#..../#..../#..../#..../#####",
    "M": "#...#/##.##/#.#.#/#.#.#/#...#/#...#/#...#",
    "N": "#...#/#...#/##..#/#.#.#/#..##/#...#/#...#",
    "O": ".###./#...#/#...#/#...#/#...#/#...#/.###.",
    "P": "####./#...#/#...#/####./#..../#..../#....",
    "Q": ".###./#...#/#...#/#...#/#.#.#/#..#./.##.#",
    "R": "####./#...#/#...#/####./#.#../#..#./#...#",
    "S": ".####/#..../#..../.###./....#/....#/####.",
    "T": "#####/..#../..#../..#../..#../..#../..#..",
    "U": "#...#/#...#/#...#/#...#/#...#/#...#/.###.",
    "V": "#...#/#...#/#...#/#...#/#...#/.#.#./..#..",
    "W": "#...#/#...#/#...#/#.#.#/#.#.#/#.#.#/.#.#.",
    "X": "#...#/#...#/.#.#./..#../.#.#./#...#/#...#",
    "Y": "#...#/#...#/#...#/.#.#./..#../..#../..#..",
    "Z": "#####/....#/...#./..#../.#.../#..../#####",
    "[": ".###./.#.../.#.../.#.../.#.../.#.../.###.",
    "\\": "...../#..../.#.../..#../...#./....#/.....",
    "]": ".###./...#./...#./...#./...#./...#./.###.",
    "^": "..#../.#.#./#...#/...../...../...../.....",
    "_": "...../...../...../...../...../...../#####",
    "`": ".#.../..#../...#./...../...../...../.....",
    "a": "...../...../.###./....#/.####/#...#/.####",
    "b": "#..../#..../#.##./##..#/#...#/#...#/####.",
    "c": "...../...../.###./#..../#..../#...#/.###.",
    "d": "....#/....#/.##.#/#..##/#...#/#...#/.####",
    "e": "...../...../.###./#...#/#####/#..../.###.",
    "f": ".##../#..../###../#..../#..../#..../#....",
    "g": "...../...../.####/#...#/#...#/#...#/.####/....#/.###.",
    "h": "#..../#..../#.##./##..#/#...#/#...#/#...#",
    "i": "..#../...../..#../..#../..#../..#../..#..",
    "j": "..#../...../..#../..#../..#../..#../..#../..#../##...",
    "k": "#..../#..../#..#./#.#../##.../#.#../#..#.",
    "l": "..#../..#../..#../..#../..#../..#../..#..",
    "m": "...../...../##.#./#.#.#/#.#.#/#...#/#...#",
    "n": "...../...../#.##./##..#/#...#/#...#/#...#",
    "o": "...../...../.###./#...#/#...#/#...#/.###.",
    "p": "...../...../####./#...#/#...#/#...#/####./#..../#....",
    "q": "...../...../.####/#...#/#...#/#...#/.####/....#/....#",
    "r": "...../...../#.##./##.../#..../#..../#....",
    "s": "...../...../.####/#..../.###./....#/####.",
    "t": ".#.../.#.../###../.#.../.#.../.#.../..#..",
    "u": "...../...../#...#/#...#/#...#/#..##/.##.#",
    "v": "...../...../#...#/#...#/#...#/.#.#./..#..",
    "w": "...../...../#...#/#...#/#.#.#/#.#.#/.#.#.",
    "x": "...../...../#...#/.#.#./..#../.#.#./#...#",
    "y": "...../...../#...#/#...#/#...#/#...#/.####/....#/.###.",
    "z": "...../...../#####/...#./..#../.#.../#####",
    "{": "...#./..#../..#../.#.../..#../..#../...#.",
    "|": "..#../..#../..#../..#../..#../..#../..#..",
    "}": ".#.../..#../..#../...#./..#../..#../.#...",
    "~": "...../...../.#.../#.#.#/...#./...../.....",
    # the Cyrillic alphabet, upper and lower case (the legend's and the soil
    # panel's lines); letters shaped like Latin ones share their glyphs below
    "Б": "#####/#..../#..../####./#...#/#...#/####.",
    "Г": "#####/#..../#..../#..../#..../#..../#....",
    "Д": "..##./.#.#./.#.#./.#.#./.#.#./#####/#...#",
    "Ё": ".#.#./...../#####/#..../####./#..../#####",
    "Ж": "#.#.#/#.#.#/.###./..#../.###./#.#.#/#.#.#",
    "З": ".###./#...#/....#/..##./....#/#...#/.###.",
    "И": "#...#/#...#/#..##/#.#.#/##..#/#...#/#...#",
    "Й": ".###./...../#..##/#.#.#/#.#.#/##..#/#...#",
    "Л": "..###/.#..#/.#..#/.#..#/.#..#/.#..#/#...#",
    "П": "#####/#...#/#...#/#...#/#...#/#...#/#...#",
    "У": "#...#/#...#/#...#/.####/....#/....#/.###.",
    "Ф": "..#../.###./#.#.#/#.#.#/.###./..#../..#..",
    "Ц": "#..#./#..#./#..#./#..#./#..#./#####/....#",
    "Ч": "#...#/#...#/#...#/.####/....#/....#/....#",
    "Ш": "#.#.#/#.#.#/#.#.#/#.#.#/#.#.#/#.#.#/#####",
    "Щ": "#.#.#/#.#.#/#.#.#/#.#.#/#.#.#/#####/....#",
    "Ъ": "##.../.#.../.#.../.###./.#..#/.#..#/.###.",
    "Ы": "#...#/#...#/#...#/###.#/#.#.#/#.#.#/###.#",
    "Ь": "#..../#..../#..../####./#...#/#...#/####.",
    "Э": ".###./#...#/....#/..###/....#/#...#/.###.",
    "Ю": "#..#./#.#.#/#.#.#/###.#/#.#.#/#.#.#/#..#.",
    "Я": ".####/#...#/#...#/.####/..#.#/.#..#/#...#",
    "б": "..##./.#.../#..../####./#...#/#...#/.###.",
    "в": "...../...../####./#...#/####./#...#/####.",
    "г": "...../...../#####/#..../#..../#..../#....",
    "д": "...../...../.###./.#.#./.#.#./#####/#...#",
    "ё": ".#.#./...../.###./#...#/#####/#..../.###.",
    "ж": "...../...../#.#.#/.###./..#../.###./#.#.#",
    "з": "...../...../.###./....#/..##./....#/.###.",
    "и": "...../...../#...#/#..##/#.#.#/##..#/#...#",
    "й": "...../..#../#...#/#..##/#.#.#/##..#/#...#",
    "к": "...../...../#..#./#.#../##.../#.#../#..#.",
    "л": "...../...../..###/.#..#/.#..#/.#..#/#...#",
    "м": "...../...../#...#/##.##/#.#.#/#...#/#...#",
    "н": "...../...../#...#/#...#/#####/#...#/#...#",
    "п": "...../...../#####/#...#/#...#/#...#/#...#",
    "т": "...../...../#####/..#../..#../..#../..#..",
    "ф": "...../..#../.###./#.#.#/#.#.#/.###./..#..",
    "ц": "...../...../#..#./#..#./#..#./#####/....#",
    "ч": "...../...../#...#/#...#/.####/....#/....#",
    "ш": "...../...../#.#.#/#.#.#/#.#.#/#.#.#/#####",
    "щ": "...../...../#.#.#/#.#.#/#.#.#/#####/....#",
    "ъ": "...../...../##.../.###./.#..#/.#..#/.###.",
    "ы": "...../...../#...#/#...#/###.#/#.#.#/###.#",
    "ь": "...../...../#..../####./#...#/#...#/####.",
    "э": "...../...../.###./....#/..###/....#/.###.",
    "ю": "...../...../#..#./#.#.#/###.#/#.#.#/#..#.",
    "я": "...../...../.####/#...#/.####/..#.#/.#..#",
}
_FONT.update({cyr: _FONT[lat] for cyr, lat in zip("АВЕКМНОРСТХаеорсух", "ABEKMHOPCTXaeopcyx")})
_BODY_ROWS = 7
_HERSHEY_CAP = 21.0  # FONT_HERSHEY_SIMPLEX's cap height in font units at scale 1
_COL_ASPECT = 0.7  # glyph column width over row height


@functools.lru_cache(maxsize=None)
def _glyph(ch: str) -> np.ndarray:
    """[9, w] bool: the glyph's inked columns only (a space keeps 3 blank
    columns); rows 7-8 are the descender."""
    rows = _FONT.get(ch, _FONT["?"]).split("/")
    g = np.zeros((_BODY_ROWS + 2, 5), bool)
    g[: len(rows)] = np.array([[c == "#" for c in r] for r in rows])
    cols = np.flatnonzero(g.any(axis=0))
    return g[:, cols[0] : cols[-1] + 1] if len(cols) else g[:, :3]


def _paint(img: np.ndarray, ys: np.ndarray, xs: np.ndarray, color) -> None:
    h, w = img.shape[:2]
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    c = np.asarray(color, np.float64).reshape(-1)
    img[ys[keep], xs[keep]] = c[: img.shape[2]] if img.ndim == 3 else c[0]


def _line8(p1, p2):
    """The pixels (ys, xs) of cv2's 8-connected line from p1 to p2, walked
    from the left end as cv2's LineIterator walks it."""
    (x0, y0), (x1, y1) = p1, p2
    if x1 < x0:
        (x0, y0), (x1, y1) = (x1, y1), (x0, y0)
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    i = np.arange(max(dx, dy) + 1, dtype=np.int64)
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    # the walk steps the minor axis when its error term is negative; after i
    # steps that has happened ceil((2 minor i - major) / (2 major)) times
    m = -((major - 2 * minor * i) // (2 * major)) if major else np.zeros_like(i)
    if dy > dx:
        return y0 + sy * i, x0 + m
    return y0 + sy * m, x0 + i


def _round_half_up(v):
    return np.floor(np.asarray(v, np.float64) + 0.5).astype(np.int64)


XY_SHIFT = 16  # cv2's sub-pixel fixed point: 16 fractional bits
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1


def _tdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero) of Python ints."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine to [0, w) x [0, h) in the points' own units: (inside,
    clipped points). The crossings are C's double products, truncated."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1, x2, y2)


def _line_int(img: np.ndarray, p1, p2, color) -> None:
    """cv2's ``Line`` (LINE_8) between integer points: clipped to the image
    first, then walked from the left end."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        ok, (x1, y1, x2, y2) = _clip_line(w, h, x1, y1, x2, y2)
        if not ok:
            return
    ys, xs = _line8((x1, y1), (x2, y2))
    _paint(img, ys, xs, color)


def _line_fixed(img: np.ndarray, p1, p2, color) -> None:
    """cv2's ``Line2`` (the outline ``FillConvexPoly`` draws at sub-pixel
    precision): the 8-connected line between points with XY_SHIFT
    fractional bits, one pixel a step along the major axis, the minor
    coordinate stepped in fixed point, clipped in those units first."""
    h, w = img.shape[:2]
    ok, (x1, y1, x2, y2) = _clip_line(w << XY_SHIFT, h << XY_SHIFT, int(p1[0]), int(p1[1]),
                                      int(p2[0]), int(p2[1]))
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _tdiv(dy * XY_ONE, ax | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _tdiv(dx * XY_ONE, ay | 1)
        count = (y2 - y1) >> XY_SHIFT
    k = np.arange(max(count + 1, 0), dtype=np.int64)
    x1 += _HALF
    y1 += _HALF
    if ax > ay:
        xs, ys = (x1 >> XY_SHIFT) + k, (y1 + k * step) >> XY_SHIFT
    else:
        xs, ys = (x1 + k * step) >> XY_SHIFT, (y1 >> XY_SHIFT) + k
    xs = np.append(xs, (x2 + _HALF) >> XY_SHIFT)
    ys = np.append(ys, (y2 + _HALF) >> XY_SHIFT)
    _paint(img, ys, xs, color)


def _lines_fixed(img: np.ndarray, p: np.ndarray, q: np.ndarray, color) -> None:
    """``_line_fixed`` for many segments [m, 2] -> [m, 2] at once: those
    inside the image in one vectorised walk, the others one by one (they
    are clipped first)."""
    h, w = img.shape[:2]
    lim = np.array([w << XY_SHIFT, h << XY_SHIFT], np.int64)
    inside = ((p >= 0) & (p < lim) & (q >= 0) & (q < lim)).all(1)
    for i in np.flatnonzero(~inside):
        _line_fixed(img, p[i], q[i], color)
    p, q = p[inside], q[inside]
    if not len(p):
        return
    d = q - p
    xmajor = np.abs(d[:, 0]) > np.abs(d[:, 1])
    major = np.where(xmajor, 0, 1)
    flip = d[np.arange(len(d)), major] < 0
    a = np.where(flip[:, None], q, p)
    b = np.where(flip[:, None], p, q)
    d = b - a
    num = np.where(xmajor, d[:, 1], d[:, 0]) * XY_ONE
    den = np.where(xmajor, np.abs(d[:, 0]), np.abs(d[:, 1])) | 1
    step = np.sign(num) * (np.abs(num) // den)  # C's truncating division
    count = np.where(xmajor, d[:, 0], d[:, 1]) >> XY_SHIFT
    n = np.maximum(count + 1, 0)
    k = np.arange(int(n.sum()), dtype=np.int64) - np.repeat(np.cumsum(n) - n, n)
    a = np.repeat(a + _HALF, n, axis=0)
    st, xm = np.repeat(step, n), np.repeat(xmajor, n)
    xs = np.where(xm, (a[:, 0] >> XY_SHIFT) + k, (a[:, 0] + k * st) >> XY_SHIFT)
    ys = np.where(xm, (a[:, 1] + k * st) >> XY_SHIFT, (a[:, 1] >> XY_SHIFT) + k)
    ends = (b + _HALF) >> XY_SHIFT
    _paint(img, np.concatenate([ys, ends[:, 1]]), np.concatenate([xs, ends[:, 0]]), color)


def _line_rounded(img: np.ndarray, p1, p2, color) -> None:
    """cv2 5.0's thin line between points with XY_SHIFT fractional bits
    (``ThickLine`` at thickness 1): the end points rounded half up to whole
    pixels, then ``Line``."""
    _line_int(img, ((int(p1[0]) + _HALF) >> XY_SHIFT, (int(p1[1]) + _HALF) >> XY_SHIFT),
              ((int(p2[0]) + _HALF) >> XY_SHIFT, (int(p2[1]) + _HALF) >> XY_SHIFT), color)


def _hspans(img: np.ndarray, rows: np.ndarray, x1: np.ndarray, x2: np.ndarray, color) -> None:
    """Fill [x1, x2] of each row (cv2's ICV_HLINE after its clipping)."""
    h, w = img.shape[:2]
    ok = (rows >= 0) & (rows < h) & (x2 >= 0) & (x1 < w)
    rows, x1, x2 = rows[ok], np.maximum(x1[ok], 0), np.minimum(x2[ok], w - 1)
    n = np.maximum(x2 - x1 + 1, 0)
    first = np.repeat(np.cumsum(n) - n, n)
    _paint(img, np.repeat(rows, n), np.repeat(x1, n) + np.arange(int(n.sum())) - first, color)


def _fill_convex(img: np.ndarray, v: np.ndarray, color, shift: int = 0) -> None:
    """cv2's ``FillConvexPoly`` (LINE_8) of int vertices [n, 2] with `shift`
    fractional bits: the outline (``Line`` at shift 0, else ``Line2``), then
    the scan with two edges walking down from the top vertex; each edge's x
    starts at its upper vertex and steps by its rounded slope a row. The
    rows between two edge changes are filled at once."""
    v = np.asarray(v, np.int64).reshape(-1, 2)
    n = len(v)
    h, w = img.shape[:2]
    up = XY_SHIFT - shift
    delta = (1 << shift) >> 1
    if shift == 0:
        for p0, p in zip(np.roll(v, 1, axis=0), v):
            _line_int(img, p0, p, color)
    else:
        _lines_fixed(img, np.roll(v, 1, axis=0) << up, v << up, color)
    imin = int(np.argmin(v[:, 1]))  # the first vertex of least y
    xmin, xmax = (int(v[:, 0].min()) + delta) >> shift, (int(v[:, 0].max()) + delta) >> shift
    ymin, ymax = (int(v[imin, 1]) + delta) >> shift, (int(v[:, 1].max()) + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % n
                while True:
                    more = edges > 0
                    edges -= 1
                    if not more:
                        break
                    ty = (int(v[idx, 1]) + delta) >> shift
                    if ty > y:
                        xs, xe = int(v[idx0, 0]) << up, int(v[idx, 0]) << up
                        e[2], e[4], e[0] = xs, ty, idx
                        e[3] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        break
                    idx0, idx = idx, (idx + di) % n
        if edges < 0:
            break
        stop = min(edge[0][4], edge[1][4], ymax + 1)
        k = np.arange(stop - y, dtype=np.int64)
        xa, xb = edge[0][2] + k * edge[0][3], edge[1][2] + k * edge[1][3]
        _hspans(img, y + k, (np.minimum(xa, xb) + _HALF) >> XY_SHIFT,
                (np.maximum(xa, xb) + _HALF) >> XY_SHIFT, color)
        edge[0][2] += len(k) * edge[0][3]
        edge[1][2] += len(k) * edge[1][3]
        y = stop
        if y > ymax:
            break


def fill_poly(img: np.ndarray, pts_list, color) -> np.ndarray:
    """cv2.fillPoly(img, pts_list, color) (LINE_8, integer vertices), in
    place: each polygon's outline as ``Line``s, then cv2's edge-collection
    scan over all of them, even-odd. Every edge that is not horizontal spans
    rows [y0, y1) from its upper end, its x stepped by its truncated 16.16
    slope. An edge inside the image starts half a pixel right of its
    vertex; one that leaves the image takes its slope from its clipped end
    points, unshifted. Each row fills between its sorted crossings in
    pairs, from (left + 0.5) rounded down (less one unit) to (right - 0.5)
    rounded down. The scan's rule is measured against cv2 5.0; a few
    pixels on the image's border still differ where an edge leaves it."""
    h, w = img.shape[:2]
    starts, slopes, y0s, y1s = [], [], [], []
    for pts in pts_list:
        v = np.asarray(pts, np.int64).reshape(-1, 2)
        for i in range(len(v)):
            (xa, ya), (xb, yb) = (int(t) for t in v[i - 1]), (int(t) for t in v[i])
            _line_int(img, (xa, ya), (xb, yb), color)
            c0x, c0y, c1x, c1y = xa << XY_SHIFT, ya, xb << XY_SHIFT, yb
            if 0 <= xa < w and 0 <= xb < w and 0 <= ya < h and 0 <= yb < h:
                c0x, c1x = c0x + _HALF, c1x + _HALF
            else:
                _, (tx0, ty0, tx1, ty1) = _clip_line(w, h, xa, ya, xb, yb)
                if ty0 != ty1:
                    c0x, c0y, c1x, c1y = tx0 << XY_SHIFT, ty0, tx1 << XY_SHIFT, ty1
            if ya == yb:
                continue
            dx = _tdiv(c1x - c0x, c1y - c0y)
            starts.append(c0x + (ya - c0y) * dx if ya < yb else c1x + (yb - c1y) * dx)
            slopes.append(dx)
            y0s.append(min(ya, yb))
            y1s.append(max(ya, yb))
    if len(starts) < 2:
        return img
    x0, dx = np.array(starts, np.int64), np.array(slopes, np.int64)
    y0, y1 = np.array(y0s, np.int64), np.array(y1s, np.int64)
    rows = np.arange(max(int(y0.min()), 0), min(int(y1.max()), h), dtype=np.int64)
    if not len(rows):
        return img
    active = (rows[:, None] >= y0[None]) & (rows[:, None] < y1[None])
    x = np.where(active, x0[None] + (rows[:, None] - y0[None]) * dx[None], np.iinfo(np.int64).max)
    x = np.sort(x, axis=1)
    n_active = active.sum(1)
    for k in range(0, x.shape[1] - 1, 2):
        on = n_active > k
        _hspans(img, rows[on], (x[on, k] + _HALF - 1) >> XY_SHIFT,
                (x[on, k + 1] - _HALF) >> XY_SHIFT, color)
    return img


# cv2's table of sines at whole degrees 0..450, as drawing.cpp spells them
# (seven decimals, float)
_SIN_TABLE = np.round(np.sin(np.radians(np.arange(451))), 7).astype(np.float32)


def _ellipse_points(center, axes, angle: int, arc_start: int, arc_end: int, delta: int):
    """cv2's ``ellipse2Poly`` in double: [(x, y)] along the arc, every
    `delta` degrees, rotated by the whole-degree `angle` through the table."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start, arc_end = arc_start + 360, arc_end + 360
    while arc_end > 360:
        arc_start, arc_end = arc_start - 360, arc_end - 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    alpha, beta = float(_SIN_TABLE[450 - angle]), float(_SIN_TABLE[angle])
    pts = []
    for i in range(arc_start, arc_end + delta, delta):
        a = min(i, arc_end)
        if a < 0:
            a += 360
        x = axes[0] * float(_SIN_TABLE[450 - a])
        y = axes[1] * float(_SIN_TABLE[a])
        pts.append((center[0] + x * alpha - y * beta, center[1] + x * beta + y * alpha))
    if len(pts) == 1:
        pts = [tuple(center)] * 2
    return pts


def ellipse(img: np.ndarray, center, axes, angle: float, start: float, end: float, color,
            thickness: int = 1) -> np.ndarray:
    """cv2.ellipse(img, center, axes, angle, start, end, color, thickness)
    (LINE_8), in place: the angles rounded to whole degrees (half to even,
    cvRound), the arc as cv2's polygon in 16.16 fixed point, filled by
    ``FillConvexPoly`` for a negative thickness and a full turn, else its
    outline, each side rounded to whole pixels (thickness 1; a thicker
    outline is not ported)."""
    ang, a0, a1 = (int(np.rint(v)) for v in (angle, start, end))
    c = (float(int(center[0]) << XY_SHIFT), float(int(center[1]) << XY_SHIFT))
    ax = (abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT)
    big = (max(ax) + _HALF) >> XY_SHIFT
    delta = 90 if big < 3 else 30 if big < 10 else 18 if big < 15 else 5
    v, prev = [], None
    for px, py in _ellipse_points(c, (float(ax[0]), float(ax[1])), ang, a0, a1, delta):
        qx = int(np.rint(px / XY_ONE)) << XY_SHIFT
        qy = int(np.rint(py / XY_ONE)) << XY_SHIFT
        q = (qx + int(np.rint(px - qx)), qy + int(np.rint(py - qy)))
        if q != prev:
            v.append(q)
            prev = q
    if len(v) == 1:
        v = [(int(c[0]), int(c[1]))] * 2
    if thickness < 0 and abs(a1 - a0) >= 360:
        _fill_convex(img, np.array(v, np.int64), color, XY_SHIFT)
    elif thickness <= 1:
        for p, q in zip(v[:-1], v[1:]):
            _line_rounded(img, p, q, color)
    else:
        raise NotImplementedError("an ellipse outline thicker than 1 is not ported")
    return img


def add_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray, beta: float,
                 gamma: float) -> np.ndarray:
    """cv2.addWeighted of two uint8 images: src1 * alpha + (src2 * beta +
    gamma) in float32 with fused multiply-adds, rounded half to even and
    saturated."""
    a, b = np.float32(alpha), np.float32(beta)
    inner = (src2.astype(np.float64) * np.float64(b) + np.float64(np.float32(gamma))).astype(
        np.float32)
    out = (src1.astype(np.float64) * np.float64(a) + inner.astype(np.float64)).astype(np.float32)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _gaussian_taps_u8(ksize: int, sigma: float) -> np.ndarray:
    """cv2's bit-exact Gaussian kernel for 8-bit images: the float64
    kernel normalised to sum 1, each tap rounded half to even to 8
    fractional bits (``ufixedpoint16``)."""
    half = (ksize - 1) // 2
    xs = np.arange(1 - ksize, 0, 2, dtype=np.float64)  # 2 * (i - half), i < half
    t = np.exp(xs * xs * (-0.125 / (sigma * sigma)))
    total = 2.0 * t.sum() + 1.0
    taps = np.concatenate([t, [1.0], t[::-1]]) * (1.0 / total)
    return np.rint(taps * 256.0).astype(np.int64)


def _symmetric_pass(x: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    """Correlate int32 `x` with symmetric integer `taps` along `axis`,
    reflect-101 borders (cv2's BORDER_DEFAULT); exact."""
    r = len(taps) // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (r, r)
    xp = np.pad(x, pad, mode="reflect")
    n = x.shape[axis]

    def tap(i):
        return xp[(slice(None),) * axis + (slice(i, i + n),)]

    out = taps[r] * tap(r)
    for i in range(r):
        if taps[i]:
            out += taps[i] * (tap(i) + tap(2 * r - i))
    return out


def gaussian_blur_u8(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), sigma) of a uint8 [H, W(, C)] image:
    ksize round(6 sigma + 1) | 1, reflect-101 borders, cv2's 8-bit fixed
    point: the row pass exact in 1/256 units, the column pass rounded once,
    (sum + 2^15) >> 16."""
    ksize = int(np.rint(sigma * 3 * 2 + 1)) | 1
    k = _gaussian_taps_u8(ksize, sigma).astype(np.int32)
    both = _symmetric_pass(_symmetric_pass(img.astype(np.int32), k, 1), k, 0)
    return np.clip((both + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def _circle_offsets(radius: int):
    """(dy, dx) of cv2's filled Circle of `radius`: the midpoint walk, one
    horizontal span per step."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    ys, xs = [], []
    while dx >= dy:
        for y, half in ((-dy, dx), (dy, dx), (-dx, dy), (dx, dy)):
            xs.append(np.arange(-half, half + 1))
            ys.append(np.full(2 * half + 1, y))
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return np.concatenate(ys), np.concatenate(xs)


@functools.lru_cache(maxsize=64)
def _circle_outline(radius: int):
    """(dy, dx) of cv2's Circle outline of `radius` (thickness 1): the ends
    of the filled circle's spans, the same midpoint walk."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    pts = []
    while dx >= dy:
        pts += [(-dy, -dx), (-dy, dx), (dy, -dx), (dy, dx),
                (-dx, -dy), (-dx, dy), (dx, -dy), (dx, dy)]
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    a = np.array(pts, np.int64)
    return a[:, 0], a[:, 1]


def line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """cv2.line(img, p1, p2, color, thickness) with LINE_8, in place: cv2's
    ``ThickLine``. Thickness 1 is ``Line``; a thicker line is clipped to the
    image grown by the thickness on each side, then drawn as the band
    ``FillConvexPoly`` fills between the end points offset by the half
    width, rounded to 16.16 fixed point, and a filled circle of radius
    (thickness + 1) // 2 at each end."""
    p1 = (int(p1[0]), int(p1[1]))
    p2 = (int(p2[0]), int(p2[1]))
    if thickness <= 1:
        _line_int(img, p1, p2, color)
        return img
    # cv2 5.0 first clips the line to the image grown by the thickness (measured)
    h, w = img.shape[:2]
    t = int(thickness)
    ok, (xa, ya, xb, yb) = _clip_line(w + 2 * t, h + 2 * t, p1[0] + t, p1[1] + t,
                                      p2[0] + t, p2[1] + t)
    if not ok:
        return img
    p1, p2 = (xa - t, ya - t), (xb - t, yb - t)
    x0, y0, x1, y1 = (v << XY_SHIFT for v in (*p1, *p2))
    dx, dy = (x0 - x1) / XY_ONE, (y1 - y0) / XY_ONE
    r2 = dx * dx + dy * dy
    if abs(r2) > np.finfo(np.float64).eps:
        r = ((thickness << (XY_SHIFT - 1)) + (thickness & 1) * XY_ONE * 0.5) / np.sqrt(r2)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(img, np.array([[x0 + dpx, y0 + dpy], [x0 - dpx, y0 - dpy],
                                    [x1 - dpx, y1 - dpy], [x1 + dpx, y1 + dpy]], np.int64),
                     color, XY_SHIFT)
    dy_c, dx_c = _circle_offsets(((thickness << (XY_SHIFT - 1)) + _HALF) >> XY_SHIFT)
    for cx, cy in (p1, p2):
        _paint(img, dy_c + cy, dx_c + cx, color)
    return img


def rectangle(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """cv2.rectangle(img, p1, p2, color, thickness), in place: the closed
    outline p1, (p2.x, p1.y), p2, (p1.x, p2.y), or filled for thickness < 0."""
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    if thickness < 0:
        h, w = img.shape[:2]
        ya, yb = max(min(y1, y2), 0), min(max(y1, y2), h - 1)
        xa, xb = max(min(x1, x2), 0), min(max(x1, x2), w - 1)
        if ya <= yb and xa <= xb:
            ys, xs = np.mgrid[ya : yb + 1, xa : xb + 1]
            _paint(img, ys.ravel(), xs.ravel(), color)
        return img
    pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    for i in range(4):
        line(img, pts[i - 1], pts[i], color, thickness)
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = 1) -> np.ndarray:
    """cv2.circle(img, center, radius, color, thickness), in place: filled
    for a negative thickness, else the outline (see the module's note)."""
    cx, cy = int(center[0]), int(center[1])
    if thickness < 0 or thickness == 1:
        dy, dx = (_circle_offsets if thickness < 0 else _circle_outline)(int(radius))
        _paint(img, dy + cy, dx + cx, color)
        return img
    delta = 90 if radius < 3 else 30 if radius < 10 else 18 if radius < 15 else 5
    ang = np.radians(np.arange(0, 360 + delta, delta))
    pts = np.stack([cx + radius * np.cos(ang), cy + radius * np.sin(ang)], -1)
    return polylines(img, [_round_half_up(pts)], False, color, thickness)


def polylines(img: np.ndarray, pts_list, closed: bool, color, thickness: int = 1) -> np.ndarray:
    """cv2.polylines(img, pts_list, closed, color, thickness), in place."""
    for pts in pts_list:
        p = np.asarray(pts).reshape(-1, 2)
        segs = list(zip(p[:-1], p[1:])) + ([(p[-1], p[0])] if closed and len(p) > 1 else [])
        for a, b in segs or [(p[0], p[0])]:
            line(img, a, b, color, thickness)
    return img


def draw_contours(img: np.ndarray, contours, color, thickness: int = 1) -> np.ndarray:
    """cv2.drawContours(img, contours, -1, color, thickness) for a
    non-negative thickness: each contour as a closed polyline. At thickness
    2, contours whose sides are all horizontal, vertical or diagonal runs
    (those of ``contours.find_external_contours``) are drawn at once: each
    run pixel widened by the plus of the radius-1 round cap, and a diagonal
    run's pixels also by their two neighbours across the run (what
    ``line``'s band gives a diagonal side)."""
    fast = []
    for c in contours:
        p = np.asarray(c, np.int64).reshape(-1, 2)
        d = np.roll(p, -1, axis=0) - p
        if thickness == 2 and len(p) and np.all(
                (d[:, 0] == 0) | (d[:, 1] == 0) | (np.abs(d[:, 0]) == np.abs(d[:, 1]))):
            fast.append((p, d))
        else:
            polylines(img, [p], True, color, thickness)
    if not fast:
        return img
    p = np.concatenate([f[0] for f in fast])
    d = np.concatenate([f[1] for f in fast])
    n = np.abs(d).max(1) + 1  # the pixels of each run, both end points included
    k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    xs = np.repeat(p[:, 0], n) + k * np.repeat(np.sign(d[:, 0]), n)
    ys = np.repeat(p[:, 1], n) + k * np.repeat(np.sign(d[:, 1]), n)
    slope = np.repeat(np.sign(d[:, 0]) * np.sign(d[:, 1]), n)  # +1 or -1 on a diagonal run
    dy, dx = _circle_offsets(1)
    _paint(img, (ys[:, None] + dy).ravel(), (xs[:, None] + dx).ravel(), color)
    on = slope != 0
    for sy in (1, -1):  # (dy, dx) = (sy, -sy * slope)
        _paint(img, ys[on] + sy, xs[on] - sy * slope[on], color)
    return img


def put_text_top(img: np.ndarray, text: str, pos, color, size: int = 16) -> np.ndarray:
    """Text with its top-left corner at `pos` and a black shadow one pixel
    down and right, as the JAX package draws its labels with PIL's
    DejaVuSans at `size` px (cap height 0.75 of it, 3/16 of it below the
    top)."""
    cap = int(round(0.75 * size))
    base = int(pos[1]) + int(round(15 * size / 16))
    scale = cap / _HERSHEY_CAP
    put_text(img, text, (int(pos[0]) + 1, base + 1), scale, (0, 0, 0))
    return put_text(img, text, (int(pos[0]), base), scale, color)


def put_text(img: np.ndarray, text: str, org, scale: float, color) -> np.ndarray:
    """cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, scale, color, 1)
    with the bitmap font, in place; `org` is the left end of the baseline."""
    # the cap height of FONT_HERSHEY_SIMPLEX at `scale`, in pixels
    cap = max(int(round(_HERSHEY_CAP * scale)), _BODY_ROWS // 2)
    colw = cap / _BODY_ROWS * _COL_ASPECT
    x = float(org[0])
    top = int(org[1]) - cap
    for ch in text:
        ys, xs, gw = _scaled_glyph(ch, cap, colw)
        _paint(img, ys + top, xs + int(round(x)), color)
        x += gw + max(1, int(round(colw)))
    return img


@functools.lru_cache(maxsize=4096)
def _scaled_glyph(ch: str, cap: int, colw: float):
    """(rows, cols) of the inked pixels of `ch` at cap height `cap` and
    column width `colw` (nearest-neighbour scaling), and its width."""
    g = _glyph(ch)
    rows = cap + int(round(2 * cap / _BODY_ROWS))
    src_row = np.minimum((np.arange(rows) * _BODY_ROWS) // cap, _BODY_ROWS + 1)
    gw = int(np.ceil(g.shape[1] * colw))
    src_col = np.minimum((np.arange(gw) / colw).astype(np.int64), g.shape[1] - 1)
    ys, xs = np.nonzero(g[src_row][:, src_col]) if ch != " " else (np.zeros(0, np.int64),) * 2
    return ys, xs, gw
