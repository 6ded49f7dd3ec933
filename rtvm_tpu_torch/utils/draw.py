"""Numpy counterparts of the cv2 drawing calls on the driver's and the
navigation map's paths (the card has no cv2): ``line``, ``rectangle``,
``circle``, ``polylines``, ``draw_contours`` and ``put_text``, each drawing
in place on a [H, W, 3] uint8 image and returning it, as cv2 does.

- ``line`` at thickness 1 is cv2's ``LINE_8``: the same Bresenham walk from
  the left end point, pixel for pixel (for end points inside the image; cv2
  first clips a line that leaves it, this walks the whole line and drops the
  pixels outside). Thicker lines are cv2's shape, a band of half-width
  (thickness + 1) // 2 with round caps of that radius, filled as the pixels
  whose centre lies that close to the segment; cv2 fills a sub-pixel polygon
  and two circles, so a few edge pixels differ.
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


def _fill_convex(img: np.ndarray, pts: np.ndarray, color) -> None:
    """cv2's FillConvexPoly scan: each edge's x steps linearly between its
    end points' rounded rows; every row from the top's rounded row to the
    bottom's is filled from its rounded leftmost to its rounded rightmost x."""
    yr = _round_half_up(pts[:, 1])
    y0, y1 = int(yr.min()), min(int(yr.max()), img.shape[0] - 1)
    if y1 < max(y0, 0):
        return
    rows = np.arange(max(y0, 0), y1 + 1)
    lo = np.full(len(rows), np.inf)
    hi = np.full(len(rows), -np.inf)
    for i in range(len(pts)):
        (xa, _), (xb, _) = pts[i - 1], pts[i]
        ya, yb = yr[i - 1], yr[i]
        if ya > yb:
            xa, xb, ya, yb = xb, xa, yb, ya
        on = (rows >= ya) & (rows <= yb)
        x = xa + (rows[on] - ya) * ((xb - xa) / (yb - ya) if yb > ya else 0.0)
        lo[on] = np.minimum(lo[on], np.minimum(x, xb if yb == ya else x))
        hi[on] = np.maximum(hi[on], np.maximum(x, xb if yb == ya else x))
    ok = np.isfinite(lo)
    xl = np.maximum(_round_half_up(lo[ok]), 0)
    xr = np.minimum(_round_half_up(hi[ok]), img.shape[1] - 1)
    n = np.maximum(xr - xl + 1, 0)
    first = np.repeat(np.cumsum(n) - n, n)
    _paint(img, np.repeat(rows[ok], n), np.repeat(xl, n) + np.arange(int(n.sum())) - first, color)
    # and the outline, each edge walked at sub-pixel precision
    for i in range(len(pts)):
        (xa, ya), (xb, yb) = pts[i - 1], pts[i]
        if abs(xb - xa) >= abs(yb - ya):
            xs = np.arange(min(_round_half_up(xa), _round_half_up(xb)),
                           max(_round_half_up(xa), _round_half_up(xb)) + 1)
            t = np.clip((xs - xa) / (xb - xa), 0.0, 1.0) if xb != xa else np.zeros(len(xs))
            _paint(img, _round_half_up(ya + t * (yb - ya)), xs, color)
        else:
            ys = np.arange(min(_round_half_up(ya), _round_half_up(yb)),
                           max(_round_half_up(ya), _round_half_up(yb)) + 1)
            t = np.clip((ys - ya) / (yb - ya), 0.0, 1.0)
            _paint(img, ys, _round_half_up(xa + t * (xb - xa)), color)


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


def _fill_box(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color) -> None:
    h, w = img.shape[:2]
    x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w - 1), min(y1, h - 1)
    if x0 <= x1 and y0 <= y1:
        c = np.asarray(color, np.float64).reshape(-1)
        img[y0 : y1 + 1, x0 : x1 + 1] = c[: img.shape[2]] if img.ndim == 3 else c[0]


def line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """cv2.line(img, p1, p2, color, thickness) with LINE_8, in place."""
    p1 = (int(p1[0]), int(p1[1]))
    p2 = (int(p2[0]), int(p2[1]))
    if thickness <= 1:
        ys, xs = _line8(p1, p2)
        _paint(img, ys, xs, color)
        return img
    # cv2's ThickLine: a band of half-width (thickness + 1) // 2 whose corners
    # are rounded to 1/65536 px, then a round cap of that radius at each end
    half = (thickness + (thickness & 1)) // 2
    ex, ey = float(p1[0] - p2[0]), float(p2[1] - p1[1])
    n = np.hypot(ex, ey)
    if n > 0 and (ex == 0 or ey == 0):  # axis-aligned: the band is a box
        (xa, xb), (ya, yb) = sorted((p1[0], p2[0])), sorted((p1[1], p2[1]))
        if ey == 0:
            _fill_box(img, xa, ya - half, xb, yb + half, color)
        else:
            _fill_box(img, xa - half, ya, xb + half, yb, color)
    elif n > 0:
        dpx = np.rint(ey * half / n * 65536.0) / 65536.0
        dpy = np.rint(ex * half / n * 65536.0) / 65536.0
        quad = np.array([[p1[0] + dpx, p1[1] + dpy], [p1[0] - dpx, p1[1] - dpy],
                         [p2[0] - dpx, p2[1] - dpy], [p2[0] + dpx, p2[1] + dpy]])
        _fill_convex(img, quad, color)
    dy, dx = _circle_offsets((thickness + 1) // 2)
    for cx, cy in (p1, p2):
        _paint(img, dy + cy, dx + cx, color)
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
