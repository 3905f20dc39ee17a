"""Drawing primitives in numpy: the OpenCV calls the molecule renderer makes.

``molnextr_tpu/chem/render.py`` draws with ``cv2.line(..., LINE_AA)``,
``cv2.fillPoly``, a filled ``cv2.rectangle``, ``cv2.getTextSize`` and
``cv2.putText(..., LINE_AA)``.  This module reproduces each of them on
uint8 (H, W, 3) images, pixel for pixel, following OpenCV's own
fixed-point algorithms (``imgproc/src/drawing.cpp``):

* :func:`line` — thickness 1 is OpenCV's ``LineAA``: a 16.16 fixed-point
  walk along the major axis that blends three pixels per step with weights
  from ``FILTER_TABLE``, scaled by the slope correction ``SLOPE_CORR`` and
  an end-point table.  Thicker lines are ``ThickLine``: a quadrilateral
  through :func:`fill_convex_poly` in its anti-aliased form (``LineAA``
  edges, solid interior) and a round cap at each end, which at these
  radii is ``ellipse2Poly``'s four-point polygon.
* :func:`fill_poly` — ``fillPoly`` with 8-connected edges: Bresenham
  outlines and a scanline fill between edge crossings.
* :func:`fill_rect` — the filled ``rectangle``, inclusive of both corners.
* :func:`text_size` / :func:`put_text` — OpenCV 5 draws the Hershey font
  ids with its built-in outline font: ids 0, 3 and 1 at weight 400, ids 2
  and 4 at 600, at pixel size ``round(scale / 0.037)`` (id 1:
  ``round(scale / 0.066)``).  Each glyph has an integer advance at each
  size (its own box's width less one); a string's box is ``1 +`` the sum
  of its advances wide and ``size`` high.  The glyphs' coverage and
  advances come from ``glyphs.npz`` beside this module (pixel sizes 6-24,
  printable ASCII; other characters draw as ``?``, as OpenCV draws them);
  each glyph is blended onto the image in turn as
  ``(bg * (255 - a) + fg * a + 127) // 255``.

The two tables are OpenCV's ``FilterTable`` and ``SlopeCorrTable``.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

FILTER_TABLE = np.array([
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252, 254, 254,
    254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202, 194, 185, 177, 168,
    158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75, 68, 62, 56, 50, 45,
    40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8, 7, 5, 5,
], np.int64)
SLOPE_CORR = (
    181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196, 198, 201,
    203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238, 242, 246, 250, 254,
)

# Hershey font id -> (weight, divisor of the scale that gives the pixel size)
FONT_STYLE = {0: (400, 0.037), 1: (400, 0.066), 2: (600, 0.037), 3: (400, 0.037),
              4: (600, 0.037)}
GLYPHS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "glyphs.npz")


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(width: int, height: int, p1, p2):
    """OpenCV's ``clipLine`` -> clipped (p1, p2), or None if outside."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return None

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def line_aa(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's ``LineAA`` between 16.16 fixed-point points."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    major_x = ax > ay
    if major_x:
        if dx < 0:  # walk left to right
            x1, x2, y1, y2, dy = x2, x1, y2, y1, -dy
        step = _cdiv(dy << XY_SHIFT, ax | 1)
        x2 += XY_ONE
        ecount = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
        j = -(x1 & (XY_ONE - 1))
        y1 += ((step * j) >> XY_SHIFT) + (XY_ONE >> 1)
        i, j = (x1 >> (XY_SHIFT - 7)) & 0x78, (x2 >> (XY_SHIFT - 7)) & 0x78
        major0, minor0 = x1 >> XY_SHIFT, y1
    else:
        if dy < 0:  # walk top to bottom
            x1, x2, y1, y2, dx = x2, x1, y2, y1, -dx
        step = _cdiv(dx << XY_SHIFT, ay | 1)
        y2 += XY_ONE
        ecount = (y2 >> XY_SHIFT) - (y1 >> XY_SHIFT)
        j = -(y1 & (XY_ONE - 1))
        x1 += ((step * j) >> XY_SHIFT) + (XY_ONE >> 1)
        i, j = (y1 >> (XY_SHIFT - 7)) & 0x78, (y2 >> (XY_SHIFT - 7)) & 0x78
        major0, minor0 = y1 >> XY_SHIFT, x1
    slope = (step >> (XY_SHIFT - 5)) & 0x3F
    slope ^= 0x3F if step < 0 else 0
    slope = 0x100 if slope & 0x20 else SLOPE_CORR[slope]
    t0, t1, t2 = slope << 7, ((0x78 - i) | 4) * slope, (j | 4) * slope
    ep_table = np.array([
        0,
        ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF,
        (t1 >> 8) & 0x1FF,
        ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF,
        ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1FF,
        ((t1 + t0) >> 8) & 0x1FF,
        (t2 >> 8) & 0x1FF,
        ((t2 + t0) >> 8) & 0x1FF,
        slope,
    ], np.int64)

    k = np.arange(ecount + 1, dtype=np.int64)
    ep = ep_table[np.minimum(k, 2) * 3 + np.minimum(ecount - k, 2)]
    minor = minor0 + k * step
    dist = (minor >> (XY_SHIFT - 5)) & 31
    # three pixels across the line per step; no pixel is visited twice
    major = np.repeat(major0 + k, 3)
    across = (((minor >> XY_SHIFT) - 1)[:, None] + np.arange(3)).reshape(-1)
    weight = FILTER_TABLE[np.stack([dist + 32, dist, 63 - dist], 1)].reshape(-1)
    a = ((np.repeat(ep, 3) * weight) >> 8) & 0xFF
    size_major, size_minor = (w, h) if major_x else (h, w)
    m = (major >= 0) & (major < size_major) & (across >= 0) & (across < size_minor)
    ys, xs = (across[m], major[m]) if major_x else (major[m], across[m])
    a = a[m][:, None]
    col = np.asarray(color, np.int64)[: img.shape[2]]
    px = img[ys, xs].astype(np.int64)
    px += ((col - px) * a + 127) >> 8
    px += ((col - px) * a + 127) >> 8
    img[ys, xs] = px


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    w = img.shape[1]
    if x2 >= 0 and x1 < w:
        img[y, max(x1, 0) : min(x2, w - 1) + 1] = color[: img.shape[2]]


def fill_convex_poly(img: np.ndarray, pts: Sequence[Tuple[int, int]], color,
                     aa: bool = True) -> None:
    """OpenCV's ``FillConvexPoly`` on 16.16 fixed-point points: with
    ``LINE_AA`` (``aa``) anti-aliased edges (``LineAA``), else ``LINE_8``
    edges (``Line2``), then a solid interior, whose rows ``LINE_8`` rounds
    to the nearest pixel at both ends."""
    h, w = img.shape[:2]
    v = [(int(x), int(y)) for x, y in pts]
    npts = len(v)
    delta = XY_ONE >> 1
    delta1, delta2 = (XY_ONE - 1, 0) if aa else (delta, delta)
    p0 = v[-1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for idx, p in enumerate(v):
        x, y = p
        if y < ymin:
            ymin, imin = y, idx
        ymax, xmax, xmin = max(ymax, y), max(xmax, x), min(xmin, x)
        (line_aa if aa else _line2)(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": npts - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    edges = npts
    y = ymin
    while True:
        if not aa or y < ymax or y == ymin:
            for e in edge:
                if y < e["ye"]:
                    continue
                idx0 = e["idx"]
                idx = idx0 + e["di"]
                if idx >= npts:
                    idx -= npts
                while True:
                    more = edges > 0
                    edges -= 1
                    if not more:
                        break
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx += e["di"]
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0]["x"] > edge[1]["x"] else (edge[0], edge[1])
            _hline(img, y, (left["x"] + delta1) >> XY_SHIFT, (right["x"] + delta2) >> XY_SHIFT,
                   color)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


# a round cap of a line up to 5 px thick touches pixels at most this far
# from its centre (radius 2.5 plus LineAA's three-pixel spread)
_CAP_REACH = 4
_CAP_ROWS, _CAP_COLS = np.indices((2 * _CAP_REACH + 1, 2 * _CAP_REACH + 1))


def _draw_round_cap(img: np.ndarray, center, radius: int, color) -> None:
    """``EllipseEx`` filled, for radii under 3 px: ``ellipse2Poly`` steps
    90 degrees, so the cap is a four-point polygon."""
    if (radius + (XY_ONE >> 1)) >> XY_SHIFT >= 3:
        raise ValueError("round caps are drawn for lines up to 5 px thick")
    cx, cy = center
    ring = [(cx + radius, cy), (cx, cy + radius), (cx - radius, cy), (cx, cy - radius),
            (cx + radius, cy)]
    pts = []
    for p in ring:
        if not pts or pts[-1] != p:
            pts.append(p)
    fill_convex_poly(img, pts, color)


@functools.lru_cache(maxsize=None)
def _cap_table(radius: int, value: int) -> np.ndarray:
    """What one cap of colour ``value`` centred on a pixel makes of each
    grey level around it: (2R+1, 2R+1, 256) uint8, R = ``_CAP_REACH``.
    Each channel blends on its own, so a canvas whose 256 channels start at
    0..255 records every level at once."""
    n = 2 * _CAP_REACH + 3
    canvas = np.tile(np.arange(256, dtype=np.uint8), (n, n, 1))
    c = (_CAP_REACH + 1) << XY_SHIFT
    _draw_round_cap(canvas, (c, c), radius, np.full(256, value, np.int64))
    assert (canvas[[0, -1]] == np.arange(256)).all() and (canvas[:, [0, -1]] == np.arange(256)).all()
    table = canvas[1:-1, 1:-1]
    table.setflags(write=False)
    return table


def _round_cap(img: np.ndarray, center, radius: int, color) -> None:
    """The cap at an integer centre, from :func:`_cap_table` where it lies
    inside the image, else drawn."""
    h, w = img.shape[:2]
    cx, cy = center[0] >> XY_SHIFT, center[1] >> XY_SHIFT
    r = _CAP_REACH
    if (center[0] | center[1]) & (XY_ONE - 1) or not (r <= cx < w - r and r <= cy < h - r):
        _draw_round_cap(img, center, radius, color)
        return
    patch = img[cy - r : cy + r + 1, cx - r : cx + r + 1]
    for ch in range(img.shape[2]):
        patch[..., ch] = _cap_table(radius, int(color[ch]))[_CAP_ROWS, _CAP_COLS, patch[..., ch]]


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> None:
    """``cv2.line(img, pt1, pt2, color, thickness, cv2.LINE_AA)`` on
    integer points.  A thick line is first clipped to the image grown by
    ``thickness`` on every side, as OpenCV clips it."""
    p0 = (int(pt1[0]) << XY_SHIFT, int(pt1[1]) << XY_SHIFT)
    p1 = (int(pt2[0]) << XY_SHIFT, int(pt2[1]) << XY_SHIFT)
    if thickness <= 1:
        line_aa(img, p0, p1, color)
        return
    h, w = img.shape[:2]
    m = thickness
    clipped = _clip_line(w + 2 * m, h + 2 * m, (int(pt1[0]) + m, int(pt1[1]) + m),
                         (int(pt2[0]) + m, int(pt2[1]) + m))
    if clipped is None:
        return
    (x0, y0), (x1, y1) = clipped
    p0 = ((x0 - m) << XY_SHIFT, (y0 - m) << XY_SHIFT)
    p1 = ((x1 - m) << XY_SHIFT, (y1 - m) << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / np.sqrt(r)
        ddx, ddy = int(np.rint(dy * r)), int(np.rint(dx * r))
        quad = [(p0[0] + ddx, p0[1] + ddy), (p0[0] - ddx, p0[1] - ddy),
                (p1[0] - ddx, p1[1] - ddy), (p1[0] + ddx, p1[1] + ddy)]
        fill_convex_poly(img, quad, color)
    _round_cap(img, p0, half, color)
    _round_cap(img, p1, half, color)


def _line8(img: np.ndarray, pt1, pt2, color) -> None:
    """OpenCV's 8-connected ``Line`` (its ``LineIterator``, left to right)."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = pt1, pt2
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, pt1, pt2)
        if clipped is None:
            return
        (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    n = dx + 1
    xs, ys = np.empty(n, np.int64), np.empty(n, np.int64)
    x, y = x1, y1
    for k in range(n):
        xs[k], ys[k] = x, y
        if err < 0:
            err += 2 * dx - 2 * dy
            x, y = (x + sx, y + sy)
        else:
            err -= 2 * dy
            if vert:
                y += sy
            else:
                x += sx
    img[ys, xs] = np.asarray(color)[: img.shape[2]]


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's ``Line2``: an 8-connected line between 16.16 fixed-point
    points, one pixel per step of the major axis plus the rounded end."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    major_x = abs(dx) > abs(dy)
    if major_x:
        if dx < 0:
            x1, x2, y1, y2, dy = x2, x1, y2, y1, -dy
        x_step, y_step = XY_ONE, _cdiv(dy << XY_SHIFT, abs(dx) | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            x1, x2, y1, y2, dx = x2, x1, y2, y1, -dx
        x_step, y_step = _cdiv(dx << XY_SHIFT, abs(dy) | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    half = XY_ONE >> 1
    k = np.arange(max(ecount + 1, 0), dtype=np.int64)
    if major_x:
        xs, ys = ((x1 + half) >> XY_SHIFT) + k, (y1 + half + k * y_step) >> XY_SHIFT
    else:
        xs, ys = (x1 + half + k * x_step) >> XY_SHIFT, ((y1 + half) >> XY_SHIFT) + k
    xs = np.append(xs, (x2 + half) >> XY_SHIFT)
    ys = np.append(ys, (y2 + half) >> XY_SHIFT)
    m = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[m], xs[m]] = np.asarray(color)[: img.shape[2]]


def _fill_circle(img: np.ndarray, center, radius: int, color) -> None:
    """OpenCV's filled ``Circle`` (the cap of a ``LINE_8`` thick line): the
    midpoint walk, a row of pixels per octant pair."""
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    h = img.shape[0]
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy), (cy + dx, dy)):
            if 0 <= y < h:
                _hline(img, y, cx - half, cx + half, color)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line8(img: np.ndarray, p0, p1, color, thickness: int, caps: Tuple[bool, bool]):
    """``ThickLine`` with ``LINE_8`` between 16.16 points: a quadrilateral
    through :func:`fill_convex_poly` and a filled circle at each end that
    ``caps`` asks for."""
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + (thickness & 1) * XY_ONE * 0.5) / np.sqrt(r)
        ddx, ddy = int(np.rint(dy * r)), int(np.rint(dx * r))
        quad = [(p0[0] + ddx, p0[1] + ddy), (p0[0] - ddx, p0[1] - ddy),
                (p1[0] - ddx, p1[1] - ddy), (p1[0] + ddx, p1[1] + ddy)]
        fill_convex_poly(img, quad, color, aa=False)
    radius = (half + (XY_ONE >> 1)) >> XY_SHIFT
    for p, cap in zip((p0, p1), caps):
        if cap:
            _fill_circle(img, ((p[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                               (p[1] + (XY_ONE >> 1)) >> XY_SHIFT), radius, color)


def line8(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> None:
    """``cv2.line(img, pt1, pt2, color, thickness)`` (``LINE_8``) on integer
    points: at thickness 1 OpenCV's ``LineIterator`` walk, clipped to the
    image; thicker, the line clipped to the image grown by ``thickness``,
    then :func:`_thick_line8` with both caps."""
    if thickness <= 1:
        _line8(img, (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1])), color)
        return
    h, w = img.shape[:2]
    m = thickness
    clipped = _clip_line(w + 2 * m, h + 2 * m, (int(pt1[0]) + m, int(pt1[1]) + m),
                         (int(pt2[0]) + m, int(pt2[1]) + m))
    if clipped is None:
        return
    (x0, y0), (x1, y1) = clipped
    _thick_line8(img, ((x0 - m) << XY_SHIFT, (y0 - m) << XY_SHIFT),
                 ((x1 - m) << XY_SHIFT, (y1 - m) << XY_SHIFT), color, thickness, (True, True))


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> None:
    """``cv2.rectangle(img, pt1, pt2, color, thickness)`` (``LINE_8``,
    outline): the closed polyline through the four corners, each side
    capped at its end only, as OpenCV's ``PolyLine`` draws it."""
    (xa, ya), (xb, yb) = (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1]))
    corners = [(xa, ya), (xb, ya), (xb, yb), (xa, yb)]
    p0 = corners[-1]
    for p in corners:
        if thickness <= 1:
            _line8(img, p0, p, color)
        else:
            _thick_line8(img, (p0[0] << XY_SHIFT, p0[1] << XY_SHIFT),
                         (p[0] << XY_SHIFT, p[1] << XY_SHIFT), color, thickness, (False, True))
        p0 = p


def fill_poly(img: np.ndarray, pts: Sequence[Tuple[int, int]], color) -> None:
    """``cv2.fillPoly(img, [pts], color)`` for one integer contour: its
    8-connected outline, then each row filled between the crossings of its
    edges (pixel-equal to OpenCV while the contour lies inside the image)."""
    h, w = img.shape[:2]
    v = [(int(x), int(y)) for x, y in pts]
    edges = []
    x0, y0 = v[-1]
    for x1, y1 in v:
        t0, t1 = (x0, y0), (x1, y1)
        _line8(img, t0, t1, color)
        e0 = [x0 << XY_SHIFT, y0]
        e1 = [x1 << XY_SHIFT, y1]
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
            clipped = _clip_line(w, h, t0, t1)
            if clipped is not None and clipped[0][1] != clipped[1][1]:
                (cx0, cy0), (cx1, cy1) = clipped
                e0, e1 = [cx0 << XY_SHIFT, cy0], [cx1 << XY_SHIFT, cy1]
        if y0 != y1:
            dx = _cdiv(e1[0] - e0[0], e1[1] - e0[1])
            if y0 < y1:
                edges.append((y0, y1, e0[0] + (y0 - e0[1]) * dx, dx))
            else:
                edges.append((y1, y0, e1[0] + (y1 - e1[1]) * dx, dx))
        x0, y0 = x1, y1
    if len(edges) < 2:
        return
    ymin = min(e[0] for e in edges)
    ymax = min(max(e[1] for e in edges), h)
    for y in range(max(ymin, 0), ymax):
        xs = sorted(x + (y - ey0) * dx for ey0, ey1, x, dx in edges if ey0 <= y < ey1)
        for xa, xb in zip(xs[0::2], xs[1::2]):
            _hline(img, y, (xa + XY_ONE - 1) >> XY_SHIFT, xb >> XY_SHIFT, color)


def fill_rect(img: np.ndarray, pt1, pt2, color) -> None:
    """``cv2.rectangle(img, pt1, pt2, color, -1)`` on integer corners."""
    h, w = img.shape[:2]
    xa, xb = sorted((int(pt1[0]), int(pt2[0])))
    ya, yb = sorted((int(pt1[1]), int(pt2[1])))
    xa, ya, xb, yb = max(xa, 0), max(ya, 0), min(xb, w - 1), min(yb, h - 1)
    if xa <= xb and ya <= yb:
        img[ya : yb + 1, xa : xb + 1] = np.asarray(color)[: img.shape[2]]


# -- text ----------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _glyph_table() -> Dict[Tuple[int, int, str], Tuple[int, int, int, np.ndarray]]:
    """(weight, size, char) -> (advance, x0, y0, coverage (h, w) uint8)."""
    with np.load(GLYPHS_PATH) as f:
        index, pixels = f["index"], f["pixels"]
    table = {}
    for weight, size, code, adv, x0, y0, gh, gw, off in index.tolist():
        cov = pixels[off : off + gh * gw].reshape(gh, gw)
        table[(weight, size, chr(code))] = (adv, x0, y0, cov)
    return table


def font_size(font: int, scale: float) -> Tuple[int, int]:
    """Hershey font id and scale -> (weight, pixel size)."""
    weight, unit = FONT_STYLE[font]
    return weight, int(np.floor(scale / unit + 0.5))


def _glyphs(text: str, font: int, scale: float):
    weight, size = font_size(font, scale)
    table = _glyph_table()
    out = []
    for ch in text:
        key = (weight, size, ch if 32 <= ord(ch) < 127 else "?")
        if key not in table:
            raise ValueError(f"no glyph table for font {font} at scale {scale} (size {size})")
        out.append(table[key])
    return size, out


def text_size(text: str, font: int, scale: float, thickness: int = 1) -> Tuple[int, int]:
    """``cv2.getTextSize(text, font, scale, 1)[0]``: (width, height)."""
    if thickness != 1:
        raise ValueError("labels are drawn at thickness 1")
    size, glyphs = _glyphs(text, font, scale)
    return 1 + sum(g[0] for g in glyphs), size


def put_text(img: np.ndarray, text: str, org, font: int, scale: float, color) -> None:
    """``cv2.putText(img, text, org, font, scale, color, 1, cv2.LINE_AA)``."""
    h, w = img.shape[:2]
    _, glyphs = _glyphs(text, font, scale)
    col = np.asarray(color, np.int64)[: img.shape[2]]
    pen_x, pen_y = int(org[0]), int(org[1])
    for adv, x0, y0, cov in glyphs:
        gx, gy = pen_x + x0, pen_y + y0
        pen_x += adv
        gh, gw = cov.shape
        xa, ya = max(gx, 0), max(gy, 0)
        xb, yb = min(gx + gw, w), min(gy + gh, h)
        if xa >= xb or ya >= yb:
            continue
        a = cov[ya - gy : yb - gy, xa - gx : xb - gx].astype(np.int64)[..., None]
        bg = img[ya:yb, xa:xb].astype(np.int64)
        img[ya:yb, xa:xb] = (bg * (255 - a) + col * a + 127) // 255
