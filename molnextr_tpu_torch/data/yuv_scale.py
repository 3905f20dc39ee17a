"""libyuv's plane scaler as libavif 1.4 calls it, in numpy, exact.

An AVIF image whose AV1 frame has another size than its ``ispe`` (or, in
an image sequence, its ``tkhd``) is rescaled by libavif's
``avifImageScaleWithLimit`` before it is converted to RGB: each plane
through libyuv's ``ScalePlane`` (8 bits) or ``ScalePlane_12`` (10 and 12
bits) with ``kFilterBox``.  :func:`scale_plane` is that call.

libyuv first reduces the filter (``ScaleFilterReduce``: box becomes
bilinear where either axis shrinks by half or less, bilinear becomes
linear where the height is kept, tripled down or one row, linear becomes
none where the width is kept, tripled down or one column), then takes the
first path that fits: a copy; rows only (``ScalePlaneVertical``); down by
3/4, 1/2, 3/8 or 1/4 (``ScalePlaneDown34/2/38/4``); a box average where
the box filter is left (``ScalePlaneBox``); up by two, linear or bilinear
(``ScalePlaneUp2_*``; ``ScalePlane_12`` tries its 12-bit ones first,
where no earlier path could fit); bilinear up or down
(``ScalePlaneBilinearUp/Down``); point sampling (``ScalePlaneSimple``).
Positions step in 16.16 fixed point from ``ScaleSlope``'s start and step.
From ``kFilterBox`` the fixed-ratio paths only ever see the bilinear
filter (3/4, 1/2) or the box (3/8, 1/4), so only those rows are here.

The rows are the ones OpenCV's build runs on x86: the 8-bit 3/4 and 3/8
boxes average rows before columns (``pavgb``) in their SSSE3 bodies, and
their ``Any`` wrappers run the C rows (columns first) on the last
``width % 24`` (3/4) or ``width % 6`` (3/8) pixels; 8-bit column filtering
weighs with 7 bits of the fraction; 8-bit box sums saturate at 65535 in
the AVX2 body (``width & ~31`` columns) and wrap in the C tail.  The 16-bit
rows are libyuv's C ones.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

NONE, LINEAR, BILINEAR, BOX = 0, 1, 2, 3  # libyuv's FilterMode
MAX_SOURCE = 16384  # libavif's limit on a side it hands libyuv


def filter_reduce(sw: int, sh: int, dw: int, dh: int, filtering: int) -> int:
    """``ScaleFilterReduce``."""
    if filtering == BOX and (dw * 2 >= sw or dh * 2 >= sh):
        filtering = BILINEAR
    if filtering == BILINEAR:
        if sh == 1 or dh == sh or dh * 3 == sh:
            filtering = LINEAR
        if sw == 1:
            filtering = NONE
    if filtering == LINEAR and (sw == 1 or dw == sw or dw * 3 == sw):
        filtering = NONE
    return filtering


def fixed_div(num: int, div: int) -> int:
    return (num << 16) // div


def fixed_div1(num: int, div: int) -> int:
    return ((num << 16) - 0x00010001) // (div - 1)


def _center(d: int, s: int) -> int:
    return (d >> 1) + s


def slope(sw: int, sh: int, dw: int, dh: int, filtering: int) -> Tuple[int, int, int, int]:
    """``ScaleSlope``: the 16.16 start (x, y) and step (dx, dy)."""
    x = y = dx = dy = 0
    if filtering == BOX:
        dx, dy = fixed_div(sw, dw), fixed_div(sh, dh)
    elif filtering in (BILINEAR, LINEAR):
        if dw <= sw:
            dx = fixed_div(sw, dw)
            x = _center(dx, -32768)
        elif sw > 1 and dw > 1:
            dx = fixed_div1(sw, dw)
        if filtering == LINEAR:
            dy = fixed_div(sh, dh)
            y = dy >> 1
        elif dh <= sh:
            dy = fixed_div(sh, dh)
            y = _center(dy, -32768)
        elif sh > 1 and dh > 1:
            dy = fixed_div1(sh, dh)
    else:
        dx, dy = fixed_div(sw, dw), fixed_div(sh, dh)
        x, y = _center(dx, 0), _center(dy, 0)
    return x, y, dx, dy


def scale_plane(src: np.ndarray, dw: int, dh: int, high: bool = False) -> np.ndarray:
    """``ScalePlane`` (``high`` False, uint8) or ``ScalePlane_12`` (uint16)
    of ``src`` to ``dh`` x ``dw`` with ``kFilterBox``, as libavif calls it."""
    sh, sw = src.shape
    out = _scale(src.astype(np.int64), dw, dh, filter_reduce(sw, sh, dw, dh, BOX), high)
    return out.astype(src.dtype)


def _scale(s: np.ndarray, dw: int, dh: int, f: int, high: bool) -> np.ndarray:
    """``ScalePlane`` / ``ScalePlane_16`` after the filter's reduction."""
    sh, sw = s.shape
    if (dw, dh) == (sw, sh):
        return s.copy()
    if dw == sw and f != BOX:
        return _vertical(s, dh, f)
    if dw <= sw and dh <= sh:
        if 4 * dw == 3 * sw and 4 * dh == 3 * sh:
            return _down34(s, dh, high)
        if 2 * dw == sw and 2 * dh == sh:
            return _down2(s)
        if 8 * dw == 3 * sw and 8 * dh == 3 * sh:
            return _down38(s, dh, high)
        if 4 * dw == sw and 4 * dh == sh and f in (BOX, NONE):
            return _down4(s)
    if f == BOX and dh * 2 < sh:
        return _box(s, dw, dh, high)
    if (dw + 1) // 2 == sw and f == LINEAR:
        return _up2_linear_rows(s, dw, dh)
    if (dh + 1) // 2 == sh and (dw + 1) // 2 == sw and f in (BILINEAR, BOX):
        return up2_bilinear(s, dw, dh)
    if f and dh > sh:
        return _bilinear_up(s, dw, dh, f, high)
    if f:
        return _bilinear_down(s, dw, dh, f, high)
    return _simple(s, dw, dh)


# ----- rows and columns ------------------------------------------------------

def _interpolate(a: np.ndarray, b: np.ndarray, f) -> np.ndarray:
    """``InterpolateRow``: ``b`` weighted ``f`` / 256 (a copy at 0, the
    rounded mean at 128, which the formula gives too)."""
    f = np.asarray(f)[..., None] if np.ndim(f) else f
    return (a * (256 - f) + b * f + 128) >> 8


def _filter_cols(rows: np.ndarray, dw: int, x: int, dx: int, high: bool) -> np.ndarray:
    """``ScaleFilterCols``: each output column between the source pixels at
    ``x >> 16`` and the next, by the fraction (``ScaleFilterCols_SSSE3``'s
    7 bits at 8 bits, ``ScaleFilterCols_16_C``'s 16 above)."""
    xs = x + np.arange(dw, dtype=np.int64) * dx
    xi = xs >> 16
    a = rows[..., xi]
    b = rows[..., np.minimum(xi + 1, rows.shape[-1] - 1)]
    frac = xs & 0xFFFF
    if high:
        return a + ((frac * (b - a) + 0x8000) >> 16)
    f7 = frac >> 9
    return ((128 - f7) * a + f7 * b + 64) >> 7


def up_linear(s: np.ndarray, w: int) -> np.ndarray:
    """``ScaleRowUp2_Linear_Any``: each output pixel 3:1 between the two
    nearest source samples, the first and last copied."""
    s = s.astype(np.int64)
    out = np.empty(s.shape[:-1] + (w,), np.int64)
    n = (w - 1) & ~1
    if n > 0:
        a, b = s[..., : n // 2], s[..., 1 : n // 2 + 1]
        out[..., 1 : n + 1 : 2] = (3 * a + b + 2) >> 2
        out[..., 2 : n + 1 : 2] = (a + 3 * b + 2) >> 2
    out[..., 0] = s[..., 0]
    out[..., w - 1] = s[..., (w - 1) // 2]
    return out


def up2_bilinear(s: np.ndarray, w: int, h: int) -> np.ndarray:
    """``ScalePlaneUp2_Bilinear`` (``ScaleRowUp2_Bilinear_Any``): the first
    and (at an even height) last rows linear, each pair of rows between two
    source rows 3:1 both ways."""
    s = s.astype(np.int64)
    out = np.empty((h, w), np.int64)
    out[0] = up_linear(s[0], w)
    n = (w - 1) & ~1
    half = n // 2
    pairs = (h - 1) // 2
    if pairs:
        for offset, (p, q) in ((1, (s[:pairs], s[1 : pairs + 1])),
                               (2, (s[1 : pairs + 1], s[:pairs]))):
            o = out[offset : offset + 2 * pairs : 2]
            o[:, 0] = (3 * p[:, 0] + q[:, 0] + 2) >> 2
            if n > 0:
                pa, pb, qa, qb = p[:, :half], p[:, 1 : half + 1], q[:, :half], q[:, 1 : half + 1]
                o[:, 1 : n + 1 : 2] = (9 * pa + 3 * pb + 3 * qa + qb + 8) >> 4
                o[:, 2 : n + 1 : 2] = (3 * pa + 9 * pb + qa + 3 * qb + 8) >> 4
            last = (w - 1) // 2
            o[:, w - 1] = (3 * p[:, last] + q[:, last] + 2) >> 2
    if not h & 1:
        out[h - 1] = up_linear(s[pairs], w)
    return out


# ----- the paths -------------------------------------------------------------

def _vertical(s: np.ndarray, dh: int, f: int) -> np.ndarray:
    """``ScalePlaneVertical``: whole rows interpolated (copied unfiltered)."""
    sh = s.shape[0]
    y = dy = 0
    if dh <= sh:
        dy = fixed_div(sh, dh)
        y = _center(dy, -32768)
    elif sh > 1 and dh > 1:
        dy = fixed_div1(sh, dh)
    max_y = ((sh - 1) << 16) - 1 if sh > 1 else 0
    ys = np.minimum(y + np.arange(dh, dtype=np.int64) * dy, max_y)
    yi = ys >> 16
    yf = (ys >> 8) & 255 if f else np.zeros(dh, np.int64)
    return _interpolate(s[yi], s[np.minimum(yi + 1, sh - 1)], yf)


def _down2(s: np.ndarray) -> np.ndarray:
    """``ScalePlaneDown2`` (``ScaleRowDown2Box``): 2 x 2 boxes."""
    return (s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2] + 2) >> 2


def _down4(s: np.ndarray) -> np.ndarray:
    """``ScalePlaneDown4`` (``ScaleRowDown4Box``): 4 x 4 boxes."""
    h, w = s.shape
    return (s.reshape(h // 4, 4, w // 4, 4).sum(axis=(1, 3)) + 8) >> 4


def _down34(s: np.ndarray, dh: int, high: bool) -> np.ndarray:
    """``ScalePlaneDown34``: each 4 source pixels to 3, output rows in
    threes from rows 0 and 1 (3:1, ``_0_Box``), 1 and 2 (1:1, ``_1_Box``)
    and 3 and 2 (3:1, ``_0_Box`` upwards); ``dh`` is a multiple of 3, so
    libyuv's remainder rows never arise."""
    dw = s.shape[1] * 3 // 4
    out = np.empty((dh, dw), np.int64)
    simd = 0 if high else dw - dw % 24
    for g in range(dh // 3):
        r = 4 * g
        for k, (near, far, zero) in enumerate(((r, r + 1, True), (r + 1, r + 2, False),
                                                (r + 3, r + 2, True))):
            a, b = s[near].reshape(-1, 4), s[far].reshape(-1, 4)
            row = _box34_c(a, b, zero)
            if simd:
                row[:simd] = _box34_simd(a, b, zero)[:simd]
            out[3 * g + k] = row
    return out


def _h34(v: np.ndarray) -> np.ndarray:
    return np.stack([(3 * v[:, 0] + v[:, 1] + 2) >> 2, (v[:, 1] + v[:, 2] + 1) >> 1,
                     (v[:, 2] + 3 * v[:, 3] + 2) >> 2], axis=1)


def _box34_c(a: np.ndarray, b: np.ndarray, zero: bool) -> np.ndarray:
    """``ScaleRowDown34_0/1_Box_C``: columns first, then rows 3:1 or 1:1."""
    ha, hb = _h34(a), _h34(b)
    return (((3 * ha + hb + 2) >> 2) if zero else ((ha + hb + 1) >> 1)).ravel()


def _box34_simd(a: np.ndarray, b: np.ndarray, zero: bool) -> np.ndarray:
    """The SSSE3 bodies: rows first with ``pavgb`` (twice for 3:1), then
    columns with weights (3, 1), (2, 2), (1, 3)."""
    v = (a + b + 1) >> 1
    if zero:
        v = (a + v + 1) >> 1
    return np.stack([(3 * v[:, 0] + v[:, 1] + 2) >> 2, (2 * v[:, 1] + 2 * v[:, 2] + 2) >> 2,
                     (v[:, 2] + 3 * v[:, 3] + 2) >> 2], axis=1).ravel()


def _down38(s: np.ndarray, dh: int, high: bool) -> np.ndarray:
    """``ScalePlaneDown38``: each 8 source pixels to 3 (boxes of 3, 3 and 2
    columns), output rows in threes from 3, 3 and 2 source rows (``dh`` a
    multiple of 3), each box's sum times 65536 over its area, over 65536."""
    dw = s.shape[1] * 3 // 8
    out = np.empty((dh, dw), np.int64)
    simd = 0 if high else dw - dw % 6
    groups = ((0, 3), (3, 6), (6, 8))
    for j in range(dh):
        r, n = 8 * (j // 3) + 3 * (j % 3), 2 if j % 3 == 2 else 3
        rows = [s[r + k].reshape(-1, 8) for k in range(n)]
        total = sum(rows)
        row = np.stack([total[:, a:b].sum(axis=1) * (65536 // (n * (b - a))) >> 16
                        for a, b in groups], axis=1).ravel()
        if n == 2 and simd:  # ScaleRowDown38_2_Box_SSSE3: rows averaged first
            v = (rows[0] + rows[1] + 1) >> 1
            row[:simd] = np.stack([v[:, a:b].sum(axis=1) * (65536 // (b - a)) >> 16
                                   for a, b in groups], axis=1).ravel()[:simd]
        out[j] = row
    return out


def _box(s: np.ndarray, dw: int, dh: int, high: bool) -> np.ndarray:
    """``ScalePlaneBox``: each output pixel the mean of its box of source
    pixels (rows summed, then columns, times 65536 over the box's area)."""
    sh, sw = s.shape
    x, y, dx, dy = slope(sw, sh, dw, dh, BOX)
    ys = np.minimum(y + np.arange(dh + 1, dtype=np.int64) * dy, sh << 16) >> 16
    iy, heights = ys[:-1], np.maximum(ys[1:] - ys[:-1], 1)
    cum = np.concatenate([np.zeros((1, sw), np.int64), np.cumsum(s, axis=0)])
    sums = cum[np.minimum(iy + heights, sh)] - cum[iy]
    if not high:  # AVX2 adds with unsigned saturation, the C tail wraps at 16 bits
        n = sw & ~31
        if int(heights.max()) * 255 > 0xFFFF:
            sums[:, :n] = _saturating_rows(s, iy, heights, n)
        sums[:, n:] &= 0xFFFF
    if dx & 0xFFFF:  # ScaleAddCols2
        xs = x + np.arange(dw + 1, dtype=np.int64) * dx
        ix = xs[:-1] >> 16
        widths = np.maximum((xs[1:] >> 16) - ix, 1)
        lo = dx >> 16
        scale = np.stack([65536 // (max(lo, 1) * heights), 65536 // (max(lo + 1, 1) * heights)],
                         axis=1)[:, widths - lo]
    else:  # ScaleAddCols1: boxes of dx >> 16 columns from x >> 16
        width = max(dx >> 16, 1)
        ix = (x >> 16) + np.arange(dw, dtype=np.int64) * width
        widths = np.full(dw, width, np.int64)
        scale = (65536 // (width * heights))[:, None]
    ccum = np.concatenate([np.zeros((dh, 1), np.int64), np.cumsum(sums, axis=1)], axis=1)
    total = ccum[:, ix + widths] - ccum[:, ix]
    if high:
        return ((total * scale) & 0xFFFFFFFF) >> 16 & 0xFFFF
    return ((total * scale) >> 16) & 0xFF


def _saturating_rows(s: np.ndarray, iy: np.ndarray, heights: np.ndarray, n: int) -> np.ndarray:
    """The first ``n`` columns of each output row's row sums, added row by
    row with saturation at 65535 (``ScaleAddRow_AVX2``)."""
    out = np.zeros((len(iy), n), np.int64)
    for j, (r, h) in enumerate(zip(iy.tolist(), heights.tolist())):
        acc = np.zeros(n, np.int64)
        for k in range(h):
            acc = np.minimum(acc + s[r + k, :n], 0xFFFF)
        out[j] = acc
    return out


def _up2_linear_rows(s: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """``ScalePlaneUp2_Linear``: rows picked by a 16.16 step from just
    under a half, each doubled across linearly."""
    sh = s.shape[0]
    if dh == 1:
        rows = np.array([(sh - 1) // 2])
    else:
        dy = fixed_div(sh - 1, dh - 1)
        rows = ((1 << 15) - 1 + np.arange(dh, dtype=np.int64) * dy) >> 16
    return up_linear(s[rows], dw)


def _bilinear_down(s: np.ndarray, dw: int, dh: int, f: int, high: bool) -> np.ndarray:
    """``ScalePlaneBilinearDown``: each output row from two source rows
    (one under ``kFilterLinear``), then filtered across."""
    sh, sw = s.shape
    x, y, dx, dy = slope(sw, sh, dw, dh, f)
    max_y = (sh - 1) << 16
    ys = np.minimum(y + np.arange(dh, dtype=np.int64) * dy, max_y)
    yi = ys >> 16
    if f == LINEAR:
        rows = s[yi]
    else:
        rows = _interpolate(s[yi], s[np.minimum(yi + 1, sh - 1)], (ys >> 8) & 255)
    return _filter_cols(rows, dw, x, dx, high)


def _bilinear_up(s: np.ndarray, dw: int, dh: int, f: int, high: bool) -> np.ndarray:
    """``ScalePlaneBilinearUp``: source rows filtered across into two row
    buffers as the position reaches them (the source pointer runs one row
    ahead, and stops short of the last row as libyuv's does), each output
    row interpolated between them (the current one alone under
    ``kFilterLinear``)."""
    sh, sw = s.shape
    x, y, dx, dy = slope(sw, sh, dw, dh, f)
    cols = _filter_cols(s, dw, x, dx, high)
    max_y = (sh - 1) << 16
    y = min(y, max_y)
    lasty = y >> 16
    src = lasty
    buf = [src, src]
    if sh > 1:
        src += 1
    buf[1] = src
    if sh > 2:
        src += 1
    cur, step = 0, 1
    first, second, fracs = [], [], []
    for _ in range(dh):
        yi = y >> 16
        if yi != lasty:
            if y > max_y:
                y = max_y
                yi = y >> 16
                src = yi
            if yi != lasty:
                buf[cur] = src
                cur += step
                step = -step
                lasty = yi
                if y + 65536 < max_y:
                    src += 1
        first.append(buf[cur])
        second.append(buf[cur + step])
        fracs.append(0 if f == LINEAR else (y >> 8) & 255)
        y += dy
    return _interpolate(cols[first], cols[second], np.array(fracs, np.int64))


def _simple(s: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """``ScalePlaneSimple``: point sampling from the pixels' centres."""
    sh, sw = s.shape
    x, y, dx, dy = slope(sw, sh, dw, dh, NONE)
    xi = (x + np.arange(dw, dtype=np.int64) * dx) >> 16
    yi = (y + np.arange(dh, dtype=np.int64) * dy) >> 16
    return s[yi][:, xi]
