"""AV1 intra prediction and lossless reconstruction (the AV1 specification,
sections 7.11.2, 7.11.3 for intra block copy, 7.11.4-7.11.5 and 7.13.2.10),
on planes held as flat Python lists.

* :func:`predict_intra`: the edge preparation (``haveAboveRight``,
  ``haveBelowLeft``, the frame's right and bottom limits), DC, V, H, the six
  directional modes with angle deltas, the intra edge filter and edge
  upsampling, SMOOTH, SMOOTH_V, SMOOTH_H, Paeth and the recursive filter
  intra modes.
* :func:`predict_cfl`: chroma from luma over the block's reconstructed
  luma, padded where the luma stops.
* :func:`predict_intrabc`: the block copy of intra block copy, through
  the bilinear filter (chroma of a subsampled plane may land between
  pixels) with the specification's rounding at 8, 10 and 12 bits.
* :func:`reconstruct_wht`: the inverse 4 x 4 Walsh-Hadamard transform of a
  lossless block and its addition, clipped to the bit depth;
  :func:`add_residual` adds the residual of any other transform block.
"""

from __future__ import annotations

from typing import List

import numpy as np

DC, V, H, D45, D135, D113, D157, D203, D67, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH = range(13)
MODE_ANGLE = (0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0)
DR_DERIVATIVE = {3: 1023, 6: 547, 9: 372, 14: 273, 17: 215, 20: 178, 23: 151, 26: 132, 29: 116,
                 32: 102, 36: 90, 39: 80, 42: 71, 45: 64, 48: 57, 51: 51, 54: 45, 58: 40,
                 61: 35, 64: 31, 67: 27, 70: 23, 73: 19, 76: 15, 81: 11, 84: 7, 87: 3}
SM_WEIGHTS = {
    4: (255, 149, 85, 64),
    8: (255, 197, 146, 105, 73, 50, 37, 32),
    16: (255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33, 26, 20, 17, 16),
    32: (255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111, 101, 92, 83, 74, 66, 59,
         52, 45, 39, 34, 29, 25, 21, 17, 14, 12, 10, 9, 8, 8),
    64: (255, 248, 240, 233, 225, 218, 210, 203, 196, 189, 182, 176, 169, 163, 156, 150, 144,
         138, 133, 127, 121, 116, 111, 106, 101, 96, 91, 86, 82, 77, 73, 69, 65, 61, 57, 54,
         50, 47, 44, 41, 38, 35, 32, 29, 27, 25, 22, 20, 18, 16, 15, 13, 12, 10, 9, 8, 7, 6,
         6, 5, 5, 4, 4, 4),
}
EDGE_KERNEL = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))
FILTER_TAPS = (
    ((-6, 10, 0, 0, 0, 12, 0), (-5, 2, 10, 0, 0, 9, 0), (-3, 1, 1, 10, 0, 7, 0),
     (-3, 1, 1, 2, 10, 5, 0), (-4, 6, 0, 0, 0, 2, 12), (-3, 2, 6, 0, 0, 2, 9),
     (-3, 2, 2, 6, 0, 2, 7), (-3, 1, 2, 2, 6, 3, 5)),
    ((-10, 16, 0, 0, 0, 10, 0), (-6, 0, 16, 0, 0, 6, 0), (-4, 0, 0, 16, 0, 4, 0),
     (-2, 0, 0, 0, 16, 2, 0), (-10, 16, 0, 0, 0, 0, 10), (-6, 0, 16, 0, 0, 0, 6),
     (-4, 0, 0, 16, 0, 0, 4), (-2, 0, 0, 0, 16, 0, 2)),
    ((-8, 8, 0, 0, 0, 16, 0), (-8, 0, 8, 0, 0, 16, 0), (-8, 0, 0, 8, 0, 16, 0),
     (-8, 0, 0, 0, 8, 16, 0), (-4, 4, 0, 0, 0, 0, 16), (-4, 0, 4, 0, 0, 0, 16),
     (-4, 0, 0, 4, 0, 0, 16), (-4, 0, 0, 0, 4, 0, 16)),
    ((-2, 8, 0, 0, 0, 10, 0), (-1, 3, 8, 0, 0, 6, 0), (-1, 2, 3, 8, 0, 4, 0),
     (0, 1, 2, 3, 8, 2, 0), (-1, 4, 0, 0, 0, 3, 10), (-1, 3, 4, 0, 0, 4, 6),
     (-1, 2, 3, 4, 0, 4, 4), (-1, 2, 2, 3, 4, 3, 3)),
    ((-12, 14, 0, 0, 0, 14, 0), (-10, 0, 14, 0, 0, 12, 0), (-9, 0, 0, 14, 0, 11, 0),
     (-8, 0, 0, 0, 14, 10, 0), (-10, 12, 0, 0, 0, 0, 14), (-9, 1, 12, 0, 0, 0, 12),
     (-8, 0, 0, 12, 0, 1, 11), (-7, 0, 0, 1, 12, 1, 9)),
)
OFF = 16  # AboveRow[k] / LeftCol[k] live at index k + OFF

# which prediction paths ran: tests read it to show every tool was reached
REACHED: dict = {}


def _hit(name: str) -> None:
    REACHED[name] = REACHED.get(name, 0) + 1


def _filter_strength(w: int, h: int, smooth: bool, delta: int) -> int:
    d, wh = abs(delta), w + h
    if not smooth:
        if wh <= 8:
            return 1 if d >= 56 else 0
        if wh <= 16:
            return 1 if d >= 40 else 0
        if wh <= 24:
            return 3 if d >= 32 else 2 if d >= 16 else 1 if d >= 8 else 0
        if wh <= 32:
            return 3 if d >= 32 else 2 if d >= 4 else 1 if d >= 1 else 0
        return 3 if d >= 1 else 0
    if wh <= 8:
        return 2 if d >= 64 else 1 if d >= 40 else 0
    if wh <= 16:
        return 2 if d >= 48 else 1 if d >= 20 else 0
    if wh <= 24:
        return 3 if d >= 4 else 0
    return 3 if d >= 1 else 0


def _edge_filter(buf: List[int], size: int, strength: int) -> None:
    """``intra_edge_filter`` of ``buf[OFF - 1 : OFF - 1 + size]`` in place."""
    if not strength:
        return
    edge = buf[OFF - 1 : OFF - 1 + size]
    k0, k1, k2, k3, k4 = EDGE_KERNEL[strength - 1]
    last = size - 1
    for i in range(1, size):
        s = (k0 * edge[max(i - 2, 0)] + k1 * edge[i - 1] + k2 * edge[i]
             + k3 * edge[min(i + 1, last)] + k4 * edge[min(i + 2, last)])
        buf[OFF + i - 1] = (s + 8) >> 4


def _upsample(buf: List[int], n: int, top: int) -> None:
    """``intra_edge_upsample`` of ``n`` pixels in place."""
    dup = [buf[OFF - 1]] + buf[OFF - 1 : OFF + n] + [buf[OFF + n - 1]]
    buf[OFF - 2] = dup[0]
    for i in range(n):
        s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
        s = (s + 8) >> 4
        buf[OFF + 2 * i - 1] = 0 if s < 0 else top if s > top else s
        buf[OFF + 2 * i] = dup[i + 2]


def predict_intra(px: List[int], stride: int, x: int, y: int, w: int, h: int,
                  have_left: bool, have_above: bool, have_ar: bool, have_bl: bool,
                  max_x: int, max_y: int, bd: int, mode: int, delta: int,
                  filter_mode: int, edge_filter: bool, smooth_nb: bool) -> None:
    """``predict_intra`` of one transform block into ``px``: ``delta`` is
    the angle delta (-3..3), ``filter_mode`` the filter intra mode or -1,
    ``smooth_nb`` ``get_filter_type``'s answer."""
    top = (1 << bd) - 1
    n = w + h
    above = [0] * (OFF + 2 * n + 2)
    left = [0] * (OFF + 2 * n + 2)
    row = (y - 1) * stride
    if not have_above and have_left:
        v = px[y * stride + x - 1]
        above[OFF : OFF + n] = [v] * n
    elif not have_above:
        above[OFF : OFF + n] = [(1 << (bd - 1)) - 1] * n
    else:
        limit = min(max_x, x + (2 * w if have_ar else w) - 1)
        span = px[row + x : row + limit + 1]
        above[OFF : OFF + len(span)] = span
        if len(span) < n:
            above[OFF + len(span) : OFF + n] = [span[-1]] * (n - len(span))
    if not have_left and have_above:
        v = px[row + x]
        left[OFF : OFF + n] = [v] * n
    elif not have_left:
        left[OFF : OFF + n] = [(1 << (bd - 1)) + 1] * n
    else:
        limit = min(max_y, y + (2 * h if have_bl else h) - 1)
        col = px[y * stride + x - 1 : (limit + 1) * stride + x - 1 : stride]
        left[OFF : OFF + len(col)] = col
        if len(col) < n:
            left[OFF + len(col) : OFF + n] = [col[-1]] * (n - len(col))
    if have_above and have_left:
        corner = px[row + x - 1]
    elif have_above:
        corner = px[row + x]
    elif have_left:
        corner = px[y * stride + x - 1]
    else:
        corner = 1 << (bd - 1)
    above[OFF - 1] = left[OFF - 1] = corner

    if filter_mode >= 0:
        _hit("filter_intra")
        pred = _filter_intra(above, left, w, h, filter_mode, top)
    elif V <= mode <= D67:
        _hit(f"mode_{mode}")
        if delta:
            _hit("angle_delta")
        pred = _directional(above, left, w, h, MODE_ANGLE[mode] + 3 * delta, have_above,
                            have_left, edge_filter, smooth_nb, max_x - x, max_y - y, top)
    elif mode == SMOOTH or mode == SMOOTH_V or mode == SMOOTH_H:
        _hit("smooth" if mode == SMOOTH else "smooth_v" if mode == SMOOTH_V else "smooth_h")
        pred = _smooth(above, left, w, h, mode)
    elif mode == DC:
        _hit("dc")
        if have_above and have_left:
            s = sum(above[OFF : OFF + w]) + sum(left[OFF : OFF + h])
            avg = (s + ((w + h) >> 1)) // (w + h)
        elif have_left:
            avg = (sum(left[OFF : OFF + h]) + (h >> 1)) // h
        elif have_above:
            avg = (sum(above[OFF : OFF + w]) + (w >> 1)) // w
        else:
            avg = 1 << (bd - 1)
        pred = [[avg] * w for _ in range(h)]
    else:
        _hit("paeth")
        pred = []
        for i in range(h):
            lv = left[OFF + i]
            prow = []
            for j in range(w):
                av = above[OFF + j]
                base = av + lv - corner
                pl, pt, ptl = abs(base - lv), abs(base - av), abs(base - corner)
                prow.append(lv if pl <= pt and pl <= ptl else av if pt <= ptl else corner)
            pred.append(prow)
    for i in range(h):
        at = (y + i) * stride + x
        px[at : at + w] = pred[i]


def _filter_intra(above, left, w, h, mode, top):
    taps = FILTER_TAPS[mode]
    pred = [[0] * w for _ in range(h)]
    for i2 in range(h >> 1):
        for j4 in range(w >> 2):
            p = []
            for i in range(7):
                if i < 5:
                    if i2 == 0:
                        p.append(above[OFF + (j4 << 2) + i - 1])
                    elif j4 == 0 and i == 0:
                        p.append(left[OFF + (i2 << 1) - 1])
                    else:
                        p.append(pred[(i2 << 1) - 1][(j4 << 2) + i - 1])
                elif j4 == 0:
                    p.append(left[OFF + (i2 << 1) + i - 5])
                else:
                    p.append(pred[(i2 << 1) + i - 5][(j4 << 2) - 1])
            for i in range(8):
                t = taps[i]
                pr = sum(t[k] * p[k] for k in range(7))
                v = (pr + 8) >> 4 if pr >= 0 else -((-pr + 8) >> 4)
                pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = 0 if v < 0 else top if v > top else v
    return pred


def _smooth(above, left, w, h, mode):
    wx, wy = SM_WEIGHTS[w], SM_WEIGHTS[h]
    bottom, right = left[OFF + h - 1], above[OFF + w - 1]
    pred = []
    for i in range(h):
        lv, yw = left[OFF + i], wy[i]
        if mode == SMOOTH:
            pred.append([(yw * above[OFF + j] + (256 - yw) * bottom + wx[j] * lv
                          + (256 - wx[j]) * right + 256) >> 9 for j in range(w)])
        elif mode == SMOOTH_V:
            pred.append([(yw * above[OFF + j] + (256 - yw) * bottom + 128) >> 8
                         for j in range(w)])
        else:
            pred.append([(wx[j] * lv + (256 - wx[j]) * right + 128) >> 8 for j in range(w)])
    return pred


def _directional(above, left, w, h, angle, have_above, have_left, edge_filter, smooth_nb,
                 room_x, room_y, top):
    up_a = up_l = 0
    if edge_filter:
        if angle != 90 and angle != 180:
            if 90 < angle < 180 and w + h >= 24:
                c = (left[OFF] * 5 + above[OFF - 1] * 6 + above[OFF] * 5 + 8) >> 4
                above[OFF - 1] = left[OFF - 1] = c
            if have_above:
                strength = _filter_strength(w, h, smooth_nb, angle - 90)
                size = min(w, room_x + 1) + (h if angle < 90 else 0) + 1
                if strength:
                    _hit("edge_filter")
                _edge_filter(above, size, strength)
            if have_left:
                strength = _filter_strength(w, h, smooth_nb, angle - 180)
                size = min(h, room_y + 1) + (w if angle > 180 else 0) + 1
                if strength:
                    _hit("edge_filter")
                _edge_filter(left, size, strength)
        up_a = _use_upsample(w, h, smooth_nb, angle - 90)
        if up_a:
            _hit("edge_upsample")
            _upsample(above, w + (h if angle < 90 else 0), top)
        up_l = _use_upsample(w, h, smooth_nb, angle - 180)
        if up_l:
            _hit("edge_upsample")
            _upsample(left, h + (w if angle > 180 else 0), top)
    pred = []
    if angle == 90:
        row = above[OFF : OFF + w]
        return [list(row) for _ in range(h)]
    if angle == 180:
        return [[left[OFF + i]] * w for i in range(h)]
    if angle < 90:
        dx = DR_DERIVATIVE[angle]
        max_base = (w + h - 1) << up_a
        for i in range(h):
            idx = (i + 1) * dx
            base0 = idx >> (6 - up_a)
            shift = ((idx << up_a) >> 1) & 0x1F
            prow = []
            for j in range(w):
                base = base0 + (j << up_a)
                if base < max_base:
                    prow.append((above[OFF + base] * (32 - shift)
                                 + above[OFF + base + 1] * shift + 16) >> 5)
                else:
                    prow.append(above[OFF + max_base])
            pred.append(prow)
        return pred
    if angle < 180:
        dx, dy = DR_DERIVATIVE[180 - angle], DR_DERIVATIVE[angle - 90]
        for i in range(h):
            prow = []
            for j in range(w):
                idx = (j << 6) - (i + 1) * dx
                base = idx >> (6 - up_a)
                if base >= -(1 << up_a):
                    shift = ((idx << up_a) >> 1) & 0x1F
                    prow.append((above[OFF + base] * (32 - shift)
                                 + above[OFF + base + 1] * shift + 16) >> 5)
                else:
                    idx = (i << 6) - (j + 1) * dy
                    base = idx >> (6 - up_l)
                    shift = ((idx << up_l) >> 1) & 0x1F
                    prow.append((left[OFF + base] * (32 - shift)
                                 + left[OFF + base + 1] * shift + 16) >> 5)
            pred.append(prow)
        return pred
    dy = DR_DERIVATIVE[270 - angle]
    max_base = (w + h - 1) << up_l
    cols = []
    for j in range(w):
        idx = (j + 1) * dy
        base0 = idx >> (6 - up_l)
        shift = ((idx << up_l) >> 1) & 0x1F
        col = []
        for i in range(h):
            base = base0 + (i << up_l)
            if base < max_base:
                col.append((left[OFF + base] * (32 - shift) + left[OFF + base + 1] * shift
                            + 16) >> 5)
            else:
                col.append(left[OFF + max_base])
        cols.append(col)
    return [[cols[j][i] for j in range(w)] for i in range(h)]


def _use_upsample(w: int, h: int, smooth_nb: bool, delta: int) -> int:
    d = abs(delta)
    if d <= 0 or d >= 40:
        return 0
    return int(w + h <= (8 if smooth_nb else 16))


def predict_cfl(px: List[int], stride: int, luma: List[int], lstride: int, x: int, y: int,
                w: int, h: int, ss_x: int, ss_y: int, max_luma_w: int, max_luma_h: int,
                alpha: int, bd: int) -> None:
    """``predict_chroma_from_luma`` over the DC prediction already in
    ``px``: the block's luma (sums of ``2**ss`` pixels, scaled to 8 times a
    pixel) less its average, times ``alpha`` / 64."""
    _hit("cfl")
    top = (1 << bd) - 1
    lx0, ly0 = x << ss_x, y << ss_y
    wmax = ((max_luma_w - lx0) >> ss_x) - 1
    hmax = ((max_luma_h - ly0) >> ss_y) - 1
    scale = 3 - ss_x - ss_y
    vals = []
    for i in range(h):
        ly = ly0 + (min(i, hmax) << ss_y)
        rowv = []
        for j in range(w):
            lx = lx0 + (min(j, wmax) << ss_x)
            s = luma[ly * lstride + lx]
            if ss_x:
                s += luma[ly * lstride + lx + 1]
            if ss_y:
                s += luma[(ly + 1) * lstride + lx]
                if ss_x:
                    s += luma[(ly + 1) * lstride + lx + 1]
            rowv.append(s << scale)
        vals.append(rowv)
    log2 = (w * h).bit_length() - 1
    avg = (sum(map(sum, vals)) + ((1 << log2) >> 1)) >> log2
    for i in range(h):
        at = (y + i) * stride + x
        for j in range(w):
            sc = alpha * (vals[i][j] - avg)
            sc = (sc + 32) >> 6 if sc >= 0 else -((-sc + 32) >> 6)
            v = px[at + j] + sc
            px[at + j] = 0 if v < 0 else top if v > top else v


def predict_intrabc(px: List[int], stride: int, x: int, y: int, w: int, h: int,
                    mv_row: int, mv_col: int, ss_x: int, ss_y: int, last_x: int, last_y: int,
                    bd: int) -> None:
    """``predict_inter`` of an intra block copy (``use_intrabc``): the
    motion vector scaled to the plane, then the bilinear filter in two
    passes with ``InterRound0``/``InterRound1`` (3/11, or 5/9 at 12 bits)."""
    _hit("intrabc")
    round0, round1 = (5, 9) if bd == 12 else (3, 11)
    top = (1 << bd) - 1
    start_x = ((x << 4) + ((2 * mv_col) >> ss_x)) << 6
    start_y = ((y << 4) + ((2 * mv_row) >> ss_y)) << 6
    fx = (start_x >> 6) & 15
    fy = (start_y >> 6) & 15
    x0, y0 = start_x >> 10, start_y >> 10
    inter = []
    for r in range(h + 1):
        ry = min(max(y0 + r, 0), last_y) * stride
        row = []
        for c in range(w):
            a = px[ry + min(max(x0 + c, 0), last_x)]
            b = px[ry + min(max(x0 + c + 1, 0), last_x)]
            s = (128 - 8 * fx) * a + 8 * fx * b
            row.append((s + (1 << (round0 - 1))) >> round0)
        inter.append(row)
    if fx or fy:
        _hit("intrabc_subpel")
    for r in range(h):
        at = (y + r) * stride + x
        out = []
        for c in range(w):
            s = (128 - 8 * fy) * inter[r][c] + 8 * fy * inter[r + 1][c]
            v = (s + (1 << (round1 - 1))) >> round1
            out.append(0 if v < 0 else top if v > top else v)
        px[at : at + w] = out


def reconstruct_wht(px: List[int], stride: int, x: int, y: int, coefs: List[int],
                    bd: int) -> None:
    """Add the inverse Walsh-Hadamard transform of a lossless block's
    coefficients (row-major, as dequantised: the level times 4) to ``px``."""
    top = (1 << bd) - 1
    t = [0] * 16
    for i in range(4):
        a, c, d, b = (coefs[4 * i] >> 2, coefs[4 * i + 1] >> 2, coefs[4 * i + 2] >> 2,
                      coefs[4 * i + 3] >> 2)
        a += c
        d -= b
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= b
        d += c
        t[4 * i : 4 * i + 4] = (a, b, c, d)
    for j in range(4):
        a, c, d, b = t[j], t[4 + j], t[8 + j], t[12 + j]
        a += c
        d -= b
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= b
        d += c
        for i, v in enumerate((a, b, c, d)):
            at = (y + i) * stride + x + j
            s = px[at] + v
            px[at] = 0 if s < 0 else top if s > top else s


def add_residual(px: List[int], stride: int, x: int, y: int, res, bd: int) -> None:
    """Add an (h, w) residual array to the prediction in ``px``, clipped to
    the bit depth."""
    h, w = res.shape
    rows = [px[(y + i) * stride + x : (y + i) * stride + x + w] for i in range(h)]
    out = np.clip(np.asarray(rows, np.int64) + res, 0, (1 << bd) - 1).tolist()
    for i in range(h):
        at = (y + i) * stride + x
        px[at : at + w] = out[i]
