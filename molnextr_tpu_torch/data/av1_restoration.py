"""AV1 loop restoration (the AV1 specification, section 7.17), as libaom's
``av1_loop_restoration_filter_frame`` gives it, in numpy.

A plane whose ``FrameRestorationType`` is not NONE is filtered in stripes
of 64 luma rows, the first 8 rows shorter (``StripeStartY``).  Inside a
stripe the source is the CDEF output; the rows above and below it come
from the deblocked frame before CDEF, two rows each way, the nearer
repeated past them, and the frame's own edges repeat its first and last
rows and columns (``get_source_sample``).  A stripe lies in one row of
restoration units (units start 8 luma rows up, so their edges are stripe
edges) and is cut at the units' columns, each unit filtered by its own
type:

* **Wiener**: a 7-tap horizontal filter, rounded by ``InterRound0`` and
  clamped, then a 7-tap vertical one rounded by ``InterRound1`` (3/11, or
  5/9 at 12 bits), taps symmetric about 128 less twice the three coded;
* **self-guided**: for each radius of the unit's ``Sgr_Params`` set (2
  and/or 1), box sums of the samples and their squares, ``A`` and ``B``
  from the variance through libaom's ``s`` scale, ``x / (x + 1)`` and
  ``1 / n`` tables (radius 2 on odd rows only), their weighted 3 x 3 sums,
  then the projection of the two filtered planes with ``xqd``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from molnextr_tpu_torch.data.av1_block import SGR_PARAMS, lr_unit_count
from molnextr_tpu_torch.data.av1_obu import RESTORE_NONE, RESTORE_SGRPROJ, RESTORE_WIENER


def restore(dec, deblocked: List[np.ndarray], cdefed: List[np.ndarray]) -> List[np.ndarray]:
    """The loop-restored planes; under superres ``deblocked`` and
    ``cdefed`` are the upscaled frames (``UpscaledCurrFrame``,
    ``UpscaledCdefFrame``) and the units lie on the upscaled width."""
    fr = dec.fr
    if not fr.uses_lr:
        return cdefed
    out = list(cdefed)
    for p, src in enumerate(cdefed):
        if fr.lr_type[p] == RESTORE_NONE:
            continue
        sx, sy = dec.ss[p]
        pw, ph = (fr.upscaled_width + sx) >> sx, (fr.height + sy) >> sy
        size = fr.lr_size[p]
        ucols, urows = lr_unit_count(size, pw), lr_unit_count(size, ph)
        res = src.copy()
        off, height = 8 >> sy, 64 >> sy
        cols = np.clip(np.arange(-3, pw + 3), 0, pw - 1)
        for start in range(-off, ph, height):
            end = start + height - 1
            y0, y1 = max(start, 0), min(end, ph - 1)
            rows = []
            for y in range(y0 - 3, y1 + 4):
                y = min(max(y, 0), ph - 1)
                if y < start:
                    rows.append(deblocked[p][max(start - 2, y)])
                elif y > end:
                    rows.append(deblocked[p][min(end + 2, y)])
                else:
                    rows.append(src[y])
            ext = np.stack(rows).astype(np.int64)[:, cols]
            ur = min(urows - 1, (y0 + off) // size)
            for uc in range(ucols):
                x0 = uc * size
                x1 = pw if uc == ucols - 1 else min(x0 + size, pw)
                kind, params = dec.lr_units[p].get((ur, uc), (RESTORE_NONE, None))
                seg = ext[:, x0 : x1 + 6]
                if kind == RESTORE_WIENER:
                    res[y0 : y1 + 1, x0:x1] = wiener(seg, params, dec.bd)
                elif kind == RESTORE_SGRPROJ:
                    res[y0 : y1 + 1, x0:x1] = self_guided(seg, params, dec.bd, y0)
        out[p] = res
    return out


def _taps(coefs) -> np.ndarray:
    f = [coefs[0], coefs[1], coefs[2], 128, coefs[2], coefs[1], coefs[0]]
    f[3] -= 2 * sum(coefs)
    return np.array(f, np.int64)


def wiener(ext: np.ndarray, coefs, bd: int) -> np.ndarray:
    """``wiener_filter_process`` of the (h + 6, w + 6) source around a
    unit's stripe segment; ``coefs`` the (vertical, horizontal) taps."""
    r0, r1 = (5, 9) if bd == 12 else (3, 11)
    vf, hf = _taps(coefs[0]), _taps(coefs[1])
    h, w = ext.shape[0] - 6, ext.shape[1] - 6
    s = sum(hf[t] * ext[:, t : t + w] for t in range(7))
    offset = 1 << (bd + 7 - r0 - 1)
    limit = (1 << (bd + 1 + 7 - r0)) - 1
    inter = np.clip((s + (1 << (r0 - 1))) >> r0, -offset, limit - offset)
    s = sum(vf[t] * inter[t : t + h] for t in range(7))
    return np.clip((s + (1 << (r1 - 1))) >> r1, 0, (1 << bd) - 1)


def _box(ext: np.ndarray, r: int, h: int, w: int):
    """Sums of the samples and of their squares over the (2r + 1)^2 box
    centred on each of the (h + 2, w + 2) positions around the segment."""
    out = []
    for v in (ext, ext * ext):
        c = np.zeros((v.shape[0] + 1, v.shape[1] + 1), np.int64)
        c[1:, 1:] = v.cumsum(0).cumsum(1)
        top, left = 2 - r, 2 - r
        n = 2 * r + 1
        ys, xs = slice(top, top + h + 2), slice(left, left + w + 2)
        ye, xe = slice(top + n, top + n + h + 2), slice(left + n, left + n + w + 2)
        out.append(c[ye, xe] - c[ys, xe] - c[ye, xs] + c[ys, xs])
    return out


def self_guided(ext: np.ndarray, params, bd: int, y0: int) -> np.ndarray:
    """``self_guided_filter_process`` of a unit's stripe segment starting
    at plane row ``y0``; ``params`` the set and ``xqd``."""
    sgr, (w0, w1) = params
    h, w = ext.shape[0] - 6, ext.shape[1] - 6
    u = ext[3 : 3 + h, 3 : 3 + w]
    radii = (SGR_PARAMS[sgr][0], SGR_PARAMS[sgr][2])
    scale = (SGR_PARAMS[sgr][1], SGR_PARAMS[sgr][3])
    filt = []
    for pas in range(2):
        r = radii[pas]
        if not r:
            filt.append(None)
            continue
        b, a = _box(ext, r, h, w)
        n = (2 * r + 1) ** 2
        a = (a + ((1 << (2 * (bd - 8))) >> 1)) >> (2 * (bd - 8))
        d = (b + ((1 << (bd - 8)) >> 1)) >> (bd - 8)
        p = np.maximum(0, a * n - d * d)
        z = (p * scale[pas] + (1 << 19)) >> 20
        a2 = np.where(z >= 255, 256, np.where(z == 0, 1, ((z << 8) + z // 2) // (z + 1)))
        one_over_n = ((1 << 12) + n // 2) // n
        bb = ((256 - a2) * b * one_over_n + (1 << 11)) >> 12
        filt.append(_weigh(a2, bb, u, pas, y0))
    rst = u << 4
    w2 = 128 - w0 - w1
    v = w1 * rst + w0 * (filt[0] if filt[0] is not None else rst) + \
        w2 * (filt[1] if filt[1] is not None else rst)
    return np.clip((v + (1 << 10)) >> 11, 0, (1 << bd) - 1)


def _weigh(a, b, u, pas: int, y0: int) -> np.ndarray:
    """The weighted 3 x 3 sums of ``A`` and ``B`` ((h + 2, w + 2), centred
    one row and column out) applied to the source ``u``."""
    h, w = u.shape

    def at(m, dy, dx):
        return m[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    if pas == 0:
        odd = ((np.arange(h) + y0) & 1).astype(bool)[:, None]
        sa_even = 6 * (at(a, -1, 0) + at(a, 1, 0)) + 5 * (at(a, -1, -1) + at(a, -1, 1)
                                                          + at(a, 1, -1) + at(a, 1, 1))
        sb_even = 6 * (at(b, -1, 0) + at(b, 1, 0)) + 5 * (at(b, -1, -1) + at(b, -1, 1)
                                                          + at(b, 1, -1) + at(b, 1, 1))
        sa_odd = 6 * at(a, 0, 0) + 5 * (at(a, 0, -1) + at(a, 0, 1))
        sb_odd = 6 * at(b, 0, 0) + 5 * (at(b, 0, -1) + at(b, 0, 1))
        sa, sb = np.where(odd, sa_odd, sa_even), np.where(odd, sb_odd, sb_even)
        shift = np.where(odd, 4, 5)
    else:
        cross = lambda m: at(m, 0, 0) + at(m, -1, 0) + at(m, 1, 0) + at(m, 0, -1) + at(m, 0, 1)  # noqa: E731
        diag = lambda m: at(m, -1, -1) + at(m, -1, 1) + at(m, 1, -1) + at(m, 1, 1)  # noqa: E731
        sa, sb = 4 * cross(a) + 3 * diag(a), 4 * cross(b) + 3 * diag(b)
        shift = 5
    v = sa * u + sb
    sh = 8 + shift - 4
    return (v + (1 << (sh - 1))) >> sh
