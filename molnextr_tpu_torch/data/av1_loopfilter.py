"""The AV1 deblocking filter (the AV1 specification, section 7.14), as
libaom's ``av1_loop_filter_frame`` gives it, in numpy.

Per plane (luma when either luma level is set; U and V when theirs is),
every vertical edge of the frame, left to right, then every horizontal edge,
top to bottom.  An edge is the left (top) side of a transform block, off
the frame's first column (row), on the frame; its filter length comes from
the smaller of the two sides' transform widths (heights): 4, 8 or 14 taps
for luma, 4 or 6 for chroma.  Its level is the block's (luma vertical and
horizontal, U, V levels, the superblock's ``delta_lf``, the segment's
feature, the intra reference delta scaled by ``1 << (level >> 5)``), or the
previous side's where it is 0; ``limit``, ``blimit`` and ``thresh`` follow
from the level and the sharpness.  Each sample line across the edge is
masked by the ``filter``, ``hev``, ``flat`` and ``flat2`` tests and takes
the narrow filter, or the 6-, 8- or 14-tap smoothing.  One edge column (row)
is filtered for all its lines at once.
"""

from __future__ import annotations

from typing import List

import numpy as np

from molnextr_tpu_torch.data.av1_block import SIZES
from molnextr_tpu_torch.data.av1_recon import _hit

PAD = 8


def levels(dec, plane: int, pas: int) -> np.ndarray:
    """The filter level of every MI of the frame for a plane and pass."""
    fr = dec.fr
    rows, cols = fr.mi_rows, fr.mi_cols
    i = pas if plane == 0 else plane + 1
    base = fr.lf_level[i]
    if fr.delta_lf_present:
        d = np.asarray(dec.delta_lf, np.int64).reshape(rows, cols, 4)
        lvl = np.clip(d[..., i if fr.delta_lf_multi else 0] + base, 0, 63)
    else:
        lvl = np.full((rows, cols), base, np.int64)
    if fr.seg_enabled:
        seg = np.asarray(dec.seg, np.int64).reshape(rows, cols)
        for s in range(8):
            data = fr.seg_features[s][1 + i]
            if data is not None:
                lvl[seg == s] = np.clip(lvl[seg == s] + data, 0, 63)
    if fr.lf_delta_enabled:
        ref = np.maximum(np.asarray(dec.ref0, np.int64).reshape(rows, cols), 0)
        mode = np.asarray(dec.y_mode, np.int64).reshape(rows, cols)
        ref_d = np.asarray(fr.lf_ref_deltas, np.int64)[ref]
        mode_d = np.where((mode >= 13) & (mode != 15) & (mode != 23), fr.lf_mode_deltas[1],
                          fr.lf_mode_deltas[0])
        delta = np.where(ref > 0, ref_d + mode_d, ref_d)
        lvl = np.clip(lvl + delta * (1 << (lvl >> 5)), 0, 63)
    return lvl


def deblock(dec, planes: List[np.ndarray]) -> List[np.ndarray]:
    """The deblocked planes (MI-aligned int32 arrays) of a decoded frame."""
    fr = dec.fr
    if not (fr.lf_level[0] or fr.lf_level[1]):
        return planes
    out = []
    for p, plane in enumerate(planes):
        if p and not fr.lf_level[p + 1]:
            out.append(plane)
            continue
        sx, sy = dec.ss[p]
        work = np.pad(plane.astype(np.int32), PAD, mode="edge")
        skipped = (np.asarray(dec.skip, bool) & np.asarray(dec.is_inter, bool)).reshape(
            fr.mi_rows, fr.mi_cols)[sy::1 << sy, sx::1 << sx]
        size = np.asarray(SIZES, np.int64)[np.asarray(dec.mi_size).reshape(
            fr.mi_rows, fr.mi_cols)][sy::1 << sy, sx::1 << sx]
        for pas in range(2):
            lvl_mi = levels(dec, p, pas)
            lvl = lvl_mi[sy::1 << sy, sx::1 << sx] if (sx or sy) else lvl_mi
            tx = dec.lf_tw[p] if pas == 0 else dec.lf_th[p]
            h4, w4 = tx.shape
            lvl = lvl[:h4, :w4]
            skip = skipped[:h4, :w4]
            # the block's width (height) in the plane: an edge inside a
            # skipped inter block, between two of its transforms, is not filtered
            extent = np.maximum(size[:h4, :w4, pas] >> (sy if pas else sx), 4)
            if pas == 0:
                _edges(work, tx, lvl, skip, extent, fr, dec.bd, p, sx, sy, vertical=True)
            else:
                _edges(work.T, tx.T, lvl.T, skip.T, extent.T, fr, dec.bd, p, sy, sx,
                       vertical=False)
        out.append(work[PAD:-PAD, PAD:-PAD])
    return out


def _edges(work, tx, lvl, skip, extent, fr, bd: int, plane: int, sx: int, sy: int,
           vertical: bool) -> None:
    """Filter the vertical edges of ``work`` (padded) left to right; the
    horizontal pass hands in transposed views."""
    h4, w4 = tx.shape
    width, height = (fr.width, fr.height) if vertical else (fr.height, fr.width)
    on_rows = (np.arange(h4) * 4 << sy) < height
    sharp = fr.lf_sharpness
    shift = 2 if sharp > 4 else 1 if sharp > 0 else 0
    cap = 16 if plane == 0 else 8
    for x4 in range(1, w4):
        if (x4 * 4 << sx) >= width:
            break
        cur = np.maximum(tx[:, x4], 4)
        edge = on_rows & ((x4 * 4) % cur == 0)
        lv = np.where(lvl[:, x4] > 0, lvl[:, x4], lvl[:, x4 - 1])
        edge &= lv > 0
        edge &= ~(skip[:, x4] & skip[:, x4 - 1]) | ((x4 * 4) % extent[:, x4] == 0)
        if not edge.any():
            continue
        size = np.minimum(np.minimum(cur, tx[:, x4 - 1]), cap)[edge]
        lv = lv[edge]
        if sharp:
            limit = np.clip(lv >> shift, 1, 9 - sharp)
        else:
            limit = np.maximum(lv >> shift, 1)
        blimit = 2 * (lv + 2) + limit
        thresh = lv >> 4
        rows = (np.nonzero(edge)[0][:, None] * 4 + np.arange(4)).reshape(-1) + PAD
        rep = lambda a: np.repeat(a, 4)  # noqa: E731
        x = x4 * 4 + PAD
        seg = work[rows, x - 7 : x + 7]
        work[rows, x - 7 : x + 7] = filter_lines(seg, rep(size), rep(limit), rep(blimit),
                                                 rep(thresh), plane > 0, bd)


def filter_lines(s: np.ndarray, size, limit, blimit, thresh, chroma: bool,
                 bd: int) -> np.ndarray:
    """``sample_filtering_process`` of lines ``s`` (N, 14): p6..p0, q0..q6."""
    s = s.astype(np.int64)
    p = [s[:, 6 - k] for k in range(7)]
    q = [s[:, 7 + k] for k in range(7)]
    up = bd - 8
    limit, blimit, thresh = limit << up, blimit << up, thresh << up
    one = 1 << up
    ad = np.abs
    hev = (ad(p[1] - p[0]) > thresh) | (ad(q[1] - q[0]) > thresh)
    m4 = (ad(p[1] - p[0]) > limit) | (ad(q[1] - q[0]) > limit) | \
        (ad(p[0] - q[0]) * 2 + (ad(p[1] - q[1]) >> 1) > blimit)
    m6 = m4 | (ad(p[2] - p[1]) > limit) | (ad(q[2] - q[1]) > limit)
    m8 = m6 | (ad(p[3] - p[2]) > limit) | (ad(q[3] - q[2]) > limit)
    if chroma:
        mask = np.where(size == 4, ~m4, ~m6)
        flat = (ad(p[1] - p[0]) <= one) & (ad(q[1] - q[0]) <= one) & \
            (ad(p[2] - p[0]) <= one) & (ad(q[2] - q[0]) <= one)
        flat2 = np.zeros_like(flat)
    else:
        mask = np.where(size == 4, ~m4, ~m8)
        flat = (ad(p[1] - p[0]) <= one) & (ad(q[1] - q[0]) <= one) & \
            (ad(p[2] - p[0]) <= one) & (ad(q[2] - q[0]) <= one) & \
            (ad(p[3] - p[0]) <= one) & (ad(q[3] - q[0]) <= one)
        flat2 = (ad(p[6] - p[0]) <= one) & (ad(q[6] - q[0]) <= one) & \
            (ad(p[5] - p[0]) <= one) & (ad(q[5] - q[0]) <= one) & \
            (ad(p[4] - p[0]) <= one) & (ad(q[4] - q[0]) <= one)
    flat &= size >= 8
    flat2 &= size >= 16
    out = s.copy()
    narrow = mask & ~flat
    if narrow.any():
        _hit("deblock_4")
        _narrow(out, narrow, hev, bd)
    wide8 = mask & flat & ~flat2
    if wide8.any():
        _hit("deblock_6" if chroma else "deblock_8")
        _wide(out, s, wide8, 2 if chroma else 3, 3, chroma)
    wide16 = mask & flat & flat2
    if wide16.any():
        _hit("deblock_14")
        _wide(out, s, wide16, 6, 4, chroma)
    return out


def _narrow(out: np.ndarray, sel, hev, bd: int) -> None:
    lo, hi = -(1 << (bd - 1)), (1 << (bd - 1)) - 1
    half = 0x80 << (bd - 8)
    hv = hev[sel]
    ps1, ps0 = out[sel, 5] - half, out[sel, 6] - half
    qs0, qs1 = out[sel, 7] - half, out[sel, 8] - half
    f = np.where(hv, np.clip(ps1 - qs1, lo, hi), 0)
    f = np.clip(f + 3 * (qs0 - ps0), lo, hi)
    f1 = np.clip(f + 4, lo, hi) >> 3
    f2 = np.clip(f + 3, lo, hi) >> 3
    out[sel, 7] = np.clip(qs0 - f1, lo, hi) + half
    out[sel, 6] = np.clip(ps0 + f2, lo, hi) + half
    f = (f1 + 1) >> 1
    out[sel, 8] = np.where(hv, out[sel, 8], np.clip(qs1 - f, lo, hi) + half)
    out[sel, 5] = np.where(hv, out[sel, 5], np.clip(ps1 + f, lo, hi) + half)


def _wide(out: np.ndarray, s: np.ndarray, sel, n: int, log2: int, chroma: bool) -> None:
    """``wide_filter_process``: taps over ``F[-n-1 .. n]`` (p_n .. q_n)."""
    n2 = 0 if (log2 == 3 and not chroma) else 1
    v = s[sel]
    f = {k: v[:, 7 + k] for k in range(-n - 1, n + 1)}  # F[k]: q_k, or p_(-k-1)
    for i in range(-n, n):
        t = 0
        for j in range(-n, n + 1):
            t = t + f[min(max(i + j, -(n + 1)), n)] * (2 if abs(j) <= n2 else 1)
        out[sel, 7 + i] = (t + (1 << (log2 - 1))) >> log2
