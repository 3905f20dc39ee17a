"""The AV1 constrained directional enhancement filter (the AV1
specification, section 7.15), as libaom's ``av1_cdef_frame`` gives it, in
numpy.

Per 8 x 8 luma block of a 64 x 64 whose ``cdef_idx`` was read (not -1) and
not all of whose four MIs are skipped: the direction search (the eight
``partial`` line sums of the block's samples, their costs weighted by
``Div_Table``, the best direction and the variance against its
perpendicular), then the filter of each plane's block: primary taps along
the direction (strength adjusted by the variance for luma) and secondary
taps at 45 degrees from it, each difference ``constrain``-ed by the
strength and damping, the sum rounded over 16 and clamped between the taps'
extremes.  A tap outside the frame's MI area is unavailable
(``CdefAvailable``).  It reads the deblocked frame and returns a new one;
every block is filtered at once, gathered by direction.
"""

from __future__ import annotations

from typing import List

import numpy as np

from molnextr_tpu_torch.data.av1_recon import _hit

DIRECTIONS = np.array([[[-1, 1], [-2, 2]], [[0, 1], [-1, 2]], [[0, 1], [0, 2]], [[0, 1], [1, 2]],
                       [[1, 1], [2, 2]], [[1, 0], [2, 1]], [[1, 0], [2, 0]], [[1, 0], [2, -1]]])
PRI_TAPS = np.array([[4, 2], [3, 3]])
SEC_TAPS = (2, 1)
DIV_TABLE = (0, 840, 420, 280, 210, 168, 140, 120, 105)
# Cdef_Uv_Dir[ss_x][ss_y]: a luma direction as seen by subsampled chroma
UV_DIR = {(0, 0): tuple(range(8)), (1, 1): tuple(range(8)),
          (1, 0): (7, 0, 2, 4, 5, 6, 6, 6), (0, 1): (1, 2, 2, 2, 3, 4, 6, 0)}
_LOG2 = np.array([0] + [n.bit_length() - 1 for n in range(1, 1 << 13)])


def _line_maps() -> np.ndarray:
    """(8, 64, 15) one-hot maps of a block sample (i, j) to each
    direction's line."""
    m = np.zeros((8, 64, 15), np.int64)
    for i in range(8):
        for j in range(8):
            for d, k in enumerate((i + j, i + j // 2, i, 3 + i - j // 2, 7 + i - j,
                                   3 - i // 2 + j, j, i // 2 + j)):
                m[d, i * 8 + j, k] = 1
    return m


_MAPS_FLAT = _line_maps().transpose(1, 0, 2).reshape(64, 8 * 15).astype(np.float64)


def directions(luma: np.ndarray, bd: int):
    """``cdef_direction`` of every 8 x 8 block: (direction, variance)."""
    h, w = luma.shape
    x = (luma.astype(np.int64) >> (bd - 8)) - 128
    blocks = x.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
    # the line sums as one product (exact in float64: each is below 2**13)
    part = (blocks.astype(np.float64) @ _MAPS_FLAT).astype(np.int64).reshape(-1, 8, 15)
    sq = (part * part).transpose(1, 0, 2)  # (8, nblocks, 15)
    cost = np.zeros((8, blocks.shape[0]), np.int64)
    cost[2] = sq[2, :, :8].sum(1) * DIV_TABLE[8]
    cost[6] = sq[6, :, :8].sum(1) * DIV_TABLE[8]
    for d in (0, 4):
        for i in range(7):
            cost[d] += (sq[d, :, i] + sq[d, :, 14 - i]) * DIV_TABLE[i + 1]
        cost[d] += sq[d, :, 7] * DIV_TABLE[8]
    for d in (1, 3, 5, 7):
        cost[d] = sq[d, :, 3:8].sum(1) * DIV_TABLE[8]
        for j in range(3):
            cost[d] += (sq[d, :, j] + sq[d, :, 10 - j]) * DIV_TABLE[2 * j + 2]
    best = np.argmax(cost, axis=0)
    idx = np.arange(blocks.shape[0])
    var = (cost[best, idx] - cost[(best + 4) & 7, idx]) >> 10
    return best.reshape(h // 8, w // 8), var.reshape(h // 8, w // 8)


def cdef(dec, planes: List[np.ndarray]) -> List[np.ndarray]:
    """The CDEF-filtered planes of a deblocked frame."""
    fr, seq = dec.fr, dec.seq
    if fr.coded_lossless or fr.allow_intrabc or not seq.enable_cdef:
        return planes
    if not any(p or s for p, s in fr.cdef_y + fr.cdef_uv):
        return planes
    rows8, cols8 = fr.mi_rows // 2, fr.mi_cols // 2
    skip = np.asarray(dec.skip, bool).reshape(fr.mi_rows, fr.mi_cols)
    skip8 = skip[0::2, 0::2] & skip[1::2, 0::2] & skip[0::2, 1::2] & skip[1::2, 1::2]
    idx = np.array([[dec.cdef_idx.get((r >> 3, c >> 3), -1) for c in range(cols8)]
                    for r in range(rows8)], np.int64).reshape(rows8, cols8)
    active = ~skip8 & (idx >= 0)
    if not active.any():
        return planes
    cs = dec.bd - 8
    safe = np.maximum(idx, 0)
    ydir, var = directions(planes[0], dec.bd)
    y_pri = np.array([s[0] for s in fr.cdef_y])[safe] << cs
    y_sec = np.array([s[1] for s in fr.cdef_y])[safe] << cs
    pri_dir = np.where(y_pri == 0, 0, ydir)
    var_str = np.where(var >> 6, np.minimum(_LOG2[np.minimum(var >> 6, len(_LOG2) - 1)], 12), 0)
    y_pri = np.where(var > 0, (y_pri * (4 + var_str) + 8) >> 4, 0)
    out = [_filter(planes[0], active, y_pri, y_sec, fr.cdef_damping + cs, pri_dir, 0, 0, cs)]
    if len(planes) > 1:
        sx, sy = dec.ss[1]
        uv_pri = np.array([s[0] for s in fr.cdef_uv])[safe] << cs
        uv_sec = np.array([s[1] for s in fr.cdef_uv])[safe] << cs
        uv_dir = np.where(uv_pri == 0, 0, np.array(UV_DIR[(sx, sy)])[ydir])
        if (sx, sy) == (1, 0) and (active & (uv_pri > 0)).any():
            _hit("cdef_422")  # a 4:2:2 chroma direction through Cdef_Uv_Dir
        for plane in planes[1:]:
            out.append(_filter(plane, active, uv_pri, uv_sec, fr.cdef_damping + cs - 1, uv_dir,
                               sx, sy, cs))
    return out


def _filter(plane: np.ndarray, active, pri, sec, damping: int, dirs, sx: int, sy: int,
            cs: int) -> np.ndarray:
    """``cdef_filter`` of every active block of a plane at once.  A tap
    outside the frame reads a large negative sentinel, which ``constrain``
    turns to 0 and which never wins the maximum; the minimum skips it."""
    h, w = plane.shape
    bh, bw = 8 >> sy, 8 >> sx
    px = lambda a: np.repeat(np.repeat(a, bh, 0), bw, 1)  # noqa: E731
    on = px(active) & (px(pri) + px(sec) > 0)
    ys, xs = np.nonzero(on)
    if not ys.size:
        return plane
    src = plane.astype(np.int64)
    stride = w + 4
    flat = np.full((h + 4, stride), -(1 << 30), np.int64)
    flat[2:-2, 2:-2] = src
    flat = flat.reshape(-1)
    base = (ys + 2) * stride + xs + 2
    offsets = DIRECTIONS[..., 0] * stride + DIRECTIONS[..., 1]  # (direction, k)
    d = px(dirs)[ys, xs]
    p_str, s_str = px(pri)[ys, xs], px(sec)[ys, xs]
    if p_str.any():
        _hit("cdef_primary")
    if s_str.any():
        _hit("cdef_secondary")
    taps = PRI_TAPS[(p_str >> cs) & 1]
    x = src[ys, xs]
    total = np.zeros_like(x)
    hi, lo = x.copy(), x.copy()
    for strength, turns in ((p_str, (0,)), (s_str, (-2, 2))):
        if not strength.any():
            continue
        adj = np.maximum(0, damping - _LOG2[np.maximum(strength, 1)])
        for k in range(2):
            weight = taps[:, k] if turns == (0,) else SEC_TAPS[k]
            for turn in turns:
                off = offsets[(d + turn) & 7, k]
                for sign in (-1, 1):
                    v = flat[base + sign * off]
                    diff = v - x
                    a = np.abs(diff)
                    val = np.minimum(a, np.maximum(0, strength - (a >> adj)))
                    total += weight * np.where(diff < 0, -val, val)
                    hi = np.maximum(hi, v)
                    lo = np.minimum(lo, np.where(v < 0, x, v))
    out = src.copy()
    out[ys, xs] = np.clip(x + ((8 + total - (total < 0)) >> 4), lo, hi)
    return out.astype(plane.dtype)
