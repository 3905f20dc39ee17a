"""AV1 inverse transforms (the AV1 specification, section 7.13.3), bit-exact
with libaom's ``av1_inv_txfm2d``, in numpy.

The 1-D transforms are libaom's flow graphs: the DCT of 4 to 64 points
(the input in bit-reversed order, the even half a DCT of half the size,
the odd half its rotations and add/subtract stages), the ADST of 4 points
(``SINPI``), the ADST of 8 and 16 points, and identity scalings of 4 to 32.
Every rotation is a 12-bit ``half_btf`` (one rounding of a sum of two
products); every add/subtract stage clamps to the stage's range (the bit
depth plus 8 for rows, ``max(bd + 6, 16)`` for columns), as libaom's C code
does.  Each graph is compiled once into a list of stages over index arrays,
and a stage runs over all the rows (or columns) of a block at once.

:func:`inverse_transform` is the 2-D process: the 64-point sizes hold their
coefficients in the top-left 32 x 32, rectangular sizes of ratio 2 scale
the input by ``1/sqrt(2)`` (2896 / 4096), rows are clamped, transformed and
shifted by ``Transform_Row_Shift``, columns clamped, transformed and shifted
by 4, and flipped ADSTs reverse the output.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List

import numpy as np

COS = [round(4096 * math.cos(k * math.pi / 128)) for k in range(65)]
SINPI = (0, 1321, 2482, 3344, 3803)
DCT, ADST, FLIPADST, IDTX = range(4)
# (vertical, horizontal) 1-D type of each of the 16 transform types
TX_TYPE_1D = ((DCT, DCT), (ADST, DCT), (DCT, ADST), (ADST, ADST), (FLIPADST, DCT),
              (DCT, FLIPADST), (FLIPADST, FLIPADST), (ADST, FLIPADST), (FLIPADST, ADST),
              (IDTX, IDTX), (DCT, IDTX), (IDTX, DCT), (ADST, IDTX), (IDTX, ADST),
              (FLIPADST, IDTX), (IDTX, FLIPADST))


def _brev(bits: int, x: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


class _Graph:
    """Ops ``(kind, a, b, waa, wab, wba, wbb)`` on indices of one 1-D
    transform, scheduled into stages of ops on disjoint indices."""

    def __init__(self, n: int):
        self.n = n
        self.ops: List[tuple] = []

    def rot(self, a, b, waa, wab, wba, wbb):
        self.ops.append(("r", a, b, waa, wab, wba, wbb))

    def add(self, a, b, saa, sab, sba, sbb):
        self.ops.append(("a", a, b, saa, sab, sba, sbb))

    def stages(self):
        depth = [0] * self.n
        groups = {}
        for op in self.ops:
            d = max(depth[op[1]], depth[op[2]]) + 1
            depth[op[1]] = depth[op[2]] = d
            groups.setdefault((d, op[0]), []).append(op)
        out = []
        for (d, kind), ops in sorted(groups.items()):
            cols = list(zip(*ops))
            a, b = np.array(cols[1]), np.array(cols[2])
            w = [np.array(c, np.int64)[:, None] for c in cols[3:]]
            out.append((kind, a, b, *w))
        return out


def _dct(g: _Graph, idx: List[int]) -> None:
    """libaom's ``av1_idctN`` on ``idx`` (already in bit-reversed order)."""
    size = len(idx)
    if size == 2:
        g.rot(idx[0], idx[1], COS[32], COS[32], COS[32], -COS[32])
        return
    _dct(g, idx[: size // 2])
    odd = idx[size // 2:]
    half = len(odd)
    nbits = size.bit_length() - 1
    for i in range(half // 2):  # first rotations of the odd half
        k = (64 // size) * (1 + 4 * _brev(nbits - 2, i))
        g.rot(odd[i], odd[half - 1 - i], COS[64 - k], -COS[k], COS[k], COS[64 - k])
    levels = half.bit_length() - 1
    for m in range(1, levels):
        grp = 1 << m
        for q in range(half // grp):
            for j in range(grp // 2):
                a, b = odd[q * grp + j], odd[q * grp + grp - 1 - j]
                if q & 1:
                    g.add(a, b, -1, 1, 1, 1)
                else:
                    g.add(a, b, 1, 1, 1, -1)
        if m <= levels - 2:
            sub = size >> (m + 1)
            sbits = sub.bit_length() - 1
            for q in range(half >> (m + 2)):
                k = (64 // sub) * (1 + 4 * _brev(sbits - 2, q))
                for t in range(1 << m):
                    off = (q << (m + 1)) + (1 << (m - 1)) + t
                    a, b = odd[off], odd[half - 1 - off]
                    if t < 1 << (m - 1):
                        g.rot(a, b, -COS[k], COS[64 - k], COS[64 - k], COS[k])
                    else:
                        g.rot(a, b, -COS[64 - k], -COS[k], -COS[k], COS[64 - k])
    for t in range(half // 4):
        a, b = odd[half // 4 + t], odd[half - 1 - half // 4 - t]
        g.rot(a, b, -COS[32], COS[32], COS[32], COS[32])
    for i in range(size // 2):
        g.add(idx[i], idx[size - 1 - i], 1, 1, 1, -1)


def _adst(g: _Graph, size: int) -> None:
    """libaom's ``av1_iadst8`` / ``av1_iadst16`` after the input permutation."""
    step = 32 // size  # 4 for 8 points, 2 for 16
    c = COS
    for i in range(size // 2):
        k = step + 4 * step * i
        g.rot(2 * i, 2 * i + 1, c[k], c[64 - k], c[64 - k], -c[k])
    half = size // 2
    for i in range(half):
        g.add(i, i + half, 1, 1, 1, -1)
    if size == 16:
        g.rot(8, 9, c[8], c[56], c[56], -c[8])
        g.rot(10, 11, c[40], c[24], c[24], -c[40])
        g.rot(12, 13, -c[56], c[8], c[8], c[56])
        g.rot(14, 15, -c[24], c[40], c[40], c[24])
        for base in (0, 8):
            for i in range(4):
                g.add(base + i, base + 4 + i, 1, 1, 1, -1)
    for base in range(4, size, 8):
        g.rot(base, base + 1, c[16], c[48], c[48], -c[16])
        g.rot(base + 2, base + 3, -c[48], c[16], c[16], c[48])
    for base in range(0, size, 4):
        g.add(base, base + 2, 1, 1, 1, -1)
        g.add(base + 1, base + 3, 1, 1, 1, -1)
    for base in range(0, size, 4):
        g.rot(base + 2, base + 3, c[32], c[32], c[32], -c[32])


@lru_cache(maxsize=None)
def _program(kind: int, size: int):
    """(input permutation, stages, output permutation, output signs)."""
    g = _Graph(size)
    if kind == DCT:
        nbits = size.bit_length() - 1
        perm = [_brev(nbits, i) for i in range(size)]
        _dct(g, list(range(size)))
        return np.array(perm), g.stages(), None, None
    perm = [size - 1 - i if i % 2 == 0 else i - 1 for i in range(size)]
    _adst(g, size)
    if size == 8:
        out = (0, 4, 6, 2, 3, 7, 5, 1)
    else:
        out = (0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1)
    sign = np.array([1 if i % 2 == 0 else -1 for i in range(size)], np.int64)[:, None]
    return np.array(perm), g.stages(), np.array(out), sign


def _run(t: np.ndarray, stages, lo: int, hi: int) -> np.ndarray:
    for kind, a, b, waa, wab, wba, wbb in stages:
        x, y = t[a], t[b]
        if kind == "r":
            t[a] = (waa * x + wab * y + 2048) >> 12
            t[b] = (wba * x + wbb * y + 2048) >> 12
        else:
            t[a] = np.minimum(np.maximum(waa * x + wab * y, lo), hi)
            t[b] = np.minimum(np.maximum(wba * x + wbb * y, lo), hi)
    return t


def _adst4(t: np.ndarray) -> np.ndarray:
    x0, x1, x2, x3 = t[0], t[1], t[2], t[3]
    s0, s1 = SINPI[1] * x0, SINPI[2] * x0
    s2, s3 = SINPI[3] * x1, SINPI[4] * x2
    s4, s5, s6 = SINPI[1] * x2, SINPI[2] * x3, SINPI[4] * x3
    s7 = (x0 - x2) + x3
    s0, s1 = s0 + s3, s1 - s4
    s3, s2 = s2, SINPI[3] * s7
    s0, s1 = s0 + s5, s1 - s6
    out = np.stack([s0 + s3, s1 + s3, s2, s0 + s1 - s3])
    return (out + 2048) >> 12


def transform_1d(t: np.ndarray, kind: int, bits: int) -> np.ndarray:
    """One 1-D inverse transform of each column of ``t`` (n, M), int64:
    ``kind`` DCT, ADST (FLIPADST is an ADST; the caller flips) or IDTX,
    ``bits`` the range of the add/subtract stages."""
    n = t.shape[0]
    if kind == IDTX:
        if n == 4:
            return (t * 5793 + 2048) >> 12
        if n == 8:
            return t * 2
        if n == 16:
            return (t * 11586 + 2048) >> 12
        return t * 4
    if kind != DCT and n == 4:
        return _adst4(t)
    perm, stages, out, sign = _program(DCT if kind == DCT else ADST, n)
    t = _run(t[perm], stages, -(1 << (bits - 1)), (1 << (bits - 1)) - 1)
    return t if out is None else t[out] * sign


ROW_SHIFT = {(4, 4): 0, (8, 8): 1, (16, 16): 2, (32, 32): 2, (64, 64): 2, (4, 8): 0, (8, 4): 0,
             (8, 16): 1, (16, 8): 1, (16, 32): 1, (32, 16): 1, (32, 64): 1, (64, 32): 1,
             (4, 16): 1, (16, 4): 1, (8, 32): 2, (32, 8): 2, (16, 64): 2, (64, 16): 2}


def inverse_transform(coefs: np.ndarray, tx_type: int, bd: int) -> np.ndarray:
    """The residual (h, w) of a block's dequantised coefficients ``coefs``
    (h, w) int64 in the specification's row-major layout, only the top-left
    32 x 32 of a 64-point size nonzero."""
    h, w = coefs.shape
    vert, horz = TX_TYPE_1D[tx_type]
    row_shift = ROW_SHIFT[(w, h)]
    rect = abs((w.bit_length()) - (h.bit_length())) == 1
    row_hi = (1 << (bd + 7)) - 1
    col_bits = max(bd + 6, 16)
    col_hi = (1 << (col_bits - 1)) - 1
    rows = min(h, 32)
    x = coefs[:rows].T.copy()  # (w, rows): one column per row of coefficients
    if rect:
        x = (x * 2896 + 2048) >> 12
    x = np.minimum(np.maximum(x, -row_hi - 1), row_hi)
    x = transform_1d(x, horz, bd + 8)
    x = (x + ((1 << row_shift) >> 1)) >> row_shift
    if horz == FLIPADST:
        x = x[::-1]
    y = np.zeros((h, w), np.int64)
    y[:rows] = x.T
    y = np.minimum(np.maximum(y, -col_hi - 1), col_hi)
    y = transform_1d(y, vert, col_bits)
    y = (y + 8) >> 4
    if vert == FLIPADST:
        y = y[::-1]
    return y
