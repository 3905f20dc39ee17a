"""Arithmetic-coded JPEG entropy decoding, as libjpeg-turbo's ``jdarith.c``.

The QM decoder of T.81 Annex D (:class:`_QM`) with libjpeg's register
layout (a floating cut between the code base and the bit buffer in ``C``),
its table of 113 probability states (T.81 Table D.2) plus the fixed
state 113 that codes signs at probability 0.5, and the four MCU decoders
of ``jdarith.c``: sequential (DC and AC of every block), progressive DC
first and refinement, progressive AC first and refinement.  Conditioning
follows the ``DAC`` marker's bounds L, U (DC) and K (AC).

One restart interval is decoded from its unstuffed bytes; past them the
decoder reads zero bytes, as libjpeg supplies zero data once it meets a
marker.  A magnitude or spectral overflow ends the interval, as
``jdarith.c``'s ``ct = -1`` skips the rest of the interval: the blocks
already decoded keep their values.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

# (Qe, next state after an LPS with the MPS switch in bit 7, next state after an MPS)
_QE: List[Tuple[int, int, int]] = [
    (qe, lps | (switch << 7), mps) for qe, lps, mps, switch in (
        (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
        (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
        (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
        (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
        (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
        (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
        (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
        (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
        (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
        (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
        (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
        (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
        (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
        (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
        (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
        (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
        (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
        (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
        (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
        (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
        (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
        (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
        (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
        (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
        (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
        (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
        (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
        (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
        (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0))
]


class _Overflow(Exception):
    """``jdarith.c``'s ``ct = -1``: the rest of the interval is skipped."""


class _QM:
    """``arith_decode`` over one interval's unstuffed bytes (zeros after them)."""

    __slots__ = ("data", "pos", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        self.c, self.a, self.ct = 0, 0, -16  # ct -16: fetch two bytes first

    def decode(self, st: List[int], i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                if self.pos < len(self.data):
                    c = (c << 8) | self.data[self.pos]
                    self.pos += 1
                else:
                    c <<= 8
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000  # two initial bytes read
            a <<= 1
        sv = st[i]
        qe, nl, nm = _QE[sv & 0x7F]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ nm
            else:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _ac_magnitude(qm: _QM, st: List[int], at: int, top: int) -> int:
    """F.23 and F.24 of an AC value from bin ``at`` (after its sign), with
    ``top`` its first X bin (189 up to K, 217 above)."""
    m = qm.decode(st, at)
    if m and qm.decode(st, at):
        m <<= 1
        at = top
        while qm.decode(st, at):
            m <<= 1
            if m == 0x8000:
                raise _Overflow
            at += 1
    v = m
    at += 14
    while m > 1:
        m >>= 1
        if qm.decode(st, at):
            v |= m
    return v + 1


def _dc_diff(qm: _QM, st: List[int], ctx: List[int], k: int, lower: int, upper: int) -> int:
    """F.19: one DC difference in a component's bins, updating its context."""
    s0 = ctx[k]
    if not qm.decode(st, s0):
        ctx[k] = 0
        return 0
    sign = qm.decode(st, s0 + 1)
    at = s0 + 2 + sign
    m = qm.decode(st, at)
    if m:
        at = 20
        while qm.decode(st, at):
            m <<= 1
            if m == 0x8000:
                raise _Overflow
            at += 1
    if m < (1 << lower) >> 1:
        ctx[k] = 0
    elif m > (1 << upper) >> 1:
        ctx[k] = 12 + 4 * sign
    else:
        ctx[k] = 4 + 4 * sign
    v = m
    at += 14
    while m > 1:
        m >>= 1
        if qm.decode(st, at):
            v |= m
    v += 1
    return -v if sign else v


def _ac_value(qm: _QM, st: List[int], at: int, k: int, kx: int, fixed: List[int]) -> int:
    sign = qm.decode(fixed, 0)
    v = _ac_magnitude(qm, st, at + 2, 189 if k <= kx else 217)
    return -v if sign else v


def decode_interval(data: bytes, blocks: Sequence, mode: str, tables: Sequence[Tuple[int, int]],
                    conditioning: Sequence[Tuple[int, int, int]], ss: int, se: int, al: int,
                    natural: Sequence[int]) -> None:
    """Decode one restart interval into the blocks' coefficients.  ``blocks``
    holds (component in scan, coefficient list, offset, first block of its
    MCU, iMCU row); ``mode`` is ``sequential``, ``dc_first``, ``dc_refine``,
    ``ac_first`` or ``ac_refine``; ``tables[k]`` is the scan's component k's
    (DC, AC) conditioning table and ``conditioning[k]`` its (L, U, K).
    Statistics bins belong to tables, DC predictions and contexts to
    components."""
    qm = _QM(data)
    fixed = [113]
    dc_bins = {t: [0] * 64 for t, _ in tables}
    ac_bins = {t: [0] * 256 for _, t in tables}
    last = [0] * len(tables)
    ctx = [0] * len(tables)
    try:
        if mode == "dc_refine":
            p1 = 1 << al
            for _k, coef, base, _start, _row in blocks:
                if qm.decode(fixed, 0):
                    coef[base] |= p1
            return
        for k, coef, base, _start, _row in blocks:
            lower, upper, kx = conditioning[k]
            if mode in ("sequential", "dc_first"):
                diff = _dc_diff(qm, dc_bins[tables[k][0]], ctx, k, lower, upper)
                if diff:
                    last[k] = (last[k] + diff) & 0xFFFF
                coef[base] = last[k] << al
                if mode == "dc_first":
                    continue
            st = ac_bins[tables[k][1]]
            if mode == "ac_refine":
                p1, m1 = 1 << al, -1 << al
                kex = se
                while kex > 0 and not coef[base + natural[kex]]:
                    kex -= 1
                i = ss
                while i <= se:
                    at = 3 * (i - 1)
                    if i > kex and qm.decode(st, at):
                        break
                    while True:
                        pos = base + natural[i]
                        c = coef[pos]
                        if c:
                            if qm.decode(st, at + 2):
                                coef[pos] = c + (m1 if c < 0 else p1)
                            break
                        if qm.decode(st, at + 1):
                            coef[pos] = m1 if qm.decode(fixed, 0) else p1
                            break
                        at += 3
                        i += 1
                        if i > se:
                            raise _Overflow
                    i += 1
                continue
            first, top = (1, 63) if mode == "sequential" else (ss, se)
            i = first
            while i <= top:
                at = 3 * (i - 1)
                if qm.decode(st, at):
                    break  # end of block
                while not qm.decode(st, at + 1):
                    at += 3
                    i += 1
                    if i > top:
                        raise _Overflow
                coef[base + natural[i]] = _ac_value(qm, st, at, i, kx, fixed) << al
                i += 1
    except _Overflow:
        return
