"""JPEG 2000 tier 1 (EBCOT) in plain Python, as OpenJPEG 2.5 decodes it.

:func:`decode_cblk` turns one code-block's segments into its coefficients:
the MQ arithmetic decoder (ISO/IEC 15444-1 annex C, with its 47-state
table) and the three coding passes of annex D (significance propagation,
magnitude refinement, cleanup with run-length mode) over the 19 contexts,
with every code-block style bit of ``COD``/``COC``: bypass (raw segments),
context reset, termination on each pass, vertically causal contexts,
predictable termination (no effect on decoding) and segmentation symbols.

The coefficients come out as OpenJPEG's ``t1`` keeps them: twice the
magnitude plus the half of the last decoded bit-plane, with the sign, so
the caller divides by 2 (5/3) or scales by half the step (9/7).  Each
segment is read as OpenJPEG reads it: its bytes followed by an artificial
``0xFF 0xFF`` marker, so a decoder that runs past its data reads ones.

State is kept per sample in flat lists over the block padded by one
sample on each side: ``nb`` holds the significance of the eight
neighbours (bits 0-7: NW, N, NE, W, E, SW, S, SE) and the signs of the
four direct ones (bits 8-11: N, W, E, S), updated when a sample becomes
significant; ``st`` holds the sample's own state (significant, negative,
visited in this bit-plane, refined before).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# MQ probability states: (Qe, next after MPS, next after LPS, switch MPS)
_QE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0),
    (0x0521, 5, 29, 0), (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0),
    (0x4801, 9, 14, 0), (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1), (0x5401, 16, 14, 0),
    (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0),
    (0x1201, 29, 26, 0), (0x1101, 30, 27, 0), (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0),
    (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0),
    (0x0005, 45, 42, 0), (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)
# the 94 (state, MPS) pairs as OpenJPEG's table: index 2 * state + mps
QEVAL = [_QE[i >> 1][0] for i in range(94)]
MPS = [i & 1 for i in range(94)]
NMPS = [2 * _QE[i >> 1][1] + (i & 1) for i in range(94)]
NLPS = [2 * _QE[i >> 1][2] + ((i & 1) ^ _QE[i >> 1][3]) for i in range(94)]

# contexts: 9 zero coding, 5 sign, 3 magnitude refinement, run-length, uniform
CTX_ZC, CTX_SC, CTX_MAG, CTX_AGG, CTX_UNI = 0, 9, 14, 17, 18
NUM_CTX = 19

# code-block style bits (COD/COC SPcod); 0x10, predictable termination,
# changes nothing in decoding
LAZY, RESET, TERMALL, VSC, SEGSYM, HT = 0x01, 0x02, 0x04, 0x08, 0x20, 0x40

# per-sample state bits
_SIG, _NEG, _VISIT, _REFINED = 1, 2, 4, 8


class T1Error(ValueError):
    """A code-block OpenJPEG refuses to decode."""


def _zc_context(nb: int, orient: int) -> int:
    """Zero-coding context (Table D.1) of a neighbourhood mask, for the
    band ``orient`` (0 LL, 1 HL, 2 LH, 3 HH): HL counts its vertical
    neighbours where LL and LH count their horizontal ones."""
    h = ((nb >> 3) & 1) + ((nb >> 4) & 1)
    v = ((nb >> 1) & 1) + ((nb >> 6) & 1)
    d = (nb & 1) + ((nb >> 2) & 1) + ((nb >> 5) & 1) + ((nb >> 7) & 1)
    if orient == 3:
        hv = h + v
        if d == 0:
            return min(hv, 2)
        if d == 1:
            return 3 + min(hv, 2)
        if d == 2:
            return 6 if hv == 0 else 7
        return 8
    if orient == 1:
        h, v = v, h
    if h == 0:
        if v == 0:
            return min(d, 2)
        return 3 if v == 1 else 4
    if h == 1:
        if v == 0:
            return 5 if d == 0 else 6
        return 7
    return 8


def _sc_context(nb: int) -> Tuple[int, int]:
    """Sign context and the bit it is XORed with (Table D.3)."""
    def contribution(sig_bit, neg_bit):
        if not (nb >> sig_bit) & 1:
            return 0
        return -1 if (nb >> neg_bit) & 1 else 1

    hc = max(-1, min(1, contribution(3, 9) + contribution(4, 10)))
    vc = max(-1, min(1, contribution(1, 8) + contribution(6, 11)))
    if hc < 0 or (hc == 0 and vc < 0):
        hc, vc, xor = -hc, -vc, 1
    else:
        xor = 0
    ctx = {(1, 1): 4, (1, 0): 3, (1, -1): 2, (0, 1): 1, (0, 0): 0}[(hc, vc)]
    return CTX_SC + ctx, xor


ZC_LUT = [[CTX_ZC + _zc_context(nb, orient) for nb in range(256)] for orient in range(4)]
SC_LUT = [_sc_context(nb) for nb in range(4096)]


def _reset_states() -> List[int]:
    """The context states at a block's start and on a context reset
    (OpenJPEG: uniform at 46, run-length at 3, the first zero-coding
    context at 4, the others at 0)."""
    states = [0] * NUM_CTX
    states[CTX_UNI], states[CTX_AGG], states[CTX_ZC] = 2 * 46, 2 * 3, 2 * 4
    return states


class MQDecoder:
    """OpenJPEG's MQ decoder (``mqc.c``: INITDEC, DECODE, RENORMD, BYTEIN
    of annex C) and its raw reader for bypass segments, over one segment
    followed by an artificial ``0xFF 0xFF``."""

    __slots__ = ("buf", "bp", "a", "c", "ct", "states")

    def __init__(self, states: List[int]):
        self.states = states
        self.buf, self.bp, self.a, self.c, self.ct = b"\xff\xff", 0, 0, 0, 0

    def init(self, segment: bytes) -> None:
        self.buf = bytes(segment) + b"\xff\xff"
        self.bp = 0
        self.c = self.buf[0] << 16
        self.bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def init_raw(self, segment: bytes) -> None:
        self.buf = bytes(segment) + b"\xff\xff"
        self.bp, self.c, self.ct = 0, 0, 0

    def bytein(self) -> None:
        buf, bp = self.buf, self.bp
        nxt = buf[bp + 1]
        if buf[bp] == 0xFF:
            if nxt > 0x8F:
                self.c = (self.c + 0xFF00) & 0xFFFFFFFF
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c = (self.c + (nxt << 9)) & 0xFFFFFFFF
                self.ct = 7
        else:
            self.bp = bp + 1
            self.c = (self.c + (nxt << 8)) & 0xFFFFFFFF
            self.ct = 8

    def decode(self, cx: int) -> int:
        states = self.states
        s = states[cx]
        qe = QEVAL[s]
        a = self.a - qe
        c = self.c
        if (c >> 16) < qe:
            if a < qe:
                d = s & 1
                states[cx] = NMPS[s]
            else:
                d = (s & 1) ^ 1
                states[cx] = NLPS[s]
            a = qe
        else:
            c -= qe << 16
            if a & 0x8000:
                self.a, self.c = a, c
                return s & 1
            if a < qe:
                d = (s & 1) ^ 1
                states[cx] = NLPS[s]
            else:
                d = s & 1
                states[cx] = NMPS[s]
        ct = self.ct
        while True:
            if ct == 0:
                self.c = c
                self.bytein()
                c, ct = self.c, self.ct
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct
        return d

    def raw(self) -> int:
        if self.ct == 0:
            buf, bp = self.buf, self.bp
            if self.c == 0xFF:
                if buf[bp] > 0x8F:
                    self.c, self.ct = 0xFF, 8
                else:
                    self.c, self.bp, self.ct = buf[bp], bp + 1, 7
            else:
                self.c, self.bp, self.ct = buf[bp], bp + 1, 8
        self.ct -= 1
        return (self.c >> self.ct) & 1


def _int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def decode_cblk(w: int, h: int, orient: int, cblksty: int, numbps: int, roishift: int,
                segments: Sequence[Tuple[bytes, int]]) -> np.ndarray:
    """Coefficients (int64, ``(h, w)``, module doc) of a ``w`` x ``h``
    code-block of band ``orient`` from its ``segments`` (bytes, passes),
    as ``opj_t1_decode_cblk`` decodes them: ``numbps`` is the block's
    bit-planes (OpenJPEG's unsigned ``cblk->numbps``, kept as an int)."""
    bpno_plus_one = _int32(roishift + numbps)
    if bpno_plus_one >= 31:
        raise T1Error(f"unsupported bpno_plus_one = {bpno_plus_one} >= 31")
    if not segments or bpno_plus_one < 1:
        return np.zeros((h, w), np.int64)
    W = w + 2
    fl = [0] * (W * (h + 2))  # per sample: neighbours (bits 0-11), own state (12-15)
    val = [0] * (W * (h + 2))
    states = _reset_states()
    mq = MQDecoder(states)
    decode, rawbit = mq.decode, mq.raw
    zc = ZC_LUT[orient]
    vsc = bool(cblksty & VSC)
    full = h & ~3
    # the padded index of each stripe's first row, and of the rows of a stripe
    stripes = [((k + 1) * W, k, min(4, h - k)) for k in range(0, h, 4)]
    SIG, NEG, VISIT, REFINED = _SIG << 12, _NEG << 12, _VISIT << 12, _REFINED << 12
    SIG_VISIT = SIG | VISIT
    W2, W3 = 2 * W, 3 * W
    # significant samples per stripe (padded by one stripe on each side): a
    # stripe whose neighbourhood has none has nothing for the significance
    # and refinement passes, and only run-length columns for the cleanup
    active = [0] * (len(stripes) + 2)

    def significant(p, neg, y):
        """Mark sample p (row y) significant with sign ``neg``."""
        active[(y >> 2) + 1] += 1
        fl[p] |= SIG | (NEG if neg else 0)
        fl[p - 1] |= 0x10 | (neg << 10)
        fl[p + 1] |= 0x08 | (neg << 9)
        q = p + W
        fl[q - 1] |= 0x04
        fl[q] |= 0x02 | (neg << 8)
        fl[q + 1] |= 0x01
        if not (vsc and (y & 3) == 0):
            q = p - W
            fl[q - 1] |= 0x80
            fl[q] |= 0x40 | (neg << 11)
            fl[q + 1] |= 0x20

    def sigpass(bpno, raw):
        oneplushalf = (1 << bpno) | (1 << (bpno - 1))
        for si, (base, k, n) in enumerate(stripes):
            if not (active[si] or active[si + 1] or active[si + 2]):
                continue
            for x in range(1, w + 1):
                p = base + x
                if n == 4 and not (fl[p] | fl[p + W] | fl[p + W2] | fl[p + W3]):
                    continue
                for i in range(n):
                    f = fl[p]
                    if f & 0xFF and not f & SIG_VISIT:
                        y = k + i
                        if raw:
                            if rawbit():
                                neg = rawbit()
                                val[p] = -oneplushalf if neg else oneplushalf
                                significant(p, neg, y)
                        elif decode(zc[f & 0xFF]):
                            cx, xor = SC_LUT[f & 0xFFF]
                            neg = decode(cx) ^ xor
                            val[p] = -oneplushalf if neg else oneplushalf
                            significant(p, neg, y)
                        fl[p] |= VISIT
                    p += W

    def refpass(bpno, raw):
        poshalf = (1 << bpno) >> 1
        for si, (base, k, n) in enumerate(stripes):
            if not active[si + 1]:
                continue
            for x in range(1, w + 1):
                p = base + x
                if n == 4 and not (fl[p] | fl[p + W] | fl[p + W2] | fl[p + W3]) & SIG:
                    continue
                for i in range(n):
                    f = fl[p]
                    if f & SIG_VISIT == SIG:
                        if raw:
                            v = rawbit()
                        else:
                            v = decode(CTX_MAG + 2 if f & REFINED else
                                       (CTX_MAG + 1 if f & 0xFF else CTX_MAG))
                        if v ^ (val[p] < 0):
                            val[p] += poshalf
                        else:
                            val[p] -= poshalf
                        fl[p] = f | REFINED
                    p += W

    def clean_one(p, y, oneplushalf):
        cx, xor = SC_LUT[fl[p] & 0xFFF]
        neg = decode(cx) ^ xor
        val[p] = -oneplushalf if neg else oneplushalf
        significant(p, neg, y)

    def cleanpass(bpno):
        oneplushalf = (1 << bpno) | (1 << (bpno - 1))
        for si, (base, k, n) in enumerate(stripes):
            calm = k < full and not (active[si] or active[si + 1] or active[si + 2])
            for x in range(1, w + 1):
                p = base + x
                if calm or (k < full and not (fl[p] | fl[p + W] | fl[p + W2] | fl[p + W3])):
                    # the run-length decision, its common case (an MPS without
                    # renormalisation) inline
                    st = states[CTX_AGG]
                    qe = QEVAL[st]
                    a = mq.a - qe
                    if a & 0x8000 and (mq.c >> 16) >= qe:
                        mq.a = a
                        mq.c -= qe << 16
                        hit = st & 1
                    else:
                        hit = decode(CTX_AGG)
                    if hit:
                        calm = False
                        run = decode(CTX_UNI) << 1
                        run |= decode(CTX_UNI)
                        q = p + run * W
                        clean_one(q, k + run, oneplushalf)
                        for i in range(run + 1, 4):
                            q += W
                            if decode(zc[fl[q] & 0xFF]):
                                clean_one(q, k + i, oneplushalf)
                    continue
                for i in range(n):
                    f = fl[p]
                    if not f & SIG_VISIT:
                        if decode(zc[f & 0xFF]):
                            clean_one(p, k + i, oneplushalf)
                    else:
                        fl[p] = f & ~VISIT
                    p += W
        if cblksty & SEGSYM:
            for _ in range(4):
                decode(CTX_UNI)

    passtype = 2
    numbps32 = _int32(numbps)
    for segment, npasses in segments:
        raw = bool(bpno_plus_one <= numbps32 - 4 and passtype < 2 and cblksty & LAZY)
        if raw:
            mq.init_raw(segment)
        else:
            mq.init(segment)
        for _ in range(npasses):
            if bpno_plus_one < 1:
                break
            if passtype == 0:
                sigpass(bpno_plus_one, raw)
            elif passtype == 1:
                refpass(bpno_plus_one, raw)
            else:
                cleanpass(bpno_plus_one)
            if cblksty & RESET and not raw:
                states[:] = _reset_states()
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno_plus_one -= 1
    out = np.array(val, np.int64).reshape(h + 2, W)
    return out[1 : h + 1, 1 : w + 1]
