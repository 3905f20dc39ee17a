"""The WebP lossy (VP8 key frame) decoder in Python and numpy, exact against
libwebp (``src/dec/vp8_dec.c``, ``tree_dec.c``, ``quant_dec.c``,
``frame_dec.c``, ``src/dsp/dec.c``, ``yuv.h``, ``upsampling.c``).

:func:`decode_vp8` decodes a ``VP8 `` chunk's bitstream (with whatever
follows it in the file: libwebp reads the last partition to the end of the
data) to the Y, U and V planes, and :func:`yuv_to_rgb` turns them into RGB
as libwebp's default output does.  Every step is integer arithmetic:

* **Frame tag.** A key frame, shown, version at most 3, a first partition
  no longer than the data; the start code 9d 01 2a; 14-bit width and
  height (the scale bits are ignored).
* **Boolean decoder.** libwebp's ``VP8BitReader`` on a 64-bit build: 56
  bits loaded at a time into a 64-bit value compared as 32 bits (which a
  corrupt stream, its value past its range, reaches); past the end it
  shifts in zeros and sets ``eof`` on the first byte it lacks.  A token partition
  that reaches its end inside a macroblock, or the first partition inside
  a row of modes, fails the frame; so does a partition of no bytes that a
  row uses.
* **Header.** Colour space and clamping bits; segmentation (map
  probabilities, absolute or delta quantizer and filter values); simple or
  normal filter, level, sharpness and the loop-filter deltas (on a key
  frame only ``ref_frame[0]`` and, for B_PRED, ``mode[0]`` apply); 1, 2, 4
  or 8 token partitions, each sized by 3 bytes but the last, which takes the
  rest and must hold a byte; the quantizer indices and deltas; the
  coefficient probability updates; the skip probability.
* **Dequantization.** ``DC_TABLE``/``AC_TABLE``; y2dc x 2, y2ac x 155/100
  (at least 8), uvdc from an index at most 117.  Products are kept to
  16 bits, as libwebp stores them.
* **Macroblocks.** Segment id, skip flag, the 16 x 16 mode or B_PRED with
  ten 4 x 4 modes under the contextual probabilities, the chroma mode;
  tokens with the band map, zigzag and three non-zero contexts; Y2 and its
  Walsh-Hadamard transform when the luma mode is not B_PRED.
* **Reconstruction.** Prediction from unfiltered pixels: 127 above the
  frame, 129 left of it (the corner 127 on the top row, else 129), DC over
  the edges there are, TM clipped; a B_PRED block's above-right pixels come
  from the row above, the right column's from the macroblock above and to
  the right (its last pixel replicated on the last column).  The inverse
  DCT (20091/35468) is libwebp's x86 one: 16-bit arithmetic for a block
  with coefficients past the third, 32-bit for the DC-only and three-
  coefficient forms.
* **Loop filter.** Per segment and mode: interior limit from level and
  sharpness, edge limit ``2 * level + interior``, high-edge-variance
  threshold 2 from level 40 and 1 from 15; simple (luma, 2 taps) or normal
  (luma and chroma; 6 taps on macroblock edges, 4 inside; 2 where the edge
  variance is high); inner edges skipped for a macroblock with no
  coefficient that is not B_PRED; level 0 filters nothing.  Macroblocks are
  filtered in libwebp's raster order (run here along the anti-diagonals
  ``x + 2y`` of macroblocks, which touch disjoint pixels).
* **Colour.** ``UpsampleRgbLinePair``'s (9, 3, 3, 1)/16 chroma upsampling,
  edges included, then ``VP8YuvToRgb`` (``MultHi`` with 19077, 26149,
  6419, 13320, 33050 and the -14234, +8708, -17685 offsets, 14-bit fixed
  point clipped).

The boolean decoding runs in Python a bit at a time; transforms, 16 x 16 and
chroma prediction, the loop filter and the colour conversion in numpy.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from molnextr_tpu_torch.data.vp8_tables import (AC_TABLE, BMODES_PROBA, COEFFS_PROBA0,
                                                COEFFS_UPDATE_PROBA, DC_TABLE)


class VP8Error(ValueError):
    """A VP8 bitstream that libwebp refuses."""


_NORM = [0] + [7 - (r.bit_length() - 1) for r in range(1, 256)]
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# kYModesIntra4: node -> (child on 0, child on 1); a leaf is -mode
_YMODES4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
_BMODES = [[[BMODES_PROBA[(t * 10 + l) * 9 + k] for k in range(9)] for l in range(10)]
           for t in range(10)]
DC, TM, VE, HE = 0, 1, 2, 3  # 16 x 16 and chroma modes, as the 4 x 4 ones


_M64 = (1 << 64) - 1  # libwebp's bit_t


def _w16(x):
    """Keep x to 16 bits, as C stores it in an int16_t."""
    return ((x + 32768) & 0xFFFF) - 32768


class _Bool:
    """libwebp's ``VP8BitReader`` over ``data[start:end]``."""

    __slots__ = ("buf", "pos", "end", "value", "bits", "range", "eof")

    def __init__(self, data: bytes, start: int, end: int):
        self.buf, self.pos, self.end = data, start, end
        self.value, self.bits, self.range, self.eof = 0, -8, 254, False
        self._load()

    def _load(self) -> None:
        if self.end - self.pos >= 8:  # 56 bits at a time, as a 64-bit build
            self.value = ((self.value << 56) & _M64) \
                | int.from_bytes(self.buf[self.pos : self.pos + 7], "big")
            self.pos += 7
            self.bits += 56
        elif self.pos < self.end:
            self.value = ((self.value << 8) & _M64) | self.buf[self.pos]
            self.pos += 1
            self.bits += 8
        elif not self.eof:
            self.value = (self.value << 8) & _M64
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def get(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        bits, rng = self.bits, self.range
        split = (rng * prob) >> 8
        if ((self.value >> bits) & 0xFFFFFFFF) > split:
            rng -= split
            self.value = (self.value - ((split + 1) << bits)) & _M64
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = _NORM[rng]
        self.range = (rng << shift) - 1
        self.bits = bits - shift
        return bit

    def sign(self) -> bool:
        """``VP8GetSigned``: a sign bit at probability 1/2, decided on the
        sign of a 32-bit difference (which a stream in a state no encoder
        makes can tell from ``get(0x80)``)."""
        if self.bits < 0:
            self._load()
        bits = self.bits
        split = self.range >> 1
        negative = ((split - ((self.value >> bits) & 0xFFFFFFFF)) & 0xFFFFFFFF) >= 1 << 31
        self.bits = bits - 1
        if negative:
            self.range = (self.range - 1) | 1
            self.value = (self.value - ((split + 1) << bits)) & _M64
        else:
            self.range |= 1
        return negative

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get(0x80)
        return v

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.get(0x80) else v

    def large(self, p) -> int:
        """``GetLargeValue``: a token's magnitude from 2 up."""
        get = self.get
        if not get(p[3]):
            return 2 if not get(p[4]) else 3 + get(p[5])
        if not get(p[6]):
            if not get(p[7]):
                return 5 + get(159)
            return 7 + 2 * get(165) + get(145)
        bit1 = get(p[8])
        cat = 2 * bit1 + get(p[9 + bit1])
        v = 0
        for prob in _CAT[cat]:
            v = 2 * v + get(prob)
        return v + 3 + (8 << cat)

    def coeffs(self, bands, ctx: int, dq: Tuple[int, int], n: int, out: list, base: int) -> int:
        """``GetCoeffs``: one block's tokens from position ``n``, dequantized
        into ``out[base:base + 16]`` in raster order; returns the position
        after the last non-zero one (16 at most)."""
        get = self.get
        p = bands[n][ctx]
        while n < 16:
            if not get(p[0]):
                return n
            while not get(p[1]):
                n += 1
                if n == 16:
                    return 16
                p = bands[n][0]
            if not get(p[2]):
                v = 1
                p = bands[n + 1][1]
            else:
                v = self.large(p)
                p = bands[n + 1][2]
            if self.sign():
                v = -v
            out[base + _ZIGZAG[n]] = _w16(v * dq[n > 0])
            n += 1
        return 16


class _Header:
    """What the frame header and its first partition's header say."""

    def __init__(self):
        self.use_segment = self.update_map = False
        self.absolute = True
        self.seg_quant = [0] * 4
        self.seg_filter = [0] * 4
        self.seg_proba = [255] * 3
        self.simple = 0
        self.level = self.sharpness = 0
        self.use_lf_delta = False
        self.ref_delta = [0] * 4
        self.mode_delta = [0] * 4


def _parse_header(br: _Bool, hdr: _Header) -> None:
    br.get(0x80)  # colour space
    br.get(0x80)  # clamping type
    hdr.use_segment = bool(br.get(0x80))
    if hdr.use_segment:
        hdr.update_map = bool(br.get(0x80))
        if br.get(0x80):  # update the segment values
            hdr.absolute = bool(br.get(0x80))
            hdr.seg_quant = [br.signed(7) if br.get(0x80) else 0 for _ in range(4)]
            hdr.seg_filter = [br.signed(6) if br.get(0x80) else 0 for _ in range(4)]
        if hdr.update_map:
            hdr.seg_proba = [br.value_bits(8) if br.get(0x80) else 255 for _ in range(3)]
    if br.eof:
        raise VP8Error("VP8: cannot parse the segment header")
    hdr.simple = br.get(0x80)
    hdr.level = br.value_bits(6)
    hdr.sharpness = br.value_bits(3)
    hdr.use_lf_delta = bool(br.get(0x80))
    if hdr.use_lf_delta and br.get(0x80):
        for i in range(4):
            if br.get(0x80):
                hdr.ref_delta[i] = br.signed(6)
        for i in range(4):
            if br.get(0x80):
                hdr.mode_delta[i] = br.signed(6)
    if br.eof:
        raise VP8Error("VP8: cannot parse the filter header")


def _quant(br: _Bool, hdr: _Header) -> list:
    """``VP8ParseQuant``: per segment ((y1 dc, ac), (y2 dc, ac), (uv dc, ac))."""
    base = br.value_bits(7)
    dy1dc, dy2dc, dy2ac, duvdc, duvac = (br.signed(4) if br.get(0x80) else 0 for _ in range(5))

    def clip(v, m):
        return 0 if v < 0 else m if v > m else v

    out = []
    for s in range(4):
        if hdr.use_segment:
            q = hdr.seg_quant[s] + (0 if hdr.absolute else base)
        elif s > 0:
            out.append(out[0])
            continue
        else:
            q = base
        y2ac = AC_TABLE[clip(q + dy2ac, 127)] * 101581 >> 16
        out.append(((DC_TABLE[clip(q + dy1dc, 127)], AC_TABLE[clip(q, 127)]),
                    (DC_TABLE[clip(q + dy2dc, 127)] * 2, max(y2ac, 8)),
                    (DC_TABLE[clip(q + duvdc, 117)], AC_TABLE[clip(q + duvac, 127)])))
    return out


def _filter_strengths(hdr: _Header) -> list:
    """``PrecomputeFilterStrengths``: [segment][is 4x4] -> (limit, interior
    limit, hev threshold), limit 0 for none."""
    out = []
    for s in range(4):
        base = hdr.level
        if hdr.use_segment:
            base = hdr.seg_filter[s] + (0 if hdr.absolute else hdr.level)
        row = []
        for i4 in (0, 1):
            level = base
            if hdr.use_lf_delta:
                level += hdr.ref_delta[0] + (hdr.mode_delta[0] if i4 else 0)
            level = 0 if level < 0 else 63 if level > 63 else level
            if level > 0:
                ilevel = level
                if hdr.sharpness > 0:
                    ilevel >>= 2 if hdr.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - hdr.sharpness)
                ilevel = max(ilevel, 1)
                hev = 2 if level >= 40 else 1 if level >= 15 else 0
                row.append((2 * level + ilevel, ilevel, hev))
            else:
                row.append((0, 0, 0))
        out.append(row)
    return out


# ----- prediction ---------------------------------------------------------

def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, X, A, B, C, D, E, F, G, H, I, J, K, L) -> List[List[int]]:
    """libwebp's ``VP8PredLuma4[mode]``: rows of a 4 x 4 block from its top-
    left X, top A-D, top-right E-H and left I-L."""
    if mode == 0:  # DC
        dc = (A + B + C + D + I + J + K + L + 4) >> 3
        return [[dc] * 4 for _ in range(4)]
    if mode == 1:  # TM
        top = (A, B, C, D)
        return [[min(max(t + left - X, 0), 255) for t in top] for left in (I, J, K, L)]
    if mode == 2:  # VE
        return [[_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]] * 4
    if mode == 3:  # HE
        return [[v] * 4 for v in (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))]
    if mode == 4:  # RD
        e = [_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I), _avg3(B, A, X),
             _avg3(C, B, A), _avg3(D, C, B)]
        return [[e[3 - y + x] for x in range(4)] for y in range(4)]
    if mode == 5:  # VR
        r = [[0] * 4 for _ in range(4)]
        r[0][0] = r[2][1] = _avg2(X, A)
        r[0][1] = r[2][2] = _avg2(A, B)
        r[0][2] = r[2][3] = _avg2(B, C)
        r[0][3] = _avg2(C, D)
        r[3][0] = _avg3(K, J, I)
        r[2][0] = _avg3(J, I, X)
        r[1][0] = r[3][1] = _avg3(I, X, A)
        r[1][1] = r[3][2] = _avg3(X, A, B)
        r[1][2] = r[3][3] = _avg3(A, B, C)
        r[1][3] = _avg3(B, C, D)
        return r
    if mode == 6:  # LD
        e = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(E, F, G),
             _avg3(F, G, H), _avg3(G, H, H)]
        return [[e[x + y] for x in range(4)] for y in range(4)]
    if mode == 7:  # VL
        r = [[0] * 4 for _ in range(4)]
        r[0][0] = _avg2(A, B)
        r[0][1] = r[2][0] = _avg2(B, C)
        r[0][2] = r[2][1] = _avg2(C, D)
        r[0][3] = r[2][2] = _avg2(D, E)
        r[1][0] = _avg3(A, B, C)
        r[1][1] = r[3][0] = _avg3(B, C, D)
        r[1][2] = r[3][1] = _avg3(C, D, E)
        r[1][3] = r[3][2] = _avg3(D, E, F)
        r[2][3] = _avg3(E, F, G)
        r[3][3] = _avg3(F, G, H)
        return r
    if mode == 8:  # HD
        r = [[0] * 4 for _ in range(4)]
        r[0][0] = r[1][2] = _avg2(I, X)
        r[1][0] = r[2][2] = _avg2(J, I)
        r[2][0] = r[3][2] = _avg2(K, J)
        r[3][0] = _avg2(L, K)
        r[0][3] = _avg3(A, B, C)
        r[0][2] = _avg3(X, A, B)
        r[0][1] = r[1][3] = _avg3(I, X, A)
        r[1][1] = r[2][3] = _avg3(J, I, X)
        r[2][1] = r[3][3] = _avg3(K, J, I)
        r[3][1] = _avg3(L, K, J)
        return r
    # 9: HU
    r = [[L] * 4 for _ in range(4)]
    r[0][0] = _avg2(I, J)
    r[0][2] = r[1][0] = _avg2(J, K)
    r[1][2] = r[2][0] = _avg2(K, L)
    r[0][1] = _avg3(I, J, K)
    r[0][3] = r[1][1] = _avg3(J, K, L)
    r[1][3] = r[2][1] = _avg3(K, L, L)
    return r


def _pred_block(mode: int, top: np.ndarray, left: np.ndarray, corner: int, size: int,
                mbx: int, mby: int) -> np.ndarray:
    """A 16 x 16 luma or 8 x 8 chroma prediction (``CheckMode`` for DC)."""
    if mode == DC:
        half = size.bit_length() - 1  # log2(size)
        if mbx and mby:
            v = (int(top.sum()) + int(left.sum()) + size) >> (half + 1)
        elif mby:  # no left
            v = (int(top.sum()) + size // 2) >> half
        elif mbx:  # no top
            v = (int(left.sum()) + size // 2) >> half
        else:
            v = 128
        return np.full((size, size), v, np.int32)
    if mode == VE:
        return np.broadcast_to(top, (size, size)).astype(np.int32)
    if mode == HE:
        return np.broadcast_to(left[:, None], (size, size)).astype(np.int32)
    return np.clip(top[None, :].astype(np.int32) + left[:, None] - corner, 0, 255)


# ----- inverse transforms -------------------------------------------------

def _mulhi(x, k):
    return (x * k) >> 16


def _idct16(c: np.ndarray) -> np.ndarray:
    """libwebp's SSE2 ``Transform``: residuals (N, 4, 4) of coefficient
    blocks (N, 4, 4) (row, column), in 16-bit arithmetic, before >> 3."""
    k1, k2 = 20091, -30068
    r0, r1, r2, r3 = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
    a, b = _w16(r0 + r2), _w16(r0 - r2)
    cc = _w16(_w16(r1 - r3) + _w16(_mulhi(r1, k2) - _mulhi(r3, k1)))
    d = _w16(_w16(r1 + r3) + _w16(_mulhi(r1, k1) + _mulhi(r3, k2)))
    t = np.stack([_w16(a + d), _w16(b + cc), _w16(b - cc), _w16(a - d)], 1)  # (N, v, col)
    t0, t1, t2, t3 = t[:, :, 0], t[:, :, 1], t[:, :, 2], t[:, :, 3]
    dc = _w16(t0 + 4)
    a, b = _w16(dc + t2), _w16(dc - t2)
    cc = _w16(_w16(t1 - t3) + _w16(_mulhi(t1, k2) - _mulhi(t3, k1)))
    d = _w16(_w16(t1 + t3) + _w16(_mulhi(t1, k1) + _mulhi(t3, k2)))
    return np.stack([_w16(a + d), _w16(b + cc), _w16(b - cc), _w16(a - d)], 2) >> 3


def _idct_ac3(c: np.ndarray) -> np.ndarray:
    """``TransformAC3_C`` (coefficients 0, 1 and 4 only), 32-bit."""
    def m1(x):
        return ((x * 20091) >> 16) + x

    def m2(x):
        return (x * 35468) >> 16

    a = c[:, 0, 0] + 4
    c4, d4, c1, d1 = m2(c[:, 1, 0]), m1(c[:, 1, 0]), m2(c[:, 0, 1]), m1(c[:, 0, 1])
    rows = []
    for dcv in (a + d4, a + c4, a - c4, a - d4):
        rows.append(np.stack([dcv + d1, dcv + c1, dcv - c1, dcv - d1], 1))
    return np.stack(rows, 1) >> 3


def _residuals(coeffs: np.ndarray, codes: np.ndarray, uv_full: np.ndarray) -> np.ndarray:
    """Residuals (M, 24, 4, 4) of every macroblock's blocks, each by the
    transform libwebp picks: full for code 3 (and for all of a chroma plane
    with any coefficient past the DC), AC3 for code 2, DC for code 1."""
    m = coeffs.shape[0]
    c = coeffs.reshape(m, 24, 4, 4)
    out = np.zeros((m, 24, 4, 4), np.int32)
    full = codes == 3
    full[:, 16:20] |= uv_full[:, 0:1]
    full[:, 20:24] |= uv_full[:, 1:2]
    ac3 = (codes == 2) & ~full
    dc = (codes == 1) & ~full
    dc[:, 16:] &= c[:, 16:, 0, 0] != 0
    if full.any():
        out[full] = _idct16(c[full])
    if ac3.any():
        out[ac3] = _idct_ac3(c[ac3])
    if dc.any():
        out[dc] = ((c[dc][:, 0, 0] + 4) >> 3)[:, None, None]
    return out


def _wht(dc: list) -> list:
    """``TransformWHT``: the 16 luma DCs of a macroblock, kept to 16 bits."""
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[3 + 4 * i], tmp[1 + 4 * i] + tmp[2 + 4 * i]
        a2, a3 = tmp[1 + 4 * i] - tmp[2 + 4 * i], d - tmp[3 + 4 * i]
        out[4 * i], out[4 * i + 1] = _w16((a0 + a1) >> 3), _w16((a3 + a2) >> 3)
        out[4 * i + 2], out[4 * i + 3] = _w16((a0 - a1) >> 3), _w16((a3 - a2) >> 3)
    return out  # out[4 * i + j] is block 4 * i + j's DC


# ----- parsing ------------------------------------------------------------

class _Frame:
    """A decoded key frame: planes, modes and what the loop filter needs."""

    def __init__(self, width: int, height: int):
        self.width, self.height = width, height
        self.mb_w, self.mb_h = (width + 15) >> 4, (height + 15) >> 4


def _parse(data: bytes) -> _Frame:
    """Headers, modes and tokens of a key frame (``VP8GetHeaders``,
    ``VP8ParseIntraModeRow``, ``VP8DecodeMB``)."""
    n = len(data)
    if n < 4:
        raise VP8Error("VP8: truncated header")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    key_frame, profile, show, part0 = not bits & 1, (bits >> 1) & 7, (bits >> 4) & 1, bits >> 5
    if profile > 3:
        raise VP8Error("VP8: incorrect keyframe parameters")
    if not show:
        raise VP8Error("VP8: frame not displayable")
    if not key_frame:
        raise VP8Error("VP8: not a key frame")
    if n - 3 < 7:
        raise VP8Error("VP8: cannot parse picture header")
    if data[3:6] != b"\x9d\x01\x2a":
        raise VP8Error("VP8: bad code word")
    width = (data[6] | (data[7] << 8)) & 0x3FFF
    height = (data[8] | (data[9] << 8)) & 0x3FFF
    if width == 0 or height == 0:
        raise VP8Error("VP8: empty frame")
    pos = 10
    if part0 > n - pos:
        raise VP8Error("VP8: bad partition length")
    fr = _Frame(width, height)
    br = _Bool(data, pos, pos + part0)
    pos += part0
    hdr = _Header()
    _parse_header(br, hdr)
    num_parts = 1 << br.value_bits(2)
    if n - pos < 3 * (num_parts - 1):
        raise VP8Error("VP8: cannot parse partitions")
    start, left = pos + 3 * (num_parts - 1), n - pos - 3 * (num_parts - 1)
    parts = []
    for p in range(num_parts - 1):
        size = min(data[pos + 3 * p] | (data[pos + 3 * p + 1] << 8) | (data[pos + 3 * p + 2] << 16),
                   left)
        parts.append(_Bool(data, start, start + size))
        start += size
        left -= size
    parts.append(_Bool(data, start, start + left))
    if left <= 0:
        raise VP8Error("VP8: cannot parse partitions")
    dqm = _quant(br, hdr)
    br.get(0x80)  # refresh entropy probabilities: ignored
    probas = [[[list(COEFFS_PROBA0[((t * 8 + b) * 3 + c) * 11 : ((t * 8 + b) * 3 + c) * 11 + 11])
                for c in range(3)] for b in range(8)] for t in range(4)]
    for t in range(4):
        for b in range(8):
            for c in range(3):
                row = probas[t][b][c]
                for p in range(11):
                    if br.get(COEFFS_UPDATE_PROBA[((t * 8 + b) * 3 + c) * 11 + p]):
                        row[p] = br.value_bits(8)
    bands = [[probas[t][_BANDS[i]] for i in range(17)] for t in range(4)]
    use_skip = br.get(0x80)
    skip_p = br.value_bits(8) if use_skip else 0
    fr.filter_type = 0 if hdr.level == 0 else 1 if hdr.simple else 2
    strengths = _filter_strengths(hdr)

    mb_w, mb_h = fr.mb_w, fr.mb_h
    count = mb_w * mb_h
    coeffs = [0] * (count * 384)
    codes = np.zeros((count, 24), np.int8)
    uv_full = np.zeros((count, 2), bool)
    fr.is_i4 = [False] * count
    fr.ymodes = [None] * count
    fr.uvmodes = [0] * count
    fr.finfo = [None] * count
    intra_t = [0] * (4 * mb_w)
    top_nz, top_dc = [0] * mb_w, [0] * mb_w
    seg_p = hdr.seg_proba
    get = br.get
    for mby in range(mb_h):
        # the row's modes, from the first partition
        intra_l = [0] * 4
        rows = []
        for mbx in range(mb_w):
            if hdr.update_map:
                seg = get(seg_p[1]) if not get(seg_p[0]) else 2 + get(seg_p[2])
            else:
                seg = 0
            skip = get(skip_p) if use_skip else 0
            i4 = not get(145)
            if not i4:
                ymode = (TM if get(128) else HE) if get(156) else (VE if get(163) else DC)
                modes = ymode
                intra_t[4 * mbx : 4 * mbx + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                modes = []
                for y in range(4):
                    ym = intra_l[y]
                    for x in range(4):
                        prob = _BMODES[intra_t[4 * mbx + x]][ym]
                        i = _YMODES4[get(prob[0])]
                        while i > 0:
                            i = _YMODES4[2 * i + get(prob[i])]
                        ym = -i
                        intra_t[4 * mbx + x] = ym
                    modes.extend(intra_t[4 * mbx : 4 * mbx + 4])
                    intra_l[y] = ym
            uvmode = DC if not get(142) else VE if not get(114) else TM if get(183) else HE
            rows.append((seg, skip, i4, modes, uvmode))
        if br.eof:
            raise VP8Error("VP8: premature end of the first partition")
        tb = parts[mby & (num_parts - 1)]
        left_nz = left_dc = 0
        for mbx, (seg, skip, i4, modes, uvmode) in enumerate(rows):
            k = mby * mb_w + mbx
            fr.is_i4[k], fr.ymodes[k], fr.uvmodes[k] = i4, modes, uvmode
            if not skip:
                (y1, y2, uv) = dqm[seg]
                base = k * 384
                code = codes[k]
                if not i4:
                    dc = [0] * 16
                    nz = tb.coeffs(bands[1], top_dc[mbx] + left_dc, y2, 0, dc, 0)
                    top_dc[mbx] = left_dc = int(nz > 0)
                    if nz > 1:
                        dcs = _wht(dc)
                    else:
                        dcs = [(dc[0] + 3) >> 3] * 16
                    for b in range(16):
                        coeffs[base + 16 * b] = dcs[b]
                    first, ac = 1, bands[0]
                else:
                    first, ac = 0, bands[3]
                tnz, lnz = top_nz[mbx] & 15, left_nz & 15
                out_t = out_l = 0
                any_nz = False
                for y in range(4):
                    l = lnz & 1
                    for x in range(4):
                        b = 4 * y + x
                        nz = tb.coeffs(ac, l + (tnz & 1), y1, first, coeffs, base + 16 * b)
                        l = int(nz > first)
                        tnz = (tnz >> 1) | (l << 7)
                        c = 3 if nz > 3 else 2 if nz > 1 else int(coeffs[base + 16 * b] != 0)
                        code[b] = c
                        any_nz |= c > 0
                    tnz >>= 4
                    lnz = (lnz >> 1) | (l << 7)
                out_t, out_l = tnz, lnz >> 4
                for ch in (0, 2):
                    tnz = top_nz[mbx] >> (4 + ch)
                    lnz = left_nz >> (4 + ch)
                    for y in range(2):
                        l = lnz & 1
                        for x in range(2):
                            b = 16 + 2 * ch + 2 * y + x
                            nz = tb.coeffs(bands[2], l + (tnz & 1), uv, 0, coeffs, base + 16 * b)
                            l = int(nz > 0)
                            tnz = (tnz >> 1) | (l << 3)
                            c = 3 if nz > 3 else 2 if nz > 1 else int(coeffs[base + 16 * b] != 0)
                            code[b] = c
                            any_nz |= c > 0
                            uv_full[k, ch >> 1] |= c >= 2
                        tnz >>= 2
                        lnz = (lnz >> 1) | (l << 5)
                    out_t |= (tnz << 4) << ch
                    out_l |= (lnz & 0xF0) << ch
                top_nz[mbx], left_nz = out_t, out_l
                skip = not any_nz
            else:
                top_nz[mbx] = left_nz = 0
                if not i4:
                    top_dc[mbx] = left_dc = 0
            if fr.filter_type:
                limit, ilevel, hev = strengths[seg][int(i4)]
                fr.finfo[k] = (limit, ilevel, hev, bool(i4) or not skip)
            if tb.eof:
                raise VP8Error("VP8: premature end of a token partition")
    fr.coeffs = np.array(coeffs, np.int32).reshape(count, 384)
    fr.codes = codes
    fr.uv_full = uv_full
    return fr


# ----- reconstruction and filtering ---------------------------------------

def _reconstruct(fr: _Frame) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    mb_w, mb_h = fr.mb_w, fr.mb_h
    Y = np.zeros((16 * mb_h, 16 * mb_w), np.int32)
    U = np.zeros((8 * mb_h, 8 * mb_w), np.int32)
    V = np.zeros((8 * mb_h, 8 * mb_w), np.int32)
    res = _residuals(fr.coeffs, fr.codes, fr.uv_full)
    # (M, 16 blocks 4 x 4) -> (M, 16, 16) luma and (M, 2, 8, 8) chroma
    res_y = res[:, :16].reshape(-1, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4).reshape(-1, 16, 16)
    res_uv = res[:, 16:].reshape(-1, 2, 2, 2, 4, 4).transpose(0, 1, 2, 4, 3, 5).reshape(-1, 2, 8, 8)
    for mby in range(mb_h):
        for mbx in range(mb_w):
            k = mby * mb_w + mbx
            y0, x0 = 16 * mby, 16 * mbx
            if mby:
                top = Y[y0 - 1, x0 : x0 + 16]
                corner = int(Y[y0 - 1, x0 - 1]) if mbx else 129
            else:
                top, corner = np.full(16, 127, np.int32), 127
            left = Y[y0 : y0 + 16, x0 - 1] if mbx else np.full(16, 129, np.int32)
            if fr.is_i4[k]:
                if not mby:
                    tr = [127] * 4
                elif mbx == mb_w - 1:
                    tr = [int(Y[y0 - 1, x0 + 15])] * 4
                else:
                    tr = Y[y0 - 1, x0 + 16 : x0 + 20].tolist()
                ws = [[0] * 21 for _ in range(17)]
                ws[0] = [corner] + top.tolist() + tr
                for j, v in enumerate(left.tolist()):
                    ws[j + 1][0] = v
                for j in (4, 8, 12):
                    ws[j][17:21] = tr
                r16 = res_y[k].tolist()
                modes = fr.ymodes[k]
                for b in range(16):
                    r0, c0 = 1 + 4 * (b >> 2), 1 + 4 * (b & 3)
                    above = ws[r0 - 1]
                    p = _pred4(modes[b], above[c0 - 1], *above[c0 : c0 + 8],
                               ws[r0][c0 - 1], ws[r0 + 1][c0 - 1], ws[r0 + 2][c0 - 1],
                               ws[r0 + 3][c0 - 1])
                    for j in range(4):
                        rr = r16[r0 - 1 + j]
                        row = ws[r0 + j]
                        for i in range(4):
                            v = p[j][i] + rr[c0 - 1 + i]
                            row[c0 + i] = 0 if v < 0 else 255 if v > 255 else v
                Y[y0 : y0 + 16, x0 : x0 + 16] = np.array(ws)[1:17, 1:17]
            else:
                pred = _pred_block(fr.ymodes[k], top, left, corner, 16, mbx, mby)
                Y[y0 : y0 + 16, x0 : x0 + 16] = np.clip(pred + res_y[k], 0, 255)
            u0, v0 = 8 * mby, 8 * mbx
            for plane, r in ((U, res_uv[k, 0]), (V, res_uv[k, 1])):
                if mby:
                    top = plane[u0 - 1, v0 : v0 + 8]
                    corner = int(plane[u0 - 1, v0 - 1]) if mbx else 129
                else:
                    top, corner = np.full(8, 127, np.int32), 127
                left = plane[u0 : u0 + 8, v0 - 1] if mbx else np.full(8, 129, np.int32)
                pred = _pred_block(fr.uvmodes[k], top, left, corner, 8, mbx, mby)
                plane[u0 : u0 + 8, v0 : v0 + 8] = np.clip(pred + r, 0, 255)
    return Y, U, V


def _filter_lines(P: np.ndarray, q0: np.ndarray, step: int, thresh: np.ndarray,
                  ithresh: np.ndarray, hev_t: np.ndarray, kind: int) -> None:
    """Filter lines across an edge in the flat plane ``P``: ``q0`` indexes
    each line's first pixel past the edge, ``step`` crosses it.  ``kind`` 0
    is the simple filter, 1 a macroblock edge, 2 an inner edge."""
    px = [P[q0 + k * step] for k in range(-4, 4)]
    p3, p2, p1, p0, q0v, q1, q2, q3 = px
    t2 = 2 * thresh + 1
    mask = 4 * np.abs(p0 - q0v) + np.abs(p1 - q1) <= t2
    if kind:
        it = ithresh
        mask &= (np.abs(p3 - p2) <= it) & (np.abs(p2 - p1) <= it) & (np.abs(p1 - p0) <= it) \
            & (np.abs(q3 - q2) <= it) & (np.abs(q2 - q1) <= it) & (np.abs(q1 - q0v) <= it)
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0v) > hev_t)
        two = mask & hev
        rest = mask & ~hev
    else:
        two, rest = mask, None
    new = [None] * 8
    if two.any():  # DoFilter2
        a = 3 * (q0v - p0) + np.clip(p1 - q1, -128, 127)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        new[3] = np.where(two, np.clip(p0 + a2, 0, 255), p0)
        new[4] = np.where(two, np.clip(q0v - a1, 0, 255), q0v)
    if rest is not None and rest.any():
        cur = [new[k] if new[k] is not None else px[k] for k in range(8)]
        if kind == 1:  # DoFilter6
            a = np.clip(3 * (q0v - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
            a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
            upd = {1: p2 + a3, 2: p1 + a2, 3: p0 + a1, 4: q0v - a1, 5: q1 - a2, 6: q2 - a3}
        else:  # DoFilter4
            a = 3 * (q0v - p0)
            a1 = np.clip((a + 4) >> 3, -16, 15)
            a2 = np.clip((a + 3) >> 3, -16, 15)
            a3 = (a1 + 1) >> 1
            upd = {2: p1 + a3, 3: p0 + a2, 4: q0v - a1, 5: q1 - a3}
        for k, v in upd.items():
            new[k] = np.where(rest, np.clip(v, 0, 255), cur[k])
    for k in range(8):
        if new[k] is not None:
            P[q0 + (k - 4) * step] = new[k]


def _loop_filter(fr: _Frame, Y: np.ndarray, U: np.ndarray, V: np.ndarray) -> None:
    """``DoFilter`` over every macroblock, in an order equal to raster order."""
    mb_w, mb_h = fr.mb_w, fr.mb_h
    yw = 16 * mb_w
    UV = np.stack([U, V])  # chroma planes filtered alike
    uvw = 8 * mb_w
    uv_off = 8 * mb_h * uvw
    fy, fuv = Y.reshape(-1), UV.reshape(-1)
    info = np.array([f if f is not None else (0, 0, 0, False) for f in fr.finfo], np.int64)
    info = info.reshape(mb_h, mb_w, 4)
    lines16, lines8 = np.arange(16), np.arange(8)
    simple = fr.filter_type == 1
    for t in range(mb_w + 2 * mb_h - 2):
        ys = np.arange(max(0, (t - mb_w + 2) // 2), min(mb_h - 1, t // 2) + 1)
        xs = t - 2 * ys
        keep = (xs >= 0) & (xs < mb_w)
        ys, xs = ys[keep], xs[keep]
        f = info[ys, xs]
        on = f[:, 0] > 0
        ys, xs, f = ys[on], xs[on], f[on]
        if not len(ys):
            continue
        limit, ilevel, hev, inner = f[:, 0], f[:, 1], f[:, 2], f[:, 3].astype(bool)

        def run(sel, across, offset, size, plane, width, thresh, kind):
            """Filter the edges of the selected macroblocks: ``across`` 1
            for vertical edges (lines are rows), ``width`` for horizontal."""
            if not sel.any():
                return
            s = 16 if size == 16 else 8
            rows0, cols0 = ys[sel] * s, xs[sel] * s
            lines = lines16 if size == 16 else lines8
            if across == 1:
                base = (rows0[:, None] + lines[None, :]) * width + cols0[:, None] + offset
            else:
                base = (rows0[:, None] + offset) * width + cols0[:, None] + lines[None, :]
            if size == 8:  # U then V
                base = np.concatenate([base, base + uv_off])
                rep = 2
            else:
                rep = 1
            n = base.shape[1]
            tt = np.tile(np.repeat(thresh[sel], n), rep)
            it = np.tile(np.repeat(ilevel[sel], n), rep)
            ht = np.tile(np.repeat(hev[sel], n), rep)
            _filter_lines(plane, base.reshape(-1), across if across == 1 else width,
                          tt, it, ht, kind)

        left, topm = xs > 0, ys > 0
        if simple:
            run(left, 1, 0, 16, fy, yw, limit + 4, 0)
            for off in (4, 8, 12):
                run(inner, 1, off, 16, fy, yw, limit, 0)
            run(topm, yw, 0, 16, fy, yw, limit + 4, 0)
            for off in (4, 8, 12):
                run(inner, yw, off, 16, fy, yw, limit, 0)
        else:
            run(left, 1, 0, 16, fy, yw, limit + 4, 1)
            run(left, 1, 0, 8, fuv, uvw, limit + 4, 1)
            for off in (4, 8, 12):
                run(inner, 1, off, 16, fy, yw, limit, 2)
            run(inner, 1, 4, 8, fuv, uvw, limit, 2)
            run(topm, yw, 0, 16, fy, yw, limit + 4, 1)
            run(topm, uvw, 0, 8, fuv, uvw, limit + 4, 1)
            for off in (4, 8, 12):
                run(inner, yw, off, 16, fy, yw, limit, 2)
            run(inner, uvw, 4, 8, fuv, uvw, limit, 2)
    U[:] = UV[0]
    V[:] = UV[1]


def decode_vp8(data: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Y (H, W), U and V ((H + 1) // 2, (W + 1) // 2) uint8 of a VP8 key
    frame, its frame tag first; raises ``VP8Error`` where libwebp fails."""
    fr = _parse(data)
    Y, U, V = _reconstruct(fr)
    if fr.filter_type:
        _loop_filter(fr, Y, U, V)
    h, w = fr.height, fr.width
    return (Y[:h, :w].astype(np.uint8), U[: (h + 1) // 2, : (w + 1) // 2].astype(np.uint8),
            V[: (h + 1) // 2, : (w + 1) // 2].astype(np.uint8))


def vp8_info(data: bytes, chunk_size: int) -> Tuple[int, int]:
    """(width, height) of a VP8 frame header as ``VP8GetInfo`` checks it
    (``data`` holds at least 10 bytes)."""
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if data[3:6] != b"\x9d\x01\x2a" or bits & 1 or ((bits >> 1) & 7) > 3 \
            or not (bits >> 4) & 1 or (bits >> 5) >= chunk_size:
        raise VP8Error("VP8: bad frame header")
    w, h = (data[6] | (data[7] << 8)) & 0x3FFF, (data[8] | (data[9] << 8)) & 0x3FFF
    if w == 0 or h == 0:
        raise VP8Error("VP8: empty frame")
    return w, h


def _mult_hi(v: np.ndarray, c: int) -> np.ndarray:
    return (v * c) >> 8


def _clip8(v: np.ndarray) -> np.ndarray:
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def yuv_to_rgb(Y: np.ndarray, U: np.ndarray, V: np.ndarray) -> np.ndarray:
    """RGB uint8 (H, W, 3) of 4:2:0 planes by libwebp's fancy upsampler
    (``UpsampleRgbLinePair``) and ``VP8YuvToRgb``."""
    h, w = Y.shape
    uvh = U.shape[0]
    n = (w + 1) // 2
    y = np.arange(h)
    # each output row's (top, current) chroma rows and whether it is the
    # bottom line of its pair
    odd = (y % 2 == 1) & ((y + 1) // 2 < uvh)
    top_row = np.where(y == 0, 0, np.where(y % 2 == 1, (y - 1) // 2, y // 2 - 1))
    cur_row = np.where(y == 0, 0, np.where(odd, (y + 1) // 2, np.where(y % 2 == 1, (y - 1) // 2,
                                                                         y // 2)))
    bottom = (y > 0) & (y % 2 == 0)
    planes = []
    for P in (U, V):
        P = P[:, :n].astype(np.int32)
        T, C = P[top_row], P[cur_row]
        top = np.empty((h, w), np.int32)
        bot = np.empty((h, w), np.int32)
        top[:, 0] = (3 * T[:, 0] + C[:, 0] + 2) >> 2
        bot[:, 0] = (3 * C[:, 0] + T[:, 0] + 2) >> 2
        if n > 1:
            tl, t, l, uv = T[:, :-1], T[:, 1:], C[:, :-1], C[:, 1:]
            avg = tl + t + l + uv + 8
            d12 = (avg + 2 * (t + l)) >> 3
            d03 = (avg + 2 * (tl + uv)) >> 3
            top[:, 1 : 2 * n - 1 : 2] = (d12 + tl) >> 1
            top[:, 2 : 2 * n - 1 : 2] = (d03 + t) >> 1
            bot[:, 1 : 2 * n - 1 : 2] = (d03 + l) >> 1
            bot[:, 2 : 2 * n - 1 : 2] = (d12 + uv) >> 1
        if w % 2 == 0:
            top[:, w - 1] = (3 * T[:, n - 1] + C[:, n - 1] + 2) >> 2
            bot[:, w - 1] = (3 * C[:, n - 1] + T[:, n - 1] + 2) >> 2
        planes.append(np.where(bottom[:, None], bot, top))
    u, v = planes
    yy = _mult_hi(Y.astype(np.int32), 19077)
    r = _clip8(yy + _mult_hi(v, 26149) - 14234)
    g = _clip8(yy - _mult_hi(u, 6419) - _mult_hi(v, 13320) + 8708)
    b = _clip8(yy + _mult_hi(u, 33050) - 17685)
    return np.stack([r, g, b], 2).astype(np.uint8)
