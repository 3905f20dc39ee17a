"""A JPEG reader in Python and numpy, exact against ``cv2.imread``.

OpenCV reads JPEG through libjpeg-turbo with its defaults: the ``islow``
integer IDCT, fancy upsampling, and the fixed-point YCbCr->RGB tables.
:func:`decode_jpeg` reproduces that arithmetic, so it returns, pixel for
pixel, ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``:

* frames: baseline and extended-sequential Huffman at 8 bits (SOF0, SOF1)
  and progressive Huffman (SOF2: DC and AC first scans, successive-
  approximation refinement, EOB runs); interleaved and non-interleaved
  scans, restart markers, sampling factors up to 4x4, any Huffman tables;
* the IDCT is ``jidctint.c``'s, pass for pass, with its range-limit table
  (an output wraps modulo 1024 before it is clamped);
* upsampling is ``jdsample.c``'s: fancy (triangle) upsampling for h2v1 and
  h2v2 when the component is wider than two samples, and for h1v2, with
  the alternating biases and the edge columns; replication for other
  integral ratios; rows past a component's edge repeat its last row;
* colour: grey, YCbCr (``jdcolor.c``'s tables, ``SCALEBITS`` 16), RGB
  (Adobe APP14 transform 0, or component ids ``R``, ``G``, ``B``), and CMYK
  and YCCK through OpenCV's own CMYK->BGR conversion;
* the APP1 ``Exif`` orientation turns the result (``data/exif.py``).

Entropy data is decoded one Huffman symbol at a time in Python (a 16-bit
look-ahead table per Huffman table); dequantisation, the IDCT, upsampling
and colour run vectorised over all blocks.  A scan whose data ends early
reads as libjpeg reads it: zero bits to the end of that MCU, and the
scan's later MCUs left as they were (all zero in a sequential scan).

Arithmetic-coded (SOF9-11, SOF13-15), lossless (SOF3), hierarchical
(SOF5-7, DHP) and 12-bit JPEGs raise :class:`UnsupportedFormat` naming the
form; so does a progressive file whose low AC coefficients are never fully
refined (libjpeg would smooth its blocks).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from molnextr_tpu_torch.data.exif import apply_orientation, exif_orientation
from molnextr_tpu_torch.data.image import UnsupportedFormat

# zig-zag position -> natural (row-major) index, with libjpeg's 16 extra
# entries that send a corrupt run past the end to coefficient 63
NATURAL = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16
_UNSUPPORTED_SOF = {
    0xC3: "lossless JPEG (SOF3)", 0xC5: "hierarchical JPEG (SOF5)",
    0xC6: "hierarchical JPEG (SOF6)", 0xC7: "hierarchical JPEG (SOF7)",
    0xC9: "arithmetic-coded JPEG (SOF9)", 0xCA: "arithmetic-coded JPEG (SOF10)",
    0xCB: "arithmetic-coded JPEG (SOF11)", 0xCD: "arithmetic-coded JPEG (SOF13)",
    0xCE: "arithmetic-coded JPEG (SOF14)", 0xCF: "arithmetic-coded JPEG (SOF15)",
    0xDE: "hierarchical JPEG (DHP)",
}


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant: Optional[np.ndarray] = None  # latched at its first scan
        self.coef: List[int] = []
        self.bw = self.bh = 0  # allocated block grid (whole MCUs)
        self.cw = self.ch = 0  # blocks a non-interleaved scan covers
        self.width = self.height = 0  # downsampled size in samples


def _huffman_table(counts: bytes, symbols: bytes) -> List[int]:
    """16-bit look-ahead table: entry = symbol | (code length << 8); an
    invalid code reads as symbol 0 of length 16."""
    table = np.full(1 << 16, 16 << 8, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("JPEG: bad Huffman table")
            lo = code << (16 - length)
            table[lo : lo + (1 << (16 - length))] = symbols[k] | (length << 8)
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


# zero windows past an interval's end: enough for one MCU of ten blocks of
# 64 symbols of 32 bits each, all read as zero bits
_TAIL = [0] * 2600


class _Bits:
    """Bits of one entropy-coded interval (stuffing removed), read through a
    32-bit window per byte: bits past the end read as zero, as libjpeg
    fills them."""

    def __init__(self, data: bytes):
        self.nbits = len(data) * 8
        b = np.frombuffer(data + bytes(3), np.uint8).astype(np.int64)
        self.win = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
        self.win.extend(_TAIL)


def _entropy_intervals(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data after an SOS header at ``pos``, split at its
    restart markers and unstuffed; and the offset of the marker that ends it."""
    parts, start = [], pos
    n = len(data)
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= n:
            parts.append(data[start:])
            return [p.replace(b"\xff\x00", b"\xff") for p in parts], n
        nxt = data[i + 1]
        if nxt == 0x00:
            pos = i + 2
        elif 0xD0 <= nxt <= 0xD7:
            parts.append(data[start:i])
            start = pos = i + 2
        elif nxt == 0xFF:  # fill byte before a marker
            j = i
            while j + 1 < n and data[j + 1] == 0xFF:
                j += 1
            if j + 1 < n and 0xD0 <= data[j + 1] <= 0xD7:
                parts.append(data[start:i])
                start = pos = j + 2
            elif j + 1 < n and data[j + 1] == 0x00:
                pos = j + 2
            else:
                parts.append(data[start:i])
                return [p.replace(b"\xff\x00", b"\xff") for p in parts], j
        else:
            parts.append(data[start:i])
            return [p.replace(b"\xff\x00", b"\xff") for p in parts], i


class _Decoder:
    def __init__(self, data: bytes, path: str):
        self.data, self.path = data, path
        self.qt: Dict[int, np.ndarray] = {}
        self.dc: Dict[int, List[int]] = {}
        self.ac: Dict[int, List[int]] = {}
        self.restart = 0
        self.comps: List[_Component] = []
        self.progressive = False
        self.adobe: Optional[int] = None
        self.jfif = False
        self.orientation = 1
        self.coef_bits: Dict[int, List[int]] = {}

    # -- markers -----------------------------------------------------------
    def run(self) -> np.ndarray:
        data = self.data
        if data[:2] != b"\xff\xd8":
            raise ValueError(f"{self.path}: not a JPEG file")
        pos, frame = 2, False
        while pos < len(data):
            if data[pos] != 0xFF:
                pos += 1  # libjpeg skips garbage before a marker (with a warning)
                continue
            marker = data[pos + 1]
            if marker == 0xFF:
                pos += 1
                continue
            pos += 2
            if marker == 0xD9:
                break
            if 0xD0 <= marker <= 0xD7 or marker == 0x01:
                continue
            (length,) = struct.unpack(">H", data[pos : pos + 2])
            seg = data[pos + 2 : pos + length]
            if len(seg) < length - 2:
                raise ValueError(f"{self.path}: truncated JPEG marker segment")
            if marker in _UNSUPPORTED_SOF:
                raise UnsupportedFormat(f"{self.path}: {_UNSUPPORTED_SOF[marker]} is not decoded "
                                        "by the port yet (ROADMAP queue 1)")
            if marker in (0xC0, 0xC1, 0xC2):
                self._frame(seg, marker == 0xC2)
                frame = True
            elif marker == 0xC4:
                self._dht(seg)
            elif marker == 0xDB:
                self._dqt(seg)
            elif marker == 0xDD:
                self.restart = struct.unpack(">H", seg[:2])[0]
            elif marker == 0xDA:
                if not frame:
                    raise ValueError(f"{self.path}: JPEG scan before its frame")
                pos = self._scan(seg, pos + length)
                continue
            elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
                self.jfif = True
            elif marker == 0xE1 and seg[:6] == b"Exif\x00\x00" and self.orientation == 1:
                self.orientation = exif_orientation(seg[6:])
            elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
                self.adobe = seg[11]
            pos += length
        if not frame or not any(c.coef for c in self.comps):
            raise ValueError(f"{self.path}: JPEG without image data")
        return apply_orientation(self._output(), self.orientation)

    def _frame(self, seg: bytes, progressive: bool) -> None:
        if self.comps:
            raise ValueError(f"{self.path}: JPEG with two frames")
        precision, height, width, n = struct.unpack(">BHHB", seg[:6])
        if precision != 8:
            raise UnsupportedFormat(f"{self.path}: {precision}-bit JPEG is not decoded by the "
                                    "port yet (ROADMAP queue 1)")
        if height == 0:
            raise UnsupportedFormat(f"{self.path}: JPEG with its height in a DNL marker is not "
                                    "decoded by the port yet (ROADMAP queue 1)")
        if width == 0 or n not in (1, 3, 4):
            raise ValueError(f"{self.path}: JPEG frame of {width} x {height}, {n} components")
        self.width, self.height, self.progressive = width, height, progressive
        for k in range(n):
            cid, hv, tq = seg[6 + 3 * k : 9 + 3 * k]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4):
                raise ValueError(f"{self.path}: JPEG sampling factors {h}x{v}")
            self.comps.append(_Component(cid, h, v, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))
        for c in self.comps:
            if self.hmax % c.h or self.vmax % c.v:
                raise ValueError(f"{self.path}: JPEG sampling ratio is not integral")
            c.width = -(-width * c.h // self.hmax)
            c.height = -(-height * c.v // self.vmax)
            c.cw, c.ch = -(-c.width // 8), -(-c.height // 8)
            c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v
            c.coef = [0] * (c.bw * c.bh * 64)
            self.coef_bits[c.id] = [-1] * 64

    def _dht(self, seg: bytes) -> None:
        pos = 0
        while pos < len(seg):
            tc_th = seg[pos]
            counts = seg[pos + 1 : pos + 17]
            total = sum(counts)
            symbols = seg[pos + 17 : pos + 17 + total]
            if len(counts) < 16 or len(symbols) < total or total > 256:
                raise ValueError(f"{self.path}: bad JPEG Huffman table")
            (self.ac if tc_th >> 4 else self.dc)[tc_th & 15] = _huffman_table(counts, symbols)
            pos += 17 + total

    def _dqt(self, seg: bytes) -> None:
        pos = 0
        while pos < len(seg):
            pq, tq = seg[pos] >> 4, seg[pos] & 15
            if pq:
                vals = struct.unpack(">64H", seg[pos + 1 : pos + 129])
                pos += 129
            else:
                vals = tuple(seg[pos + 1 : pos + 65])
                if len(vals) < 64:
                    raise ValueError(f"{self.path}: bad JPEG quantisation table")
                pos += 65
            table = np.zeros(64, np.int64)
            table[NATURAL[:64]] = vals
            self.qt[tq] = table

    # -- scans -------------------------------------------------------------
    def _scan(self, seg: bytes, pos: int) -> int:
        n = seg[0]
        by_id = {c.id: c for c in self.comps}
        comps, tables = [], []
        for k in range(n):
            cid, tdta = seg[1 + 2 * k], seg[2 + 2 * k]
            if cid not in by_id:
                raise ValueError(f"{self.path}: JPEG scan names an unknown component")
            comps.append(by_id[cid])
            tables.append((tdta >> 4, tdta & 15))
        if n > 1 and sum(c.h * c.v for c in comps) > 10:
            raise ValueError(f"{self.path}: JPEG MCU of more than 10 blocks")  # libjpeg's limit
        ss, se, ahal = seg[1 + 2 * n], seg[2 + 2 * n], seg[3 + 2 * n]
        ah, al = ahal >> 4, ahal & 15
        if not self.progressive:
            ss, se, ah, al = 0, 63, 0, 0
        elif ss > se or se > 63 or (ss == 0 and se != 0) or (ss > 0 and n != 1):
            raise ValueError(f"{self.path}: bad progressive JPEG scan")
        for c in comps:
            if c.quant is None:
                if c.tq not in self.qt:
                    raise ValueError(f"{self.path}: JPEG component without its table")
                c.quant = self.qt[c.tq]
        intervals, end = _entropy_intervals(self.data, pos)
        blocks = self._scan_blocks(comps)
        dc = [self.dc.get(t[0]) for t in tables]
        ac = [self.ac.get(t[1]) for t in tables]
        need_dc = ss == 0 and ah == 0
        need_ac = se > 0
        for k in range(n):
            if (need_dc and dc[k] is None) or (need_ac and ac[k] is None):
                raise ValueError(f"{self.path}: JPEG scan without its Huffman table")
        per_interval = self.restart * sum(
            (1 if n == 1 else c.h * c.v) for c in comps) if self.restart else len(blocks)
        for c in comps:
            bits = self.coef_bits[c.id]
            for k in range(ss, se + 1):
                bits[k] = al
        for j, i in enumerate(range(0, len(blocks), max(per_interval, 1))):
            if j >= len(intervals):
                break  # the data ended: libjpeg skips the scan's later intervals
            chunk = intervals[j]
            part = blocks[i : i + per_interval]
            if not self.progressive:
                self._sequential(_Bits(chunk), part, dc, ac)
            elif ss == 0:
                self._dc_scan(_Bits(chunk), part, dc, ah, al)
            elif ah == 0:
                self._ac_first(_Bits(chunk), part, ac[0], ss, se, al)
            else:
                self._ac_refine(_Bits(chunk), part, ac[0], ss, se, al)
        return end

    def _scan_blocks(self, comps: List[_Component]) -> List[Tuple[int, List[int], int, bool]]:
        """(component index in the scan, coefficient list, offset, first block
        of its MCU) of every block in the scan's order."""
        out = []
        if len(comps) == 1:
            c = comps[0]
            for by in range(c.ch):
                for bx in range(c.cw):
                    out.append((0, c.coef, (by * c.bw + bx) * 64, True))
            return out
        for my in range(self.mcuy):
            for mx in range(self.mcux):
                start = True
                for k, c in enumerate(comps):
                    for v in range(c.v):
                        row = (my * c.v + v) * c.bw + mx * c.h
                        for h in range(c.h):
                            out.append((k, c.coef, (row + h) * 64, start))
                            start = False
        return out

    @staticmethod
    def _sequential(bits: _Bits, blocks, dc, ac) -> None:
        win, pos, nbits = bits.win, 0, bits.nbits
        pred = [0] * len(dc)
        natural = NATURAL
        for k, coef, base, start in blocks:
            if start and pos > nbits:
                return  # the data ran out in an earlier MCU: libjpeg skips the rest
            look = dc[k][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            pos += look >> 8
            s = look & 0xFF
            if s:
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                pred[k] += v
            coef[base] = pred[k]
            table = ac[k]
            i = 1
            while i < 64:
                look = table[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                pos += look >> 8
                rs = look & 0xFF
                s = rs & 15
                if s:
                    i += rs >> 4
                    v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                    pos += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    coef[base + natural[i]] = v
                    i += 1
                elif rs == 0xF0:
                    i += 16
                else:
                    break

    @staticmethod
    def _dc_scan(bits: _Bits, blocks, dc, ah: int, al: int) -> None:
        win, pos, nbits = bits.win, 0, bits.nbits
        pred = [0] * len(dc)
        for k, coef, base, start in blocks:
            if start and pos > nbits:
                return  # the data ran out in an earlier MCU: libjpeg skips the rest
            if ah:
                if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
                    coef[base] |= 1 << al
                pos += 1
                continue
            look = dc[k][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            pos += look >> 8
            s = look & 0xFF
            if s:
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                pred[k] += v
            coef[base] = pred[k] << al

    @staticmethod
    def _ac_first(bits: _Bits, blocks, table, ss: int, se: int, al: int) -> None:
        win, pos, nbits = bits.win, 0, bits.nbits
        natural = NATURAL
        eobrun = 0
        for _k, coef, base, _start in blocks:
            if pos > nbits:
                return
            if eobrun:
                eobrun -= 1
                continue
            i = ss
            while i <= se:
                look = table[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                pos += look >> 8
                rs = look & 0xFF
                r, s = rs >> 4, rs & 15
                if s:
                    i += r
                    v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                    pos += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    coef[base + natural[i]] = v << al
                elif r == 15:
                    i += 15
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) & ((1 << r) - 1)
                        pos += r
                    eobrun -= 1
                    break
                i += 1

    @staticmethod
    def _ac_refine(bits: _Bits, blocks, table, ss: int, se: int, al: int) -> None:
        win, pos, nbits = bits.win, 0, bits.nbits
        natural = NATURAL
        p1, m1 = 1 << al, -1 << al
        eobrun = 0
        for _k, coef, base, _start in blocks:
            if pos > nbits:
                return
            i = ss
            if eobrun == 0:
                while i <= se:
                    look = table[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                    pos += look >> 8
                    rs = look & 0xFF
                    r, s = rs >> 4, rs & 15
                    if s:
                        s = p1 if (win[pos >> 3] >> (31 - (pos & 7))) & 1 else m1
                        pos += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) & ((1 << r) - 1)
                            pos += r
                        break
                    while i <= se:
                        at = base + natural[i]
                        c = coef[at]
                        if c:
                            if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                                coef[at] = c + (p1 if c >= 0 else m1)
                            pos += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        i += 1
                    if s:
                        coef[base + natural[i]] = s
                    i += 1
            if eobrun > 0:
                while i <= se:
                    at = base + natural[i]
                    c = coef[at]
                    if c:
                        if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                            coef[at] = c + (p1 if c >= 0 else m1)
                        pos += 1
                    i += 1
                eobrun -= 1

    # -- output ------------------------------------------------------------
    def _output(self) -> np.ndarray:
        if self._smoothing():
            raise UnsupportedFormat(
                f"{self.path}: progressive JPEG whose low AC coefficients are never fully "
                "refined (libjpeg smooths its blocks) is not decoded by the port yet "
                "(ROADMAP queue 1)")
        planes = []
        for c in self.comps:
            coef = np.asarray(c.coef, np.int64).astype(np.int16).astype(np.int64)
            blocks = _idct_islow(coef.reshape(-1, 64) * c.quant[None, :])
            plane = blocks.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(
                c.bh * 8, c.bw * 8)[: c.height, : c.width]
            planes.append(_upsample(plane, self.hmax // c.h, self.vmax // c.v)
                          [: self.height, : self.width])
        return self._colour(planes)

    def _smoothing(self) -> bool:
        """libjpeg's ``smoothing_ok``: a progressive file whose DC is known in
        every component and some AC coefficient 1-9 of some component is not
        fully refined is block-smoothed on output."""
        if not self.progressive:
            return False
        useful = False
        for c in self.comps:
            bits = self.coef_bits[c.id]
            if c.quant is None or not c.quant[[0, 1, 8, 16, 9, 2, 3, 10, 17, 24]].all() \
                    or bits[0] < 0:
                return False
            useful |= any(b != 0 for b in bits[1:10])
        return useful

    def _colour(self, planes: List[np.ndarray]) -> np.ndarray:
        """``default_decompress_parms``' colour space, then OpenCV's output."""
        n = len(planes)
        if n == 1:
            return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
        if n == 3:
            if self.jfif:
                rgb = False
            elif self.adobe is not None:
                rgb = self.adobe == 0
            else:
                rgb = [c.id for c in self.comps] == [82, 71, 66]
            if rgb:
                return np.stack(planes, axis=2).astype(np.uint8)
            return _ycc_to_rgb(*planes)
        if self.adobe not in (None, 0):  # YCCK
            cmyk = list(_ycc_to_rgb(*planes[:3], invert=True).transpose(2, 0, 1)) + [planes[3]]
        else:
            cmyk = planes
        c, m, y, k = (p.astype(np.int64) for p in cmyk)
        out = [k - (((255 - ch) * k) >> 8) for ch in (c, m, y)]
        return np.stack(out, axis=2).astype(np.uint8)


_C = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633,
          f1501=12299, f1847=15137, f1961=16069, f2053=16819, f2562=20995, f3072=25172)


def _idct_1d(x: List[np.ndarray]) -> Tuple[np.ndarray, ...]:
    """One pass of ``jpeg_idct_islow`` over 8 inputs (each an array), before
    the descale: returns the 8 outputs scaled by 2**13."""
    c = _C
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * c["f0541"]
    tmp2 = z1 - z3 * c["f1847"]
    tmp3 = z1 + z2 * c["f0765"]
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * c["f1175"]
    t0 = t0 * c["f0298"]
    t1 = t1 * c["f2053"]
    t2 = t2 * c["f3072"]
    t3 = t3 * c["f1501"]
    z1 = z1 * -c["f0899"]
    z2 = z2 * -c["f2562"]
    z3 = z3 * -c["f1961"] + z5
    z4 = z4 * -c["f0390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """``jpeg_idct_islow`` of dequantised blocks (N, 64) -> samples (N, 8, 8)
    uint8, through libjpeg's post-IDCT range-limit table."""
    blk = coef.reshape(-1, 8, 8)
    cols = [blk[:, r, :] for r in range(8)]  # column pass: inputs along rows of coefficients
    out = _idct_1d(cols)
    ws = np.stack([(o + (1 << 10)) >> 11 for o in out], axis=1)  # CONST_BITS - PASS1_BITS
    rows = [ws[:, :, k] for k in range(8)]
    out = _idct_1d(rows)
    vals = np.stack([(o + (1 << 17)) >> 18 for o in out], axis=2)  # CONST_BITS + PASS1_BITS + 3
    vals = ((vals + 512) & 1023) - 512 + 128
    return np.clip(vals, 0, 255)


def _upsample(plane: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """``jdsample.c``: fancy h2v1/h2v2 (component wider than 2) and h1v2,
    replication for other integral ratios."""
    p = plane.astype(np.int64)
    h, w = p.shape
    if hr == 1 and vr == 1:
        return p
    if hr == 1 and vr == 2:
        up = np.vstack([p[:1], p[:-1]])
        down = np.vstack([p[1:], p[-1:]])
        out = np.empty((2 * h, w), np.int64)
        out[0::2] = (3 * p + up + 1) >> 2
        out[1::2] = (3 * p + down + 2) >> 2
        return out
    if hr == 2 and vr in (1, 2) and w > 2:
        if vr == 2:
            up = np.vstack([p[:1], p[:-1]])
            down = np.vstack([p[1:], p[-1:]])
            sums = np.empty((2 * h, w), np.int64)
            sums[0::2] = 3 * p + up
            sums[1::2] = 3 * p + down
            left_bias, right_bias, shift = 8, 7, 4
        else:
            sums = p
            left_bias, right_bias, shift = 1, 2, 2
        left = np.hstack([sums[:, :1], sums[:, :-1]])
        right = np.hstack([sums[:, 1:], sums[:, -1:]])
        out = np.empty((sums.shape[0], 2 * w), np.int64)
        # an edge column is its own neighbour: libjpeg's special cases
        # (4 * sum + bias) >> shift are the same values
        out[:, 0::2] = (3 * sums + left + left_bias) >> shift
        out[:, 1::2] = (3 * sums + right + right_bias) >> shift
        return out
    return np.repeat(np.repeat(p, vr, axis=0), hr, axis=1)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    cr_r = (fix(1.40200) * x + 32768) >> 16
    cb_b = (fix(1.77200) * x + 32768) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + 32768
    return cr_r, cb_b, cr_g, cb_g


_YCC = _ycc_tables()


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, invert: bool = False) -> np.ndarray:
    """``ycc_rgb_convert`` (``invert``: ``ycck_cmyk_convert``'s 255 - x)."""
    cr_r, cb_b, cr_g, cb_g = _YCC
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    if invert:
        r, g, b = 255 - r, 255 - g, 255 - b
    return np.clip(np.stack([r, g, b], axis=2), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """RGB uint8 (H, W, 3) of a JPEG file's bytes, as OpenCV reads it."""
    return _Decoder(data, path).run()
