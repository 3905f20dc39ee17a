"""A JPEG reader in Python and numpy, exact against ``cv2.imread``.

OpenCV reads JPEG through libjpeg-turbo 3.1 with its defaults: the
``islow`` integer IDCT, fancy upsampling, block smoothing, and the
fixed-point YCbCr->RGB tables.  :func:`decode_jpeg` reproduces that
arithmetic, so it returns, pixel for pixel,
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``, or raises
``ValueError`` where ``cv2.imread`` returns None:

* frames at 8 bits: baseline and extended-sequential Huffman (SOF0,
  SOF1), progressive Huffman (SOF2: DC and AC first scans, successive-
  approximation refinement, EOB runs), lossless Huffman (SOF3, at 2-8
  bits, its samples as they are: predictors 1-7, the point transform, as
  ``jdlhuff.c``, ``jddiffct.c`` and ``jdlossls.c`` undifference it; RGB or
  CMYK only, as libjpeg-turbo converts no colour space of a lossless
  frame), and arithmetic-coded sequential and
  progressive (SOF9, SOF10: ``data/jpeg_arith.py``, with the ``DAC``
  conditioning); interleaved and non-interleaved scans, restart markers,
  sampling factors up to 4x4, any Huffman tables (Annex K's where a
  sequential scan's table 0 or 1 is missing, as in Motion-JPEG);
* the IDCT is libjpeg-turbo's x86 SIMD ``islow`` (``jidctint.c``'s
  arithmetic, its products and first-pass outputs kept to 16 bits and its
  output saturated, as the vector registers keep them);
* block smoothing (``jdcoefct.c``'s ``decompress_smooth_data``): a
  progressive file whose first nine AC coefficients are not all known to
  full precision has them (and, when no AC coefficient was ever coded, the
  DC too) estimated from the DC values of the 5 x 5 blocks around each
  block, with the coefficient bits latched as libjpeg latches them;
* upsampling is ``jdsample.c``'s: fancy (triangle) upsampling for h2v1 and
  h2v2 when the component is wider than two samples, and for h1v2, with
  the alternating biases and the edge columns; replication for other
  integral ratios, and for every ratio of a lossless frame; rows past a
  component's edge repeat its last row;
* colour: grey, YCbCr (``jdcolor.c``'s tables, ``SCALEBITS`` 16), RGB
  (Adobe APP14 transform 0, or component ids ``R``, ``G``, ``B``), and CMYK
  and YCCK through OpenCV's own CMYK->BGR conversion;
* the APP1 ``Exif`` orientation turns the result (``data/exif.py``).

Entropy data is decoded one symbol (or one binary decision) at a time in
Python; dequantisation, smoothing, the IDCT, upsampling and colour run
vectorised over all blocks.  A Huffman scan whose data ends early reads as
libjpeg reads it: zero bits to the end of that MCU, and the scan's later
MCUs left as they were (all zero in a sequential scan; a lossless row of
the centre value); an arithmetic scan reads zero bytes to its end.

Read as None, as libjpeg-turbo refuses them under OpenCV's 8-bit reader:
frames of other precisions (12-bit, or a lossless frame of 9-16 bits),
grey and YCbCr lossless frames, hierarchical frames (SOF5-7, SOF13-15, ``DHP``), lossless
arithmetic-coded frames (SOF11), the reserved ``JPG``, ``JPGn``, ``EXP``
and ``RESn`` markers, and a frame whose height is left to a ``DNL``
marker.  :func:`decode_in_tiff` reads the abbreviated streams of
JPEG-in-TIFF (``data/tiff.py``) after their ``JPEGTables`` stream, in the
colour mode libtiff asks for.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from molnextr_tpu_torch.data.exif import apply_orientation, exif_orientation
from molnextr_tpu_torch.data import jpeg_arith

# zig-zag position -> natural (row-major) index, with libjpeg's 16 extra
# entries that send a corrupt run past the end to coefficient 63
NATURAL = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16
# Annex K's tables, which libjpeg-turbo's jpeg_std_huff_table() lends to a
# sequential Huffman scan whose table 0 or 1 was never defined (Motion-JPEG
# frames): (class, id) -> (counts of codes of 1-16 bits, symbols), as hex
_STD_HUFFMAN = {
    (0, 0): ("00010501010101010100000000000000", "000102030405060708090a0b"),
    (0, 1): ("00030101010101010101010000000000", "000102030405060708090a0b"),
    (1, 0): ("0002010303020403050504040000017d",
             "01020300041105122131410613516107227114328191a1082342b1c11552d1f024336272"
             "82090a161718191a25262728292a3435363738393a434445464748494a53545556575859"
             "5a636465666768696a737475767778797a838485868788898a92939495969798999aa2a3"
             "a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
             "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    (1, 1): ("00020102040403040705040400010277",
             "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d1"
             "0a162434e125f11718191a262728292a35363738393a434445464748494a535455565758"
             "595a636465666768696a737475767778797a82838485868788898a92939495969798999a"
             "a2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
             "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}
# markers libjpeg-turbo refuses (JERR_SOF_UNSUPPORTED, JERR_UNKNOWN_MARKER,
# JERR_ARITH_NOTIMPL for lossless arithmetic coding): cv2.imread returns None
_REFUSED_SOF = {0xC5: "SOF5", 0xC6: "SOF6", 0xC7: "SOF7", 0xC8: "JPG", 0xCB: "SOF11",
                0xCD: "SOF13", 0xCE: "SOF14", 0xCF: "SOF15"}
_FRAMES = {0xC0: "huffman", 0xC1: "huffman", 0xC2: "progressive", 0xC3: "lossless",
           0xC9: "arith", 0xCA: "arith progressive"}
_KNOWN = set(_FRAMES) | {0xC4, 0xCC, 0xD8, 0xD9, 0xDA, 0xDB, 0xDC, 0xDD, 0xFE, 0x01} \
    | set(range(0xD0, 0xD8)) | set(range(0xE0, 0xF0))


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant: Optional[np.ndarray] = None  # latched at its first scan
        self.coef: List[int] = []
        self.samples: Optional[np.ndarray] = None  # a lossless frame's samples
        self.bw = self.bh = 0  # allocated block grid (whole MCUs)
        self.cw = self.ch = 0  # blocks a non-interleaved scan covers
        self.width = self.height = 0  # downsampled size in samples


def _huffman_table(counts: bytes, symbols: bytes) -> List[int]:
    """16-bit look-ahead table: entry = symbol | (code length << 8); an
    invalid code reads as symbol 0 of 17 bits, as ``jpeg_huff_decode``
    reads it."""
    table = np.full(1 << 16, 17 << 8, np.int64)
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

    def __init__(self, data: bytes, tail: int = 0):
        self.nbits = len(data) * 8
        b = np.frombuffer(data + bytes(3), np.uint8).astype(np.int64)
        self.win = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
        self.win.extend(_TAIL if not tail else [0] * tail)


_EOF_FILL = b"\xff\xd9" * 32768


def length_of(data: bytes, pos: int) -> int:
    """The big-endian length of the marker segment at ``pos``."""
    return (data[pos] << 8) | data[pos + 1]


def _unstuff(part: bytes) -> bytes:
    """0xFF 0x00 -> 0xFF, the fill bytes of ``FF FF .. 00`` swallowed too."""
    return re.sub(b"\xff+\x00", b"\xff", part) if b"\xff" in part else part


def _entropy_intervals(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data after an SOS header at ``pos``, split at its
    restart markers and unstuffed; and the offset of the marker that ends it."""
    parts, start = [], pos
    n = len(data)
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= n:
            # a 0xFF as the file's last byte starts the fake EOI marker
            # libjpeg's source supplies at the end of the file
            parts.append(data[start:] if i < 0 else data[start:i])
            return [_unstuff(p) for p in parts], n
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
                return [_unstuff(p) for p in parts], j
        else:
            parts.append(data[start:i])
            return [_unstuff(p) for p in parts], i


def _next_marker(data: bytes, p: int) -> Tuple[bytes, int, int, int]:
    """From ``p``: the entropy-coded bytes up to the next marker (unstuffed),
    the marker, where it starts and where its code ends; at the end of the
    file, libjpeg's fake EOI."""
    n, i = len(data), p
    while True:
        j = data.find(b"\xff", i)
        if j < 0:
            return _unstuff(data[p:]), 0xD9, n, n
        k = j + 1
        while k < n and data[k] == 0xFF:
            k += 1
        if k >= n:
            return _unstuff(data[p:j]), 0xD9, n, n
        if data[k] == 0:
            i = k + 1
            continue
        return _unstuff(data[p:j]), data[k], j, k + 1


def _restart_segments(data: bytes, pos: int, count: int) -> Tuple[List[bytes], int]:
    """The bytes of each of ``count`` restart intervals of an arithmetic
    scan as libjpeg reads them, and where marker reading resumes: at each
    restart ``read_restart_marker`` takes the expected RSTn, else
    ``jpeg_resync_to_restart`` skips invalid markers and RSTs behind the
    expected one, takes one too far ahead, and leaves one just ahead or any
    other marker unread (the interval then reads zero data)."""
    seg, marker, start, after = _next_marker(data, pos)
    segs, desired = [seg], 0
    for _ in range(1, count):
        while True:
            ahead = (marker - 0xD0 - desired) % 8 if 0xD0 <= marker <= 0xD7 else None
            if marker < 0xC0 or ahead in (6, 7):  # invalid, or a prior restart: skip on
                _, marker, start, after = _next_marker(data, after)
                continue
            break
        if ahead is None or ahead in (1, 2):  # left unread: zero data
            segs.append(b"")
        else:  # the expected restart, or one too far away: resume after it
            seg, marker, start, after = _next_marker(data, after)
            segs.append(seg)
        desired = (desired + 1) & 7
    return segs, start


class _Decoder:
    """One JPEG stream; ``colour`` None reads the colour space as libjpeg's
    ``default_decompress_parms`` does, ``"ycc"`` forces YCbCr->RGB and
    ``"raw"`` no conversion (libtiff's JPEG colour modes)."""

    def __init__(self, data: bytes, path: str, colour: Optional[str] = None):
        self.data, self.path, self.colour = data, path, colour
        self.qt: Dict[int, np.ndarray] = {}
        self.dc: Dict[int, Tuple[bytes, bytes]] = {}
        self.ac: Dict[int, Tuple[bytes, bytes]] = {}
        self.built: Dict[tuple, List[int]] = {}  # look-ahead tables by their bytes
        self.restart = 0
        self.comps: List[_Component] = []
        self.kind = ""
        self.progressive = self.lossless = False
        self.precision = 8
        self.adobe: Optional[int] = None
        self.jfif = False
        self.orientation = 1
        self.coef_bits: Dict[int, List[int]] = {}
        self.prev_bits: Dict[int, List[int]] = {}
        self.scans = 0
        self.last_good = -1  # the iMCU row where the data ran out (-1: never)
        # DAC conditioning per table: DC (L, U), AC K
        self.dc_bounds = {t: (0, 1) for t in range(16)}
        self.ac_k = {t: 5 for t in range(16)}

    # -- markers -----------------------------------------------------------
    def run(self) -> np.ndarray:
        self.parse(self.data)
        return apply_orientation(self._output(), self.orientation)

    def parse(self, data: bytes, tables_only: bool = False) -> None:
        if data[:2] != b"\xff\xd8":
            raise ValueError(f"{self.path}: not a JPEG file")
        pos, frame = 2, bool(self.comps)
        while pos < len(data):
            if data[pos] != 0xFF:
                pos += 1  # libjpeg skips garbage before a marker (with a warning)
                continue
            if pos + 1 >= len(data):
                break  # the fake EOI libjpeg's source supplies at the end
            marker = data[pos + 1]
            if marker == 0xFF:
                pos += 1
                continue
            pos += 2
            if marker == 0xD9:
                break
            if marker not in _KNOWN:
                raise ValueError(f"{self.path}: JPEG marker {marker:#04x} (libjpeg refuses it)")
            if 0xD0 <= marker <= 0xD7 or marker == 0x01:
                continue
            if pos + 2 > len(data) or pos + length_of(data, pos) > len(data):
                # at the end of the file libjpeg's source supplies a fake EOI
                # marker again and again: the segment reads those bytes, and
                # the stream ends after it
                data = data + _EOF_FILL[: pos + 65538 - len(data)]
                self.data = data = data[: pos + length_of(data, pos)] + b"\xff\xd9"
            length = length_of(data, pos)
            seg = data[pos + 2 : pos + length]
            if marker in _FRAMES:
                if tables_only:
                    raise ValueError(f"{self.path}: a frame in a JPEG tables stream")
                self._frame(seg, _FRAMES[marker])
                frame = True
            elif marker == 0xC4:
                self._dht(seg)
            elif marker == 0xCC:
                self._dac(seg)
            elif marker == 0xDB:
                self._dqt(seg)
            elif marker == 0xDD:
                self.restart = struct.unpack(">H", seg[:2])[0]
            elif marker == 0xDA:
                if not frame:
                    raise ValueError(f"{self.path}: JPEG scan before its frame")
                pos = self._scan(seg, pos + length)
                if self.scans == 1 and not self.progressive and seg[0] == len(self.comps) \
                        and not tables_only:
                    # a single-scan file is output as its scan is read: what
                    # follows is read by jpeg_finish_decompress, whose errors
                    # OpenCV ignores
                    break
                continue
            elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
                self.jfif = True
            elif marker == 0xE1 and seg[:6] == b"Exif\x00\x00" and self.orientation == 1:
                self.orientation = exif_orientation(seg[6:])
            elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
                self.adobe = seg[11]
            pos += length
        if tables_only:
            return
        if not frame or not self.scans:
            raise ValueError(f"{self.path}: JPEG without image data")

    def _frame(self, seg: bytes, kind: str) -> None:
        if self.comps:
            raise ValueError(f"{self.path}: JPEG with two frames")
        precision, height, width, n = struct.unpack(">BHHB", seg[:6])
        if precision != 8 and not (kind == "lossless" and 2 <= precision < 8):
            raise ValueError(f"{self.path}: {precision}-bit JPEG (OpenCV's reader is 8-bit)")
        self.precision = precision
        if height == 0:
            raise ValueError(f"{self.path}: JPEG with its height in a DNL marker")
        if width == 0 or n not in (1, 3, 4):
            raise ValueError(f"{self.path}: JPEG frame of {width} x {height}, {n} components")
        self.width, self.height, self.kind = width, height, kind
        self.progressive = kind in ("progressive", "arith progressive")
        self.lossless = kind == "lossless"
        size = 1 if self.lossless else 8  # a lossless "block" is one sample
        for k in range(n):
            cid, hv, tq = seg[6 + 3 * k : 9 + 3 * k]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4):
                raise ValueError(f"{self.path}: JPEG sampling factors {h}x{v}")
            self.comps.append(_Component(cid, h, v, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-width // (size * self.hmax))
        self.mcuy = -(-height // (size * self.vmax))
        for c in self.comps:
            if self.hmax % c.h or self.vmax % c.v:
                raise ValueError(f"{self.path}: JPEG sampling ratio is not integral")
            c.width = -(-width * c.h // self.hmax)
            c.height = -(-height * c.v // self.vmax)
            c.cw, c.ch = -(-c.width // size), -(-c.height // size)
            c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v
            c.coef = [0] * (c.bw * c.bh * (1 if self.lossless else 64))
            self.coef_bits[c.id] = [-1] * 64
            self.prev_bits[c.id] = [-1] * 64

    def _dht(self, seg: bytes) -> None:
        """``get_dht``: the tables are checked further, and built, when a scan
        first uses them (``jpeg_make_d_derived_tbl``)."""
        pos = 0
        while pos < len(seg):
            tc_th = seg[pos]
            counts = seg[pos + 1 : pos + 17]
            total = sum(counts)
            symbols = seg[pos + 17 : pos + 17 + total]
            if len(counts) < 16 or len(symbols) < total or total > 256 or tc_th & 0xEC:
                raise ValueError(f"{self.path}: bad JPEG Huffman table")
            (self.ac if tc_th >> 4 else self.dc)[tc_th & 15] = (bytes(counts), bytes(symbols))
            pos += 17 + total

    def _table(self, ac: bool, number: int) -> List[int]:
        """``jpeg_make_d_derived_tbl``: table ``number`` of its class, Annex
        K's for an undefined 0 or 1 of a sequential frame (progressive and
        lossless scans refuse a missing table); DC symbols above 15 (16 in a
        lossless frame) or an over-full code are refused."""
        raw = (self.ac if ac else self.dc).get(number)
        if raw is None:
            if number > 1 or self.progressive or self.lossless:
                raise ValueError(f"{self.path}: JPEG scan without its Huffman table")
            raw = tuple(bytes.fromhex(h) for h in _STD_HUFFMAN[(int(ac), number)])
        key = (ac, raw)
        if key not in self.built:
            if not ac and any(sym > (16 if self.lossless else 15) for sym in raw[1]):
                raise ValueError(f"{self.path}: bad JPEG Huffman table")
            self.built[key] = _huffman_table(*raw)
        return self.built[key]

    def _dac(self, seg: bytes) -> None:
        """``get_dac``: conditioning bounds of arithmetic-coding tables."""
        if len(seg) % 2:
            raise ValueError(f"{self.path}: bad JPEG DAC length")
        for index, val in zip(seg[0::2], seg[1::2]):
            if index >= 32:
                raise ValueError(f"{self.path}: JPEG DAC index {index}")
            if index >= 16:
                self.ac_k[index - 16] = val
            elif (val & 15) > val >> 4:
                raise ValueError(f"{self.path}: JPEG DAC bounds {val:#x}")
            else:
                self.dc_bounds[index] = (val & 15, val >> 4)

    def _dqt(self, seg: bytes) -> None:
        pos = 0
        while pos < len(seg):
            pq, tq = seg[pos] >> 4, seg[pos] & 15
            if tq >= 4:
                raise ValueError(f"{self.path}: JPEG quantisation table {tq}")
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
        self.scans += 1
        if self.lossless:
            intervals, end = _entropy_intervals(self.data, pos)
            self._lossless(comps, tables, ss, al, intervals)
            return end
        if not self.progressive:
            ss, se, ah, al = 0, 63, 0, 0
        elif ss > se or se > 63 or (ss == 0 and se != 0) or (ss > 0 and n != 1) \
                or (ah and ah - 1 != al) or al > 13:
            raise ValueError(f"{self.path}: bad progressive JPEG scan")
        for c in comps:
            if c.quant is None:
                if c.tq not in self.qt:
                    raise ValueError(f"{self.path}: JPEG component without its table")
                c.quant = self.qt[c.tq]
        blocks = self._scan_blocks(comps)
        arith = self.kind.startswith("arith")
        if not arith:  # the tables a scan decodes with (a sequential scan: both)
            need_dc = not self.progressive or (ss == 0 and ah == 0)
            need_ac = not self.progressive or ss > 0
            dc = [self._table(False, t[0]) if need_dc else None for t in tables]
            ac = [self._table(True, t[1]) if need_ac else None for t in tables]
        per_interval = self.restart * sum(
            (1 if n == 1 else c.h * c.v) for c in comps) if self.restart else len(blocks)
        if self.progressive:
            for c in comps:  # start_pass: the bits before this scan, then this scan's
                bits, prev = self.coef_bits[c.id], self.prev_bits[c.id]
                for k in range(min(ss, 1), max(se, 9) + 1):
                    prev[k] = bits[k] if self.scans > 1 else 0
                for k in range(ss, se + 1):
                    bits[k] = al
        if arith:
            mode = "sequential" if not self.progressive else (
                ("dc_refine" if ah else "dc_first") if ss == 0 else
                ("ac_refine" if ah else "ac_first"))
            cond = [(*self.dc_bounds[t[0]], self.ac_k[t[1]]) for t in tables]
            starts = range(0, len(blocks), max(per_interval, 1))
            segments, end = _restart_segments(self.data, pos, len(starts))
            for chunk, i in zip(segments, starts):
                # past its bytes an interval reads zero data to its end
                jpeg_arith.decode_interval(chunk, blocks[i : i + per_interval], mode, tables,
                                           cond, ss, se, al, NATURAL)
            return end
        intervals, end = _entropy_intervals(self.data, pos)
        for j, i in enumerate(range(0, len(blocks), max(per_interval, 1))):
            if j >= len(intervals):
                self._ran_out(blocks, i)
                break  # the data ended: libjpeg skips the scan's later intervals
            chunk = intervals[j]
            part = blocks[i : i + per_interval]
            if not self.progressive:
                stop = self._sequential(_Bits(chunk), part, dc, ac)
            elif ss == 0:
                stop = self._dc_scan(_Bits(chunk), part, dc, ah, al)
            elif ah == 0:
                stop = self._ac_first(_Bits(chunk), part, ac[0], ss, se, al)
            else:
                stop = self._ac_refine(_Bits(chunk), part, ac[0], ss, se, al)
            if stop is not None:
                self._ran_out(blocks, i + stop - 1)  # the MCU that read past the data
        return end

    def _ran_out(self, blocks, index: int) -> None:
        """Note the iMCU row of the scan's ``index``-th block, in whose MCU
        its data ran out (libjpeg-turbo's ``last_good_iMCU_row``: block
        smoothing uses the coefficient bits from before the scan below it)."""
        if self.last_good < 0 and index < len(blocks):
            self.last_good = blocks[index][4]

    def _scan_blocks(self, comps: List[_Component]) -> List[Tuple[int, List[int], int, bool, int]]:
        """(component index in the scan, coefficient list, offset, first block
        of its MCU, iMCU row) of every block in the scan's order."""
        out = []
        if len(comps) == 1:
            c = comps[0]
            for by in range(c.ch):
                for bx in range(c.cw):
                    out.append((0, c.coef, (by * c.bw + bx) * 64, True, by // c.v))
            return out
        for my in range(self.mcuy):
            for mx in range(self.mcux):
                start = True
                for k, c in enumerate(comps):
                    for v in range(c.v):
                        row = (my * c.v + v) * c.bw + mx * c.h
                        for h in range(c.h):
                            out.append((k, c.coef, (row + h) * 64, start, my))
                            start = False
        return out

    @staticmethod
    def _sequential(bits: _Bits, blocks, dc, ac) -> None:
        win, pos, nbits = bits.win, 0, bits.nbits
        pred = [0] * len(dc)
        natural = NATURAL
        for at, (k, coef, base, start, _row) in enumerate(blocks):
            if start and pos > nbits:
                return at  # the data ran out in an earlier MCU: libjpeg skips the rest
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
        for at, (k, coef, base, start, _row) in enumerate(blocks):
            if start and pos > nbits:
                return at  # the data ran out in an earlier MCU: libjpeg skips the rest
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
        for at, (_k, coef, base, _start, _row) in enumerate(blocks):
            if pos > nbits:
                return at
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
        for at, (_k, coef, base, _start, _row) in enumerate(blocks):
            if pos > nbits:
                return at
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

    # -- lossless ----------------------------------------------------------
    def _lossless(self, comps: List[_Component], tables, predictor: int, pt: int,
                  intervals: List[bytes]) -> None:
        """One lossless scan (``jdlhuff.c``, ``jddiffct.c``, ``jdlossls.c``):
        differences per MCU row, undifferenced per iMCU row; restarts every
        ``restart // MCUs per row`` MCU rows; once the data has run out, each
        later MCU row is zero and resets the predictors (the centre value)."""
        if not 1 <= predictor <= 7 or pt >= self.precision:
            raise ValueError(f"{self.path}: bad lossless JPEG scan")
        dc = [self._table(False, t[0]) for t in tables]
        n = len(comps)
        if n == 1:
            c = comps[0]
            per_row, imcu_rows, rows_per_imcu = c.cw, -(-c.ch // c.v), c.v
            units = [[(0, 0, x)] for x in range(c.cw)]  # (component, row, column) per MCU
        else:
            per_row, imcu_rows, rows_per_imcu = self.mcux, self.mcuy, 1
            units = [[(k, v, mx * cp.h + h) for k, cp in enumerate(comps)
                      for v in range(cp.v) for h in range(cp.h)] for mx in range(self.mcux)]
        for cp in comps:
            cp.samples = np.zeros((cp.ch, cp.cw), np.uint8)
        diffs = [np.zeros((cp.v if n > 1 else 1, cp.bw), np.int64) for cp in comps]
        first = [True] * n
        prev = [np.zeros(cp.cw, np.int64) for cp in comps]
        done = [0] * n  # rows undifferenced
        restart_rows = self.restart // per_row if self.restart else 0
        to_go = restart_rows
        interval = 0
        # zero windows past an interval for a whole MCU row of 33-bit codes
        tail = 5 * sum(len(u) for u in units) + 8
        bits = _Bits(intervals[0] if intervals else b"", tail)
        pos, insufficient = 0, not intervals
        for r in range(imcu_rows):
            last = r == imcu_rows - 1
            mcu_rows = rows_per_imcu if n > 1 or not last else (comps[0].ch % comps[0].v
                                                                 or comps[0].v)
            rows_here = [[] for _ in comps]
            for y in range(mcu_rows):
                if self.restart and to_go == 0:
                    interval += 1
                    if interval < len(intervals):
                        bits, pos, insufficient = _Bits(intervals[interval], tail), 0, False
                    else:
                        bits, pos = _Bits(b"", tail), 0
                    first = [True] * n
                    to_go = restart_rows
                if pos > bits.nbits:
                    insufficient = True
                for d in diffs:
                    d[:] = 0
                if insufficient:
                    first = [True] * n
                else:
                    pos = self._lossless_row(bits, pos, units, dc, diffs)
                if self.restart:
                    to_go = (to_go - 1) & 0xFFFFFFFF
                for k in range(n):
                    rows_here[k].extend(diffs[k][: (1 if n == 1 else comps[k].v)].copy())
            for k, cp in enumerate(comps):
                height = cp.v if not last else (cp.ch - done[k])
                for row in rows_here[k][:height]:
                    prev[k] = _undifference(row[: cp.cw], prev[k], predictor if not first[k]
                                            else 0, 1 << (self.precision - pt - 1))
                    first[k] = False
                    cp.samples[done[k]] = (prev[k] << pt) & 0xFF
                    done[k] += 1

    @staticmethod
    def _lossless_row(bits: _Bits, pos: int, units, dc, diffs) -> int:
        win = bits.win
        for unit in units:
            for k, y, x in unit:
                look = dc[k][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                pos += look >> 8
                s = look & 0xFF
                if s == 16:
                    v = 32768
                elif s:
                    v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                    pos += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                else:
                    v = 0
                diffs[k][y, x] = v
        return pos

    # -- output ------------------------------------------------------------
    def _output(self) -> np.ndarray:
        return self._colour(self._planes())

    def _planes(self) -> List[np.ndarray]:
        """Each component's samples, upsampled to the image size."""
        planes = []
        for c in self.comps:
            if self.lossless:
                if c.samples is None:
                    raise ValueError(f"{self.path}: lossless JPEG component without a scan")
                plane = c.samples
            else:
                blocks = np.asarray(c.coef, np.int64).astype(np.int16).reshape(c.bh, c.bw, 64)
                blocks = self._smooth(c, blocks) if self._smoothing() else blocks[: c.ch, : c.cw]
                # a component no scan reached has no table latched: libjpeg's
                # multipliers stay zero, and it reads as mid-grey
                quant = c.quant if c.quant is not None else np.zeros(64, np.int64)
                pixels = _idct_islow(blocks.reshape(-1, 64).astype(np.int64) * quant[None, :])
                plane = pixels.reshape(c.ch, c.cw, 8, 8).transpose(0, 2, 1, 3).reshape(
                    c.ch * 8, c.cw * 8)[: c.height, : c.width]
            planes.append(_upsample(plane, self.hmax // c.h, self.vmax // c.v,
                                    fancy=not self.lossless)[: self.height, : self.width])
        return planes

    def _smoothing(self) -> bool:
        """``smoothing_ok``: a progressive file whose DC is known in every
        component and some AC coefficient 1-9 of some component is not fully
        refined is block-smoothed on output."""
        if not self.progressive:
            return False
        useful = False
        for c in self.comps:
            bits = self.coef_bits[c.id]
            if c.quant is None or not c.quant[_Q_POS].all() or bits[0] < 0:
                return False
            useful |= any(b != 0 for b in bits[1:10])
        return useful

    def _smooth(self, c: _Component, blocks: np.ndarray) -> np.ndarray:
        """``decompress_smooth_data`` over the component's output blocks:
        each block row with the DC values of the two rows above and below
        (chosen per iMCU row as libjpeg chooses them) and of the two columns
        either side (clamped), the coefficient bits latched per iMCU row."""
        latch = self.coef_bits[c.id][:10]
        prev_latch = self.prev_bits[c.id][:10] if self.scans > 1 else [-1] * 10
        dc = blocks[..., 0].astype(np.int64)
        total = self.mcuy if len(self.comps) > 1 else -(-c.ch // c.v)
        last_row = total - 1
        q = c.quant[_Q_POS].astype(np.int64)
        cols = np.arange(c.cw)
        out = blocks[: c.ch, : c.cw].astype(np.int64)
        good = self.last_good if self.last_good >= 0 else total
        for r in range(c.ch):
            imcu, br = divmod(r, c.v)
            block_rows = c.v if imcu < last_row else (c.ch % c.v or c.v)
            ibr, ibrs = imcu * block_rows + br, block_rows * total
            prev = r - 1 if ibr > 0 else r
            pprev = r - 2 if ibr > 1 else prev
            nxt = r + 1 if ibr < ibrs - 1 else r
            nnxt = r + 2 if ibr < ibrs - 2 else nxt
            bits = latch if imcu <= good else prev_latch
            change_dc = all(b == -1 for b in bits[1:10])
            d = {}
            for j, row in enumerate((pprev, prev, r, nxt, nnxt)):
                for i in range(5):
                    d[5 * j + i + 1] = dc[row, np.clip(cols + i - 2, 0, c.cw - 1)]
            ws = out[r]
            for n_coef, (pos, kernel, dc_kernel) in enumerate(_SMOOTH, start=1):
                if n_coef > 5 and not change_dc:
                    break
                al = bits[n_coef]
                if al == 0:
                    continue
                terms = dc_kernel if change_dc else kernel
                num = q[0] * sum(w * d[i] for i, w in terms)
                qk = q[n_coef]
                pred = np.where(num >= 0, ((qk << 7) + num) // (qk << 8),
                                ((qk << 7) - num) // (qk << 8))
                if al > 0:
                    pred = np.minimum(pred, (1 << al) - 1)
                pred = np.where(num >= 0, pred, -pred)
                ws[:, pos] = np.where(ws[:, pos] == 0, pred, ws[:, pos])
            if change_dc:
                num = q[0] * sum(w * d[i] for i, w in _SMOOTH_DC)
                pred = np.where(num >= 0, ((q[0] << 7) + num) // (q[0] << 8),
                                ((q[0] << 7) - num) // (q[0] << 8))
                ws[:, 0] = np.where(num >= 0, pred, -pred)
        return out.astype(np.int16)

    def _colour(self, planes: List[np.ndarray]) -> np.ndarray:
        """``default_decompress_parms``' colour space (or libtiff's forced
        one), then OpenCV's output."""
        n = len(planes)
        if self.colour == "raw":
            return np.stack(planes, axis=2).astype(np.uint8)
        if self.colour == "ycc":
            return _ycc_to_rgb(*planes)
        if self.lossless and (n == 1 or (n == 3 and (self.jfif or self.adobe not in (None, 0)))
                              or (n == 4 and self.adobe not in (None, 0))):
            # libjpeg-turbo converts no colour space of a lossless frame
            raise ValueError(f"{self.path}: lossless JPEG needing a colour conversion")
        if n == 1:
            return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
        if n == 3:
            if self.jfif:
                rgb = False
            elif self.adobe is not None:
                rgb = self.adobe == 0
            else:  # a lossless frame without markers is RGB
                rgb = self.lossless or [c.id for c in self.comps] == [82, 71, 66]
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


# natural positions of the DC and the first nine AC coefficients, and for
# each of those nine (position, 5 x 5 kernel, kernel when the DC is
# interpolated too): ``decompress_smooth_data``'s estimates, the DC values
# numbered DC01-DC25 row by row over the 5 x 5 neighbourhood
_Q_POS = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24]
_SMOOTH = [
    (1, [(11, -7), (12, 50), (14, -50), (15, 7)],
     [(1, -1), (2, -1), (4, 1), (5, 1), (6, -3), (7, 13), (9, -13), (10, 3), (11, -3),
      (12, 38), (14, -38), (15, 3), (16, -3), (17, 13), (19, -13), (20, 3), (21, -1),
      (22, -1), (24, 1), (25, 1)]),
    (8, [(3, -7), (8, 50), (18, -50), (23, 7)],
     [(1, -1), (2, -3), (3, -3), (4, -3), (5, -1), (6, -1), (7, 13), (8, 38), (9, 13),
      (10, -1), (16, 1), (17, -13), (18, -38), (19, -13), (20, 1), (21, 1), (22, 3), (23, 3),
      (24, 3), (25, 1)]),
    (16, [(3, -1), (8, 13), (13, -24), (18, 13), (23, -1)],
     [(3, 1), (7, 2), (8, 7), (9, 2), (12, -5), (13, -14), (14, -5), (17, 2), (18, 7),
      (19, 2), (23, 1)]),
    (9, [(10, 1), (16, 1), (17, -10), (19, 10), (2, -1), (20, -1), (22, 1), (24, -1), (4, 1),
         (6, -1), (7, 10), (9, -10)],
     [(1, -1), (5, 1), (7, 9), (9, -9), (17, -9), (19, 9), (21, 1), (25, -1)]),
    (2, [(11, -1), (12, 13), (13, -24), (14, 13), (15, -1)],
     [(7, 2), (8, -5), (9, 2), (11, 1), (12, 7), (13, -14), (14, 7), (15, 1), (17, 2),
      (18, -5), (19, 2)]),
    (3, None, [(7, 1), (9, -1), (12, 2), (14, -2), (17, 1), (19, -1)]),
    (10, None, [(7, 1), (8, -3), (9, 1), (17, -1), (18, 3), (19, -1)]),
    (17, None, [(7, 1), (9, -1), (12, -3), (14, 3), (17, 1), (19, -1)]),
    (24, None, [(7, 1), (8, 2), (9, 1), (17, -1), (18, -2), (19, -1)]),
]
_SMOOTH_DC = [(1, -2), (2, -6), (3, -8), (4, -6), (5, -2), (6, -6), (7, 6), (8, 42), (9, 6),
              (10, -6), (11, -8), (12, 42), (13, 152), (14, 42), (15, -8), (16, -6), (17, 6),
              (18, 42), (19, 6), (20, -6), (21, -2), (22, -6), (23, -8), (24, -6), (25, -2)]


def _undifference(diff: np.ndarray, prev: np.ndarray, predictor: int, initial: int) -> np.ndarray:
    """One row of ``jdlossls.c``'s undifferencing (``predictor`` 0: the
    first row of a scan or restart interval), modulo 2**16."""
    w = len(diff)
    if predictor == 0:
        diff = diff.copy()
        diff[0] += initial
        return np.cumsum(diff) & 0xFFFF
    rb = prev
    rc = np.concatenate([[0], prev[:-1]])
    if predictor in (2, 3):
        out = (diff + (rb if predictor == 2 else rc)) & 0xFFFF
        out[0] = (diff[0] + prev[0]) & 0xFFFF
        return out
    if predictor in (1, 4, 5):  # linear in Ra: a running sum
        step = diff.copy()
        if predictor == 4:
            step[1:] += rb[1:] - rc[1:]
        elif predictor == 5:
            step[1:] += (rb[1:] - rc[1:]) >> 1
        step[0] = diff[0] + prev[0]
        return np.cumsum(step) & 0xFFFF
    out = np.empty(w, np.int64)
    ra = int(diff[0] + prev[0]) & 0xFFFF
    out[0] = ra
    d, b, c = diff.tolist(), rb.tolist(), rc.tolist()
    for x in range(1, w):
        if predictor == 6:
            ra = (d[x] + b[x] + ((ra - c[x]) >> 1)) & 0xFFFF
        else:
            ra = (d[x] + ((ra + b[x]) >> 1)) & 0xFFFF
        out[x] = ra
    return out


_C = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633,
          f1501=12299, f1847=15137, f1961=16069, f2053=16819, f2562=20995, f3072=25172)


def _wrap(v: np.ndarray, bits: int) -> np.ndarray:
    half = 1 << (bits - 1)
    return ((v + half) & ((1 << bits) - 1)) - half


def _idct_1d(x: List[np.ndarray]) -> Tuple[np.ndarray, ...]:
    """One pass of libjpeg-turbo's SIMD ``jsimd_idct_islow`` over 8 inputs
    (int16 each), before the descale: ``jidctint.c``'s products regrouped
    into ``pmaddwd`` pairs, with its 16-bit sums (``in0 +- in4``,
    ``in7 + in3``, ``in5 + in1``) and 32-bit accumulations wrapping as the
    vector registers wrap them.  Returns the 8 outputs scaled by 2**13."""
    c = _C
    w16 = lambda v: _wrap(v, 16)  # noqa: E731
    w32 = lambda v: _wrap(v, 32)  # noqa: E731
    z2, z3 = x[2], x[6]
    tmp3 = w32(z2 * (c["f0541"] + c["f0765"]) + z3 * c["f0541"])
    tmp2 = w32(z2 * c["f0541"] + z3 * (c["f0541"] - c["f1847"]))
    tmp0 = w16(x[0] + x[4]) << 13
    tmp1 = w16(x[0] - x[4]) << 13
    tmp10, tmp13 = w32(tmp0 + tmp3), w32(tmp0 - tmp3)
    tmp11, tmp12 = w32(tmp1 + tmp2), w32(tmp1 - tmp2)
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    s3, s4 = w16(t0 + t2), w16(t1 + t3)
    z3 = w32(s3 * (c["f1175"] - c["f1961"]) + s4 * c["f1175"])
    z4 = w32(s3 * c["f1175"] + s4 * (c["f1175"] - c["f0390"]))
    a0 = w32(t0 * (c["f0298"] - c["f0899"]) - t3 * c["f0899"] + z3)
    a3 = w32(-t0 * c["f0899"] + t3 * (c["f1501"] - c["f0899"]) + z4)
    a1 = w32(t1 * (c["f2053"] - c["f2562"]) - t2 * c["f2562"] + z4)
    a2 = w32(-t1 * c["f2562"] + t2 * (c["f3072"] - c["f2562"]) + z3)
    return tuple(w32(v) for v in (tmp10 + a3, tmp11 + a2, tmp12 + a1, tmp13 + a0,
                                  tmp13 - a0, tmp12 - a1, tmp11 - a2, tmp10 - a3))


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """``jsimd_idct_islow`` (the x86 SIMD islow IDCT OpenCV's libjpeg-turbo
    runs) of quantised blocks times their tables (N, 64) -> samples
    (N, 8, 8): the products kept to 16 bits (``pmullw``), each pass's
    outputs saturated to 16 bits (``packssdw``), the last to 8 bits
    (``packsswb``) around the centre 128.  Inside those ranges it equals
    ``jidctint.c``."""
    blk = _wrap(coef.reshape(-1, 8, 8), 16)
    cols = [blk[:, r, :] for r in range(8)]  # column pass: inputs along rows of coefficients
    out = _idct_1d(cols)
    ws = np.stack([np.clip(_wrap(o + (1 << 10), 32) >> 11, -32768, 32767) for o in out],
                  axis=1)  # CONST_BITS - PASS1_BITS
    rows = [ws[:, :, k] for k in range(8)]
    out = _idct_1d(rows)
    vals = np.stack([np.clip(_wrap(o + (1 << 17), 32) >> 18, -128, 127) for o in out],
                    axis=2)  # CONST_BITS + PASS1_BITS + 3
    return vals + 128


def _upsample(plane: np.ndarray, hr: int, vr: int, fancy: bool = True) -> np.ndarray:
    """``jdsample.c``: fancy h2v1/h2v2 (component wider than 2) and h1v2,
    replication for other integral ratios (and for all of them when not
    ``fancy``: a lossless frame's DCT size is 1)."""
    p = plane.astype(np.int64)
    h, w = p.shape
    if hr == 1 and vr == 1:
        return p
    if not fancy:
        return np.repeat(np.repeat(p, vr, axis=0), hr, axis=1)
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


class InTiff:
    """One strip or tile of JPEG-in-TIFF as ``tif_jpeg.c`` hands it to
    libjpeg: the ``JPEGTables`` stream read first (tables-only), then the
    abbreviated stream; ``colour`` ``"ycc"`` (``JPEGCOLORMODE_RGB`` on YCbCr)
    or ``"raw"`` (no conversion).  ``frame()`` gives the header's size,
    precision and sampling factors, ``samples()`` the upsampled
    (rows, columns, components) uint8 output."""

    def __init__(self, data: bytes, tables: Optional[bytes], colour: str, path: str):
        self.dec = _Decoder(data, path, colour)
        if tables:
            self.dec.parse(tables, tables_only=True)
        self.dec.parse(data)

    def frame(self) -> Tuple[int, int, List[Tuple[int, int]]]:
        d = self.dec
        return d.width, d.height, [(c.h, c.v) for c in d.comps]

    def samples(self) -> np.ndarray:
        return self.dec._output()
