"""A TIFF reader in Python and numpy, exact against ``cv2.imread``.

OpenCV 5.0 reads a TIFF through libtiff 4.7's RGBA interface
(``tif_getimage.c``, ``TIFFReadRGBAStrip``/``Tile``, not stopping on
errors) and drops the alpha it returns.  :func:`decode_tiff` reads the
first page the same way and returns RGB uint8 ``(H, W, 3)``, or raises
``ValueError`` where ``cv2.imread`` returns None:

* layout: classic TIFF and BigTIFF (8-byte offsets and counts, ``LONG8``,
  ``SLONG8`` and ``IFD8`` values), both byte orders, strips and tiles,
  planar configuration 1 and 2,
  ``FillOrder`` 2 (bits reversed in each byte before decoding); byte
  counts missing or doubtful estimated as ``EstimateStripByteCounts``
  does; a strip or tile whose RGBA buffer would reach 1 GiB read as None,
  as OpenCV refuses it;
* compressions: none (1), CCITT MH (2), T.4 1-D and 2-D (3), T.6 (4) and
  RLE/W (32771) (``data/ccitt.py``), LZW (5, old-style codes too), Deflate (8 and 32946),
  PackBits (32773), JPEG (7: each strip or tile an abbreviated stream read
  after ``JPEGTables`` by ``data/jpeg.py``, YCbCr converted by libjpeg as
  ``JPEGCOLORMODE_RGB`` asks, other photometrics raw), ThunderScan (32809)
  and SGILog (34676, 34677) (``data/tiff_codecs.py``); horizontal
  differencing (predictor 2) on 8- and 16-bit samples of LZW and Deflate
  strips, undone only where the strip decoded whole (other predictors, and
  predictor 2 at other depths, fail ``PredictorSetup``: None; the tag is
  ignored beside other compressions);
* samples (libtiff's maps): grey (MinIsBlack, MinIsWhite) at 1, 2, 4 and 8
  bits as ``v * 255 // max`` (MinIsWhite inverted), at 16 bits by the high
  byte; RGB at 8 bits as stored and at 16 bits as ``(v + 128) // 257``; a
  palette at 1, 2, 4 and 8 bits through its colour map, each entry shifted
  right by 8 unless every entry is below 256 (libtiff then assumes an 8-bit
  map; a map of another count than 3 * 2**bits is ignored, and a palette
  image of 8 bits or more without one reads as grey); an unassociated alpha (``ExtraSamples`` 2) premultiplies RGB as
  ``(v * a + 127) // 255``, while other extra samples, and any beside grey,
  are dropped; signed samples (``SampleFormat`` 2) read as their unsigned
  bytes, as libtiff reads them;
* photometric interpretations (``data/tiff_colour.py``): YCbCr at 8 bits,
  contiguous at every ``YCbCrSubSampling`` of ``putcontig8bitYCbCr*tile``
  (1, 2 or 4 across, 1, 2 or 4 down, not more down than across but 1x2),
  planar at 1x1, through ``TIFFYCbCrToRGBInit``'s tables; CMYK with 4 inks
  at 8 bits, contiguous or planar; CIE L*a*b* at 8 and 16 bits,
  contiguous, through ``TIFFCIELabToXYZ`` and ``display_sRGB``; LogL and
  LogLuv from SGILog data;
* the orientation tag (274): 2-4 flip as OpenCV flips, 5-8 turn as the JPEG
  ones do (``data/exif.py``).

A strip or tile that libtiff's decoder fails on (a compressed one of too
little data, a corrupt LZW or Deflate stream, a ThunderScan or SGILog row
of too little or too much data, or a compression libtiff does not know at
all) reads as far as the decoder wrote and zero after:
OpenCV reads each strip or tile into a zeroed buffer, and the RGBA
interface does not stop on a decoding error.

Read as None, as OpenCV 5.0 refuses them: LZMA, ZSTD (50000), WebP
(50001), JBIG (34661), LERC and PixarLog (32909) compressions, which its
libtiff lacks ("not configured"); old-style JPEG (6) and NeXT (32766);
samples of 12, 24, 32 or 64 bits, floating-point (``SampleFormat`` 3) or
void ones, or formats that differ between samples; ICC Lab (9), ITU Lab
(10) and transparency masks; CMYK or YCbCr at 16 bits or with the wrong
sample count, CMYK of another ink set, planar subsampled YCbCr, planar or
non-3-sample Lab; more than four samples a pixel.

The CCITT codecs, RLE/W (32771) among them, are read by libtiff's own
state machine (``data/ccitt.py``), so a bad code, a row of the wrong
length or a strip cut short is repaired as libtiff repairs it.  RLE/W
aligns its rows by how many bytes its bit accumulator happened to load and
by the parity of the byte it stopped at in the mapped file, so each
strip's or tile's file offset goes to the decoder.

The directory is read as ``TIFFReadDirectory`` reads it (``_directory``):
each tag through its ``TIFFReadDirEntry*`` reader's rules (the types it
converts from, the count, each value in range, the values inside the file),
a failure failing the directory (None) for the tags libtiff lays the image
out by (``SamplesPerPixel``, ``Compression``, the sizes, ``PlanarConfig``,
``RowsPerStrip``, ``ExtraSamples``, the per-sample tags, the strip or tile
arrays) and ignoring the tag for the others; the values ``TIFFSetField``
refuses; strip or tile arrays cut or padded with zeros to their number;
no strips or tiles, or a zero size, failing; a size past OpenCV's limits
(2^20 a side, 2^30 pixels) read as None before anything is allocated.

Differences by design, each pinned by a test: OpenCV 5.0 fails to read
orientations 5-8 (it returns None), and refuses grey at 2 and 4 bits (a
ThunderScan one too) and palettes at 2 bits, which the port reads as
libtiff's maps give them.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from molnextr_tpu_torch.data import ccitt, jpeg, tiff_codecs, tiff_colour
from molnextr_tpu_torch.data.exif import apply_orientation

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
          11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
# compressions libtiff 4.7 registers but OpenCV 5.0 builds without ("not
# configured": TIFFRGBAImageOK fails), or that can never give an image
# OpenCV takes: cv2.imread returns None
_REFUSED_COMPRESSION = {
    34925: "LZMA", 50000: "ZSTD", 50001: "WebP", 34661: "JBIG", 34887: "LERC",
    32909: "PixarLog", 6: "old-style JPEG", 32766: "NeXT (2-bit samples only)",
}
# compressions the port decodes; any code libtiff does not know decodes to
# nothing (libtiff's default codec fails every strip)
_DECODED = {1, 2, 3, 4, 5, 7, 8, 32771, 32773, 32809, 32946, 34676, 34677}
_LIBTIFF_CODECS = _DECODED | set(_REFUSED_COMPRESSION)
_REFUSED_PHOTOMETRIC = {9: "ICC Lab", 10: "ITU Lab", 4: "transparency mask"}
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
# putcontig8bitYCbCr*tile's subsamplings (across, down)
_YCBCR_SUBSAMPLING = {(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)}
# D50 as the WhitePoint default (float32 sums, as tif_aux.c computes it)
_D50 = (np.float32(96.425), np.float32(100.0), np.float32(82.468))


class _Failed(Exception):
    """libtiff's decoder failed on a strip or tile: the RGBA interface goes
    on with the strip buffer as the decoder left it."""


def _entries(data: bytes, order: str, ifd: int, big: bool) -> List[Tuple[int, int, int, int]]:
    """``TIFFFetchDirectory``: the IFD's entries as (tag, type, count, offset
    of the value field).  A directory of more than 4096 entries, or one that
    runs past the end of the file, fails."""
    word, entry = ("Q", 20) if big else ("I", 12)
    (count,) = struct.unpack_from(order + ("Q" if big else "H"), data, ifd)
    first = ifd + (8 if big else 2)
    if count > 4096 or first + entry * count > len(data):
        raise ValueError("TIFF: directory count fails libtiff's sanity check")
    out = []
    for k in range(count):
        tag, typ, n = struct.unpack_from(order + "HH" + word, data, first + entry * k)
        out.append((tag, typ, n, first + entry * k + (12 if big else 8)))
    return out


class _EntryError(Exception):
    """A ``TIFFReadDirEntry*`` error: count, type, range or I/O."""


def _values(data: bytes, order: str, big: bool, e: Tuple[int, int, int, int],
            limit: Optional[int] = None) -> list:
    """An entry's values in its own type, at most ``limit`` of them; values
    that lie past the end of the file are an I/O error."""
    _tag, typ, count, at = e
    n = count if limit is None else min(count, limit)
    width = _WIDTHS[typ]
    if width * n > 2147483647:
        raise _EntryError("size")
    size = width * n
    if width * count > (8 if big else 4):  # in place or not by the whole count
        (at,) = struct.unpack_from(order + ("Q" if big else "I"), data, at)
    if at + size > len(data):
        raise _EntryError("I/O")
    fmt = _TYPES[typ]
    vals = list(struct.unpack_from(order + fmt * n, data, at))
    if typ in (5, 10):  # RATIONAL, SRATIONAL: pairs
        vals = [(a, b) for a, b in zip(vals[0::2], vals[1::2])]
    return vals


# types each TIFFReadDirEntry* reader converts from
_INTEGER_TYPES = {1, 3, 4, 6, 8, 9, 16, 17}  # BYTE SHORT LONG SBYTE SSHORT SLONG LONG8 SLONG8
_FLOAT_TYPES = _INTEGER_TYPES | {5, 10, 11, 12}


def _tags(data: bytes, order: str, ifd: int, big: bool = False) -> Dict[int, List]:
    """Every tag of the IFD at ``ifd`` -> its raw values (a rational as two
    numbers), skipping entries of an unknown type or whose values lie past
    the end of the file: the tests' view of a file they wrote.  The reader
    itself goes through :func:`_directory`."""
    tags: Dict[int, List] = {}
    for e in _entries(data, order, ifd, big):
        if e[1] in _TYPES:
            try:
                vals = _values(data, order, big, e)
            except _EntryError:
                continue
            tags[e[0]] = [v for pair in vals for v in pair] if e[1] in (5, 10) else vals
    return tags


# the base directory's tags that TIFFReadDirectory reads in its first pass
# (a failure fails the directory), as UINT32 or UINT16
_FIRST_PASS = {256: "L", 257: "L", 278: "L", 322: "L", 323: "L", 32997: "L", 32998: "L",
               284: "H"}
# tags read per sample in the second pass, whose failure fails the directory
_PER_SAMPLE = (258, 280, 281, 339, 32996)
# codec tags, known only to their codec (_TIFFCheckFieldIsValidForCodec)
_CODEC_TAGS = {317: {5, 8, 32946}, 347: {7}, 292: {3}, 293: {4}}
# single UINT16 tags of the second pass the port reads; a failure ignores the tag
_SHORTS = (262, 266, 274, 317, 332)
_FLOAT_COUNTS = {318: 2, 529: 3, 532: 6}  # C0_FLOAT tags and their counts
_MAX_COLOUR = {0: 1, 1: 1, 3: 1, 4: 1, 32844: 1, 2: 3, 6: 3, 8: 3, 9: 3, 10: 3, 32845: 3,
               5: 4}  # _TIFFGetMaxColorChannels


def _directory(data: bytes, order: str, ifd: int, big: bool, path: str) -> Dict[int, List]:
    """``TIFFReadDirectory`` of the IFD at ``ifd``: each tag read as its
    ``TIFFReadDirEntry*`` reader reads it (the types it converts from, the
    count it needs, each value in range, the values inside the file), a
    failure failing the directory (``ValueError``) for the tags libtiff
    needs to lay out the image and ignoring the tag for the others; the
    values ``TIFFSetField`` refuses; the strip or tile arrays cut or padded
    with zeros to the number of strips or tiles.  Returns tag -> values with
    ``nstrips`` under the key -1."""
    seen: set = set()  # a tag's later duplicates are ignored (libtiff's bugzilla 1994)
    ents = [e for e in _entries(data, order, ifd, big) if not (e[0] in seen or seen.add(e[0]))]
    t: Dict[int, List] = {}

    def fail(what: str):
        raise ValueError(f"{path}: TIFF directory: {what} (TIFFReadDirectory fails)")

    def ints(e, top: int, limit: Optional[int] = None) -> list:
        if e[1] not in _INTEGER_TYPES:
            raise _EntryError("type")
        vals = _values(data, order, big, e, limit)
        if any(v < 0 or v > top for v in vals):
            raise _EntryError("range")
        return vals

    def short(e) -> int:  # TIFFReadDirEntryShort
        if e[2] != 1:
            raise _EntryError("count")
        return ints(e, 0xFFFF)[0]

    def per_sample(e) -> int:  # ...Short, then TIFFReadDirEntryPersampleShort on a count error
        if e[2] == 1:
            return short(e)
        spp = t.get(277, [1])[0]
        if e[2] < spp:
            raise _EntryError("count")
        vals = ints(e, 0xFFFF)[:spp]
        if len(set(vals)) > 1:
            raise _EntryError("per-sample values differ")
        return vals[0]

    def find(tag):
        return next((e for e in ents if e[0] == tag), None)

    handled = set()
    e = find(277)
    if e is not None:
        handled.add(id(e))
        try:
            spp = short(e)
        except _EntryError as err:
            fail(f"SamplesPerPixel: {err}")
        if spp == 0:
            fail("SamplesPerPixel 0")
        t[277] = [spp]
    e = find(259)
    if e is not None:
        handled.add(id(e))
        try:
            t[259] = [per_sample(e)]
        except _EntryError as err:
            fail(f"Compression: {err}")
    compression = t.get(259, [1])[0]
    # first pass: the layout
    for e in ents:
        if id(e) in handled or e[0] not in _FIRST_PASS and e[0] != 338:
            continue
        handled.add(id(e))
        try:
            if e[0] == 338:  # ExtraSamples: C16_UINT16
                if e[2] > 0xFFFF:
                    raise _EntryError("count")
                vals = ints(e, 0xFFFF)
                if len(vals) > t.get(277, [1])[0] or any(v > 2 and v != 999 for v in vals):
                    fail(f"ExtraSamples {vals}")
                t[338] = [2 if v == 999 else v for v in vals]
                continue
            if e[2] != 1:
                raise _EntryError("count")
            (v,) = ints(e, 0xFFFFFFFF if _FIRST_PASS[e[0]] == "L" else 0xFFFF)
        except _EntryError as err:
            fail(f"tag {e[0]}: {err}")
        if e[0] == 278 and v == 0 or e[0] == 284 and v not in (1, 2):
            fail(f"tag {e[0]} value {v}")
        t[e[0]] = [v]
    if 256 not in t and 257 not in t:
        fail("no ImageLength")
    width, height = t.setdefault(256, [0])[0], t.setdefault(257, [0])[0]
    if width == 0 or height == 0:
        fail("zero scanline or strip size")
    if width > 1 << 20 or height > 1 << 20 or width * height > 1 << 30:
        # OpenCV's validateInputImageSize raises before it allocates
        raise ValueError(f"{path}: TIFF of {width} x {height} (past OpenCV's limits)")
    spp, planar = t.get(277, [1])[0], t.get(284, [1])[0]
    tiled = 322 in t or 323 in t
    if tiled:
        tw, tl = t.get(322, [0])[0], t.get(323, [0])[0]
        depth, td = t.get(32997, [1])[0], t.get(32998, [1])[0]
        n = 0 if 0 in (tw, tl, td) else \
            -(-width // tw) * -(-height // tl) * -(-depth // td)
    else:
        rps = min(t.get(278, [2**32 - 1])[0], height)
        n = 1 if rps == 0 else -(-height // rps)
    if planar == 2:
        n *= spp
    if n == 0 or n >= 2**32:
        fail("no strips or tiles")
    if not ({273, 324} & {e[0] for e in ents}):
        fail("no StripOffsets")
    # second pass
    for e in ents:
        tag, typ = e[0], e[1]
        if id(e) in handled or tag in _CODEC_TAGS and compression not in _CODEC_TAGS[tag]:
            continue
        try:
            if tag in (273, 279, 324, 325):  # TIFFFetchStripThing
                try:
                    vals = ints(e, 2**64 - 1, n)
                except _EntryError as err:
                    fail(f"tag {tag}: {err}")
                if len(vals) < n:
                    if n > 1_000_000:
                        fail(f"tag {tag}: {len(vals)} of {n} strips or tiles")
                    vals += [0] * (n - len(vals))
                t[273 if tag in (273, 324) else 279] = vals
            elif tag in _PER_SAMPLE:
                try:
                    v = per_sample(e)
                except _EntryError as err:
                    fail(f"tag {tag}: {err}")
                if tag == 339 and not 1 <= v <= 6 or tag == 32996 and v > 3:
                    fail(f"tag {tag} value {v}")
                if tag == 32996:
                    tag, v = 339, {0: 4, 1: 2, 2: 1, 3: 3}[v]
                t[tag] = [v]
                if tag == 258:
                    t[-2] = [1]  # BitsPerSample read
            elif tag in (340, 341):  # per-sample doubles
                if e[2] != spp or typ not in _FLOAT_TYPES:
                    fail(f"tag {tag}")
                _values(data, order, big, e)
            elif tag == 320:
                bps = t.get(258, [1])[0]
                if -2 in t and bps <= 24:
                    if e[2] != 3 << bps:
                        raise _EntryError("count")
                    t[320] = ints(e, 0xFFFF)
            elif tag in _SHORTS:
                v = short(e)
                if tag == 266 and v not in (1, 2) or tag == 274 and not 1 <= v <= 8:
                    continue  # TIFFSetField refuses it: the tag is ignored
                t[tag] = [v]
            elif tag in _FLOAT_COUNTS:
                if e[2] != _FLOAT_COUNTS[tag] or typ not in _FLOAT_TYPES:
                    continue
                t[tag] = _values(data, order, big, e)
                t[-tag] = [typ]
            elif tag == 530:  # UINT16_PAIR
                if e[2] == 2:
                    t[530] = ints(e, 0xFFFF)
            elif tag == 347:  # C32_UINT8
                if typ not in _INTEGER_TYPES | {2, 7}:
                    raise _EntryError("type")
                vals = _values(data, order, big, e)
                if any(v < 0 or v > 255 for v in vals):
                    raise _EntryError("range")
                if vals:
                    t[347] = vals
            elif tag in (292, 293):
                if e[2] == 1:
                    t[tag] = ints(e, 0xFFFFFFFF)
        except _EntryError:
            continue  # "...; tag ignored"
    t.pop(-2, None)
    if 273 not in t:
        fail("no StripOffsets")
    colours = _MAX_COLOUR.get(t.get(262, [None])[0], 0)
    extra = t.get(338, [])
    if colours and spp - len(extra) > colours:
        t[338] = extra + [0] * (spp - colours - len(extra))
    t[-1] = [n]
    return t


_WIDTHS = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
           16: 8, 17: 8, 18: 8}


def _ifd_space(data: bytes, order: str, ifd: int, big: bool) -> int:
    """``EstimateStripByteCounts``' bytes taken by the header, the IFD and
    the values stored outside it; a tag of a type libtiff cannot size
    fails the estimate."""
    ents = _entries(data, order, ifd, big)
    inline = 8 if big else 4
    space = (16 + 8 + 20 * len(ents) + 8) if big else (8 + 2 + 12 * len(ents) + 4)
    for _tag, typ, n, _at in ents:
        if typ not in _WIDTHS:
            raise ValueError("TIFF: a tag of unknown type")
        size = _WIDTHS[typ] * n
        space += size if size > inline else 0
    return space


def _lzw(data: bytes, expected: int) -> bytes:
    """TIFF LZW (MSB first, the code width grown one code early), or the
    old-style codes ``LZWDecodeCompat`` reads (LSB first, grown at the
    width's limit), which a strip starting ``00`` and an odd byte uses.
    A corrupt code ends the strip, as in libtiff."""
    compat = len(data) >= 2 and data[0] == 0 and data[1] & 1
    b = np.frombuffer(data + bytes(4), np.uint8).astype(np.int64)
    if compat:
        win = (b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16) | (b[3:] << 24)).tolist()
    else:
        win = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
    nbits_total = len(data) * 8
    base = [bytes([i]) for i in range(256)] + [b"", b""]
    table = list(base)
    out = bytearray()
    pos, width, prev = 0, 9, None
    early = 0 if compat else 1
    while len(out) < expected:
        if pos + width > nbits_total:
            break
        if compat:
            code = (win[pos >> 3] >> (pos & 7)) & ((1 << width) - 1)
        else:
            code = (win[pos >> 3] >> (32 - (pos & 7) - width)) & ((1 << width) - 1)
        pos += width
        if code == 257:
            break
        if code == 256:
            table = list(base)
            width, prev = 9, None
            continue
        if prev is None:
            if code > 255:
                break  # "Corrupted LZW table"
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            break
        out += entry
        prev = entry
        if len(table) >= (1 << width) - early and width < 12:
            width += 1
    return bytes(out[:expected])


def _packbits(data: bytes, expected: int) -> bytes:
    """``PackBitsDecode``: a run or a literal that the data cuts short ends
    the strip; one past the strip is cut to it."""
    out = bytearray()
    pos, n = 0, len(data)
    while pos < n and len(out) < expected:
        c = data[pos]
        pos += 1
        if c > 128:  # a run of 257 - c
            if pos >= n:
                break
            out += bytes([data[pos]]) * min(257 - c, expected - len(out))
            pos += 1
        elif c < 128:  # c + 1 literal bytes
            count = min(c + 1, expected - len(out))
            if n - pos < count:
                break
            out += data[pos : pos + count]
            pos += count
    return bytes(out)


def _inflate(raw: bytes, expected: int) -> bytes:
    """``ZIPDecode``: what inflate writes before the stream ends or breaks."""
    try:
        return zlib.decompressobj().decompress(raw, expected)
    except zlib.error:
        stream, out = zlib.decompressobj(), bytearray()
        for k in range(len(raw)):  # a byte at a time, up to the broken one
            try:
                out += stream.decompress(raw[k : k + 1], expected - len(out))
            except zlib.error:
                break
        return bytes(out)


class _Image:
    def __init__(self, data: bytes, path: str):
        self.path = path
        head = data[:4]
        order = {b"II": "<", b"MM": ">"}.get(head[:2])
        big = head in (b"II+\x00", b"MM\x00+")
        if order is None or not (big or head in (b"II*\x00", b"MM\x00*")):
            raise ValueError(f"{path}: not a TIFF file")
        if big:
            size, zero, ifd = struct.unpack_from(order + "HHQ", data, 4)
            if size != 8 or zero != 0:
                raise ValueError(f"{path}: BigTIFF header")
        else:
            (ifd,) = struct.unpack_from(order + "I", data, 4)
        self.data, self.order = data, order
        t = _directory(data, order, ifd, big, path)
        self.tags = t
        self._ifd, self._big = ifd, big
        self.width, self.height = t[256][0], t[257][0]
        self.tiled = 322 in t or 323 in t
        self._fax = None
        self.spp = t.get(277, [1])[0]
        self.bps = t.get(258, [1])[0]
        self.compression = t.get(259, [1])[0]
        if 262 not in t:
            raise ValueError(f"{path}: TIFF without a photometric interpretation")
        self.photometric = t[262][0]
        if self.photometric == 3 and 320 not in t and self.bps >= 8:
            # TIFFReadDirectory: a palette image without its map at 8 bits
            # or more is read as grey (with three samples as RGB, but it has
            # made two of them extra samples by then: refused)
            if self.spp == 3:
                raise ValueError(f"{path}: palette TIFF of 3 samples without its colour map")
            self.photometric = 1
        self.planar = t.get(284, [1])[0]
        self.predictor = t.get(317, [1])[0]
        self.fill_order = t.get(266, [1])[0]
        self.orientation = t.get(274, [1])[0]
        self.extra = t.get(338, [])
        self.t4 = t.get(292, [0])[0]
        self.subsampling = tuple(t.get(530, [2, 2])[:2])
        self._jpeg_subsampling = None
        if self.photometric != 6 or self.compression == 7 or self.planar == 2:
            self.subsampling = (1, 1)  # only raw contiguous YCbCr data is packed in blocks
        self._check()

    def _check(self) -> None:
        path, t, ph = self.path, self.tags, self.photometric
        if self.compression in _REFUSED_COMPRESSION:
            raise ValueError(f"{path}: TIFF {_REFUSED_COMPRESSION[self.compression]} "
                             "compression (OpenCV 5.0 reads none)")
        formats = t.get(339, [1])
        if formats[0] not in (1, 2):
            raise ValueError(f"{path}: TIFF sample format {formats} (OpenCV takes unsigned "
                             "and signed integers)")
        if ph in _REFUSED_PHOTOMETRIC:
            raise ValueError(f"{path}: TIFF {_REFUSED_PHOTOMETRIC[ph]} photometric "
                             "interpretation (libtiff's RGBA interface refuses it)")
        if self.bps not in (1, 2, 4, 8, 16):
            raise ValueError(f"{path}: TIFF {self.bps}-bit samples (libtiff's RGBA "
                             "interface refuses them)")
        if self.spp > 4 or self.spp < 1:
            raise ValueError(f"{path}: TIFF with {self.spp} samples a pixel")
        c = self.compression
        if c in (5, 8, 32946) and self.predictor != 1 and not (
                self.predictor == 2 and self.bps in (8, 16)):
            # PredictorSetup fails: "not supported" (the decoder never starts)
            raise ValueError(f"{path}: TIFF predictor {self.predictor} at {self.bps} bits")
        if c in (2, 3, 4) and (self.bps != 1 or self.spp != 1):
            raise ValueError(f"{path}: CCITT TIFF that is not bilevel")
        if c == 32809 and self.bps != 4:
            raise ValueError(f"{path}: ThunderScan TIFF at {self.bps} bits")
        if c in (34676, 34677) and ph not in (32844, 32845):
            raise ValueError(f"{path}: SGILog TIFF that is not LogL or LogLuv")
        if ph in (0, 1, 3):
            if self.planar == 1 and self.spp > 1 and self.bps < 8 and ph != 3:
                # tif_getimage: "can not handle contiguous data with ... BitsPerSample < 8"
                raise ValueError(f"{path}: contiguous TIFF with {self.spp} samples of "
                                 f"{self.bps} bits")
            if ph == 3 and (self.bps > 8 or 320 not in t):
                raise ValueError(f"{path}: palette TIFF at {self.bps} bits")
        elif ph == 2:
            if self.spp - len(self.extra) < 3 or self.bps not in (8, 16):
                raise ValueError(f"{path}: RGB TIFF of {self.spp} samples at {self.bps} bits")
        elif ph == 5:
            if t.get(332, [1])[0] != 1 or self.bps != 8 or self.spp != 4:
                raise ValueError(f"{path}: CMYK TIFF of {self.spp} samples at {self.bps} bits "
                                 "or of another ink set (libtiff reads 8-bit CMYK)")
        elif ph == 6:
            if self.bps != 8 or self.spp != 3:
                raise ValueError(f"{path}: YCbCr TIFF of {self.spp} samples at {self.bps} "
                                 "bits (libtiff reads 8-bit YCbCr)")
            sub = tuple(t.get(530, [2, 2])[:2])
            if (self.planar == 2 and sub != (1, 1)) or sub not in _YCBCR_SUBSAMPLING:
                raise ValueError(f"{path}: YCbCr TIFF subsampled {sub} in planar "
                                 f"configuration {self.planar}")
        elif ph == 8:
            if self.spp != 3 or len(self.extra) or self.bps not in (8, 16) or self.planar != 1:
                raise ValueError(f"{path}: CIE Lab TIFF of {self.spp} samples at {self.bps} "
                                 "bits, or planar")
        elif ph == 32844:
            if c != 34676 or self.spp != 1:
                raise ValueError(f"{path}: LogL TIFF without SGILog compression")
        elif ph == 32845:
            if c not in (34676, 34677) or self.planar != 1 or self.spp != 3:
                raise ValueError(f"{path}: LogLuv TIFF without SGILog compression")
        else:
            raise ValueError(f"{path}: TIFF photometric interpretation {ph}")

    # -- chunks ------------------------------------------------------------
    def _depth(self) -> int:
        """Bits of a sample as the chunk buffer holds it (SGILog is read as
        8-bit data)."""
        return 8 if self.compression in (34676, 34677) else self.bps

    def _chunk_size(self, rows: int, width: int, spp: int) -> int:
        """Bytes of a strip or tile of ``rows`` rows: YCbCr subsampled data in
        blocks of hs x vs luma samples and two chroma ones, other data in
        rows of ``width * spp`` samples."""
        hs, vs = self.subsampling
        if (hs, vs) != (1, 1):
            return -(-rows // vs) * -(-width // hs) * (hs * vs + 2)
        return ((width * spp * self._depth() + 7) // 8) * rows

    def _decompress(self, raw: bytes, rows: int, width: int, spp: int, buf: bytearray,
                    last: bool = True, offset: int = 0) -> None:
        """One strip or tile (at ``offset`` in the file) into ``buf``; raises
        ``_Failed`` where libtiff's decoder fails and the RGBA interface
        carries on."""
        if self.fill_order == 2:
            raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
        expected = self._chunk_size(rows, width, spp)
        c = self.compression
        if c not in _LIBTIFF_CODECS:
            raise _Failed  # libtiff's default codec: "Decoding of ... is not implemented"
        if c in (2, 3, 4, 32771):
            if self._fax is None:  # libtiff keeps its run arrays from strip to strip
                self._fax = ccitt.FaxState(width, c == 4 or (c == 3 and self.t4 & 1))
            bits, ok = ccitt.decode_strip(raw, width, rows, c, self.t4, self._fax, offset & 1)
            buf[:expected] = np.packbits(bits, axis=1).tobytes()
            if not ok:
                raise _Failed
            return
        if c == 32809:
            if not tiff_codecs.thunderscan(raw, rows, width, buf):
                raise _Failed
            return
        if c in (34676, 34677):
            kind = "L" if self.photometric == 32844 else ("Luv24" if c == 34677 else "Luv32")
            if not tiff_codecs.sgilog(raw, rows, width, buf, kind):
                raise _Failed
            return
        if c == 7:
            buf[:expected] = self._jpeg(raw, rows, width, spp, last)
            return
        if c == 1:  # DumpModeDecode copies nothing from a short strip
            out = raw if len(raw) >= expected else b""
        elif c == 5:
            out = _lzw(raw, expected)
        elif c in (8, 32946):
            out = _inflate(raw, expected)
        else:
            out = _packbits(raw, expected)
        buf[: min(len(out), expected)] = out[:expected]
        if len(out) < expected:
            raise _Failed  # "Not enough data": the rest stays zero

    def _jpeg(self, raw: bytes, rows: int, width: int, spp: int, last: bool) -> bytes:
        """``JPEGPreDecode`` and ``JPEGDecode``: the stream's header must
        match the strip or tile (its width, its height or, in the last strip,
        more; the components; 8 bits; the YCbCr subsampling on its first
        component and 1x1 on the others).  Without a ``YCbCrSubSampling`` tag
        libtiff takes the first strip's own factors (``JPEGFixupTags``).  A
        refused strip fails the read (None)."""
        ycc = self.photometric == 6 and self.planar == 1
        stream = jpeg.InTiff(raw, _bytes_of(self.tags.get(347)), "ycc" if ycc else "raw",
                             self.path)
        jw, jh, factors = stream.frame()
        want = (1, 1)
        if ycc:
            if 530 not in self.tags and self._jpeg_subsampling is None:
                self._jpeg_subsampling = factors[0]
            want = self._jpeg_subsampling or tuple(self.tags[530][:2])
        taller_last = jw == width and jh > rows and last
        if (jw > width or jh > rows) and not taller_last or len(factors) != spp \
                or factors[0] != want or any(f != (1, 1) for f in factors[1:]):
            raise ValueError(f"{self.path}: JPEG strip of {jw} x {jh} and factors {factors} "
                             f"for a {width} x {rows} strip of {spp} samples, subsampled {want}")
        # a smaller stream (only a warning in libtiff) fills the rows and
        # columns it has; the rest of the zeroed buffer stays zero
        out = np.zeros((rows, width, spp), np.uint8)
        got = stream.samples()[:rows]
        out[: got.shape[0], : got.shape[1]] = got
        return out.tobytes()

    def _unpack(self, data: bytes, rows: int, width: int, spp: int,
                decoded: bool = True) -> np.ndarray:
        """A chunk's bytes -> samples (rows, width, spp) (uint8 or uint16);
        the predictor undone only where the decoder succeeded, as libtiff's
        ``PredictorDecodeTile`` skips it after a failure."""
        hs, vs = self.subsampling
        if (hs, vs) != (1, 1):  # blocks of hs x vs Y, then Cb, Cr
            across = -(-width // hs)
            blocks = np.frombuffer(data, np.uint8).reshape(-1, across, hs * vs + 2)
            y = blocks[..., : hs * vs].reshape(-1, across, vs, hs).transpose(0, 2, 1, 3)
            y = y.reshape(-1, across * hs)[:rows, :width]
            chroma = np.repeat(np.repeat(blocks[..., hs * vs :], vs, axis=0), hs, axis=1)
            return np.concatenate([y[..., None], chroma[:rows, :width]], axis=2)
        bps = self._depth()
        stride = (width * spp * bps + 7) // 8
        rowdata = np.frombuffer(data, np.uint8).reshape(rows, stride)
        if bps == 16:
            samples = rowdata.view(self.order + "u2").reshape(rows, width, spp).astype(np.uint16)
        elif bps == 8:
            samples = rowdata.reshape(rows, width, spp)
        else:
            shifts = np.arange(8 - bps, -1, -bps, dtype=np.uint8)
            vals = (rowdata[:, :, None] >> shifts) & ((1 << bps) - 1)
            samples = vals.reshape(rows, -1)[:, : width * spp].reshape(rows, width, spp)
        if self.predictor == 2 and bps in (8, 16) and decoded:
            mod = np.uint16 if bps == 16 else np.uint8
            samples = np.cumsum(samples.astype(np.int64), axis=1).astype(mod)
        return samples

    def samples(self) -> np.ndarray:
        """All samples of the page, (H, W, spp)."""
        t, h, w = self.tags, self.height, self.width
        planes = self.spp if self.planar == 2 else 1
        per = 1 if self.planar == 2 else self.spp
        dtype = np.uint16 if self._depth() == 16 else np.uint8
        out = np.zeros((h, w, self.spp), dtype)
        tiled = self.tiled
        if tiled:
            cw, ch = t[322][0], t[323][0]
            across, down = -(-w // cw), -(-h // ch)
        else:
            cw, ch = w, min(t.get(278, [h])[0], h)
            across, down = 1, -(-h // ch)
        offsets = t[273]
        chunks = across * down * planes
        counts = t.get(279)
        if counts is None:  # libtiff estimates them for one strip or tile (a plane)
            if chunks != (self.spp if self.planar == 2 else 1):
                raise ValueError(f"{self.path}: TIFF without its byte counts")
            counts = self._estimate_counts(offsets, chunks, cw, ch, per)
        elif self._counts_look_bad(offsets, counts, chunks, cw):
            counts = self._estimate_counts(offsets, chunks, cw, ch, per)
        if len(offsets) < across * down * planes or len(counts) < len(offsets):
            raise ValueError(f"{self.path}: TIFF with missing {'tiles' if tiled else 'strips'}")
        # OpenCV's RGBA buffer for one strip or tile (its RowsPerStrip as
        # written, 2**32 - 1 meaning the image) must stay under 1 GiB
        rps = t.get(278, [h])[0]
        tall = ch if tiled else (h if rps == 2**32 - 1 else rps)
        if tall * cw * 4 >= 1 << 30:
            raise ValueError(f"{self.path}: TIFF strip or tile buffer of 1 GiB or more")
        k = 0
        hs, vs = self.subsampling
        for p in range(planes):
            for ty in range(down):
                for tx in range(across):
                    y0, x0 = ty * ch, tx * cw
                    rows = ch if tiled else min(ch, h - y0)
                    # OpenCV reads each strip or tile with a TIFFReadRGBA call of
                    # its own, whose buffer starts zeroed
                    size = self._chunk_size(rows, cw, per)
                    buf = bytearray(size)
                    decoded = True
                    try:
                        self._decompress(self._chunk(offsets[k], counts[k]), rows, cw, per,
                                         buf, not tiled and ty == down - 1, offsets[k])
                    except _Failed:
                        decoded = False
                    k += 1
                    if not tiled and (hs, vs) != (1, 1):
                        # gtStripContig asks for whole block rows of TIFFScanlineSize
                        # bytes, a block row's size divided by vs and truncated
                        line = (-(-cw // hs) * (hs * vs + 2)) // vs
                        limit = -(-rows // vs) * vs * line
                        buf[limit:] = bytes(len(buf) - limit)
                    hh, ww = min(ch, h - y0), min(cw, w - x0)
                    if tiled and (hs, vs) == (4, 4) and ww < cw:
                        buf = _skewed_44(buf, ww, cw)
                    chunk = self._unpack(bytes(buf), rows, cw, per, decoded)
                    out[y0 : y0 + hh, x0 : x0 + ww, p : p + per] = chunk[:hh, :ww]
        return out

    def _counts_look_bad(self, offsets: List[int], counts: List[int], chunks: int,
                         width: int) -> bool:
        """``TIFFReadDirectory``'s doubts about StripByteCounts, after which it
        estimates them (``ByteCountLooksBad``): one strip at a nonzero offset
        of no bytes, or uncompressed past the end of the file or shorter than
        the image; or three or more uncompressed contiguous strips or tiles
        whose first two counts differ."""
        raw = self.compression == 1
        if chunks == 1:
            if self.tiled or offsets[0] == 0:
                return False
            n = len(self.data)
            return counts[0] == 0 or raw and (
                offsets[0] <= n and counts[0] > n - offsets[0]
                or counts[0] < self._chunk_size(self.height, width, self.spp))
        return raw and self.planar == 1 and chunks > 2 and counts[0] != counts[1] \
            and counts[0] != 0 and counts[1] != 0


    def _estimate_counts(self, offsets: List[int], chunks: int, width: int, rows: int,
                         spp: int) -> List[int]:
        """``EstimateStripByteCounts``: compressed, the file past its header,
        IFD and tag values (a plane's share), the last cut at the end of the
        file; uncompressed, a tile's bytes or the rows' of ImageLength over
        the strips of a plane."""
        n = len(self.data)
        if self.compression != 1:
            space = _ifd_space(self.data, self.order, self._ifd, self._big)
            space = n - space if n >= space else n
            if self.planar == 2:
                space //= self.spp
            counts = [space] * chunks
            last = offsets[chunks - 1]
            if last + counts[-1] > n:
                counts[-1] = n - last if last < n else 0
            return counts
        if self.tiled:
            return [self._chunk_size(rows, width, spp)] * chunks
        per_plane = chunks // (self.spp if self.planar == 2 else 1)
        return [self._chunk_size(self.height // per_plane, width, spp)] * chunks

    def _chunk(self, offset: int, count: int) -> bytes:
        if not count or offset + count > len(self.data):  # TIFFFillStrip fails: None
            raise ValueError(f"{self.path}: TIFF strip or tile empty or past the end of the file")
        return self.data[offset : offset + count]

    # -- libtiff's RGBA maps -----------------------------------------------
    def rgb(self) -> np.ndarray:
        s = self.samples()
        bps, ph = self._depth(), self.photometric
        if ph in (0, 1, 32844):
            v = s[..., 0].astype(np.int64)
            if bps == 16:
                v = v >> 8
                top = 255
            else:
                top = (1 << bps) - 1
            grey = (v * 255) // top if ph != 0 else ((top - v) * 255) // top
            return np.repeat(grey.astype(np.uint8)[..., None], 3, axis=2)
        if ph == 3:
            cmap = np.asarray(self.tags[320], np.int64).reshape(3, -1)
            if (cmap >= 256).any():
                cmap = cmap >> 8
            return cmap[:, s[..., 0].astype(np.int64)].transpose(1, 2, 0).astype(np.uint8)
        if ph == 5:
            return tiff_colour.cmyk_to_rgb(*(s[..., k] for k in range(4)))
        if ph == 6 and not (self.compression == 7 and self.planar == 1):
            luma = self._floats(529, [0.299, 0.587, 0.114])
            ref = self._floats(532, [0, 255, 128, 255, 128, 255])
            if luma[1] == 0 or not all(v < np.float32(2**31) for v in ref):
                # initYCbCrConversion: "Invalid values for YCbCrCoefficients
                # tag", "... ReferenceBlackWhite tag"
                raise ValueError(f"{self.path}: TIFF YCbCr coefficients {luma} or reference "
                                 f"{ref} libtiff refuses")
            return tiff_colour.ycbcr_to_rgb(s, luma, ref)
        if ph == 8:
            d50 = sum(_D50[1:], _D50[0])
            white = self._floats(318, [_D50[0] / d50, _D50[1] / d50])
            if white[1] == 0:
                raise ValueError(f"{self.path}: TIFF white point of zero luminance")
            return tiff_colour.cielab_to_rgb(s, bps, white)
        rgb = s[..., :3].astype(np.int64)
        if bps == 16:
            rgb = (rgb + 128) // 257
        if self.spp == 4 and self.extra[:1] == [2]:
            alpha = s[..., 3:4].astype(np.int64)
            if bps == 16:
                alpha = (alpha + 128) // 257
            rgb = (rgb * alpha + 127) // 255
        return rgb.astype(np.uint8)

    def _floats(self, tag: int, default: List[float]) -> List[np.float32]:
        """A C0_FLOAT tag as ``TIFFReadDirEntryFloatArray`` reads it (a
        rational of denominator 0 as 0), or its default."""
        vals = self.tags.get(tag)
        if vals is None:
            return [np.float32(v) for v in default]
        if self.tags[-tag][0] in (5, 10):
            return [np.float32(n) / np.float32(d) if d else np.float32(0) for n, d in vals]
        return [np.float32(v) for v in vals]


def _skewed_44(buf: bytearray, visible: int, width: int) -> bytearray:
    """A 4x4-subsampled YCbCr tile as ``putcontig8bitYCbCr44tile`` walks an
    edge tile ``visible`` samples wide: after each block row it skips the
    hidden blocks at 10 bytes a block, not 18 (libtiff's ``4 * 2 + 2``).
    Returns the blocks each row reads, at their places in a tile buffer."""
    used, per_row = -(-visible // 4), width // 4
    skip = ((width - visible) // 4) * 10
    out = bytearray(len(buf))
    for r in range(len(buf) // (per_row * 18)):
        start = r * (used * 18 + skip)
        row = buf[start : start + used * 18]
        out[r * per_row * 18 : r * per_row * 18 + len(row)] = row
    return out


def _bytes_of(values: Optional[List[int]]) -> Optional[bytes]:
    return None if values is None else bytes(v & 0xFF for v in values)


def decode_tiff(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """RGB uint8 (H, W, 3) of the first page of a TIFF file's bytes, as
    OpenCV reads it (module doc)."""
    img = _Image(data, path)
    orientation = img.orientation if 1 <= img.orientation <= 8 else 1
    return apply_orientation(img.rgb(), orientation)
