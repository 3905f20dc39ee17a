"""Hand encoders for the image-reader tests: files that ``cv2.imwrite`` and
PIL do not write, read back by ``cv2.imread`` as the reference.

* :func:`encode_tiff`: a TIFF or BigTIFF from raw or already-compressed
  strips or tiles and any tags (both byte orders, a second page on
  request);
* :func:`encode_jpeg`: a baseline JPEG from component planes at any
  sampling factors (1-4), with any component ids, an Adobe APP14 marker
  and restart markers; fixed-length Huffman codes, so no table needs
  building;
* :func:`exif_block`, :func:`with_jpeg_exif`, :func:`with_png_exif`: an
  EXIF orientation in either byte order, put into a JPEG or a PNG;
* :func:`encode_bmp`, :func:`rle8`, :func:`rle4`: a BMP at any depth under
  any header (OS/2 12 bytes, 40, v4 108, v5 124), bottom-up or top-down,
  with bit fields, short palettes, and RLE8 / RLE4 streams with deltas;
* :func:`encode_sunras`, :func:`sun_rle`: a Sun raster of any type and
  depth, with or without a colour map, run-length encoded on request;
* :func:`encode_gif`, :func:`gif_lzw`: a GIF87a/89a of one or more frames,
  each with its own table, offset, interlace and transparent index;
* :func:`encode_vp8` (with :class:`BoolEncoder`): a VP8 key frame from given
  modes and quantized coefficients, under any filter, segmentation,
  partition count, quantizer deltas, probability updates and skip
  probability;
* :func:`encode_vp8l`, :func:`vp8l_stream`: a VP8L image from ARGB pixels
  with chosen transforms, colour cache, meta prefix codes, code forms and
  copy distances, its code lengths written out; :func:`alph_chunk`: an
  ``ALPH`` payload, filtered, raw or lossless;
* :func:`encode_webp`, :func:`webp_chunk`, :func:`vp8x`: a RIFF/WEBP file of
  any chunks.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 16: "Q", 17: "q", 18: "Q"}


def encode_tiff(chunks: Sequence[bytes], width: int, height: int,
                tags: Dict[int, Tuple[int, list]], order: str = "<",
                second_page: Optional[Dict[int, Tuple[int, list]]] = None,
                big: bool = False, offset_type: Optional[int] = None) -> bytes:
    """A TIFF whose strips (or tiles, when ``tags`` has 322) are ``chunks``;
    the size and the chunks' offsets and counts are filled in.  A
    ``second_page`` is an IFD of its own tags, pointing at the same chunks.
    ``big`` writes a BigTIFF (8-byte offsets, counts and IFD entries), whose
    chunk offsets and counts are ``LONG8`` unless ``offset_type`` says."""
    word = "Q" if big else "I"
    inline = 8 if big else 4
    if offset_type is None:
        offset_type = 16 if big else 4
    if big:
        out = bytearray((b"II+\x00" if order == "<" else b"MM\x00+")
                        + struct.pack(order + "HH", 8, 0) + bytes(8))
    else:
        out = bytearray((b"II*\x00" if order == "<" else b"MM\x00*") + bytes(4))
    offsets = []
    for c in chunks:
        out += b"\x00" * (len(out) % 2)
        offsets.append(len(out))
        out += c
    out += b"\x00" * (len(out) % 2)

    def ifd(tags, base, next_ifd):
        tags = dict(tags)
        tiled = 322 in tags
        tags[256], tags[257] = (4, [width]), (4, [height])
        tags[324 if tiled else 273] = (offset_type, offsets)
        tags[325 if tiled else 279] = (offset_type, [len(c) for c in chunks])
        entries = sorted(tags.items())
        size = (8 + 20 * len(entries) + 8) if big else (2 + 12 * len(entries) + 4)
        head = bytearray(struct.pack(order + ("Q" if big else "H"), len(entries)))
        extra = bytearray()
        for tag, (typ, vals) in entries:
            if typ == 2:
                raw = bytes(vals)
            elif typ == 5:
                raw = b"".join(struct.pack(order + "II", *v) for v in vals)
            else:
                raw = struct.pack(order + _TYPES[typ] * len(vals), *vals)
            n = len(raw) if typ == 2 else len(vals)
            if len(raw) <= inline:
                head += struct.pack(order + "HH" + word, tag, typ, n) + raw.ljust(inline, b"\x00")
            else:
                head += struct.pack(order + "HH" + word + word, tag, typ, n,
                                    base + size + len(extra))
                extra += raw + b"\x00" * (len(raw) % 2)
        head += struct.pack(order + word, next_ifd)
        return bytes(head + extra)

    first = len(out)
    struct.pack_into(order + word, out, 8 if big else 4, first)
    page = ifd(tags, first, 0)
    if second_page is not None:
        page = ifd(tags, first, first + len(page))
        page += ifd(second_page, first + len(page), 0)
    return bytes(out + page)


def pack_bits(samples: np.ndarray, bps: int) -> np.ndarray:
    """(rows, n) samples of ``bps`` bits -> (rows, stride) bytes, MSB first."""
    rows, n = samples.shape
    if bps == 8:
        return samples.astype(np.uint8)
    per = 8 // bps
    pad = (-n) % per
    flat = np.concatenate([samples, np.zeros((rows, pad), samples.dtype)], axis=1)
    shifts = np.arange(8 - bps, -1, -bps)
    return (flat.reshape(rows, -1, per).astype(np.int64) << shifts).sum(axis=2).astype(np.uint8)


def exif_block(orientation: int, order: str = ">") -> bytes:
    """A TIFF-structured EXIF block whose IFD0 holds the orientation."""
    head = (b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(order + "I", 8)
    entry = struct.pack(order + "HHIH", 0x0112, 3, 1, orientation) + b"\x00\x00"
    return head + struct.pack(order + "H", 1) + entry + struct.pack(order + "I", 0)


def with_jpeg_exif(jpeg: bytes, orientation: int, order: str = ">") -> bytes:
    body = b"Exif\x00\x00" + exif_block(orientation, order)
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + jpeg[2:]


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def with_png_exif(png: bytes, orientation: int, order: str = "<") -> bytes:
    """The PNG with an ``eXIf`` chunk after its IHDR."""
    return png[:33] + _png_chunk(b"eXIf", exif_block(orientation, order)) + png[33:]


# -- a baseline JPEG encoder ------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_DCT = np.array([[np.sqrt((1 if k == 0 else 2) / 8) * np.cos((2 * n + 1) * k * np.pi / 16)
                  for n in range(8)] for k in range(8)])
# fixed-length codes: DC categories 0-11 in 4 bits, AC run/size symbols in 8
_DC_SYMBOLS = list(range(12))
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


class _BitWriter:
    def __init__(self):
        self.bits: List[str] = []

    def put(self, value: int, n: int) -> None:
        if n:
            self.bits.append(format(value & ((1 << n) - 1), f"0{n}b"))

    def flush(self) -> bytes:
        s = "".join(self.bits)
        s += "1" * ((-len(s)) % 8)
        data = int(s, 2).to_bytes(len(s) // 8, "big") if s else b""
        self.bits = []
        return data.replace(b"\xff", b"\xff\x00")


def _category(v: int) -> Tuple[int, int]:
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def encode_jpeg(planes: Sequence[np.ndarray], factors: Sequence[Tuple[int, int]],
                ids: Optional[Sequence[int]] = None, quality_step: int = 4,
                adobe: Optional[int] = None, jfif: bool = False, restart: int = 0) -> bytes:
    """A baseline JPEG of component planes (full image size each; a plane is
    subsampled by its factors against the largest) with one flat
    quantisation table."""
    h, w = planes[0].shape
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    ids = list(ids) if ids is not None else list(range(1, len(planes) + 1))
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    comps = []
    for plane, (fh, fv) in zip(planes, factors):
        cw, ch = -(-w * fh // hmax), -(-h * fv // vmax)
        ys = (np.arange(ch) * vmax // fv).clip(0, h - 1)
        xs = (np.arange(cw) * hmax // fh).clip(0, w - 1)
        sub = plane.astype(np.float64)[ys][:, xs]
        full = np.pad(sub, ((0, mcuy * fv * 8 - ch), (0, mcux * fh * 8 - cw)), mode="edge")
        blocks = full.reshape(mcuy * fv, 8, mcux * fh, 8).transpose(0, 2, 1, 3) - 128
        coef = np.einsum("ij,abjk,lk->abil", _DCT, blocks, _DCT)
        comps.append(np.rint(coef / quality_step).astype(np.int64).reshape(
            mcuy * fv, mcux * fh, 64)[:, :, _ZIGZAG])
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    out += _segment(0xDB, bytes([0]) + bytes([quality_step]) * 64)
    sof = struct.pack(">BHHB", 8, h, w, len(planes))
    for cid, (fh, fv) in zip(ids, factors):
        sof += bytes([cid, (fh << 4) | fv, 0])
    out += _segment(0xC0, sof)
    out += _segment(0xC4, bytes([0x00]) + bytes([0, 0, 0, 12] + [0] * 12) + bytes(_DC_SYMBOLS))
    ac_counts = [0] * 16
    ac_counts[7] = len(_AC_SYMBOLS)
    out += _segment(0xC4, bytes([0x10]) + bytes(ac_counts) + bytes(_AC_SYMBOLS))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    sos = bytes([len(planes)]) + b"".join(bytes([cid, 0x00]) for cid in ids) + bytes([0, 63, 0])
    out += _segment(0xDA, sos)
    dc_code = {s: i for i, s in enumerate(_DC_SYMBOLS)}
    ac_code = {s: i for i, s in enumerate(_AC_SYMBOLS)}
    writer = _BitWriter()
    pred = [0] * len(planes)
    mcu = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and mcu and mcu % restart == 0:
                out += writer.flush() + bytes([0xFF, 0xD0 + (mcu // restart - 1) % 8])
                pred = [0] * len(planes)
            mcu += 1
            for k, (comp, (fh, fv)) in enumerate(zip(comps, factors)):
                for v in range(fv):
                    for hh in range(fh):
                        blk = comp[my * fv + v, mx * fh + hh].tolist()
                        s, bits = _category(blk[0] - pred[k])
                        pred[k] = blk[0]
                        writer.put(dc_code[s], 4)
                        writer.put(bits, s)
                        run = 0
                        for c in blk[1:]:
                            if c == 0:
                                run += 1
                                continue
                            while run > 15:
                                writer.put(ac_code[0xF0], 8)
                                run -= 16
                            s, bits = _category(c)
                            writer.put(ac_code[(run << 4) | s], 8)
                            writer.put(bits, s)
                            run = 0
                        if run:
                            writer.put(ac_code[0x00], 8)
    out += writer.flush() + b"\xff\xd9"
    return bytes(out)


# -- BMP --------------------------------------------------------------------------


def encode_bmp(pixels: np.ndarray, bpp: int, palette: Optional[np.ndarray] = None,
               header: int = 40, compression: int = 0, top_down: bool = False,
               masks: Optional[Sequence[int]] = None, used: Optional[int] = None,
               raw: Optional[bytes] = None, masks_after: bool = True) -> bytes:
    """A BMP of ``pixels``: indices (H, W) at 1, 4 and 8 bits, packed 16-bit
    values (H, W) at 16, BGR(A) (H, W, 3 or 4) at 24 and 32.  ``palette`` is
    (n, 3) RGB; ``raw`` replaces the pixel data (an RLE stream, in the order
    the rows are stored); ``masks`` (red, green, blue[, alpha]) go after a
    40-byte header (``masks_after``) or into a v4/v5 header."""
    h, w = pixels.shape[:2]
    if raw is None:
        stored = pixels[::-1] if not top_down else pixels
        if bpp <= 8:
            rows = pack_bits(stored.astype(np.int64), bpp)
        elif bpp == 16:
            rows = stored.astype("<u2").view(np.uint8).reshape(h, -1)
        else:
            rows = stored.astype(np.uint8).reshape(h, -1)
        pitch = (rows.shape[1] + 3) & -4
        raw = np.pad(rows, ((0, 0), (0, pitch - rows.shape[1]))).tobytes()
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)
        pal = p.tobytes()
    mask_bytes = b"".join(struct.pack("<I", m) for m in (masks or ()))
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, -h if top_down else h, 1, bpp)
    else:
        n_used = used if used is not None else (len(palette) if palette is not None else 0)
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bpp,
                           compression, len(raw), 2835, 2835, n_used, 0)
        if header > 40:
            inner = (mask_bytes if not masks_after else b"").ljust(16, b"\x00")
            info += inner.ljust(header - 40, b"\x00")
        if masks_after:
            pal = mask_bytes + pal
    offset = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(raw), 0, 0, offset) + info + pal + raw


def _rle_runs(row: np.ndarray, four: bool) -> bytes:
    """One row of indices as encoded runs of equal values and absolute runs
    of unequal ones (RLE4 runs alternate two indices)."""
    out = bytearray()
    n, i = len(row), 0
    while i < n:
        j = i + 1
        while j < n and j - i < 255 and row[j] == row[i]:
            j += 1
        if j - i >= 3 or n - i < 3:
            v = int(row[i])
            out += bytes([j - i, (v << 4) | v if four else v])
            i = j
            continue
        j = i
        while j < n and j - i < 255 and not (j + 2 < n and row[j] == row[j + 1] == row[j + 2]):
            j += 1
        count = j - i
        if count < 3:
            v = int(row[i])
            out += bytes([1, (v << 4) | v if four else v])
            i += 1
            continue
        vals = [int(v) for v in row[i:j]]
        if four:
            vals += [0] * (count % 2)
            data = bytes((a << 4) | b for a, b in zip(vals[::2], vals[1::2]))
        else:
            data = bytes(vals)
        data += b"\x00" * (len(data) % 2)
        out += bytes([0, count]) + data
        i = j
    return bytes(out)


def rle8(indices: np.ndarray, top_down: bool = False, eob: bool = True) -> bytes:
    """An RLE8 stream of (H, W) indices, each row closed by an end of line."""
    rows = indices if top_down else indices[::-1]
    out = b"".join(_rle_runs(r, False) + b"\x00\x00" for r in rows)
    return out + (b"\x00\x01" if eob else b"")


def rle4(indices: np.ndarray, top_down: bool = False, eob: bool = True) -> bytes:
    rows = indices if top_down else indices[::-1]
    out = b"".join(_rle_runs(r, True) + b"\x00\x00" for r in rows)
    return out + (b"\x00\x01" if eob else b"")


# -- Sun raster -------------------------------------------------------------------


def sun_rle(raw: bytes) -> bytes:
    """Sun's byte RLE: runs of 3 or more (and any 0x80) as ``0x80 n v``."""
    out = bytearray()
    i, n = 0, len(raw)
    while i < n:
        j = i + 1
        while j < n and j - i < 256 and raw[j] == raw[i]:
            j += 1
        run = j - i
        if run >= 3 or raw[i] == 0x80:
            if run == 1:
                out += b"\x80\x00"
            else:
                out += bytes([0x80, run - 1, raw[i]])
            i = j
        else:
            out += raw[i:j]
            i = j
    return bytes(out)


def encode_sunras(pixels: np.ndarray, bpp: int, kind: int = 1,
                  cmap: Optional[np.ndarray] = None, maptype: Optional[int] = None,
                  raw: Optional[bytes] = None) -> bytes:
    """A Sun raster of ``pixels``: bits or indices (H, W) at 1 and 8 bits,
    byte triples or quads (H, W, 3 or 4) in file order at 24 and 32.
    ``cmap`` is (n, 3) RGB; ``kind`` 2 run-length encodes; ``raw``
    replaces the (encoded) pixel data."""
    h, w = pixels.shape[:2]
    if raw is None:
        if bpp <= 8:
            rows = pack_bits(pixels.astype(np.int64), bpp)
        else:
            rows = pixels.astype(np.uint8).reshape(h, -1)
        pitch = (rows.shape[1] + 1) & -2
        raw = np.pad(rows, ((0, 0), (0, pitch - rows.shape[1]))).tobytes()
        if kind == 2:
            raw = sun_rle(raw)
    maps = b"" if cmap is None else np.asarray(cmap, np.uint8).T.tobytes()
    if maptype is None:
        maptype = 0 if cmap is None else 1
    head = struct.pack(">8I", 0x59A66A95, w, h, bpp, len(raw), kind, maptype, len(maps))
    return head + maps + raw


# -- GIF --------------------------------------------------------------------------


def gif_lzw(indices: Sequence[int], min_size: int) -> bytes:
    """GIF LZW (LSB first) of ``indices``, as sub-blocks ending in a 0 block;
    a clear code first and whenever the table is full."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    width, table = min_size + 1, {}
    acc = nbits = 0
    out = bytearray()

    def put(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    put(clear)
    nxt = eoi + 1
    prefix = None
    for k in indices:
        k = int(k)
        if prefix is None:
            prefix = k
            continue
        key = (prefix, k)
        if key in table:
            prefix = table[key]
            continue
        put(prefix)
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        else:
            put(clear)
            table, nxt, width = {}, eoi + 1, min_size + 1
        prefix = k
    if prefix is not None:
        put(prefix)
    put(eoi)
    if nbits:
        out.append(acc & 255)
    blocks = bytearray([min_size])
    for i in range(0, len(out), 255):
        chunk = out[i : i + 255]
        blocks += bytes([len(chunk)]) + chunk
    return bytes(blocks + b"\x00")


def _gif_table(colours: np.ndarray) -> Tuple[bytes, int]:
    """A colour table padded to a power of two, and its size field."""
    n = max(2, len(colours))
    bits = max(1, (n - 1).bit_length())
    table = np.zeros((1 << bits, 3), np.uint8)
    table[: len(colours)] = colours
    return table.tobytes(), bits - 1


def encode_gif(frames: Sequence[dict], width: int, height: int,
               palette: Optional[np.ndarray] = None, version: bytes = b"89a",
               background: int = 0) -> bytes:
    """A GIF of ``frames``, each a dict with ``indices`` (h, w) and optional
    ``left``, ``top``, ``palette`` (a local table, (n, 3) RGB),
    ``interlace``, ``transparent`` (an index) and ``disposal``."""
    out = bytearray(b"GIF" + version)
    flags = 0
    gct = b""
    if palette is not None:
        gct, size = _gif_table(np.asarray(palette, np.uint8))
        flags = 0x80 | 0x70 | size
    out += struct.pack("<HHBBB", width, height, flags, background, 0) + gct
    for f in frames:
        idx = np.asarray(f["indices"])
        h, w = idx.shape
        if "transparent" in f or "disposal" in f:
            packed = (f.get("disposal", 0) << 2) | (1 if "transparent" in f else 0)
            out += b"\x21\xf9\x04" + struct.pack("<BHB", packed, 10,
                                                  f.get("transparent", 0)) + b"\x00"
        lct, lflags = b"", 0
        if f.get("palette") is not None:
            lct, size = _gif_table(np.asarray(f["palette"], np.uint8))
            lflags = 0x80 | size
        rows = np.arange(h)
        if f.get("interlace"):
            lflags |= 0x40
            rows = np.concatenate([rows[0::8], rows[4::8], rows[2::4], rows[1::2]])
        out += b"\x2c" + struct.pack("<HHHHB", f.get("left", 0), f.get("top", 0), w, h,
                                      lflags) + lct
        ncolours = (len(lct) or len(gct)) // 3
        min_size = max(2, (max(ncolours, 2) - 1).bit_length())
        out += gif_lzw(idx[rows].ravel(), min_size)
    return bytes(out + b"\x3b")


# -- WebP -------------------------------------------------------------------------


class BoolEncoder:
    """The boolean entropy encoder of RFC 6386 section 7.3."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.put((v >> k) & 1, 128)

    def signed(self, v: int, n: int) -> None:
        self.value(abs(v), n)
        self.put(int(v < 0), 128)

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append((v >> 24) & 0xFF)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


# 4 x 4 modes in libwebp's order DC, TM, VE, HE, RD, VR, LD, VL, HD, HU: their
# paths down kYModesIntra4 as (node, bit) pairs
_BMODE_PATHS = {0: [(0, 0)], 1: [(0, 1), (1, 0)], 2: [(0, 1), (1, 1), (2, 0)],
                3: [(0, 1), (1, 1), (2, 1), (3, 0), (4, 0)],
                4: [(0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 0)],
                5: [(0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 1)],
                6: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 0)],
                7: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 0)],
                8: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 0)],
                9: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 1)]}
_VP8_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_VP8_CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
         (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))


def _put_tokens(enc: BoolEncoder, probas, t: int, ctx: int, levels: Sequence[int],
                first: int, eob: bool = True) -> int:
    """One block's quantized ``levels`` (16, in zigzag order) as tokens of
    type ``t``; returns what the decoder's ``GetCoeffs`` returns.  Without
    ``eob`` trailing zeros run to 16 instead of an end-of-block token."""
    levels = [int(v) for v in levels]
    last = max([i for i in range(first, 16) if levels[i]], default=-1)
    n, p, after_zero = first, probas[t][_VP8_BANDS[first]][ctx], False
    while n < 16:
        if not after_zero:
            if n > last and eob:
                enc.put(0, p[0])
                return n
            enc.put(1, p[0])
        v = levels[n]
        if v == 0:
            enc.put(0, p[1])
            n += 1
            if n == 16:
                return 16
            p, after_zero = probas[t][_VP8_BANDS[n]][0], True
            continue
        enc.put(1, p[1])
        a = abs(v)
        if a == 1:
            enc.put(0, p[2])
            nxt = probas[t][_VP8_BANDS[n + 1]][1]
        else:
            enc.put(1, p[2])
            if a <= 4:
                enc.put(0, p[3])
                enc.put(int(a > 2), p[4])
                if a > 2:
                    enc.put(a - 3, p[5])
            elif a <= 10:
                enc.put(1, p[3])
                enc.put(0, p[6])
                enc.put(int(a > 6), p[7])
                if a <= 6:
                    enc.put(a - 5, 159)
                else:
                    enc.put((a - 7) >> 1, 165)
                    enc.put((a - 7) & 1, 145)
            else:
                enc.put(1, p[3])
                enc.put(1, p[6])
                cat = 0 if a < 19 else 1 if a < 35 else 2 if a < 67 else 3
                enc.put(cat >> 1, p[8])
                enc.put(cat & 1, p[9 + (cat >> 1)])
                extra = a - 3 - (8 << cat)
                for k, prob in enumerate(_VP8_CATS[cat]):
                    enc.put((extra >> (len(_VP8_CATS[cat]) - 1 - k)) & 1, prob)
            nxt = probas[t][_VP8_BANDS[n + 1]][2]
        enc.put(int(v < 0), 128)
        n += 1
        p, after_zero = nxt, False
    return 16


def encode_vp8(width: int, height: int, mbs: Sequence[dict], *, q_index: int = 40,
               q_deltas: Sequence[int] = (0, 0, 0, 0, 0), simple: int = 0, level: int = 20,
               sharpness: int = 0, lf_deltas: Optional[Tuple[Sequence, Sequence]] = None,
               segments: Optional[dict] = None, partitions: int = 1,
               proba_updates: Optional[Dict[Tuple[int, int, int, int], int]] = None,
               skip_prob: Optional[int] = None, profile: int = 0,
               colour_bits: Tuple[int, int] = (0, 0)) -> bytes:
    """A VP8 key frame (RFC 6386) of ``mbs``, one dict per macroblock in
    raster order: ``y`` a 16 x 16 mode (0 DC, 1 TM, 2 V, 3 H) or a list of
    sixteen 4 x 4 modes (libwebp's order), ``uv`` a chroma mode, ``levels``
    quantized coefficients (25 blocks of 16 in zigzag order: Y2, 16 Y, 4 U,
    4 V; Y2 unused for B_PRED), and optional ``segment``, ``skip`` and
    ``eob`` (False: code each block's trailing zeros).  ``segments`` holds
    ``absolute``, ``quant`` and ``filter`` (4 values each) and ``probs`` (3
    map probabilities, None for no map); ``lf_deltas`` (ref, mode) 4 values
    each; ``proba_updates`` maps (type, band, context, index) to a new token
    probability; ``partitions`` is 1, 2, 4 or 8."""
    from molnextr_tpu_torch.data.vp8_tables import (BMODES_PROBA, COEFFS_PROBA0,
                                                    COEFFS_UPDATE_PROBA)

    proba_updates = proba_updates or {}
    hdr = BoolEncoder()
    hdr.put(colour_bits[0], 128)
    hdr.put(colour_bits[1], 128)
    hdr.put(int(segments is not None), 128)
    if segments is not None:
        probs = segments.get("probs")
        hdr.put(int(probs is not None), 128)  # update the map
        hdr.put(1, 128)  # update the data
        hdr.put(int(segments.get("absolute", True)), 128)
        for bits, values in ((7, segments.get("quant", [0] * 4)),
                             (6, segments.get("filter", [0] * 4))):
            for v in values:
                hdr.put(int(v != 0), 128)
                if v:
                    hdr.signed(v, bits)
        if probs is not None:
            for v in probs:
                hdr.put(int(v != 255), 128)
                if v != 255:
                    hdr.value(v, 8)
    hdr.put(simple, 128)
    hdr.value(level, 6)
    hdr.value(sharpness, 3)
    hdr.put(int(lf_deltas is not None), 128)
    if lf_deltas is not None:
        hdr.put(1, 128)
        for values in lf_deltas:
            for v in values:
                hdr.put(int(v != 0), 128)
                if v:
                    hdr.signed(v, 6)
    hdr.value({1: 0, 2: 1, 4: 2, 8: 3}[partitions], 2)
    hdr.value(q_index, 7)
    for d in q_deltas:
        hdr.put(int(d != 0), 128)
        if d:
            hdr.signed(d, 4)
    hdr.put(0, 128)  # refresh entropy probabilities
    probas = [[[list(COEFFS_PROBA0[((t * 8 + b) * 3 + c) * 11:((t * 8 + b) * 3 + c) * 11 + 11])
                for c in range(3)] for b in range(8)] for t in range(4)]
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    new = proba_updates.get((t, b, c, p))
                    hdr.put(int(new is not None),
                            COEFFS_UPDATE_PROBA[((t * 8 + b) * 3 + c) * 11 + p])
                    if new is not None:
                        hdr.value(new, 8)
                        probas[t][b][c][p] = new
    hdr.put(int(skip_prob is not None), 128)
    if skip_prob is not None:
        hdr.value(skip_prob, 8)
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    parts = [BoolEncoder() for _ in range(partitions)]
    intra_t = [0] * (4 * mb_w)
    top_nz, top_dc = [0] * mb_w, [0] * mb_w
    seg_probs = (segments or {}).get("probs")
    for mby in range(mb_h):
        intra_l, left_nz, left_dc = [0] * 4, 0, 0
        tok = parts[mby % partitions]
        for mbx in range(mb_w):
            mb = mbs[mby * mb_w + mbx]
            if seg_probs is not None:
                s = mb.get("segment", 0)
                hdr.put(s >> 1, seg_probs[0])
                hdr.put(s & 1, seg_probs[1 + (s >> 1)])
            skip = bool(mb.get("skip", False))
            if skip_prob is not None:
                hdr.put(int(skip), skip_prob)
            y = mb["y"]
            i4 = isinstance(y, (list, tuple))
            hdr.put(int(not i4), 145)
            if not i4:
                hdr.put(int(y in (1, 3)), 156)
                hdr.put(int(y in (1, 2)), 128 if y in (1, 3) else 163)
                intra_t[4 * mbx : 4 * mbx + 4] = [y] * 4
                intra_l = [y] * 4
            else:
                for yy in range(4):
                    for xx in range(4):
                        mode = y[4 * yy + xx]
                        prob = BMODES_PROBA[(intra_t[4 * mbx + xx] * 10 + intra_l[yy]) * 9:][:9]
                        for node, bit in _BMODE_PATHS[mode]:
                            hdr.put(bit, prob[node])
                        intra_t[4 * mbx + xx] = intra_l[yy] = mode
            uv = mb["uv"]
            hdr.put(int(uv != 0), 142)
            if uv:
                hdr.put(int(uv != 2), 114)
                if uv != 2:
                    hdr.put(int(uv == 1), 183)
            if skip and skip_prob is not None:
                top_nz[mbx] = left_nz = 0
                if not i4:
                    top_dc[mbx] = left_dc = 0
                continue
            lv = np.asarray(mb.get("levels", np.zeros((25, 16), int))).reshape(25, 16)
            eob = mb.get("eob", True)
            if not i4:
                nz = _put_tokens(tok, probas, 1, top_dc[mbx] + left_dc, lv[0], 0, eob)
                top_dc[mbx] = left_dc = int(nz > 0)
                first, t = 1, 0
            else:
                first, t = 0, 3
            tnz, lnz = top_nz[mbx] & 15, left_nz & 15
            for yy in range(4):
                l = lnz & 1
                for xx in range(4):
                    nz = _put_tokens(tok, probas, t, l + (tnz & 1), lv[1 + 4 * yy + xx], first, eob)
                    l = int(nz > first)
                    tnz = (tnz >> 1) | (l << 7)
                tnz >>= 4
                lnz = (lnz >> 1) | (l << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz, lnz = top_nz[mbx] >> (4 + ch), left_nz >> (4 + ch)
                for yy in range(2):
                    l = lnz & 1
                    for xx in range(2):
                        nz = _put_tokens(tok, probas, 2, l + (tnz & 1),
                                         lv[17 + 2 * ch + 2 * yy + xx], 0, eob)
                        l = int(nz > 0)
                        tnz = (tnz >> 1) | (l << 3)
                    tnz >>= 2
                    lnz = (lnz >> 1) | (l << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            top_nz[mbx], left_nz = out_t, out_l
    first_part = hdr.flush()
    tokens = [p.flush() for p in parts]
    tag = (profile << 1) | (1 << 4) | (len(first_part) << 5)
    out = bytearray(struct.pack("<I", tag)[:3]) + b"\x9d\x01\x2a"
    out += struct.pack("<HH", width, height) + first_part
    for t in tokens[:-1]:
        out += struct.pack("<I", len(t))[:3]
    return bytes(out + b"".join(tokens))


def webp_chunk(tag: bytes, payload: bytes) -> bytes:
    """A RIFF chunk, padded to an even size."""
    return tag + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)


def encode_webp(chunks: Sequence[Tuple[bytes, bytes]]) -> bytes:
    """A RIFF/WEBP file of (fourcc, payload) chunks."""
    body = b"WEBP" + b"".join(webp_chunk(t, p) for t, p in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(flags: int, width: int, height: int) -> bytes:
    """A ``VP8X`` payload: flags and the 24-bit canvas size."""
    return struct.pack("<I", flags) + struct.pack("<I", width - 1)[:3] \
        + struct.pack("<I", height - 1)[:3]


class _LsbWriter:
    """Bits least significant first, as VP8L reads them."""

    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value: int, nbits: int) -> None:
        self.acc |= (int(value) & ((1 << nbits) - 1)) << self.n
        self.n += nbits
        while self.n >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.n -= 8

    def bytes(self) -> bytes:
        return bytes(self.out + (bytes([self.acc]) if self.n else b""))


def _huffman_lengths(freq: Sequence[int], limit: int) -> List[int]:
    """Code lengths of a Huffman code of ``freq``, at most ``limit`` long
    (frequencies halved until they fit); every symbol of non-zero frequency
    gets a length, and a lone symbol gets 1."""
    import heapq

    freq = [int(f) for f in freq]
    while True:
        used = [i for i, f in enumerate(freq) if f]
        lengths = [0] * len(freq)
        if len(used) <= 1:
            for i in used:
                lengths[i] = 1
            return lengths
        heap = [(freq[i], k, [i]) for k, i in enumerate(used)]
        heapq.heapify(heap)
        tie = len(heap)
        while len(heap) > 1:
            fa, _, a = heapq.heappop(heap)
            fb, _, b = heapq.heappop(heap)
            for i in a + b:
                lengths[i] += 1
            heapq.heappush(heap, (fa + fb, tie, a + b))
            tie += 1
        if max(lengths) <= limit:
            return lengths
        freq = [(f >> 1) | (f > 0) for f in freq]


def _canonical(lengths: Sequence[int]) -> List[int]:
    """Bit-reversed canonical codes (deflate's order), ready to write LSB first."""
    codes, code = [0] * len(lengths), 0
    for n in range(1, 16):
        for s, ln in enumerate(lengths):
            if ln == n:
                codes[s] = int(format(code, f"0{n}b")[::-1], 2)
                code += 1
        code <<= 1
    return codes


_CL_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _write_code(w: _LsbWriter, lengths: List[int], simple: bool = True,
                repeats: bool = True, trim: bool = True) -> List[int]:
    """Write a prefix code of ``lengths`` (VP8L ``ReadHuffmanCode``): a simple
    code when it holds one or two symbols below 256 and ``simple``, else code
    lengths through the code-length code (with runs 16/17/18 when
    ``repeats``, and ``max_symbol`` cutting trailing zeros when ``trim``).
    Returns the codes to write symbols with."""
    used = [s for s, n in enumerate(lengths) if n]
    if simple and len(used) <= 2 and all(s < 256 for s in used):
        w.put(1, 1)
        w.put(len(used) - 1, 1)
        first = used[0]
        w.put(int(first > 1), 1)
        w.put(first, 8 if first > 1 else 1)
        if len(used) == 2:
            w.put(used[1], 8)
        return [0] * len(lengths) if len(used) == 1 else _canonical(lengths)
    w.put(0, 1)
    last = max(used) + 1 if trim else len(lengths)
    tokens = _length_tokens(lengths, last, repeats)
    if last < len(lengths) and len(tokens) < 2:  # max_symbol counts 2 tokens at least
        last = len(lengths)
        tokens = _length_tokens(lengths, last, repeats)
    cl_freq = [0] * 19
    for s, _, _ in tokens:
        cl_freq[s] += 1
    cl_lengths = _huffman_lengths(cl_freq, 7)
    count = max(4, max(k + 1 for k, s in enumerate(_CL_ORDER) if cl_lengths[s]))
    w.put(count - 4, 4)
    for k in range(count):
        w.put(cl_lengths[_CL_ORDER[k]], 3)
    if last < len(lengths):
        max_symbol = len(tokens)
        nbits = 0
        while max_symbol - 2 >= 1 << (2 + 2 * nbits):
            nbits += 1
        w.put(1, 1)
        w.put(nbits, 3)
        w.put(max_symbol - 2, 2 + 2 * nbits)
    else:
        w.put(0, 1)
    single = sum(1 for n in cl_lengths if n) == 1
    cl_codes = _canonical(cl_lengths)
    for s, extra, nbits in tokens:
        if not single:
            w.put(cl_codes[s], cl_lengths[s])
        w.put(extra, nbits)
    return [0] * len(lengths) if len(used) == 1 else _canonical(lengths)


def _length_tokens(lengths: Sequence[int], last: int, repeats: bool) -> list:
    """Code lengths up to ``last`` as (code-length symbol, extra value, extra
    bits): runs of zeros as 17/18 and repeats of the last non-zero length
    as 16 when ``repeats``."""
    tokens = []
    i, prev = 0, 8
    while i < last:
        n = lengths[i]
        run = 1
        while i + run < last and lengths[i + run] == n:
            run += 1
        if repeats and n == 0 and run >= 3:
            take = min(run, 138)
            tokens.append((17, take - 3, 3) if take <= 10 else (18, take - 11, 7))
            i += take
        elif repeats and n and n == prev and run >= 3:
            take = min(run, 6)
            tokens.append((16, take - 3, 2))
            i += take
        else:
            tokens.append((n, 0, 0))
            prev = n or prev
            i += 1
    return tokens


def _prefix(value: int) -> Tuple[int, int, int]:
    """VP8L length/distance prefix code of ``value`` >= 1: (symbol, extra
    bits value, extra bit count)."""
    v = value - 1
    if v < 4:
        return v, 0, 0
    high = v.bit_length() - 1
    second = (v >> (high - 1)) & 1
    extra = high - 1
    return 2 * high + second, v & ((1 << extra) - 1), extra


def _plane_code(dist: int, width: int) -> int:
    """The distance code of a backward distance: a short (dx, dy) code of the
    120-entry map where one fits, else ``dist + 120``."""
    from molnextr_tpu_torch.data.vp8_tables import CODE_TO_PLANE

    for code, pc in enumerate(CODE_TO_PLANE, 1):
        if max((pc >> 4) * width + 8 - (pc & 15), 1) == dist:
            return code
    return dist + 120


def _vp8l_tokens(px: np.ndarray, cache_bits: int, distances: Sequence[int], min_len: int,
                 plane: bool) -> list:
    """Greedy LZ77 of the coded pixels (h, w) in raster order: at each pixel
    the longest copy at one of ``distances`` (overlapping allowed, at most
    4096 long), else the colour cache, else a literal."""
    h, w = px.shape
    flat = [int(v) for v in px.reshape(-1)]
    cache = [None] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    out, p = [], 0
    while p < len(flat):
        best, best_d = 0, 0
        for d in distances:
            if d > p:
                continue
            n = 0
            while p + n < len(flat) and n < 4096 and flat[p + n] == flat[p + n - d]:
                n += 1
            if n > best:
                best, best_d = n, d
        if best >= min_len:
            code = _plane_code(best_d, w) if plane else best_d + 120
            out.append(("copy", best, code))
            seg = flat[p : p + best]
            p += best
        else:
            c = flat[p]
            key = ((c * 0x1E35A7BD) & 0xFFFFFFFF) >> shift if cache is not None else None
            if cache is not None and cache[key] == c:
                out.append(("cache", key))
            else:
                out.append(("lit", c))
            seg = [c]
            p += 1
        if cache is not None:
            for c in seg:
                cache[((c * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = c
    return out


def _vp8l_entropy(w: _LsbWriter, px: np.ndarray, cache_bits: int = 0, meta=None,
                  distances: Sequence[int] = (), min_len: int = 3, plane: bool = True,
                  simple: bool = True, repeats: bool = True, trim: bool = True) -> None:
    """The colour cache bit, optional meta prefix codes, the groups' codes and
    the pixels of a coded image.  ``meta`` (level 0 only) is (bits, (th, tw)
    group indices), or None for one group."""
    h, wd = px.shape
    if cache_bits:
        w.put(1, 1)
        w.put(cache_bits, 4)
    else:
        w.put(0, 1)
    if meta is not False:  # only a level-0 image has the meta bit
        if meta is None:
            w.put(0, 1)
        else:
            bits, groups = meta
            w.put(1, 1)
            w.put(bits - 2, 3)
            _vp8l_entropy(w, (np.asarray(groups, np.uint32) & 0xFFFF) << 8, meta=False)
    tokens = _vp8l_tokens(px, cache_bits, distances, min_len, plane)
    ngroups = 1 if not meta else int(np.max(meta[1])) + 1
    sizes = (256 + 24 + ((1 << cache_bits) if cache_bits else 0), 256, 256, 256, 40)
    freqs = [[[0] * n for n in sizes] for _ in range(ngroups)]
    located, p = [], 0
    for t in tokens:
        y, x = divmod(p, wd)
        g = 0 if not meta else int(meta[1][y >> meta[0], x >> meta[0]])
        f = freqs[g]
        if t[0] == "lit":
            c = t[1]
            f[0][(c >> 8) & 255] += 1
            f[1][(c >> 16) & 255] += 1
            f[2][c & 255] += 1
            f[3][c >> 24] += 1
            p += 1
        elif t[0] == "cache":
            f[0][280 + t[1]] += 1
            p += 1
        else:
            f[0][256 + _prefix(t[1])[0]] += 1
            f[4][_prefix(t[2])[0]] += 1
            p += t[1]
        located.append((g, t))
    codes = []
    for g in range(ngroups):
        group = []
        for k, n in enumerate(sizes):
            fr = freqs[g][k]
            if not any(fr):
                fr = list(fr)
                fr[0] = 1
            lengths = _huffman_lengths(fr, 15)
            group.append((lengths, _write_code(w, lengths, simple, repeats, trim)))
        codes.append(group)

    def sym(g, k, s):
        lengths, c = codes[g][k]
        if sum(1 for n in lengths if n) > 1:
            w.put(c[s], lengths[s])

    for g, t in located:
        if t[0] == "lit":
            c = t[1]
            sym(g, 0, (c >> 8) & 255)
            sym(g, 1, (c >> 16) & 255)
            sym(g, 2, c & 255)
            sym(g, 3, c >> 24)
        elif t[0] == "cache":
            sym(g, 0, 280 + t[1])
        else:
            s, extra, nbits = _prefix(t[1])
            sym(g, 0, 256 + s)
            w.put(extra, nbits)
            s, extra, nbits = _prefix(t[2])
            sym(g, 4, s)
            w.put(extra, nbits)


def _argb_channels(c: int) -> List[int]:
    return [(c >> 24) & 255, (c >> 16) & 255, (c >> 8) & 255, c & 255]


def _argb(ch: Sequence[int]) -> int:
    return ((ch[0] & 255) << 24) | ((ch[1] & 255) << 16) | ((ch[2] & 255) << 8) | (ch[3] & 255)


def vp8l_predict(mode: int, L: int, T: int, TR: int, TL: int) -> int:
    """The VP8L predictor ``mode`` (0-15) of a pixel from its left, top,
    top-right and top-left neighbours (ARGB ints), per the format's spec."""
    l, t, tr, tl = (_argb_channels(v) for v in (L, T, TR, TL))

    def avg(a, b):
        return [(x + y) // 2 for x, y in zip(a, b)]

    if mode in (0, 14, 15):  # libwebp predicts 14 and 15 as 0
        return 0xFF000000
    if mode in (1, 2, 3, 4):
        return (L, T, TR, TL)[mode - 1]
    table = {5: lambda: avg(avg(l, tr), t), 6: lambda: avg(l, tl), 7: lambda: avg(l, t),
             8: lambda: avg(tl, t), 9: lambda: avg(t, tr),
             10: lambda: avg(avg(l, tl), avg(t, tr))}
    if mode in table:
        return _argb(table[mode]())
    if mode == 11:
        p_left = sum(abs(a - b) for a, b in zip(t, tl))
        p_top = sum(abs(a - b) for a, b in zip(l, tl))
        return L if p_left < p_top else T
    if mode == 12:
        return _argb([min(max(a + b - c, 0), 255) for a, b, c in zip(l, t, tl)])
    ave = avg(l, t)
    return _argb([min(max(a + int((a - c) / 2), 0), 255) for a, c in zip(ave, tl)])


def _forward(argb: np.ndarray, transforms: Sequence[dict]):
    """Apply VP8L transforms forward in stream order: the coded image and,
    per transform, what the stream carries."""
    px = np.asarray(argb, np.uint32).copy()
    carried = []
    for t in transforms:
        h, w = px.shape
        kind = t["kind"]
        if kind == "green":
            g = (px >> 8) & 255
            r = (((px >> 16) & 255) - g) & 255
            b = ((px & 255) - g) & 255
            px = (px & 0xFF00FF00) | (r << 16) | b
            carried.append(None)
        elif kind == "predictor":
            bits = t["bits"]
            modes = np.asarray(t["modes"])[: -(-h >> bits), : -(-w >> bits)]
            src = [[int(v) for v in row] for row in px]
            res = np.zeros_like(px)
            for y in range(h):
                for x in range(w):
                    if y == 0:
                        mode = 0 if x == 0 else 1
                    elif x == 0:
                        mode = 2
                    else:
                        mode = int(modes[y >> bits, x >> bits])
                    L = src[y][x - 1] if x else 0
                    T = src[y - 1][x] if y else 0
                    TL = src[y - 1][x - 1] if x and y else 0
                    TR = (src[y - 1][x + 1] if x + 1 < w else src[y][0]) if y else 0
                    pred = _argb_channels(vp8l_predict(mode, L, T, TR, TL))
                    res[y, x] = _argb([a - b for a, b in zip(_argb_channels(src[y][x]), pred)])
            px = res
            carried.append((bits, (modes.astype(np.uint32) & 15) << 8))
        elif kind == "cross":
            bits = t["bits"]
            m = np.asarray(t["multipliers"], np.int64)[: -(-h >> bits), : -(-w >> bits)]
            out = px.copy()
            for y in range(h):
                for x in range(w):
                    g2r, g2b, r2b = (int(v) for v in m[y >> bits, x >> bits])
                    c = int(px[y, x])
                    green = ((c >> 8) & 255) - 256 * (((c >> 8) & 255) > 127)
                    red = ((c >> 16) & 255) - 256 * (((c >> 16) & 255) > 127)
                    nr = ((c >> 16) - ((g2r * green) >> 5)) & 255
                    nb = (c - ((g2b * green) >> 5) - ((r2b * red) >> 5)) & 255
                    out[y, x] = (c & 0xFF00FF00) | (nr << 16) | nb
            px = out
            code = (m[..., 0] & 255) | ((m[..., 1] & 255) << 8) | ((m[..., 2] & 255) << 16)
            carried.append((bits, code.astype(np.uint32)))
        else:  # palette
            colours = [int(c) for c in t["colours"]]
            index = {c: i for i, c in enumerate(colours)}
            idx = np.vectorize(lambda c: index[int(c)])(px) if px.size else px
            n = len(colours)
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            if bits:
                per = 1 << bits
                bpp = 8 >> bits
                packed = np.zeros((h, (w + per - 1) // per), np.uint32)
                for x in range(w):
                    packed[:, x >> bits] |= idx[:, x].astype(np.uint32) << (bpp * (x & (per - 1)))
                px = 0xFF000000 | (packed << 8)
            else:
                px = 0xFF000000 | (idx.astype(np.uint32) << 8)
            pal = np.array(colours, np.uint32)
            delta = pal.copy()
            for i in range(1, n):  # delta-coded bytewise
                delta[i] = _argb([a - b for a, b in zip(_argb_channels(int(pal[i])),
                                                        _argb_channels(int(pal[i - 1])))])
            carried.append((n, delta))
    return px, carried


def vp8l_stream(argb: np.ndarray, transforms: Sequence[dict] = (), cache_bits: int = 0,
                meta=None, distances: Sequence[int] = (), min_len: int = 3,
                plane: bool = True, simple: bool = True, repeats: bool = True,
                trim: bool = True, sub_cache: int = 0) -> bytes:
    """A VP8L image stream (no header) of ARGB (h, w): ``transforms`` in
    stream order (dicts of ``kind`` green, predictor with ``bits`` and
    ``modes`` (th, tw), cross with ``bits`` and ``multipliers`` (th, tw, 3)
    as signed green-to-red, green-to-blue, red-to-blue, palette with
    ``colours``); ``cache_bits`` 0-11; ``meta`` (bits, group index per
    tile); ``distances`` tried for copies (``plane``: through the 120-entry
    map where one fits); ``simple``, ``repeats``, ``trim`` choose how codes
    are written; ``sub_cache`` a cache width for the transform images."""
    w = _LsbWriter()
    px, carried = _forward(argb, transforms)
    for t, data in zip(transforms, carried):
        w.put(1, 1)
        kind = t["kind"]
        w.put({"predictor": 0, "cross": 1, "green": 2, "palette": 3}[kind], 2)
        if kind in ("predictor", "cross"):
            bits, image = data
            w.put(bits - 2, 3)
            _vp8l_entropy(w, image, sub_cache, meta=False, simple=simple, repeats=repeats,
                          trim=trim)
        elif kind == "palette":
            n, delta = data
            w.put(n - 1, 8)
            _vp8l_entropy(w, delta.reshape(1, -1), sub_cache, meta=False, simple=simple,
                          repeats=repeats, trim=trim)
    w.put(0, 1)
    _vp8l_entropy(w, px, cache_bits, meta, distances, min_len, plane, simple, repeats, trim)
    return w.bytes()


def encode_vp8l(argb: np.ndarray, alpha_hint: bool = False, **kw) -> bytes:
    """A ``VP8L`` chunk payload: the signature, 14-bit size, the alpha hint,
    version 0, then :func:`vp8l_stream` of ``argb``."""
    h, w = np.asarray(argb).shape
    head = bytes([0x2F]) + struct.pack("<I", (w - 1) | ((h - 1) << 14) | (int(alpha_hint) << 28))
    return head + vp8l_stream(argb, **kw)


def alph_chunk(alpha: np.ndarray, filtering: int = 0, lossless: bool = False,
               pre: int = 0, **kw) -> bytes:
    """An ``ALPH`` payload: the header byte, then the plane filtered (0
    none, 1 horizontal, 2 vertical, 3 gradient) raw or as a VP8L stream of
    its green channel (``kw`` to :func:`vp8l_stream`)."""
    a = np.asarray(alpha, np.int64)
    h, w = a.shape
    pred = np.zeros_like(a)
    for y in range(h):
        for x in range(w):
            if filtering == 0:
                continue
            if y == 0:
                pred[y, x] = a[y, x - 1] if x else 0
            elif filtering == 1:
                pred[y, x] = a[y, x - 1] if x else a[y - 1, 0]
            elif filtering == 2:
                pred[y, x] = a[y - 1, x]
            else:
                pred[y, x] = min(max(a[y, x - 1] + a[y - 1, x] - a[y - 1, x - 1], 0), 255) \
                    if x else a[y - 1, 0]
    res = ((a - pred) & 255).astype(np.uint32)
    head = bytes([int(lossless) | (filtering << 2) | (pre << 4)])
    if not lossless:
        return head + res.astype(np.uint8).tobytes()
    return head + vp8l_stream(0xFF000000 | (res << 8), **kw)
