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
  each with its own table, offset, interlace and transparent index.
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
