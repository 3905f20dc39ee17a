"""Hand encoders for the image-reader tests: files that ``cv2.imwrite`` and
PIL do not write, read back by ``cv2.imread`` as the reference.

* :func:`encode_tiff`: a TIFF or BigTIFF from raw or already-compressed
  strips or tiles and any tags (both byte orders, a second page on
  request); :func:`thunderscan`, :func:`sgilog_rle`, :func:`ycbcr_blocks`,
  :func:`mh_to_rlew` and :func:`lzw_compat`: ThunderScan, SGILog, packed
  YCbCr, CCITT RLE/W and old-style LZW strip data; :func:`rlew_strips` and
  :func:`rlew_tiff`: an RLE/W TIFF whose strips lie at chosen file offsets;
* :func:`encode_jpeg`: a baseline JPEG from component planes at any
  sampling factors (1-4), with any component ids, an Adobe APP14 marker
  and restart markers; fixed-length Huffman codes, so no table needs
  building (12-bit samples too); :func:`jpeg_tables_and_body` splits one
  into a JPEG-in-TIFF tables stream and abbreviated stream;
* :func:`encode_jpeg_arith` (with :class:`ArithEncoder`, ``jcarith.c``'s
  QM coder): sequential or progressive arithmetic-coded JPEG with any scan
  script, restarts and ``DAC`` conditioning; :func:`encode_jpeg_lossless`:
  a lossless JPEG at any predictor and point transform;
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
  any chunks;
* :func:`film_grain_avif`: a lossy AVIF whose frame applies film grain
  (Pillow's libaom with ``denoise-noise-level``); :func:`grain_table`: a
  libaom film grain table for Pillow's ``film-grain-table`` option;
  :func:`av1_with_grain` (with :func:`film_grain_bits`): an AV1 key
  frame's OBUs given any ``film_grain_params``; :func:`av1_hidden_key`: a
  key frame hidden and shown by ``show_existing_frame``;
  :func:`av1_superres_obus`: the OBUs of an AV1 key frame that uses
  superres, cut short, for :func:`avif_rebuild`'s ``payload``;
  :func:`rescaled_avif`: an ``ispe`` (or ``tkhd``) of another size than
  the frame's, at any depth and subsampling, with alpha, in a grid or an
  ``avis`` sequence; :func:`with_ispe`: any one-item AVIF's ``ispe``
  replaced;
  :func:`avif_grid`: a ``grid`` of any tiles, output size and field width,
  with an alpha grid; :func:`avif_with_alpha`: an item with an alpha item
  of any AVIF's stream;
* :func:`aom_encode` (with :func:`aom_default_config`, :class:`AomEncCfg`
  and :class:`AomImage`): one AV1 key frame from the libaom that cv2
  ships, driven through ``ctypes``, at 8 or 10 bits, 4:2:0, 4:2:2, 4:4:4
  or monochrome, with superres at any denominator and libaom's named
  options (tiles, restoration, ``deltaq-mode``, ``delta-lf-mode``, film
  grain); :func:`aom_yuv`: an RGB picture's planes for it;
  :func:`aom_avif`: its OBUs in a one-item AVIF;
* :func:`cbd_segment`, :func:`mct_segment`, :func:`mcc_segment`,
  :func:`mco_segment` and :func:`part2_identity`: JPEG 2000 Part 2 marker
  segments for :func:`encode_j2k`'s ``main_markers`` and ``tile_header``;
  :func:`openjpeg_part2`: a Part 2 file from OpenJPEG's own encoder
  (Pillow's ``libopenjp2`` through ``ctypes``, ``opj_set_MCT``);
* :func:`ht_encode`: an HTJ2K (Part 15) code-block, the cleanup pass
  (:func:`ht_cleanup`: :class:`HTMel`, the VLC codes of
  :func:`ht_codewords` turned round from the decoder's tables, u-VLC,
  MagSgn) and the SigProp and MagRef passes (:func:`ht_sigprop`,
  :func:`ht_magref`; :class:`HTForward` and :class:`HTBackward` stuff
  bits as each stream's reader unstuffs them), which :func:`encode_j2k`
  writes for ``style`` ``J2K_HT`` with a ``CAP`` marker; precincts; and
  :func:`encode_jp2`'s ``brand`` for a JPH file.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 7: "B", 8: "h", 16: "Q", 17: "q", 18: "Q"}


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


def lzw_compat(data: bytes) -> bytes:
    """Old-style TIFF LZW (before TIFF 5): codes LSB first, the width grown
    when the next code passes the width's limit, a clear code first."""
    table = {bytes([i]): i for i in range(256)}
    codes, width, nxt, w = [(256, 9)], 9, 258, b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], width))
        table[wc] = nxt
        nxt += 1
        if nxt > 1 << width and width < 12:
            width += 1
        w = bytes([byte])
    if w:
        codes.append((table[w], width))
    codes.append((257, width))
    acc = nbits = 0
    out = bytearray()
    for code, size in codes:
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc)
    return bytes(out)


def thunderscan(values: np.ndarray, runs: bool = True, seed: int = 0) -> bytes:
    """ThunderScan (compression 32809) rows of 4-bit ``values``: each row
    from last pixel 0, as runs of the last pixel (``runs``), three 2-bit or
    two 3-bit deltas where they fit, else raw values; ``seed`` varies the
    choice between the codes that fit."""
    rng = np.random.RandomState(seed)
    out = bytearray()
    for row in values.astype(np.int64).tolist():
        last, i, w = 0, 0, len(row)
        while i < w:
            n = 0
            while runs and i + n < w and row[i + n] == last and n < 63:
                n += 1
            if n >= 2 or (n == 1 and rng.rand() < 0.3):
                out.append(n)
                i += n
                continue
            d2 = [(row[i + k] - (row[i + k - 1] if k else last)) % 16 for k in range(min(3, w - i))]
            if len(d2) == 3 and all(d in (0, 1, 15) for d in d2) and rng.rand() < 0.8:
                out.append(0x40 | sum({0: 0, 1: 1, 15: 3}[d] << s for d, s in zip(d2, (4, 2, 0))))
                last, i = row[i + 2], i + 3
                continue
            d3 = d2[:2]
            if len(d3) == 2 and all(d in (0, 1, 2, 3, 13, 14, 15) for d in d3) and rng.rand() < 0.8:
                code = {0: 0, 1: 1, 2: 2, 3: 3, 13: 5, 14: 6, 15: 7}
                out.append(0x80 | (code[d3[0]] << 3) | code[d3[1]])
                last, i = row[i + 1], i + 2
                continue
            out.append(0xC0 | row[i])
            last, i = row[i], i + 1
    return bytes(out)


def sgilog_rle(values: np.ndarray, nbytes: int, runs: bool = True) -> bytes:
    """SGILog run-length rows (compression 34676) of ``nbytes``-byte codes
    (2: LogL, 4: LogLuv): each row's byte planes, high byte first, as runs
    (a byte of 128 + n - 2 then the value, for n of 2-129) and literal
    spans (a count of 1-127, then the bytes)."""
    out = bytearray()
    for row in values.astype(np.int64):
        for shift in range(8 * (nbytes - 1), -1, -8):
            plane = ((row >> shift) & 0xFF).tolist()
            i = 0
            while i < len(plane):
                n = 1
                while runs and i + n < len(plane) and plane[i + n] == plane[i] and n < 129:
                    n += 1
                if n >= 3:
                    out += bytes([128 + n - 2, plane[i]])
                    i += n
                    continue
                j = i
                while j < len(plane) and j - i < 127 and not (
                        runs and j + 2 < len(plane) and plane[j] == plane[j + 1] == plane[j + 2]):
                    j += 1
                j = max(j, i + 1)
                out += bytes([j - i]) + bytes(plane[i:j])
                i = j
    return bytes(out)


def ycbcr_blocks(ycc: np.ndarray, hs: int, vs: int) -> bytes:
    """Contiguous TIFF YCbCr data of (h, w, 3) samples subsampled hs x vs:
    blocks of hs x vs luma samples (edge samples repeated) then the
    block's top-left Cb and Cr, block rows of ceil(w / hs) blocks."""
    h, w, _ = ycc.shape
    by, bx = -(-h // vs), -(-w // hs)
    pad = np.pad(ycc, ((0, by * vs - h), (0, bx * hs - w), (0, 0)), mode="edge")
    y = pad[..., 0].reshape(by, vs, bx, hs).transpose(0, 2, 1, 3).reshape(by, bx, vs * hs)
    chroma = pad[::vs, ::hs, 1:]
    return np.concatenate([y, chroma], axis=2).astype(np.uint8).tobytes()


def mh_to_rlew(strip: bytes, width: int, rows: int, odd: Optional[bool] = None) -> bytes:
    """A CCITT MH strip (compression 2, rows on byte boundaries) re-aligned
    to 16-bit words, as CCITT RLE/W (32771) lays its rows out: each row
    padded to a word of the strip (``odd`` None), a layout libtiff misreads
    wherever its accumulator holds a word past a row's end; or each row
    placed where libtiff's ``Fax3DecodeRLE`` looks for it in a strip at an
    even or ``odd`` file offset (its 12- and 13-bit look-ups load bytes
    ahead; at a row's end it keeps a whole word it holds, else drops the
    bits and moves to an even address), so the strip reads intact."""
    from molnextr_tpu_torch.data import ccitt

    white, black, _ = ccitt._tables()
    reader = ccitt._Reader(strip)
    bits = np.unpackbits(np.frombuffer(strip, np.uint8))
    out = np.zeros(0, np.uint8)
    avail = cp = 0  # libtiff's BitsAvail and byte pointer (from the strip's start)
    for _ in range(rows):
        start = reader.pos
        codes, a0, colour = [], 0, 0
        while a0 < width:  # each code's look-up width and length, as _row_1d walks
            table = black if colour else white
            while True:
                entry = table[reader.peek(ccitt.PEEK)]
                codes.append((13 if colour else 12, entry & 31))
                reader.pos += entry & 31
                a0 += entry >> 5
                if entry >> 5 < 64:
                    break
            colour ^= 1
        row = bits[start : reader.pos]
        reader.pos = (reader.pos + 7) & ~7
        if odd is None:
            out = np.concatenate([out, row, np.zeros((-len(row)) % 16, np.uint8)])
            continue
        at = cp * 8 - avail  # the row's first bit
        out = np.concatenate([out, np.zeros(at - len(out), np.uint8), row])
        for need, length in codes:
            while avail < need:
                avail, cp = avail + 8, cp + 1
            avail -= length
        avail -= avail & 15
        if avail == 0 and (cp + odd) & 1:
            cp += 1
    if odd is not None:
        out = np.concatenate([out, np.zeros(max(cp * 8 - len(out), 0), np.uint8)])
    return np.packbits(out).tobytes()


def rlew_strips(bits: np.ndarray, rows_per_strip: int, odd=None) -> Tuple[List[bytes], int]:
    """``bits`` (rows, width; True where Pillow's mode ``1`` is set) as CCITT
    RLE/W strips of ``rows_per_strip`` rows (Pillow's MH strips through
    :func:`mh_to_rlew`, laid out for libtiff at ``odd`` offsets: None, a
    bool, or one a strip), and the photometric Pillow writes with them."""
    import io

    from PIL import Image

    from molnextr_tpu_torch.data.tiff import _tags

    h, w = bits.shape
    strips, photometric = [], 0
    for y in range(0, h, rows_per_strip):
        part = bits[y : y + rows_per_strip]
        buf = io.BytesIO()
        Image.fromarray(part).convert("1").save(buf, "TIFF", compression="tiff_ccitt")
        mh = buf.getvalue()
        t = _tags(mh, "<", int.from_bytes(mh[4:8], "little"))
        photometric = t[262][0]
        strip = b"".join(mh[o : o + n] for o, n in zip(t[273], t[279]))
        parity = odd[len(strips)] if isinstance(odd, (list, tuple)) else odd
        strips.append(mh_to_rlew(strip, w, part.shape[0], parity))
    return strips, photometric


def rlew_tiff(strips: Sequence[bytes], width: int, height: int, rows_per_strip: int,
              photometric: int = 0, offsets: Optional[Sequence[int]] = None,
              fill_order: int = 1) -> bytes:
    """A little-endian CCITT RLE/W (32771) TIFF whose ``strips`` lie at the
    file ``offsets`` given (ascending, 8 or more; default each right after
    the header or the strip before), the IFD after them.  ``fill_order`` 2
    reverses the bits of each strip byte and says so (tag 266)."""
    if offsets is None:
        offsets = list(np.cumsum([8] + [len(c) for c in strips[:-1]]))
    out = bytearray(b"II*\x00" + bytes(4))
    for strip, at in zip(strips, offsets):
        assert at >= len(out)
        out += bytes(at - len(out))
        if fill_order == 2:
            strip = bytes(int(f"{b:08b}"[::-1], 2) for b in strip)
        out += strip
    out += bytes(len(out) % 2)
    ifd = len(out)
    struct.pack_into("<I", out, 4, ifd)
    n = len(strips)
    tags = {256: (3, [width]), 257: (3, [height]), 258: (3, [1]), 259: (3, [32771]),
            262: (3, [photometric]), 266: (3, [fill_order]), 273: (4, list(offsets)),
            277: (3, [1]), 278: (3, [rows_per_strip]), 279: (4, [len(c) for c in strips])}
    extra_at = ifd + 2 + 12 * len(tags) + 4
    body, extra = struct.pack("<H", len(tags)), b""
    for tag, (typ, vals) in sorted(tags.items()):
        raw = struct.pack("<" + _TYPES[typ] * len(vals), *[int(v) for v in vals])
        if len(raw) <= 4:
            body += struct.pack("<HHI", tag, typ, len(vals)) + raw.ljust(4, b"\x00")
        else:
            body += struct.pack("<HHII", tag, typ, len(vals), extra_at + len(extra))
            extra += raw
    return bytes(out) + body + bytes(4) + extra


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


def _jpeg_coefficients(planes: Sequence[np.ndarray], factors: Sequence[Tuple[int, int]],
                       quality_step: int, precision: int = 8) -> List[np.ndarray]:
    """Each plane subsampled by its factors, padded to whole MCUs and
    transformed: (block rows, block columns, 64) quantised coefficients in
    zig-zag order."""
    h, w = planes[0].shape
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    comps = []
    for plane, (fh, fv) in zip(planes, factors):
        cw, ch = -(-w * fh // hmax), -(-h * fv // vmax)
        ys = (np.arange(ch) * vmax // fv).clip(0, h - 1)
        xs = (np.arange(cw) * hmax // fh).clip(0, w - 1)
        sub = plane.astype(np.float64)[ys][:, xs]
        full = np.pad(sub, ((0, mcuy * fv * 8 - ch), (0, mcux * fh * 8 - cw)), mode="edge")
        blocks = full.reshape(mcuy * fv, 8, mcux * fh, 8).transpose(0, 2, 1, 3) \
            - (1 << (precision - 1))
        coef = np.einsum("ij,abjk,lk->abil", _DCT, blocks, _DCT)
        comps.append(np.rint(coef / quality_step).astype(np.int64).reshape(
            mcuy * fv, mcux * fh, 64)[:, :, _ZIGZAG])
    return comps


def _jpeg_head(planes, factors, ids, quality_step, adobe, jfif, sof: int,
               precision: int = 8) -> bytearray:
    h, w = planes[0].shape
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    if quality_step:
        out += _segment(0xDB, bytes([0]) + bytes([quality_step]) * 64)
    body = struct.pack(">BHHB", precision, h, w, len(planes))
    for cid, (fh, fv) in zip(ids, factors):
        body += bytes([cid, (fh << 4) | fv, 0])
    out += _segment(sof, body)
    return out


def _mcu_blocks(comps, factors, mcux, mcuy):
    """Per MCU in raster order: the (component, block) pairs of an
    interleaved scan."""
    for my in range(mcuy):
        for mx in range(mcux):
            yield [(k, comp[my * fv + v, mx * fh + hh]) for k, (comp, (fh, fv))
                   in enumerate(zip(comps, factors)) for v in range(fv) for hh in range(fh)]


def encode_jpeg(planes: Sequence[np.ndarray], factors: Sequence[Tuple[int, int]],
                ids: Optional[Sequence[int]] = None, quality_step: int = 4,
                adobe: Optional[int] = None, jfif: bool = False, restart: int = 0,
                precision: int = 8) -> bytes:
    """A baseline JPEG of component planes (full image size each; a plane is
    subsampled by its factors against the largest) with one flat
    quantisation table (``precision`` 12: an extended-sequential SOF1 frame
    of 12-bit samples)."""
    h, w = planes[0].shape
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    ids = list(ids) if ids is not None else list(range(1, len(planes) + 1))
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    comps = _jpeg_coefficients(planes, factors, quality_step, precision)
    out = _jpeg_head(planes, factors, ids, quality_step, adobe, jfif,
                     0xC0 if precision == 8 else 0xC1, precision)
    dc_symbols = _DC_SYMBOLS + ([12, 13, 14, 15] if precision > 8 else [])
    dc_counts = [0, 0, 0, len(dc_symbols)] + [0] * 12
    out += _segment(0xC4, bytes([0x00]) + bytes(dc_counts) + bytes(dc_symbols))
    ac_symbols = _AC_SYMBOLS + ([(r << 4) | s for r in range(16) for s in range(11, 15)]
                                if precision > 8 else [])
    ac_counts = [0] * 16
    ac_counts[8 if precision > 8 else 7] = len(ac_symbols)
    ac_len = 9 if precision > 8 else 8
    out += _segment(0xC4, bytes([0x10]) + bytes(ac_counts) + bytes(ac_symbols))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    sos = bytes([len(planes)]) + b"".join(bytes([cid, 0x00]) for cid in ids) + bytes([0, 63, 0])
    out += _segment(0xDA, sos)
    dc_code = {s: i for i, s in enumerate(dc_symbols)}
    ac_code = {s: i for i, s in enumerate(ac_symbols)}
    writer = _BitWriter()
    pred = [0] * len(planes)
    for mcu, blocks in enumerate(_mcu_blocks(comps, factors, mcux, mcuy)):
        if restart and mcu and mcu % restart == 0:
            out += writer.flush() + bytes([0xFF, 0xD0 + (mcu // restart - 1) % 8])
            pred = [0] * len(planes)
        for k, blk in blocks:
            blk = blk.tolist()
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
                    writer.put(ac_code[0xF0], ac_len)
                    run -= 16
                s, bits = _category(c)
                writer.put(ac_code[(run << 4) | s], ac_len)
                writer.put(bits, s)
                run = 0
            if run:
                writer.put(ac_code[0x00], ac_len)
    out += writer.flush() + b"\xff\xd9"
    return bytes(out)


def jpeg_tables_and_body(jpeg: bytes) -> Tuple[bytes, bytes]:
    """A JPEG split as a JPEG-in-TIFF writer splits it: the tables-only
    stream (SOI, every DQT, DHT, DAC and DRI, EOI) for ``JPEGTables`` and
    the abbreviated stream of the rest."""
    tables, body = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8")
    pos = 2
    while jpeg[pos + 1] != 0xDA:
        length = struct.unpack(">H", jpeg[pos + 2 : pos + 4])[0]
        seg = jpeg[pos : pos + 2 + length]
        (tables if jpeg[pos + 1] in (0xDB, 0xC4, 0xCC, 0xDD) else body).extend(seg)
        pos += 2 + length
    return bytes(tables + b"\xff\xd9"), bytes(body + jpeg[pos:])


# -- the arithmetic coder of T.81 Annex D (libjpeg's jcarith.c) ----------------------

# Qe, next index after an LPS, next index after an MPS, switch: T.81 Table D.2,
# and libjpeg's entry 113, the fixed probability 0.5 of sign bits
_QE = [
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
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
]


class ArithEncoder:
    """The QM coder of T.81 Annex D as libjpeg's ``jcarith.c`` writes it:
    ``encode(bins, index, bit)`` codes one decision in a statistics bin (a
    state index with the MPS in bit 7); ``flush()`` ends the segment
    (D.1.8) and returns its stuffed bytes."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b: int) -> None:
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _zeros(self) -> None:
        self.out += bytes(self.zc)
        self.zc = 0

    def encode(self, bins, i: int, bit: int) -> None:
        sv = bins[i]
        qe, nlps, nmps, switch = _QE[sv & 0x7F]
        self.a -= qe
        if bit != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) ^ (nlps | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def flush(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        out = bytes(self.out)
        self.__init__()
        return out


def _arith_value(enc: ArithEncoder, bins, st: int, v: int, x_bin: int, ac: bool, fixed) -> int:
    """F.6-F.9: a nonzero value's sign, magnitude category and bits; returns
    the category's top bit ``m``."""
    if ac:
        enc.encode(fixed, 0, int(v < 0))
        st += 2
    else:
        enc.encode(bins, st + 1, int(v < 0))
        st += 3 if v < 0 else 2
    v = abs(v) - 1
    m = 0
    if v:
        enc.encode(bins, st, 1)
        m = 1
        v2 = v
        if ac:
            v2 >>= 1
            if v2:
                enc.encode(bins, st, 1)
                m <<= 1
                st = x_bin
                while v2 >> 1:
                    v2 >>= 1
                    enc.encode(bins, st, 1)
                    m <<= 1
                    st += 1
        else:
            st = x_bin
            while v2 >> 1:
                v2 >>= 1
                enc.encode(bins, st, 1)
                m <<= 1
                st += 1
    enc.encode(bins, st, 0)
    st += 14
    mm = m
    while mm > 1:
        mm >>= 1
        enc.encode(bins, st, int(bool(mm & v)))
    return m


def _dc_context(m: int, negative: bool, lower: int, upper: int) -> int:
    if m < (1 << lower) >> 1:
        return 0
    return (12 if m > (1 << upper) >> 1 else 4) + 4 * negative


def encode_jpeg_arith(planes: Sequence[np.ndarray], factors: Sequence[Tuple[int, int]],
                      scans: Optional[Sequence[Tuple[Sequence[int], int, int, int, int]]] = None,
                      ids: Optional[Sequence[int]] = None, quality_step: int = 4,
                      restart: int = 0, dac: Sequence[Tuple[int, int]] = (),
                      jfif: bool = False, adobe: Optional[int] = None) -> bytes:
    """An arithmetic-coded JPEG: sequential (SOF9) when ``scans`` is None,
    else progressive (SOF10) with scans of (components, Ss, Se, Ah, Al);
    ``dac`` holds (Tc << 4 | Tb, value) conditioning entries.  Every
    component uses DC and AC conditioning table 0."""
    h, w = planes[0].shape
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    ids = list(ids) if ids is not None else list(range(1, len(planes) + 1))
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    comps = _jpeg_coefficients(planes, factors, quality_step)
    zz = [c.tolist() for c in comps]  # per block, zig-zag order
    out = _jpeg_head(planes, factors, ids, quality_step, adobe, jfif,
                     0xC9 if scans is None else 0xCA)
    lower, upper, kx = 0, 1, 5
    if dac:
        out += _segment(0xCC, b"".join(bytes(d) for d in dac))
        for index, val in dac:
            if index == 0x10:
                kx = val
            elif index == 0:
                lower, upper = val & 15, val >> 4
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    progressive = scans is not None
    if scans is None:
        scans = [(list(range(len(planes))), 0, 63, 0, 0)]
    for members, ss, se, ah, al in scans:
        out += _segment(0xDA, bytes([len(members)]) + b"".join(
            bytes([ids[k], 0x00]) for k in members) + bytes([ss, se, (ah << 4) | al]))
        if len(members) > 1:
            mcus = [[(members.index(k), zz[k][by][bx]) for k in members
                     for by, bx in _blocks_of(k, factors, my, mx)]
                    for my in range(mcuy) for mx in range(mcux)]
        else:
            k = members[0]
            fh, fv = factors[k]
            cw, ch = -(-(-(-w * fh // hmax)) // 8), -(-(-(-h * fv // vmax)) // 8)
            mcus = [[(0, zz[k][by][bx])] for by in range(ch) for bx in range(cw)]
        enc = ArithEncoder()
        fixed = [113]
        for mcu, blocks in enumerate(mcus):
            if mcu % (restart or len(mcus) + 1) == 0:
                if mcu:
                    out += enc.flush() + bytes([0xFF, 0xD0 + (mcu // restart - 1) % 8])
                dc_bins, ac_bins = [0] * 64, [0] * 256
                last, ctx = [0] * len(members), [0] * len(members)
            for ci, blk in blocks:
                if not progressive or (ss == 0 and ah == 0):
                    dc = blk[0] >> al
                    st = ctx[ci]
                    diff = dc - last[ci]
                    if diff == 0:
                        enc.encode(dc_bins, st, 0)
                        ctx[ci] = 0
                    else:
                        last[ci] = dc
                        enc.encode(dc_bins, st, 1)
                        m = _arith_value(enc, dc_bins, st, diff, 20, False, fixed)
                        ctx[ci] = _dc_context(m, diff < 0, lower, upper)
                elif ss == 0:
                    enc.encode(fixed, 0, (blk[0] >> al) & 1)
                if progressive and ss == 0:
                    continue
                lo = 1 if not progressive else ss
                hi = 63 if not progressive else se

                def point(k):
                    v = blk[k]
                    return (abs(v) >> al) * (1 if v >= 0 else -1)

                ke = hi
                while ke > 0 and point(ke) == 0:
                    ke -= 1
                kex = 0
                if ah:
                    kex = ke
                    while kex > 0 and (abs(blk[kex]) >> ah) == 0:
                        kex -= 1
                k = lo
                while k <= ke:
                    st = 3 * (k - 1)
                    if not ah or k > kex:
                        enc.encode(ac_bins, st, 0)
                    while True:
                        v = point(k)
                        if v:
                            if ah and abs(v) >> 1:
                                enc.encode(ac_bins, st + 2, abs(v) & 1)
                            elif ah:
                                enc.encode(ac_bins, st + 1, 1)
                                enc.encode(fixed, 0, int(v < 0))
                            else:
                                enc.encode(ac_bins, st + 1, 1)
                                _arith_value(enc, ac_bins, st, v, 189 if k <= kx else 217,
                                             True, fixed)
                            break
                        enc.encode(ac_bins, st + 1, 0)
                        st += 3
                        k += 1
                    k += 1
                if k <= hi:
                    enc.encode(ac_bins, 3 * (k - 1), 1)
        out += enc.flush()
    return bytes(out + b"\xff\xd9")


def _blocks_of(k, factors, my, mx):
    fh, fv = factors[k]
    return [(my * fv + v, mx * fh + hh) for v in range(fv) for hh in range(fh)]


def encode_jpeg_lossless(planes: Sequence[np.ndarray], predictor: int, pt: int = 0,
                         precision: int = 8, ids: Optional[Sequence[int]] = None,
                         restart: int = 0, jfif: bool = False,
                         adobe: Optional[int] = None) -> bytes:
    """A lossless JPEG (SOF3) of full-size component planes of
    ``precision``-bit samples, one interleaved scan with the given predictor
    (1-7) and point transform; the differences in fixed 5-bit codes of
    categories 0-16.  ``restart`` is in MCUs (samples of every component)."""
    h, w = planes[0].shape
    n = len(planes)
    ids = list(ids) if ids is not None else list(range(1, n + 1))
    out = _jpeg_head(planes, [(1, 1)] * n, ids, 0, adobe, jfif, 0xC3, precision)
    symbols = list(range(17))
    out += _segment(0xC4, bytes([0x00]) + bytes([0, 0, 0, 0, 17] + [0] * 11) + bytes(symbols))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    out += _segment(0xDA, bytes([n]) + b"".join(bytes([cid, 0x00]) for cid in ids)
                    + bytes([predictor, 0, pt]))
    assert restart % w == 0, "restart intervals of whole rows"
    x = [p.astype(np.int64) >> pt for p in planes]
    writer = _BitWriter()
    first_row = 0
    for y in range(h):
        for xx in range(w):
            mcu = y * w + xx
            if restart and mcu and mcu % restart == 0:
                out += writer.flush() + bytes([0xFF, 0xD0 + (mcu // restart - 1) % 8])
                first_row = y
            for k in range(n):
                p = x[k]
                if y == first_row:
                    pred = p[y, xx - 1] if xx else 1 << (precision - pt - 1)
                elif xx == 0:
                    pred = p[y - 1, 0]
                else:
                    ra, rb, rc = p[y, xx - 1], p[y - 1, xx], p[y - 1, xx - 1]
                    pred = [0, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                            rb + ((ra - rc) >> 1), (ra + rb) >> 1][predictor]
                diff = (int(p[y, xx]) - int(pred)) & 0xFFFF
                if diff >= 0x8000:
                    diff -= 0x10000
                if diff == -0x8000:
                    writer.put(16, 5)
                    continue
                s, bits = _category(diff)
                writer.put(s, 5)
                writer.put(bits, s)
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


# ----- JPEG 2000 -------------------------------------------------------------

# MQ coder states (ISO/IEC 15444-1 Table C.2): Qe, next after MPS, after LPS, switch
_MQ_STATES = (
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
    (0x0005, 45, 42, 0), (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))
J2K_LAZY, J2K_RESET, J2K_TERMALL, J2K_VSC, J2K_PTERM, J2K_SEGSYM = 1, 2, 4, 8, 16, 32


class _MQEncoder:
    """The MQ encoder of Annex C.2 (ENCODE, RENORME, BYTEOUT, FLUSH) over
    19 contexts started as Part 1 starts them."""

    def __init__(self):
        self.reset()
        self.start()

    def reset(self):
        self.index = [0] * 19
        self.mps = [0] * 19
        self.index[18], self.index[17], self.index[0] = 46, 3, 4

    def start(self):
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.out = bytearray([0])  # the byte before the first, never written

    def _byteout(self):
        if self.out[-1] == 0xFF:
            self.out.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            self.out.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.out[-1] += 1
            if self.out[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                self.out.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self.out.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def encode(self, d: int, cx: int) -> None:
        qe, nmps, nlps, switch = _MQ_STATES[self.index[cx]]
        self.a -= qe
        if d == self.mps[cx]:
            if self.a & 0x8000:
                self.c += qe
                return
            if self.a < qe:
                self.a = qe
            else:
                self.c += qe
            self.index[cx] = nmps
        else:
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if switch:
                self.mps[cx] ^= 1
            self.index[cx] = nlps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def flush(self) -> bytes:
        temp = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= temp:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        out = self.out[1:]
        if out and out[-1] == 0xFF:
            out = out[:-1]
        return bytes(out)


class _RawWriter:
    """Bypass bits, MSB first, seven bits in the byte after a 0xFF."""

    def __init__(self):
        self.out, self.cur, self.n = bytearray(), 0, 0

    def put(self, bit: int) -> None:
        self.cur = (self.cur << 1) | bit
        self.n += 1
        if self.n == (7 if self.out and self.out[-1] == 0xFF else 8):
            self.out.append(self.cur)
            self.cur = self.n = 0

    def flush(self) -> bytes:
        if self.n:
            limit = 7 if self.out and self.out[-1] == 0xFF else 8
            self.out.append(self.cur << (limit - self.n))
            self.cur = self.n = 0
        return bytes(self.out)


def _zc(h: int, v: int, d: int, orient: int) -> int:
    """Zero-coding context (Table D.1); HL swaps the horizontal and vertical
    counts."""
    if orient == 3:
        hv = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if hv else 6
        if d == 1:
            return 3 + min(hv, 2)
        return min(hv, 2)
    if orient == 1:
        h, v = v, h
    if h == 2:
        return 8
    if h == 1:
        return 7 if v else (6 if d else 5)
    if v:
        return 3 + (v == 2)
    return min(d, 2)


def _t1_encode(q: np.ndarray, orient: int, style: int):
    """Tier 1 of one code-block of signed integers ``q``: (number of bit
    planes, [(segment bytes, passes)], per pass the bytes of its segment
    written by its end)."""
    h, w = q.shape
    mag = np.abs(q).astype(np.int64)
    nbits = int(mag.max()).bit_length()
    if nbits == 0:
        return 0, [], []
    sig = np.zeros((h + 2, w + 2), np.int8)
    neg = np.zeros((h + 2, w + 2), np.int8)
    visited = np.zeros((h, w), bool)
    refined = np.zeros((h, w), bool)
    vsc = bool(style & J2K_VSC)
    npasses = 1 + 3 * (nbits - 1)
    mq, raw = _MQEncoder(), None
    segments, ends = [], []
    seg_passes, in_raw = 0, False

    def below(y):  # the row under y is visible to y's contexts
        return not (vsc and y % 4 == 3)

    def counts(y, x):
        Y, X = y + 1, x + 1
        s = sig
        hh = s[Y, X - 1] + s[Y, X + 1]
        vv = s[Y - 1, X] + (s[Y + 1, X] if below(y) else 0)
        dd = s[Y - 1, X - 1] + s[Y - 1, X + 1]
        if below(y):
            dd += s[Y + 1, X - 1] + s[Y + 1, X + 1]
        return int(hh), int(vv), int(dd)

    def sign_ctx(y, x):
        Y, X = y + 1, x + 1

        def contrib(yy, xx):
            return 0 if not sig[yy, xx] else (-1 if neg[yy, xx] else 1)

        hc = max(-1, min(1, contrib(Y, X - 1) + contrib(Y, X + 1)))
        vc = contrib(Y - 1, X) + (contrib(Y + 1, X) if below(y) else 0)
        vc = max(-1, min(1, vc))
        xor = 0
        if hc < 0 or (hc == 0 and vc < 0):
            hc, vc, xor = -hc, -vc, 1
        return 9 + {(1, 1): 4, (1, 0): 3, (1, -1): 2, (0, 1): 1, (0, 0): 0}[(hc, vc)], xor

    def put(bit, cx):
        if in_raw:
            raw.put(bit)
        else:
            mq.encode(bit, cx)

    def code_sig(y, x, p):
        bit = int((mag[y, x] >> p) & 1)
        put(bit, _zc(*counts(y, x), orient))
        if bit:
            code_sign(y, x)

    def code_sign(y, x):
        s = int(q[y, x] < 0)
        if in_raw:
            raw.put(s)
        else:
            cx, xor = sign_ctx(y, x)
            mq.encode(s ^ xor, cx)
        sig[y + 1, x + 1], neg[y + 1, x + 1] = 1, s

    def order():
        for k in range(0, h, 4):
            for x in range(w):
                for y in range(k, min(k + 4, h)):
                    yield y, x

    def sig_pass(p):
        for y, x in order():
            if not sig[y + 1, x + 1] and any(counts(y, x)):
                code_sig(y, x, p)
                visited[y, x] = True

    def ref_pass(p):
        for y, x in order():
            if sig[y + 1, x + 1] and not visited[y, x]:
                if in_raw:
                    cx = 0
                elif refined[y, x]:
                    cx = 16
                else:
                    cx = 15 if any(counts(y, x)) else 14
                put(int((mag[y, x] >> p) & 1), cx)
                refined[y, x] = True

    def clean_pass(p):
        for k in range(0, h, 4):
            for x in range(w):
                ys = list(range(k, min(k + 4, h)))
                quiet = len(ys) == 4 and all(
                    not sig[y + 1, x + 1] and not visited[y, x] and not any(counts(y, x))
                    for y in ys)
                start = 0
                if quiet:
                    hits = [i for i, y in enumerate(ys) if (mag[y, x] >> p) & 1]
                    mq.encode(int(bool(hits)), 17)
                    if not hits:
                        continue
                    run = hits[0]
                    mq.encode(run >> 1, 18)
                    mq.encode(run & 1, 18)
                    code_sign(ys[run], x)
                    start = run + 1
                for y in ys[start:]:
                    if not sig[y + 1, x + 1] and not visited[y, x]:
                        code_sig(y, x, p)
        visited[:] = False
        if style & J2K_SEGSYM:
            for bit in (1, 0, 1, 0):
                mq.encode(bit, 18)

    def maxpasses(index):
        if style & J2K_TERMALL:
            return 1
        if style & J2K_LAZY:
            return 10 if index == 0 else (2 if index % 2 else 1)
        return 109

    def written():
        return len(raw.out) if in_raw else len(mq.out) - 1

    passtype, plane = 2, nbits - 1
    for n in range(npasses):
        if seg_passes == 0:  # a segment starts
            in_raw = bool(style & J2K_LAZY and passtype < 2 and nbits - 1 - plane >= 4)
            if in_raw:
                raw = _RawWriter()
            else:
                mq.start()
        (sig_pass, ref_pass, clean_pass)[passtype](plane)
        if style & J2K_RESET and not in_raw:
            mq.reset()
        seg_passes += 1
        ends.append(written())
        if seg_passes == maxpasses(len(segments)) or n == npasses - 1:
            segments.append((raw.flush() if in_raw else mq.flush(), seg_passes))
            seg_passes = 0
        passtype += 1
        if passtype == 3:
            passtype, plane = 0, plane - 1
    return nbits, segments, ends


class _TagEncoder:
    """A tag tree (B.10.2) for writing: ``opj_tgt_encode``."""

    def __init__(self, values: np.ndarray):
        h, w = values.shape
        self.levels = [values.astype(np.int64)]
        while h * w > 1:
            h, w = (h + 1) // 2, (w + 1) // 2
            prev = self.levels[-1]
            up = np.full((h, w), 1 << 30, np.int64)
            for j in range(prev.shape[0]):
                for i in range(prev.shape[1]):
                    up[j // 2, i // 2] = min(up[j // 2, i // 2], prev[j, i])
            self.levels.append(up)
        self.low = [np.zeros_like(v) for v in self.levels]
        self.known = [np.zeros(v.shape, bool) for v in self.levels]

    def encode(self, bits, j: int, i: int, threshold: int) -> None:
        path = [(lvl, j >> lvl, i >> lvl) for lvl in range(len(self.levels))][::-1]
        low = 0
        for lvl, y, x in path:
            if low > self.low[lvl][y, x]:
                self.low[lvl][y, x] = low
            else:
                low = int(self.low[lvl][y, x])
            while low < threshold:
                if low >= self.levels[lvl][y, x]:
                    if not self.known[lvl][y, x]:
                        bits.put(1)
                        self.known[lvl][y, x] = True
                    break
                bits.put(0)
                low += 1
            self.low[lvl][y, x] = low


class _HeaderBits:
    """Packet-header bits with the stuffing of B.10.1."""

    def __init__(self):
        self.out, self.cur, self.n = bytearray(), 0, 0

    def put(self, bit: int, nbits: int = 1) -> None:
        for k in range(nbits - 1, -1, -1):
            self.cur = (self.cur << 1) | ((bit >> k) & 1)
            self.n += 1
            if self.n == (7 if self.out and self.out[-1] == 0xFF else 8):
                self.out.append(self.cur)
                self.cur = self.n = 0

    def flush(self) -> bytes:
        if self.n:
            limit = 7 if self.out and self.out[-1] == 0xFF else 8
            self.out.append(self.cur << (limit - self.n))
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


def _passes_code(bits, n: int) -> None:
    if n == 1:
        bits.put(0)
    elif n == 2:
        bits.put(0b10, 2)
    elif n <= 5:
        bits.put(0b1100 | (n - 3), 4)
    elif n <= 36:
        bits.put(0b111100000 | (n - 6), 9)
    else:
        bits.put((0b111111111 << 7) | (n - 37), 16)


def _lift(a: np.ndarray, origin: int, reversible: bool) -> np.ndarray:
    """Forward 5/3 (integer) or 9/7 (float) lifting along axis 1, the
    result low samples first: the inverse of what Part 1 decoders do,
    with OpenJPEG's 9/7 scaling (K on the low pass, K/2 on the high)."""
    n = a.shape[1]
    cas = origin % 2
    if n == 1:
        return a * 2 if reversible and cas else a.copy()
    x = a.astype(np.int64 if reversible else np.float64)
    lo, hi = np.arange(cas, n, 2), np.arange(1 - cas, n, 2)

    def nbr(pos):
        left, right = pos - 1, pos + 1
        return np.where(left < 0, 1, left), np.where(right >= n, n - 2, right)

    if reversible:
        l, r = nbr(hi)
        x[:, hi] -= (x[:, l] + x[:, r]) >> 1
        l, r = nbr(lo)
        x[:, lo] += (x[:, l] + x[:, r] + 2) >> 2
    else:
        for pos, c in ((hi, -1.586134342), (lo, -0.052980118), (hi, 0.882911075),
                       (lo, 0.443506852)):
            l, r = nbr(pos)
            x[:, pos] += c * (x[:, l] + x[:, r])
        x[:, lo] /= 1.230174105
        x[:, hi] *= 1.230174105 / 2
    return np.concatenate([x[:, lo], x[:, hi]], axis=1)


def _forward_dwt(tc: np.ndarray, x0: int, y0: int, levels: int, reversible: bool):
    """The Mallat layout of ``levels`` forward levels on a tile-component
    whose origin is (x0, y0)."""
    out = tc.astype(np.int64 if reversible else np.float64)
    h, w = out.shape
    for lvl in range(levels):
        rx0, ry0 = -(-x0 >> lvl), -(-y0 >> lvl)
        rw = -(-(x0 + w) >> lvl) - rx0
        rh = -(-(y0 + h) >> lvl) - ry0
        if rw and rh:
            out[:rh, :rw] = _lift(out[:rh, :rw].T, ry0, reversible).T
            out[:rh, :rw] = _lift(out[:rh, :rw], rx0, reversible)
    return out


def j2k_segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def cbd_segment(depths: Sequence[Tuple[int, bool]], count: Optional[int] = None) -> bytes:
    """A Part 2 ``CBD`` segment: ``Ncbd`` (``count``, default the number of
    ``depths``) and each component's (bits, signed)."""
    ncbd = len(depths) if count is None else count
    return j2k_segment(0xFF78, struct.pack(">H", ncbd) + bytes(
        (bits - 1) | (0x80 if signed else 0) for bits, signed in depths))


_MCT_DTYPES = (">i2", ">i4", ">f4", ">f8")


def mct_segment(index: int, array_type: int, element_type: int, values=(), zmct: int = 0,
                ymct: int = 0, body: Optional[bytes] = None) -> bytes:
    """A Part 2 ``MCT`` segment: ``Zmct``, ``Imct`` (index, array type 0
    dependency / 1 decorrelation / 2 offset, element type 0 int16 / 1
    int32 / 2 float32 / 3 float64), ``Ymct`` and ``values`` in that type
    (or ``body`` as given)."""
    if body is None:
        body = np.asarray(values).astype(_MCT_DTYPES[element_type]).tobytes()
    imct = index | (array_type << 8) | (element_type << 10)
    return j2k_segment(0xFF74, struct.pack(">HHH", zmct, imct, ymct) + body)


def mcc_segment(index: int, ncomp: int, decorrelation: int = 0, offset: int = 0,
                reversible: bool = False, collections: int = 1, kind: int = 1,
                order: Optional[Sequence[int]] = None, wide: bool = False, zmcc: int = 0,
                ymcc: int = 0, outputs: Optional[int] = None, tail: bytes = b"") -> bytes:
    """A Part 2 ``MCC`` segment: ``Zmcc``, ``Imcc``, ``Ymcc``, ``Qmcc``
    (``collections``), then each collection: ``Xmcc`` (``kind``, 1 array
    decorrelation), ``Nmcc`` input components (``order``, default 0, 1,
    ...; 16-bit numbers if ``wide``), ``Mmcc`` outputs (``outputs``
    components, default ``ncomp``) in the same order, and ``Tmcc`` (the
    reversible bit, the offset and decorrelation arrays' indices);
    ``tail`` bytes after."""
    order = list(range(ncomp)) if order is None else list(order)
    width = 2 if wide else 1
    comps = b"".join(k.to_bytes(width, "big") for k in order)
    out = ncomp if outputs is None else outputs
    one = (bytes([kind]) + struct.pack(">H", ncomp | (0x8000 if wide else 0)) + comps
           + struct.pack(">H", out | (0x8000 if wide else 0)) + comps
           + bytes([int(reversible), offset, decorrelation]))
    return j2k_segment(0xFF75, struct.pack(">HBHH", zmcc, index, ymcc, collections)
                       + one * collections + tail)


def mco_segment(stages: Sequence[int], count: Optional[int] = None) -> bytes:
    """A Part 2 ``MCO`` segment: ``Nmco`` (``count``, default the number of
    ``stages``) and the ``MCC`` index of each stage."""
    return j2k_segment(0xFF77, bytes([len(stages) if count is None else count]) + bytes(stages))


def part2_identity(ncomp: int = 3, prec: int = 8, element_type: int = 2) -> List[bytes]:
    """``CBD`` at ``prec`` unsigned bits, an identity decorrelation matrix
    (index 1), offsets of the level shift ``2 ** (prec - 1)`` (index 2),
    the ``MCC`` collection that names both (index 1) and the ``MCO`` stage
    that applies it: segments that leave a lossless image as it was."""
    return [cbd_segment([(prec, False)] * ncomp),
            mct_segment(1, 1, element_type, np.eye(ncomp).ravel()),
            mct_segment(2, 2, element_type, [1 << (prec - 1)] * ncomp),
            mcc_segment(1, ncomp, decorrelation=1, offset=2),
            mco_segment([1])]


class OpjCmptParm(ctypes.Structure):
    """``opj_image_cmptparm_t`` (OpenJPEG 2.5)."""
    _fields_ = [(name, ctypes.c_uint32)
                for name in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class OpjImageComp(ctypes.Structure):
    """``opj_image_comp_t`` (OpenJPEG 2.5)."""
    _fields_ = [(name, ctypes.c_uint32) for name in (
        "dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd", "resno_decoded", "factor")] + [
        ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class OpjImage(ctypes.Structure):
    """``opj_image_t`` (OpenJPEG 2.5)."""
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32), ("x1", ctypes.c_uint32),
                ("y1", ctypes.c_uint32), ("numcomps", ctypes.c_uint32),
                ("color_space", ctypes.c_int), ("comps", ctypes.POINTER(OpjImageComp)),
                ("icc_profile_buf", ctypes.c_void_p), ("icc_profile_len", ctypes.c_uint32)]


def libopenjp2():
    """The OpenJPEG 2.5 that Pillow ships, through ``ctypes``."""
    import glob
    import os

    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libopenjp2-*.so*"))[0])
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    for name, args, res in (
            ("opj_set_default_encoder_parameters", [ptr], None),
            ("opj_set_MCT", [ptr, ptr, ptr, u32], i32),
            ("opj_image_create", [u32, ctypes.POINTER(OpjCmptParm), i32],
             ctypes.POINTER(OpjImage)),
            ("opj_image_destroy", [ctypes.POINTER(OpjImage)], None),
            ("opj_create_compress", [i32], ptr),
            ("opj_destroy_codec", [ptr], None),
            ("opj_stream_create_default_file_stream", [ctypes.c_char_p, i32], ptr),
            ("opj_stream_destroy", [ptr], None),
            ("opj_setup_encoder", [ptr, ptr, ctypes.POINTER(OpjImage)], i32),
            ("opj_start_compress", [ptr, ctypes.POINTER(OpjImage), ptr], i32),
            ("opj_encode", [ptr, ptr], i32),
            ("opj_end_compress", [ptr, ptr], i32)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = res
    return lib


def openjpeg_part2(planes: Sequence[np.ndarray], matrix: np.ndarray,
                   shifts: Optional[Sequence[int]] = None, jp2: bool = False) -> bytes:
    """A Part 2 file from OpenJPEG's own encoder: ``opj_set_MCT`` with the
    encoding ``matrix`` (float32, components x components) and the level
    ``shifts`` (default ``2 ** 7`` each), which writes ``MCT``, ``MCC`` and
    ``MCO`` and a ``COD`` of the custom transform (``mct`` 2), 9/7, on the
    encoder's other defaults (six resolutions: 32 x 32 pixels or more).
    ``planes``: 8-bit unsigned, one a component;
    ``jp2`` wraps the codestream in a JP2 file.  The parameters are
    ``opj_cparameters_t``, which the library lays out and fills itself
    (``opj_set_default_encoder_parameters`` into a buffer larger than it)."""
    import os
    import tempfile

    lib = libopenjp2()
    n = len(planes)
    h, w = planes[0].shape
    params = ctypes.create_string_buffer(1 << 16)
    lib.opj_set_default_encoder_parameters(params)
    mat = np.ascontiguousarray(matrix, np.float32)
    dc = np.ascontiguousarray([128] * n if shifts is None else shifts, np.int32)
    assert lib.opj_set_MCT(params, mat.ctypes.data_as(ctypes.c_void_p),
                           dc.ctypes.data_as(ctypes.c_void_p), n)
    cmpt = (OpjCmptParm * n)(*[OpjCmptParm(1, 1, w, h, 0, 0, 8, 8, 0) for _ in range(n)])
    image = lib.opj_image_create(n, cmpt, 1 if n >= 3 else 2)  # sRGB, grey
    assert image
    img = image.contents
    img.x0, img.y0, img.x1, img.y1 = 0, 0, w, h
    for k, plane in enumerate(planes):
        data = np.ascontiguousarray(plane, np.int32).ravel()
        ctypes.memmove(img.comps[k].data, data.ctypes.data, data.nbytes)
    codec = lib.opj_create_compress(2 if jp2 else 0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.jp2" if jp2 else "out.j2k")
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        try:
            assert lib.opj_setup_encoder(codec, params, image)
            assert lib.opj_start_compress(codec, image, stream)
            assert lib.opj_encode(codec, stream)
            assert lib.opj_end_compress(codec, stream)
        finally:
            lib.opj_stream_destroy(stream)
            lib.opj_destroy_codec(codec)
            lib.opj_image_destroy(image)
        with open(path, "rb") as f:
            return f.read()


# ----- HTJ2K (ISO/IEC 15444-15) code-blocks --------------------------------------

J2K_HT = 0x40
HT_TABLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "molnextr_tpu_torch", "data", "j2k_ht.npz")
_MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)


def ht_codewords(initial: bool) -> Dict[Tuple[int, int, int, int, int], Tuple[int, int]]:
    """The cleanup pass's context VLC codes for writing: (context, rho,
    u_off, e_k, e_1) -> (codeword, length), the decoder's 1024-entry table
    of the first line pair of quads (``initial``) or of the others turned
    round (``data/j2k_ht.npz``: entries ``e_k << 12 | e_1 << 8 | rho << 4 |
    u_off << 3 | length`` indexed by context and the next 7 bits)."""
    with np.load(HT_TABLES) as z:
        table = z["vlc_initial" if initial else "vlc_later"].astype(np.int64)
    codes = {}
    for index, entry in enumerate(table):
        length = int(entry & 7)
        key = (index >> 7, int(entry >> 4) & 15, int(entry >> 3) & 1, int(entry >> 12),
               int(entry >> 8) & 15)
        codes[key] = ((index & 127) & ((1 << length) - 1), length)
    return codes


def _ht_choices(codes) -> Dict[Tuple[int, int, int, int], Tuple[int, int, int]]:
    """(context, rho, u_off, EMB pattern) -> (codeword, length, e_k): the
    code whose e_k covers most samples among those that fit (OpenJPH's
    choice), the shorter of equals."""
    best = {}
    for (c, rho, u_off, e_k, e_1), (cwd, length) in codes.items():
        for emb in range(16) if u_off else (0,):
            if emb & ~rho or (emb & e_k) != e_1 or (u_off and not emb):
                continue
            rank = (bin(e_k).count("1"), -length)
            key = (c, rho, u_off, emb)
            if key not in best or rank > best[key][0]:
                best[key] = (rank, cwd, length, e_k)
    return {k: v[1:] for k, v in best.items()}


@functools.lru_cache(maxsize=None)
def ht_tables():
    """The writer's codes for the first line pair and for the others."""
    return _ht_choices(ht_codewords(True)), _ht_choices(ht_codewords(False))


class HTMel:
    """The MEL coder (T.814 clause 7.3.3): runs of events, MSB first, seven
    bits in the byte after a 0xFF."""

    def __init__(self):
        self.out, self.tmp, self.rem, self.run, self.k = bytearray(), 0, 8, 0, 0

    def _bit(self, bit: int) -> None:
        self.tmp = (self.tmp << 1) | bit
        self.rem -= 1
        if self.rem == 0:
            self.out.append(self.tmp)
            self.rem = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def encode(self, event: int) -> None:
        e = _MEL_EXP[self.k]
        if not event:
            self.run += 1
            if self.run == 1 << e:
                self._bit(1)
                self.run, self.k = 0, min(12, self.k + 1)
            return
        self._bit(0)
        for t in range(e - 1, -1, -1):
            self._bit((self.run >> t) & 1)
        self.run, self.k = 0, max(0, self.k - 1)


class HTBackward:
    """A stream written from the end of its segment towards its start, LSB
    first (the cleanup's VLC and the MagRef pass): a byte that follows one
    above 0x8F in reading order holds seven bits if they are all ones (its
    MSB a stuffed 0).  The VLC stream opens in the low nibble of the byte
    before the segment's last, both kept for ``Scup`` (``vlc=True``)."""

    def __init__(self, vlc: bool):
        self.out = bytearray([0xFF]) if vlc else bytearray()
        self.tmp, self.used, self.gt8f = (0xF, 4, True) if vlc else (0, 0, True)

    def put(self, cwd: int, n: int) -> None:
        while n > 0:
            avail = 8 - self.gt8f - self.used
            t = min(avail, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            cwd >>= t
            n -= t
            if avail == t:
                if self.gt8f and self.tmp != 0x7F:
                    self.gt8f = False
                    continue
                self.out.append(self.tmp)
                self.gt8f = self.tmp > 0x8F
                self.tmp = self.used = 0

    def flush(self) -> bytes:
        """The stream in segment order (MagRef: its last byte zero-padded)."""
        if self.used:
            self.out.append(self.tmp)
            self.tmp = self.used = 0
        return bytes(self.out[::-1])


class HTForward:
    """A stream written forward, LSB first, seven bits in the byte after a
    0xFF (the cleanup's MagSgn and the SigProp pass)."""

    def __init__(self):
        self.out, self.tmp, self.used, self.max = bytearray(), 0, 0, 8

    def put(self, cwd: int, n: int) -> None:
        while n > 0:
            t = min(self.max - self.used, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            cwd >>= t
            n -= t
            if self.used == self.max:
                self.out.append(self.tmp)
                self.max = 7 if self.tmp == 0xFF else 8
                self.tmp = self.used = 0

    def flush(self, pad_ones: bool) -> bytes:
        """MagSgn is padded with ones and never ends in 0xFF; SigProp's last
        byte is padded with zeros."""
        if self.used:
            if pad_ones:
                self.tmp |= ((1 << (self.max - self.used)) - 1) << self.used
            if self.tmp != 0xFF or not pad_ones:
                self.out.append(self.tmp)
        elif pad_ones and self.max == 7:
            self.out.pop()
        self.used = 0
        return bytes(self.out)


def _uvlc(u: int) -> Tuple[int, int, int, int]:
    """(prefix, its length, suffix, its length) of u_q >= 1 (T.814 table 3:
    "1", "01", "001" with one suffix bit, "000" with five)."""
    if u <= 2:
        return (1, 1, 0, 0) if u == 1 else (2, 2, 0, 0)
    if u <= 4:
        return 4, 3, u - 3, 1
    assert u - 5 < 28, "u_q past the suffix (u_ext) is not written"
    return 0, 3, u - 5, 5


def _ht_join(mel: HTMel, vlc: HTBackward) -> Tuple[bytes, bytes]:
    """The MEL and VLC streams' last bytes, fused into one where their bits
    fit (OpenJPH's ``terminate_mel_vlc``)."""
    if mel.run:
        mel._bit(1)
    mel_tmp = (mel.tmp << mel.rem) & 0xFF
    mel_mask = (0xFF << mel.rem) & 0xFF
    vlc_mask = 0xFF >> (8 - vlc.used)
    if mel_mask | vlc_mask:
        fuse = mel_tmp | vlc.tmp
        if (not ((fuse ^ mel_tmp) & mel_mask | (fuse ^ vlc.tmp) & vlc_mask)
                and fuse != 0xFF and len(vlc.out) > 1):
            mel.out.append(fuse)
        else:
            mel.out.append(mel_tmp)
            vlc.out.append(vlc.tmp)
        vlc.used = 0
    return bytes(mel.out), bytes(vlc.out[::-1])


def ht_cleanup(mu: np.ndarray, neg: np.ndarray, codes=None) -> bytes:
    """The HT cleanup segment of magnitudes ``mu`` (the bits of each sample
    from the cleanup's plane up) and signs ``neg``: MagSgn, MEL and VLC
    streams, ``Scup`` in the last two bytes (T.814 clause 7)."""
    h, w = mu.shape
    qh, qw = (h + 1) // 2, (w + 1) // 2
    m = np.zeros((2 * qh, 2 * qw), np.int64)
    m[:h, :w] = mu
    s = np.zeros(m.shape, np.int64)
    s[:h, :w] = neg
    e = np.zeros(m.shape, np.int64)
    nz = m > 0
    e[nz] = np.array([int(v).bit_length() for v in (2 * m[nz] - 1)], np.int64)
    codes = codes or ht_tables()
    mel, vlc, ms = HTMel(), HTBackward(True), HTForward()
    # per quad: samples in the order TL, BL, TR, BR
    def quad(y, x):
        return [(2 * y, 2 * x), (2 * y + 1, 2 * x), (2 * y, 2 * x + 1), (2 * y + 1, 2 * x + 1)]

    for qy in range(qh):
        first = qy == 0
        table = codes[0] if first else codes[1]
        up = e[2 * qy - 1] if not first else None
        prev_rho = 0
        for qx0 in range(0, qw, 2):
            pair = []
            for qx in (qx0, qx0 + 1):
                if qx >= qw:
                    continue
                cells = quad(qy, qx)
                rho = sum(1 << n for n, (y, x) in enumerate(cells) if m[y, x])
                if first:
                    c_q = (prev_rho & 1 | (prev_rho >> 1) & 1) | ((prev_rho >> 2) & 3) << 1
                else:
                    nw = [2 * qx - 1, 2 * qx]
                    ne = [2 * qx + 1, 2 * qx + 2]
                    above = lambda cols: any(0 <= c < 2 * qw and up[c] for c in cols)
                    c_q = (int(above(nw)) | (2 if prev_rho & 12 else 0)
                           | (4 if above(ne) else 0))
                es = [int(e[y, x]) for y, x in cells]
                emax = max(es)
                kappa = 1
                if not first and rho & (rho - 1):
                    eup = max(int(up[c]) for c in range(max(2 * qx - 1, 0),
                                                        min(2 * qx + 3, 2 * qw)))
                    kappa = max(1, eup - 1)
                big_u = max(emax, kappa)
                u_q = big_u - kappa
                u_off = int(u_q > 0)
                emb = sum(1 << n for n in range(4) if u_off and es[n] == big_u)
                if c_q == 0:
                    mel.encode(int(rho != 0))
                e_k = 0
                if c_q or rho:
                    cwd, length, e_k = table[(c_q, rho, u_off, emb)]
                    vlc.put(cwd, length)
                pair.append((cells, rho, big_u, u_q, u_off, e_k))
                prev_rho = rho
            # u_q of the pair
            uo = [p[4] for p in pair] + [0]
            if uo[0] and uo[1]:
                u1, u2 = pair[0][3], pair[1][3]
                if first:
                    both = u1 > 2 and u2 > 2
                    mel.encode(int(both))
                    if both:
                        a, b = _uvlc(u1 - 2), _uvlc(u2 - 2)
                        vlc.put(a[0], a[1]), vlc.put(b[0], b[1])
                        vlc.put(a[2], a[3]), vlc.put(b[2], b[3])
                    elif u1 > 2:
                        a = _uvlc(u1)
                        vlc.put(a[0], a[1])
                        vlc.put(u2 - 1, 1)
                        vlc.put(a[2], a[3])
                    else:
                        a, b = _uvlc(u1), _uvlc(u2)
                        vlc.put(a[0], a[1]), vlc.put(b[0], b[1])
                        vlc.put(a[2], a[3]), vlc.put(b[2], b[3])
                else:
                    a, b = _uvlc(u1), _uvlc(u2)
                    vlc.put(a[0], a[1]), vlc.put(b[0], b[1])
                    vlc.put(a[2], a[3]), vlc.put(b[2], b[3])
            elif uo[0] or uo[1]:
                a = _uvlc(pair[0][3] if uo[0] else pair[1][3])
                vlc.put(a[0], a[1])
                vlc.put(a[2], a[3])
            # magnitudes and signs
            for cells, rho, big_u, u_q, u_off, e_k in pair:
                for n, (y, x) in enumerate(cells):
                    if rho >> n & 1:
                        bits = big_u - (e_k >> n & 1)
                        vlc_val = ((int(m[y, x]) - 1) << 1) | int(s[y, x])
                        ms.put(vlc_val & ((1 << bits) - 1), bits)
    magsgn = ms.flush(True)
    mel_bytes, vlc_bytes = _ht_join(mel, vlc)
    seg = bytearray(magsgn + mel_bytes + vlc_bytes)
    scup = len(mel_bytes) + len(vlc_bytes)
    assert 2 <= scup <= 4079, scup
    seg[-1] = scup >> 4
    seg[-2] = (seg[-2] & 0xF0) | (scup & 0xF)
    return bytes(seg)


def ht_sigprop(mag: np.ndarray, sig: np.ndarray, neg: np.ndarray, plane: int,
               vsc: bool) -> Tuple[bytes, np.ndarray, int]:
    """The HT SigProp pass of bit-plane ``plane``: stripes of four rows,
    each in groups of four columns, a significance bit for every sample
    not significant in the cleanup that has a significant neighbour (the
    cleanup's anywhere, this pass's before it; with ``vsc`` none from the
    stripe below), then the signs of the group's new ones.  Returns the
    bytes, the new significance and how many set bits had no member."""
    h, w = mag.shape
    old = np.zeros((h + 2, w + 2), bool)
    old[1:-1, 1:-1] = sig
    new = np.zeros_like(old)
    out, lost = HTForward(), 0
    for y0 in range(0, h, 4):
        y1 = min(y0 + 4, h)
        for x0 in range(0, w, 4):
            found = []
            for x in range(x0, min(x0 + 4, w)):
                for y in range(y0, y1):
                    if sig[y, x]:
                        continue
                    win = old[y : y + 3, x : x + 3] | new[y : y + 3, x : x + 3]
                    if vsc and y == y0 + 3:
                        win = win[:2]
                    bit = int(mag[y, x] >> plane) & 1
                    if not win.any():
                        lost += bit
                        continue
                    out.put(bit, 1)
                    if bit:
                        new[y + 1, x + 1] = True
                        found.append((y, x))
            for y, x in found:
                out.put(int(neg[y, x]), 1)
    return out.flush(False), new[1:-1, 1:-1], lost


def ht_magref(mag: np.ndarray, sig: np.ndarray, plane: int) -> bytes:
    """The HT MagRef pass of bit-plane ``plane``: a bit for each sample
    significant in the cleanup, stripe by stripe, column by column,
    written backward from the refinement segment's end."""
    h, w = mag.shape
    out = HTBackward(False)
    for y0 in range(0, h, 4):
        for x in range(w):
            for y in range(y0, min(y0 + 4, h)):
                if sig[y, x]:
                    out.put(int(mag[y, x] >> plane) & 1, 1)
    return out.flush()


def ht_encode(q: np.ndarray, p: int, passes: int = 1, vsc: bool = False, codes=None):
    """One HT code-block of signed integers ``q`` whose cleanup pass codes
    the bits from plane ``p - 1`` up (OpenJPEG's ``p``: the block's
    zero bit-planes are Mb - p), with the SigProp (``passes`` 2) and MagRef
    (3) passes of plane ``p - 2``: (cleanup segment, SigProp bytes, MagRef
    bytes, set bits SigProp could not reach), or None for a block with
    nothing to code."""
    mag = np.abs(q).astype(np.int64)
    neg = q < 0
    mu = mag >> (p - 1)
    sig = mu > 0
    if not sig.any():
        return None
    cleanup = ht_cleanup(mu, neg & sig, codes)
    sp = mr = b""
    lost = 0
    if passes >= 2:
        sp, _, lost = ht_sigprop(mag, sig, neg, p - 2, vsc)
    if passes >= 3:
        mr = ht_magref(mag, sig, p - 2)
    return cleanup, sp, mr, lost


def encode_j2k(planes: Sequence[np.ndarray], *, prec: int = 8, sub=None, tile=None,
               numres: int = 3, cblk: Tuple[int, int] = (4, 4), style: int = 0,
               reversible: bool = True, mct: int = 0, layers: int = 1, progression: int = 0,
               pocs: Sequence[Tuple[int, int, int, int, int, int]] = (), sop: bool = False,
               eph: bool = False, headers: str = "packets", parts: int = 1,
               interleave: bool = False, coc: Optional[Dict[int, dict]] = None,
               qntsty: int = 0, expn0: Optional[int] = None, mant: int = 0,
               roi: Optional[Dict[int, Tuple[int, int, int, int]]] = None,
               tile_markers: bool = False, comment: Optional[bytes] = None,
               main_markers: Sequence[bytes] = (), tile_header: Sequence[bytes] = (),
               eoc: bool = True, ht_passes: int = 1, ht_drop: int = 0,
               cap: bool = True,
               precincts: Optional[Sequence[Tuple[int, int]]] = None) -> bytes:
    """A JPEG 2000 codestream (Part 1) of unsigned ``planes`` of ``prec``
    bits, one precinct per resolution unless ``precincts`` gives each
    resolution's (log2 width, log2 height), lowest first (then LRCP or
    RLCP only):

    * ``sub``: per component (XRsiz, YRsiz), each plane already at its size;
      ``tile``: (width, height) of the tiles;
    * ``numres``, ``cblk`` (log2 width, height), ``style`` (the ``J2K_*``
      code-block bits), ``reversible`` (5/3, or 9/7 with scalar
      quantisation, ``qntsty`` 1 derived or 2 expounded from ``expn0`` and
      ``mant``); ``coc``: component -> overrides of those keys, written as
      ``COC``/``QCC``;
    * ``mct`` (RCT or ICT on the first three), ``layers`` (passes spread
      over them), ``progression`` (0-4: LRCP, RLCP, RPCL, PCRL, CPRL) and
      ``pocs`` (resno0, compno0, layno1, resno1, compno1, order);
    * ``sop``/``eph`` markers; ``headers``: "packets", "ppm" or "ppt";
      ``parts`` tile-parts a tile, ``interleave`` them across tiles;
    * ``roi``: component -> a rectangle (x0, y0, x1, y1) on its grid,
      coded with the max-shift method (``RGN``); ``tile_markers`` puts
      ``COC``, ``QCC``, ``RGN`` and ``POC`` in the first tile-part
      headers instead of the main header; ``main_markers``: whole marker
      segments put at the end of the main header (``TLM``, ``PLM``, ``CRG``,
      unknown ones), ``tile_header`` at the start of each tile's first
      tile-part header;
    * HTJ2K (``style`` with ``J2K_HT``, Part 15): each code-block's cleanup
      pass codes its bits down to plane ``ht_drop`` (``ht_passes`` 1) or
      ``ht_drop + 1``, with the SigProp (``ht_passes`` 2) and MagRef (3)
      passes of plane ``ht_drop``, at most up to the band's top plane; a
      5/3 block whose SigProp would miss a set bit is coded by its cleanup
      alone, so 5/3 stays lossless at ``ht_drop`` 0.  A ``CAP`` marker
      (``Pcap`` bit 15, ``Ccap15``) follows ``SIZ`` unless ``cap`` is
      False."""
    ncomp = len(planes)
    sub = sub or [(1, 1)] * ncomp
    height = max(p.shape[0] * s[1] for p, s in zip(planes, sub))
    width = max(p.shape[1] * s[0] for p, s in zip(planes, sub))
    height = min(height, planes[0].shape[0] * sub[0][1])
    width = min(width, planes[0].shape[1] * sub[0][0])
    tw, th = tile or (width, height)
    base = dict(numres=numres, cblk=cblk, style=style, reversible=reversible, qntsty=qntsty,
                expn0=expn0, mant=mant)
    cp = [dict(base, **((coc or {}).get(c, {}))) for c in range(ncomp)]
    roi = roi or {}
    # forward transforms, per tile and component: the integer coefficients of each band
    ntx, nty = -(-width // tw), -(-height // th)
    shifted = [p.astype(np.float64) - (1 << (prec - 1)) for p in planes]
    if mct and ncomp >= 3:
        r, g, b = shifted[:3]
        if cp[0]["reversible"]:
            shifted[:3] = [np.floor((r + 2 * g + b) / 4), b - g, r - g]
        else:
            shifted[:3] = [0.299 * r + 0.587 * g + 0.114 * b,
                           -0.16875 * r - 0.33126 * g + 0.5 * b,
                           0.5 * r - 0.41869 * g - 0.08131 * b]
    tiles = []
    for t in range(ntx * nty):
        tx0, ty0 = (t % ntx) * tw, (t // ntx) * th
        tx1, ty1 = min(tx0 + tw, width), min(ty0 + th, height)
        comps = []
        for c in range(ncomp):
            dx, dy = sub[c]
            p = cp[c]
            x0, y0, x1, y1 = -(-tx0 // dx), -(-ty0 // dy), -(-tx1 // dx), -(-ty1 // dy)
            coeffs = _forward_dwt(shifted[c][y0:y1, x0:x1], x0, y0, p["numres"] - 1,
                                  p["reversible"])
            comps.append((x0, y0, x1, y1, coeffs))
        tiles.append(((tx0, ty0, tx1, ty1), comps))

    def bands(c, x0, y0, x1, y1):
        """(resno, bandno, band rectangle, offset in the Mallat layout)."""
        n = cp[c]["numres"]
        out = []
        for r in range(n):
            lvl = n - 1 - r
            if r == 0:
                out.append((0, 0, (-(-x0 >> lvl), -(-y0 >> lvl), -(-x1 >> lvl), -(-y1 >> lvl)),
                            (0, 0)))
                continue
            pw = -(-x1 >> (lvl + 1)) - -(-x0 >> (lvl + 1))
            ph = -(-y1 >> (lvl + 1)) - -(-y0 >> (lvl + 1))
            for b in (1, 2, 3):
                xb, yb = b & 1, b >> 1
                rect = tuple(-(-(v - (o << lvl)) >> (lvl + 1))
                             for v, o in ((x0, xb), (y0, yb), (x1, xb), (y1, yb)))
                out.append((r, b, rect, (pw if xb else 0, ph if yb else 0)))
        return out

    # steps and guard bits per component
    steps = []
    for c in range(ncomp):
        p = cp[c]
        if p["reversible"]:
            steps.append(None)
            continue
        e0 = p["expn0"] if p["expn0"] is not None else prec + 1
        nb = 3 * p["numres"] - 2
        if p["qntsty"] == 1:
            ex = [e0] + [max(e0 - (b - 1) // 3, 0) for b in range(1, nb)]
        else:
            ex = [e0 + (0 if b == 0 else min(2, (b - 1) % 3 + 1) // 2) for b in range(nb)]
        steps.append([(e, p["mant"]) for e in ex])
    # quantised code-block coefficients, and the ROI shift per component
    blocks = {}
    need = [0] * ncomp
    shifts = {}
    for t, (_, comps) in enumerate(tiles):
        for c, (x0, y0, x1, y1, coeffs) in enumerate(comps):
            p = cp[c]
            for i, (r, b, (bx0, by0, bx1, by1), (ox, oy)) in enumerate(bands(c, x0, y0, x1, y1)):
                band = coeffs[oy : oy + by1 - by0, ox : ox + bx1 - bx0]
                if not p["reversible"]:
                    e, m = steps[c][i]
                    delta = (1 + m / 2048) * 2.0 ** (prec - e)
                    band = np.sign(band) * np.floor(np.abs(band) / delta)
                band = band.astype(np.int64)
                if c in roi:
                    lvl = p["numres"] - 1 - r if r else p["numres"] - 1
                    rx0, ry0, rx1, ry1 = (v >> (lvl + (1 if r else 0)) for v in roi[c])
                    mask = np.zeros(band.shape, bool)
                    mask[max(ry0 - by0, 0) : max(ry1 - by0 + 1, 0),
                         max(rx0 - bx0, 0) : max(rx1 - bx0 + 1, 0)] = True
                    back = np.abs(band[~mask]).max() if (~mask).any() else 0
                    shifts[c] = max(shifts.get(c, 1), int(back).bit_length() + 1)
                    blocks[(t, c, i)] = (band, mask)
                else:
                    blocks[(t, c, i)] = (band, None)
    for key, (band, mask) in blocks.items():
        c = key[1]
        if mask is not None:
            band = np.where(mask, band << shifts[c], band)
        blocks[key] = band
        need[c] = max(need[c], int(np.abs(band).max(initial=0)).bit_length() - shifts.get(c, 0))
    qcd = []
    for c in range(ncomp):
        p = cp[c]
        nb = 3 * p["numres"] - 2
        if p["reversible"]:
            guard = 2
            ex = [max(need[c] - guard + 1, 0)] * nb
            body = bytes([guard << 5]) + bytes(e << 3 for e in ex)
            mbs = [e + guard - 1 for e in ex]
        else:
            ex = [e for e, _ in steps[c]]
            guard = min(7, max(1, max(need[c] - e + 1 for e in ex)))
            mbs = [e + guard - 1 for e in ex]
            if p["qntsty"] == 1:
                body = bytes([1 | guard << 5]) + struct.pack(">H", ex[0] << 11 | p["mant"])
            else:
                body = bytes([2 | guard << 5]) + b"".join(
                    struct.pack(">H", e << 11 | p["mant"]) for e in ex)
        qcd.append((body, mbs))

    ht_codes = ht_tables() if any(p["style"] & J2K_HT for p in cp) else None

    def spcod(p):
        return bytes([p["numres"] - 1, p["cblk"][0] - 2, p["cblk"][1] - 2, p["style"],
                      int(p["reversible"])]) + bytes(
            ppx | ppy << 4 for ppx, ppy in (precincts or [])[: p["numres"]])

    def precinct_grid(c, r, x0, y0, x1, y1):
        """Resolution ``r`` of a tile-component: (precincts across, down,
        their origin and log2 size in the coordinates of its bands)."""
        lvl = cp[c]["numres"] - 1 - r
        ppx, ppy = precincts[r] if precincts else (15, 15)
        rx0, ry0, rx1, ry1 = (-(-v >> lvl) for v in (x0, y0, x1, y1))
        pw = 0 if rx0 == rx1 else -(-rx1 >> ppx) - (rx0 >> ppx)
        ph = 0 if ry0 == ry1 else -(-ry1 >> ppy) - (ry0 >> ppy)
        gx0, gy0 = (rx0 >> ppx) << ppx, (ry0 >> ppy) << ppy
        if r:
            return pw, ph, -(-gx0 >> 1), -(-gy0 >> 1), ppx - 1, ppy - 1
        return pw, ph, gx0, gy0, ppx, ppy

    # code-blocks, passes and layers per tile
    def code_blocks(t, c, i, rect, grid):
        """The band's code-blocks, row by row, each with its precinct."""
        p = cp[c]
        bx0, by0, bx1, by1 = rect
        pw, _, gx0, gy0, ppx, ppy = grid
        cw, ch = min(p["cblk"][0], ppx), min(p["cblk"][1], ppy)
        band = blocks[(t, c, i)]
        out = []
        for gy in range((by0 >> ch) << ch, by1, 1 << ch):
            row = []
            for gx in range((bx0 >> cw) << cw, bx1, 1 << cw):
                k = ((max(gy, by0) - gy0) >> ppy) * pw + ((max(gx, bx0) - gx0) >> ppx)
                ya, yb = max(gy, by0), min(gy + (1 << ch), by1)
                xa, xb = max(gx, bx0), min(gx + (1 << cw), bx1)
                q = band[ya - by0 : yb - by0, xa - bx0 : xb - bx0]
                r, b = bands(c, 0, 0, 1, 1)[i][:2]
                if not q.size:  # an empty band's: never written
                    row.append((k, (0, [], [], 0)))
                elif p["style"] & J2K_HT:
                    row.append((k, ht_block(q, qcd[c][1][i] + shifts.get(c, 0), p)))
                else:
                    nbits, segs, ends = _t1_encode(q, b, p["style"])
                    row.append((k, (nbits, segs, ends, 1 + 3 * (nbits - 1) if nbits else 0)))
            out.append(row)
        return out

    def ht_block(q, mb, p):
        """(p, segments, ends, passes) of an HT code-block."""
        passes = ht_passes
        top = min(1 + ht_drop + (passes > 1), mb)
        if top < 2:
            passes = 1
        coded = ht_encode(q, top, passes, bool(p["style"] & J2K_VSC), ht_codes)
        missed = coded[3] if coded else q.any()
        if passes > 1 and missed and p["reversible"] and ht_drop == 0:
            top, passes = 1, 1
            coded = ht_encode(q, top, passes, False, ht_codes)
        if coded is None:
            return 0, [], [], 0
        cleanup, sp, mr, _ = coded
        segs = [(cleanup, 1)] + ([(sp + mr, passes - 1)] if passes > 1 else [])
        ends = [len(cleanup), len(sp), len(sp) + len(mr)][:passes]
        return top, segs, ends, passes

    def split_layers(npasses):
        return [(l * npasses // layers, (l + 1) * npasses // layers) for l in range(layers)]

    def segment_pieces(nbits, segments, ends, u, v, exact):
        """(passes, bytes) of each segment part in passes [u, v); a cut
        inside an MQ segment keeps 3 bytes more, an HT one (``exact``) none."""
        pieces, first = [], 0
        for data, n in segments:
            lo, hi = max(u, first), min(v, first + n)
            if lo < hi:
                def cut(k):
                    if k == first:
                        return 0
                    if k == first + n:
                        return len(data)
                    return min(len(data), ends[k - 1] + (0 if exact else 3))
                pieces.append((hi - lo, data[cut(lo) : cut(hi)]))
            first += n
        return pieces

    def precinct_state(c, i, r, rect, cbs):
        """A precinct's code-blocks of one band, with its tag trees."""
        ny, nx = len(cbs), len(cbs[0]) if cbs else 0
        first = np.full((max(ny, 1), max(nx, 1)), layers, np.int64)
        zero = np.zeros((max(ny, 1), max(nx, 1)), np.int64)
        for y, row in enumerate(cbs):
            for x, (nbits, segs, ends, npass) in enumerate(row):
                if nbits:
                    first[y, x] = next(l for l, (u, v) in enumerate(split_layers(npass))
                                       if v > u)
                    zero[y, x] = qcd[c][1][i] + shifts.get(c, 0) - nbits
        return dict(cbs=cbs, incl=_TagEncoder(first), zbp=_TagEncoder(zero), lblock={},
                    done=set(), r=r, empty=rect[0] >= rect[2] or rect[1] >= rect[3])

    tile_streams = []
    for t, ((tx0, ty0, tx1, ty1), comps) in enumerate(tiles):
        state = {}
        nprec = {}
        for c, (x0, y0, x1, y1, _) in enumerate(comps):
            for i, (r, b, rect, _) in enumerate(bands(c, x0, y0, x1, y1)):
                grid = precinct_grid(c, r, x0, y0, x1, y1)
                nprec[(c, r)] = grid[0] * grid[1]
                every = code_blocks(t, c, i, rect, grid)
                for k in range(grid[0] * grid[1]):
                    cbs = [[blk for kk, blk in row if kk == k] for row in every]
                    state[(c, i, k)] = precinct_state(c, i, r, rect, [row for row in cbs if row])
        nres = [cp[c]["numres"] for c in range(ncomp)]

        def packet(l, r, c, k):
            bits, body = _HeaderBits(), bytearray()
            pieces_all = []
            for i, (rr, b, rect, _) in enumerate(bands(c, *comps[c][:4])):
                if rr != r:
                    continue
                st = state[(c, i, k)]
                if st["empty"]:
                    continue
                for y, row in enumerate(st["cbs"]):
                    for x, (nbits, segs, ends, npass) in enumerate(row):
                        u, v = split_layers(npass)[l] if nbits else (0, 0)
                        pieces_all.append((st, y, x, nbits, segs, ends, u, v))
            if not any(v > u for *_, u, v in pieces_all):
                return bits, bytes([0]), b""
            bits.put(1)
            for st, y, x, nbits, segs, ends, u, v in pieces_all:
                included = v > u
                if (y, x) not in st["done"]:
                    st["incl"].encode(bits, y, x, l + 1)
                    if not included:
                        continue
                    st["zbp"].encode(bits, y, x, 1 << 30)
                    st["done"].add((y, x))
                    st["lblock"][(y, x)] = 3
                else:
                    bits.put(int(included))
                    if not included:
                        continue
                _passes_code(bits, v - u)
                pieces = segment_pieces(nbits, segs, ends, u, v,
                                        bool(cp[c]["style"] & J2K_HT))
                lb = st["lblock"][(y, x)]
                inc = max([0] + [len(d).bit_length() - (n.bit_length() - 1) - lb
                                 for n, d in pieces])
                bits.put((1 << (inc + 1)) - 2, inc + 1)
                lb += inc
                st["lblock"][(y, x)] = lb
                for n, d in pieces:
                    bits.put(len(d), lb + n.bit_length() - 1)
                    body += d
            return bits, bits.flush(), bytes(body)

        def walk(order, r0, c0, l1, r1, c1):
            if order == 0:
                keys = [(l, r, c) for l in range(l1) for r in range(r0, r1)
                        for c in range(c0, c1) if r < nres[c]]
            elif order == 1:
                keys = [(l, r, c) for r in range(r0, r1) for l in range(l1)
                        for c in range(c0, c1) if r < nres[c]]
            elif order == 2:
                keys = [(l, r, c) for r in range(r0, r1) for c in range(c0, c1)
                        for l in range(l1) if r < nres[c]]
            else:
                keys = [(l, r, c) for c in range(c0, c1) for r in range(r0, min(r1, nres[c]))
                        for l in range(l1)]
            assert order < 2 or not precincts, "precincts are written in LRCP or RLCP only"
            return [(l, r, c, k) for l, r, c in keys for k in range(nprec[(c, r)])]

        seq = []
        seen = set()
        walks = pocs or [(0, 0, layers, max(nres), ncomp, progression)]
        for r0, c0, l1, r1, c1, order in walks:
            for key in walk(order, r0, c0, min(l1, layers), r1, min(c1, ncomp)):
                if key not in seen:
                    seen.add(key)
                    seq.append(key)
        pkts = []
        for n, key in enumerate(seq):
            _, head, body = packet(*key)
            if eph:
                head += b"\xff\x92"
            pre = struct.pack(">HHH", 0xFF91, 4, n & 0xFFFF) if sop else b""
            pkts.append((head, pre + body))
        tile_streams.append(pkts)

    # markers
    siz = struct.pack(">HIIIIIIIIH", 0, width, height, 0, 0, tw, th, 0, 0, ncomp)
    for c in range(ncomp):
        siz += bytes([prec - 1, sub[c][0], sub[c][1]])
    scod = (2 if sop else 0) | (4 if eph else 0) | (1 if precincts else 0)
    main = j2k_segment(0xFF51, siz)
    if cap and any(p["style"] & J2K_HT for p in cp):
        main += j2k_segment(0xFF50, struct.pack(">IH", 1 << (32 - 15), 0))
    main += j2k_segment(0xFF52, bytes([scod, progression]) + struct.pack(">H", layers)
                         + bytes([mct]) + spcod(cp[0]))
    main += j2k_segment(0xFF5C, qcd[0][0])
    extra = b""
    for c in range(1, ncomp):
        if spcod(cp[c]) != spcod(cp[0]):
            extra += j2k_segment(0xFF53, bytes([c, 1 if precincts else 0]) + spcod(cp[c]))
        if qcd[c][0] != qcd[0][0]:
            extra += j2k_segment(0xFF5D, bytes([c]) + qcd[c][0])
    for c in sorted(shifts):
        extra += j2k_segment(0xFF5E, bytes([c, 0, shifts[c]]))
    if pocs:
        extra += j2k_segment(0xFF5F, b"".join(
            bytes([r0, c0]) + struct.pack(">H", l1) + bytes([r1, c1, order])
            for r0, c0, l1, r1, c1, order in pocs))
    if not tile_markers:
        main += extra
    if comment is not None:
        main += j2k_segment(0xFF64, b"\x00\x01" + comment)
    main += b"".join(main_markers)
    # tile-parts
    parts_of = []
    for t, pkts in enumerate(tile_streams):
        k = max(1, min(parts, len(pkts)))
        cuts = [len(pkts) * j // k for j in range(k + 1)]
        parts_of.append([pkts[cuts[j] : cuts[j + 1]] for j in range(k)])
    if interleave:
        order_tp = [(t, j) for j in range(max(len(p) for p in parts_of))
                    for t in range(len(parts_of)) if j < len(parts_of[t])]
    else:
        order_tp = [(t, j) for t in range(len(parts_of)) for j in range(len(parts_of[t]))]
    if headers == "ppm":
        ppm = b"".join(struct.pack(">I", sum(len(h) for h, _ in parts_of[t][j]))
                       + b"".join(h for h, _ in parts_of[t][j]) for t, j in order_tp)
        for z, start in enumerate(range(0, len(ppm), 60000)):
            main += j2k_segment(0xFF60, bytes([z]) + ppm[start : start + 60000])
    out = b"\xff\x4f" + main
    for t, j in order_tp:
        pk = parts_of[t][j]
        hdr = b""
        if j == 0:
            hdr += b"".join(tile_header)
        if j == 0 and tile_markers:
            hdr += extra
        if headers == "ppt":
            hdr += j2k_segment(0xFF61, bytes([j]) + b"".join(h for h, _ in pk))
            data = b"".join(b for _, b in pk)
        elif headers == "ppm":
            data = b"".join(b for _, b in pk)
        else:
            data = b"".join(b[:6] + h + b[6:] if sop else h + b for h, b in pk)
        psot = 12 + len(hdr) + 2 + len(data)
        out += j2k_segment(0xFF90, struct.pack(">HIBB", t, psot, j, len(parts_of[t])))
        out += hdr + b"\xff\x93" + data
    return out + (b"\xff\xd9" if eoc else b"")


def jp2_box(kind: bytes, body: bytes, form: str = "plain") -> bytes:
    """A JP2 box; ``form`` "xl" writes an extended length, "open" a length
    of 0 (to the end of the file)."""
    if form == "xl":
        return struct.pack(">I", 1) + kind + struct.pack(">Q", len(body) + 16) + body
    if form == "open":
        return struct.pack(">I", 0) + kind + body
    return struct.pack(">I", len(body) + 8) + kind + body


def encode_jp2(codestream: bytes, width: int, height: int, ncomp: int, bpc: int = 7, *,
               colr: Optional[bytes] = b"\x01\x00\x00" + struct.pack(">I", 16),
               header_boxes: Sequence[bytes] = (), before: Sequence[bytes] = (),
               jp2c_form: str = "plain", brand: bytes = b"jp2 ") -> bytes:
    """A JP2 file around ``codestream``: the signature and ``ftyp`` boxes
    (``brand``, also the one compatible brand: ``jph `` for Part 15's JPH),
    ``jp2h`` with ``ihdr``, ``colr`` (a box body; None for none) and
    ``header_boxes`` (whole boxes: ``pclr``, ``cmap``, ``cdef``, ``res ``),
    ``before`` (whole boxes before ``jp2c``) and the ``jp2c`` box in
    ``jp2c_form``."""
    ihdr = struct.pack(">IIHBBBB", height, width, ncomp, bpc, 7, 0, 0)
    jp2h = jp2_box(b"ihdr", ihdr) + (jp2_box(b"colr", colr) if colr is not None else b"")
    jp2h += b"".join(header_boxes)
    return (jp2_box(b"jP  ", b"\r\n\x87\n") + jp2_box(b"ftyp", brand + bytes(4) + brand)
            + jp2_box(b"jp2h", jp2h) + b"".join(before) + jp2_box(b"jp2c", codestream, jp2c_form))


def pclr_box(entries: np.ndarray, bits: Sequence[int]) -> bytes:
    """A ``pclr`` box of ``entries`` (n, channels) at ``bits`` a channel."""
    n, nch = entries.shape
    body = struct.pack(">HB", n, nch) + bytes(b - 1 for b in bits)
    for row in entries:
        for v, b in zip(row, bits):
            body += int(v).to_bytes((b + 7) // 8, "big")
    return jp2_box(b"pclr", body)


def cmap_box(maps: Sequence[Tuple[int, int, int]]) -> bytes:
    """A ``cmap`` box of (component, type, palette column) entries."""
    return jp2_box(b"cmap", b"".join(struct.pack(">HBB", *m) for m in maps))


def cdef_box(defs: Sequence[Tuple[int, int, int]]) -> bytes:
    """A ``cdef`` box of (channel, type, association) entries."""
    return jp2_box(b"cdef", struct.pack(">H", len(defs)) + b"".join(
        struct.pack(">HHH", *d) for d in defs))


# ----- AVIF (HEIF boxes around a writer's AV1 payload) ----------------------

def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, body: bytes) -> bytes:
    return _box(kind, bytes([version]) + flags.to_bytes(3, "big") + body)


def avif_boxes(data: bytes) -> Dict[bytes, Tuple[int, int]]:
    """Top-level and ``meta``/``iprp``/``ipco`` boxes of an AVIF file: type
    -> (start of the box, end), the first of each type."""
    out: Dict[bytes, Tuple[int, int]] = {}

    def walk(pos: int, end: int) -> None:
        while pos + 8 <= end:
            size, kind = struct.unpack_from(">I4s", data, pos)
            out.setdefault(kind, (pos, pos + size))
            if kind == b"meta":
                walk(pos + 12, pos + size)
            elif kind in (b"iprp", b"ipco"):
                walk(pos + 8, pos + size)
            pos += size

    walk(0, len(data))
    return out


def avif_grid(tiles, rows: int, cols: int, size: Optional[Tuple[int, int]] = None,
              wide: bool = False, grid_colr: Optional[bytes] = None,
              grid_data: Optional[bytes] = None, alpha=None) -> bytes:
    """A ``grid`` AVIF of ``rows`` x ``cols`` tiles.  ``tiles`` is one
    one-item AVIF, repeated, or a list of them in row-major order (each
    tile item takes its file's ``ispe``, ``pixi``, ``av1C``, ``colr`` and
    AV1 payload; a list of another length than ``rows * cols`` writes
    that many ``dimg`` references).  The grid's output size is ``size``
    (width, height; default the tiles' whole canvas), written in 32-bit
    fields if ``wide``; the grid item has ``grid_colr`` as its ``colr``
    box (default the first tile's, ``b""`` none) and ``grid_data`` in
    place of its ``ImageGrid`` body.  ``alpha`` (one AVIF or a list, as
    ``tiles``) adds an alpha grid of the same layout, an ``auxl`` item
    with an ``auxC`` alpha URN."""
    colour = [tiles] * (rows * cols) if isinstance(tiles, bytes) else list(tiles)
    layers = [colour]
    if alpha is not None:
        layers.append([alpha] * (rows * cols) if isinstance(alpha, bytes) else list(alpha))
    w, h = struct.unpack_from(">II", colour[0], avif_boxes(colour[0])[b"ispe"][0] + 12)
    out_w, out_h = size if size is not None else (w * cols, h * rows)
    if grid_data is None:
        grid_data = bytes([0, int(wide), rows - 1, cols - 1]) + struct.pack(
            ">II" if wide else ">HH", out_w, out_h)
    if grid_colr is None:
        boxes = avif_boxes(colour[0])
        grid_colr = colour[0][boxes[b"colr"][0] : boxes[b"colr"][1]] if b"colr" in boxes else b""
    props: List[bytes] = []

    def prop(box: bytes) -> int:
        if box not in props:
            props.append(box)
        return props.index(box) + 1

    items = []  # (id, type, [(property index, essential)], data, in idat)
    payloads = []
    next_id = 1
    grid_ids = []
    refs = b""
    for layer, files in enumerate(layers):
        grid_id = next_id
        grid_ids.append(grid_id)
        tile_ids = list(range(grid_id + 1, grid_id + 1 + len(files)))
        next_id = tile_ids[-1] + 1 if tile_ids else grid_id + 1
        gprops = [(prop(_full(b"ispe", 0, 0, struct.pack(">II", out_w, out_h))), False)]
        if layer == 0 and grid_colr:
            gprops.append((prop(grid_colr), True))
        if layer == 1:
            gprops.append((prop(_full(b"auxC", 0, 0,
                                      b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0")), True))
            refs += _box(b"auxl", struct.pack(">HHH", grid_id, 1, grid_ids[0]))
        items.append((grid_id, b"grid", gprops, grid_data, True))
        refs += _box(b"dimg", struct.pack(">HH", grid_id, len(tile_ids)) + b"".join(
            struct.pack(">H", k) for k in tile_ids))
        for tid, single in zip(tile_ids, files):
            boxes = avif_boxes(single)
            tprops = []
            for kind in (b"ispe", b"pixi", b"av1C", b"colr"):
                if kind in boxes:
                    tprops.append((prop(single[boxes[kind][0] : boxes[kind][1]]),
                                   kind in (b"av1C", b"colr")))
            payload = single[boxes[b"mdat"][0] + 8 : boxes[b"mdat"][1]]
            items.append((tid, b"av01", tprops, payload, False))
    ftyp = _box(b"ftyp", b"avif\0\0\0\0avifmif1miaf")
    hdlr = _full(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 13)
    pitm = _full(b"pitm", 0, 0, struct.pack(">H", 1))
    iinf = _full(b"iinf", 0, 0, struct.pack(">H", len(items)) + b"".join(
        _full(b"infe", 2, 0, struct.pack(">HH", i, 0) + t + b"\0") for i, t, _, _, _ in items))
    iref = _full(b"iref", 0, 0, refs)
    assoc = b""
    for i, _, ps, _, _ in items:
        assoc += struct.pack(">HB", i, len(ps)) + bytes(k | (0x80 if e else 0) for k, e in ps)
    ipma = _full(b"ipma", 0, 0, struct.pack(">I", len(items)) + assoc)
    iprp = _box(b"iprp", _box(b"ipco", b"".join(props)) + ipma)
    idat_body = b"".join(d for _, _, _, d, in_idat in items if in_idat)
    idat = _box(b"idat", idat_body)
    mdat_body = b"".join(d for _, _, _, d, in_idat in items if not in_idat)

    def meta(offset: int) -> bytes:
        entries, at_idat, at_mdat = b"", 0, offset
        for i, _, _, d, in_idat in items:
            start = at_idat if in_idat else at_mdat
            entries += struct.pack(">HHHH", i, int(in_idat), 0, 1) + struct.pack(">II", start,
                                                                              len(d))
            if in_idat:
                at_idat += len(d)
            else:
                at_mdat += len(d)
        iloc = _full(b"iloc", 1, 0, bytes([0x44, 0x00]) + struct.pack(">H", len(items))
                     + entries)
        return _full(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iref + iprp + idat)

    head = ftyp + meta(0)
    head = ftyp + meta(len(head) + 8)
    return head + _box(b"mdat", mdat_body)


def avif_rebuild(single: bytes, iloc_version: int = 0, method: int = 0, infe_version: int = 2,
                 ipma_version: int = 0, ipma_flags: int = 0, pitm_version: int = 0,
                 iinf_version: int = 0, extents: int = 1, extra: Sequence[bytes] = (),
                 clap: Optional[bytes] = None, payload: Optional[bytes] = None) -> bytes:
    """A one-item AVIF's image (its ``ispe``, ``pixi``, ``av1C``, ``colr``
    and AV1 payload) in other box forms: ``iloc`` version 0, 1 or 2 and
    construction method 0 (``mdat``) or 1 (``idat``), the payload in
    ``extents`` pieces, ``infe`` version 2 or 3, ``ipma`` version 0 or 1 with
    flags 0 or 1 (16-bit indices), ``pitm`` and ``iinf`` versions 0 or 1,
    ``extra`` whole boxes appended to ``meta``, and a ``clap`` body
    associated (essential) with the item; ``payload`` AV1 OBUs in place of
    the file's own."""
    boxes = avif_boxes(single)
    props = [single[boxes[k][0] : boxes[k][1]] for k in (b"ispe", b"pixi", b"av1C", b"colr")
             if k in boxes]
    if clap is not None:
        props.append(_box(b"clap", clap))
    mdat_at, mdat_end = boxes[b"mdat"]
    if payload is None:
        payload = single[mdat_at + 8 : mdat_end]
    wide = 4 if iloc_version == 2 else 2
    idw = 4 if infe_version == 3 else 2
    ftyp = _box(b"ftyp", b"avif\0\0\0\0avifmif1miaf")
    hdlr = _full(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 13)
    pitm = _full(b"pitm", pitm_version, 0, (1).to_bytes(2 if pitm_version == 0 else 4, "big"))
    infe = _full(b"infe", infe_version, 0, (1).to_bytes(idw, "big") + b"\0\0av01Color\0")
    iinf = _full(b"iinf", iinf_version, 0,
                 (1).to_bytes(2 if iinf_version == 0 else 4, "big") + infe)
    ipco = _box(b"ipco", b"".join(props))
    index_bytes = 2 if ipma_flags & 1 else 1
    assoc = b""
    for k in range(len(props)):
        essential = k >= 2  # av1C, colr, clap
        v = (k + 1) | ((1 << (8 * index_bytes - 1)) if essential else 0)
        assoc += v.to_bytes(index_bytes, "big")
    ipma = _full(b"ipma", ipma_version, ipma_flags,
                 struct.pack(">I", 1) + (1).to_bytes(2 if ipma_version == 0 else 4, "big")
                 + bytes([len(props)]) + assoc)
    iprp = _box(b"iprp", ipco + ipma)
    pieces = np.array_split(np.arange(len(payload)), extents)
    cuts = [(int(p[0]), len(p)) for p in pieces if len(p)]

    def meta(base: int) -> bytes:
        head = bytes([0x44, 0x00 if iloc_version == 0 else 0x00])
        body = head + (1).to_bytes(wide, "big") + (1).to_bytes(wide, "big")
        if iloc_version:
            body += struct.pack(">H", method)
        body += struct.pack(">HH", 0, len(cuts))
        for start, length in cuts:
            body += struct.pack(">II", base + start, length)
        iloc = _full(b"iloc", iloc_version, 0, body)
        idat = _box(b"idat", payload) if method == 1 else b""
        return _full(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iprp + idat
                     + b"".join(extra))

    if method == 1:
        return ftyp + meta(0)
    head = ftyp + meta(0)
    head = ftyp + meta(len(head) + 8)
    return head + _box(b"mdat", payload)


def film_grain_avif(seed: int = 0, level: int = 25, size: int = 64,
                    subsampling: str = "4:2:0") -> bytes:
    """A ``size`` x ``size`` flat grey with mild Gaussian noise, written
    lossy by Pillow's libaom with ``denoise-noise-level`` ``level``: the
    noise is modelled and its frame header applies film grain."""
    import io

    from PIL import Image

    rng = np.random.RandomState(seed)
    img = np.clip(128 + rng.normal(0, 4, (size, size, 3)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "AVIF", quality=60, subsampling=subsampling,
                              advanced={"denoise-noise-level": str(level)})
    return buf.getvalue()


def rescaled_avif(frame: Optional[np.ndarray] = None, ispe: Tuple[int, int] = (32, 32),
                  depth: int = 8, subsampling: str = "4:2:0", q: int = 0,
                  alpha: Optional[Tuple[int, int]] = None,
                  alpha_ispe: Optional[Tuple[int, int]] = None,
                  grid: Optional[Tuple[int, int]] = None, sequence: bool = False) -> bytes:
    """An AVIF whose ``ispe`` (width, height) differs from its AV1 frame's
    size, which libavif rescales to the ``ispe``: ``frame`` (RGB uint8,
    default a 16 x 16 flat grey) coded by libaom at ``depth`` bits (8, 10,
    12) and ``subsampling`` (4:2:0, 4:2:2, 4:4:4, 4:0:0) with quantiser
    ``q`` (0 is lossless).  ``alpha`` (width, height) adds an alpha item
    coded at that size, its ``ispe`` ``alpha_ispe`` (default ``ispe``);
    ``grid`` (rows, columns) makes the primary item a grid of that many
    copies of the rescaled item; ``sequence`` writes Pillow's ``avis``
    sequence of the frame (8 bits; ``depth`` and ``q`` unused) with its
    colour track's ``tkhd`` size set to ``ispe`` (and, with ``alpha``, an
    alpha track of the frame's size whose ``tkhd`` is ``alpha_ispe``)."""
    if frame is None:
        frame = np.full((16, 16, 3), 200, np.uint8)
    if sequence:
        return _rescaled_sequence(frame, ispe, subsampling,
                                  None if alpha is None else alpha_ispe or ispe)
    obus = aom_encode(aom_yuv(frame, subsampling, depth), depth, subsampling, q=q)
    single = with_ispe(aom_avif(obus), ispe)
    if alpha is not None:
        a = (np.indices(alpha[::-1]).sum(axis=0) * 7) % 256
        a = np.clip(np.rint(a * ((1 << depth) - 1) / 255), 0, (1 << depth) - 1)
        matte = aom_avif(aom_encode([a.astype(np.int64)], depth, "4:0:0", q=q))
        single = avif_with_alpha(single, matte, alpha_ispe=alpha_ispe or ispe)
    if grid is not None:
        return avif_grid(single, *grid)
    return single


def with_ispe(single: bytes, ispe: Tuple[int, int]) -> bytes:
    """A one-item AVIF with its ``ispe`` (width, height) replaced."""
    data = bytearray(single)
    k = avif_boxes(single)[b"ispe"][0] + 12
    struct.pack_into(">II", data, k, *ispe)
    return bytes(data)


def _rescaled_sequence(frame: np.ndarray, ispe: Tuple[int, int], subsampling: str,
                       alpha_ispe: Optional[Tuple[int, int]]) -> bytes:
    """Pillow's two-frame ``avis`` of ``frame`` (and its mirror), with an
    alpha ramp where ``alpha_ispe`` is given; the colour track's ``tkhd``
    width and height (16.16) set to ``ispe``, the alpha track's (Pillow
    writes it second) to ``alpha_ispe``."""
    import io

    from PIL import Image

    if alpha_ispe is not None:
        ramp = (np.indices(frame.shape[:2]).sum(axis=0) * 5 % 256).astype(np.uint8)
        frame = np.dstack([frame, ramp])
    frames = [Image.fromarray(frame), Image.fromarray(np.ascontiguousarray(frame[:, ::-1]))]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:], quality=100,
                   subsampling=subsampling)
    data = bytearray(buf.getvalue())
    k = data.find(b"tkhd")
    for size in (ispe, alpha_ispe):
        if size is None:
            break
        version = data[k + 4]
        at = k + 8 + (16 if version else 8) + 4 + 4 + (8 if version else 4) + 8 + 8 + 36
        struct.pack_into(">II", data, at, size[0] << 16, size[1] << 16)
        k = data.find(b"tkhd", k + 4)
    return bytes(data)


def av1_superres_obus(size: int = 16) -> bytes:
    """A reduced still-picture sequence header (profile 0, 8-bit 4:2:0,
    ``enable_superres``) and a frame header OBU whose ``use_superres`` is
    set, cut after that bit and its denominator: a header libaom refuses
    (it runs past its OBU)."""
    def obu(kind: int, bits: str) -> bytes:
        bits += "1" + "0" * ((-len(bits) - 1) % 8)  # trailing_bits
        body = int(bits, 2).to_bytes(len(bits) // 8, "big")
        return bytes([(kind << 3) | 2, len(body)]) + body

    side = format(size - 1, "06b")
    seq = ("000" "1" "1" "00000"  # profile, still_picture, reduced header, level
           "0101" "0101" + side + side  # frame size bits and sizes
           + "000"  # 128 superblocks, filter intra, intra edge filter
           + "1" "0" "0"  # enable_superres, enable_cdef, enable_restoration
           + "0" "0" "0" "0" "00" "0"  # 8 bits, colour: no description, limited, 4:2:0
           + "0")  # film_grain_params_present
    frame = "0" "0" "1" "000"  # disable_cdf_update, screen tools, use_superres, denom
    return obu(1, seq) + obu(3, frame)


def grain_table(lag: int = 1, ar_shift: int = 7, scale_shift: int = 0, scaling_shift: int = 9,
                from_luma: bool = False, overlap: bool = True, cb: Sequence[int] = (128, 192, 256),
                cr: Sequence[int] = (128, 192, 256),
                point_y: Sequence[Tuple[int, int]] = ((0, 20), (255, 40)),
                point_cb: Sequence[Tuple[int, int]] = ((0, 30), (255, 10)),
                point_cr: Sequence[Tuple[int, int]] = ((0, 10), (128, 40)), seed: int = 1234,
                coeff_seed: int = 0) -> str:
    """A libaom film grain table (``aom_film_grain_table_write``'s text)
    of one entry over all time, for the encoder's ``film-grain-table``
    option: ``ar_shift`` and ``scaling_shift`` are the shifts themselves
    (6-9, 8-11), the AR coefficients seeded draws in [-40, 40)."""
    n = 2 * lag * (lag + 1)
    rng = np.random.RandomState(coeff_seed)

    def row(values) -> str:
        return " ".join(str(int(v)) for v in values)

    def points(p) -> str:
        return f"{len(p)} " + row(v for xy in p for v in xy)

    return ("filmgrn1\nE 0 9223372036854775807 1 %d 1\n" % seed
            + f"\tp {lag} {ar_shift} {scale_shift} {scaling_shift} {int(from_luma)} "
            + f"{int(overlap)} {row(cb)} {row(cr)}\n"
            + f"\tsY {points(point_y)}\n\tsCb {points(point_cb)}\n\tsCr {points(point_cr)}\n"
            + f"\tcY {row(rng.randint(-40, 40, n))}\n\tcCb {row(rng.randint(-40, 40, n + 1))}\n"
            + f"\tcCr {row(rng.randint(-40, 40, n + 1))}\n")


def film_grain_bits(mono: bool, ss_x: int, ss_y: int, seed: int = 0,
                    point_y: Sequence[Tuple[int, int]] = (), from_luma: bool = False,
                    point_cb: Sequence[Tuple[int, int]] = (),
                    point_cr: Sequence[Tuple[int, int]] = (), scaling_minus_8: int = 0,
                    lag: int = 0, ar_y: Sequence[int] = (), ar_cb: Sequence[int] = (),
                    ar_cr: Sequence[int] = (), ar_shift_minus_6: int = 0, scale_shift: int = 0,
                    cb: Sequence[int] = (128, 192, 256), cr: Sequence[int] = (128, 192, 256),
                    overlap: bool = True, clip: bool = False) -> str:
    """``film_grain_params`` of an intra frame that applies grain, as a
    string of bits (the AV1 specification, 5.9.30; AR coefficients given
    less 128, as many as the lag needs)."""
    def f(v: int, n: int) -> str:
        return format(v, f"0{n}b")

    def pts(p) -> str:
        return f(len(p), 4) + "".join(f(x, 8) + f(y, 8) for x, y in p)

    bits = "1" + f(seed, 16) + pts(point_y)
    if not mono:
        bits += f(int(from_luma), 1)
    if not (mono or from_luma or (ss_x and ss_y and not point_y)):
        bits += pts(point_cb) + pts(point_cr)
    bits += f(scaling_minus_8, 2) + f(lag, 2)
    n = 2 * lag * (lag + 1)
    for on, coeffs, count in ((bool(point_y), ar_y, n),
                              (from_luma or bool(point_cb), ar_cb, n + bool(point_y)),
                              (from_luma or bool(point_cr), ar_cr, n + bool(point_y))):
        if on:
            assert len(coeffs) == count
            bits += "".join(f(c + 128, 8) for c in coeffs)
    bits += f(ar_shift_minus_6, 2) + f(scale_shift, 2)
    for on, (mult, luma_mult, offset) in ((point_cb, cb), (point_cr, cr)):
        if on:
            bits += f(mult, 8) + f(luma_mult, 8) + f(offset, 9)
    return bits + f(int(overlap), 1) + f(int(clip), 1)


def _av1_units(data: bytes) -> List[Tuple[int, bytes, bytes]]:
    """The OBUs of ``data`` as (type, header bytes without the size field,
    body)."""
    out, pos = [], 0
    while pos < len(data):
        kind, ext = (data[pos] >> 3) & 15, (data[pos] >> 2) & 1
        head = bytes([data[pos] & ~2]) + data[pos + 1 : pos + 1 + ext]
        k = pos + 1 + ext
        size = shift = 0
        while True:
            size |= (data[k] & 0x7F) << shift
            shift += 7
            k += 1
            if not data[k - 1] & 0x80:
                break
        out.append((kind, head, data[k : k + size]))
        pos = k + size
    return out


def _av1_join(units: Sequence[Tuple[int, bytes, bytes]]) -> bytes:
    out = b""
    for _kind, head, body in units:
        size, leb = len(body), b""
        while True:
            leb += bytes([(size & 0x7F) | (0x80 if size > 0x7F else 0)])
            size >>= 7
            if not size:
                break
        out += bytes([head[0] | 2]) + head[1:] + leb + body
    return out


def _bits(data: bytes) -> str:
    return "".join(format(b, "08b") for b in data)


def _unbits(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def av1_with_grain(payload: bytes, **params) -> bytes:
    """An AV1 key frame's OBUs (one ``OBU_FRAME``) with film grain: the
    sequence header's ``film_grain_params_present`` set and the frame
    header given :func:`film_grain_bits` of ``params`` at its end.  The
    ends of both headers are found with the port's header parser; the
    tile data is moved, not changed."""
    from molnextr_tpu_torch.data import av1_obu

    units, seq = [], None
    for kind, head, body in _av1_units(payload):
        if kind == 1:
            r = av1_obu.BitReader(body)
            seq = av1_obu.sequence_header(r)
            bits = _bits(body)
            body = _unbits(bits[: r.bit - 1] + "1" + bits[r.bit :])
        elif kind == 6:
            r = av1_obu.BitReader(body)
            av1_obu.frame_header(r, seq, 0, 0)
            bits = _bits(body)[: r.bit] + film_grain_bits(seq.mono, seq.ss_x, seq.ss_y,
                                                          **params)
            body = _unbits(bits) + body[(r.bit + 7) // 8 :]
        units.append((kind, head, body))
    return _av1_join(units)


def av1_hidden_key(payload: bytes, slot: int = 0, showable: bool = True) -> bytes:
    """The OBUs of a shown key frame under a full sequence header (no
    decoder model, no frame ids, no film grain), rewritten so that the key
    frame is hidden (``showable_frame`` as given, refreshing every slot)
    and a following ``OBU_FRAME_HEADER`` shows it with
    ``show_existing_frame`` from ``slot``."""
    from molnextr_tpu_torch.data import av1_obu

    units, seq = [], None
    for kind, head, body in _av1_units(payload):
        if kind == 1:
            seq = av1_obu.sequence_header(av1_obu.BitReader(body))
            assert not (seq.reduced or seq.decoder_model or seq.frame_id_bits or seq.film_grain)
        elif kind == 6:
            r = av1_obu.BitReader(body)
            av1_obu.frame_header(r, seq, 0, 0)
            bits = _bits(body)
            assert bits[:4] == "0001"  # not show_existing, KEY_FRAME, shown
            p = 5  # past disable_cdf_update
            screen = int(bits[p]) if seq.screen_tools == 2 else seq.screen_tools
            p += seq.screen_tools == 2
            p += bool(screen and seq.integer_mv == 2)
            p += 1 + seq.order_hint_bits  # frame_size_override_flag, order_hint
            # show_frame 0, showable_frame 1, error_resilient_mode 1; then
            # refresh_frame_flags after the order hint
            new = bits[:3] + "0" + str(int(showable)) + "1" + bits[4:p] + "11111111" \
                + bits[p : r.bit]
            units.append((kind, head, _unbits(new) + body[(r.bit + 7) // 8 :]))
            units.append((3, bytes([3 << 3]), _unbits("1" + format(slot, "03b") + "1")))
            continue
        units.append((kind, head, body))
    return _av1_join(units)



# ----- libaom through ctypes: the AV1 encoder that cv2 ships ---------------------

class _FixedBuf(ctypes.Structure):
    _fields_ = [("buf", ctypes.c_void_p), ("sz", ctypes.c_size_t)]


_U, _I = ctypes.c_uint, ctypes.c_int
# aom_codec_enc_cfg_t as libaom 3.x's aom_encoder.h lays it out; its
# cfg_options_t (encoder_cfg) is 35 unsigned ints
_ENC_CFG_FIELDS = [
    ("g_usage", _U), ("g_threads", _U), ("g_profile", _U), ("g_w", _U), ("g_h", _U),
    ("g_limit", _U), ("g_forced_max_frame_width", _U), ("g_forced_max_frame_height", _U),
    ("g_bit_depth", _I), ("g_input_bit_depth", _U), ("g_timebase_num", _I),
    ("g_timebase_den", _I), ("g_error_resilient", _U), ("g_pass", _I), ("g_lag_in_frames", _U),
    ("rc_dropframe_thresh", _U), ("rc_resize_mode", _U), ("rc_resize_denominator", _U),
    ("rc_resize_kf_denominator", _U), ("rc_superres_mode", _U),
    ("rc_superres_denominator", _U), ("rc_superres_kf_denominator", _U),
    ("rc_superres_qthresh", _U), ("rc_superres_kf_qthresh", _U), ("rc_end_usage", _I),
    ("rc_twopass_stats_in", _FixedBuf), ("rc_firstpass_mb_stats_in", _FixedBuf),
    ("rc_target_bitrate", _U), ("rc_min_quantizer", _U), ("rc_max_quantizer", _U),
    ("rc_undershoot_pct", _U), ("rc_overshoot_pct", _U), ("rc_buf_sz", _U),
    ("rc_buf_initial_sz", _U), ("rc_buf_optimal_sz", _U), ("rc_2pass_vbr_bias_pct", _U),
    ("rc_2pass_vbr_minsection_pct", _U), ("rc_2pass_vbr_maxsection_pct", _U),
    ("fwd_kf_enabled", _I), ("kf_mode", _I), ("kf_min_dist", _U), ("kf_max_dist", _U),
    ("sframe_dist", _U), ("sframe_mode", _U), ("large_scale_tile", _U), ("monochrome", _U),
    ("full_still_picture_hdr", _U), ("save_as_annexb", _U), ("tile_width_count", _I),
    ("tile_height_count", _I), ("tile_widths", _I * 64), ("tile_heights", _I * 64),
    ("use_fixed_qp_offsets", _U), ("fixed_qp_offsets", _I * 5), ("encoder_cfg", _U * 35)]


class AomEncCfg(ctypes.Structure):
    """``aom_codec_enc_cfg_t`` (904 bytes)."""
    _fields_ = _ENC_CFG_FIELDS


class AomImage(ctypes.Structure):
    """``aom_image_t``."""
    _fields_ = [("fmt", _I), ("cp", _I), ("tc", _I), ("mc", _I), ("monochrome", _I),
                ("csp", _I), ("range", _I), ("w", _U), ("h", _U), ("bit_depth", _U),
                ("d_w", _U), ("d_h", _U), ("r_w", _U), ("r_h", _U), ("x_chroma_shift", _U),
                ("y_chroma_shift", _U), ("planes", ctypes.c_void_p * 3), ("stride", _I * 3),
                ("sz", ctypes.c_size_t), ("bps", _I), ("temporal_id", _I), ("spatial_id", _I),
                ("user_priv", ctypes.c_void_p), ("img_data", ctypes.c_void_p),
                ("img_data_owner", _I), ("self_allocd", _I), ("metadata", ctypes.c_void_p),
                ("fb_priv", ctypes.c_void_p)]


AOM_USAGE_GOOD_QUALITY, AOM_USAGE_ALL_INTRA = 0, 2
AOM_SUPERRES_FIXED = 1
_AOM_Q = 3
_AOM_HIGHBITDEPTH_FLAG = 0x40000  # AOM_CODEC_USE_HIGHBITDEPTH
_AOM_ABI = {}


def libaom():
    """The libaom that cv2 ships (``opencv_python.libs/libaom-*.so.3.14.1``),
    its entry points typed."""
    if "lib" not in _AOM_ABI:
        import glob
        import os

        import cv2

        libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
        (path,) = glob.glob(os.path.join(libs, "libaom-*.so.3.14.1"))
        lib = ctypes.CDLL(path)
        vp = ctypes.c_void_p
        lib.aom_codec_av1_cx.restype = vp
        lib.aom_codec_enc_config_default.argtypes = [vp, ctypes.POINTER(AomEncCfg), _U]
        lib.aom_codec_enc_init_ver.argtypes = [vp, vp, ctypes.POINTER(AomEncCfg), ctypes.c_long,
                                               _I]
        lib.aom_codec_set_option.argtypes = [vp, ctypes.c_char_p, ctypes.c_char_p]
        lib.aom_img_wrap.restype = vp
        lib.aom_img_wrap.argtypes = [ctypes.POINTER(AomImage), _I, _U, _U, _U, vp]
        lib.aom_codec_encode.argtypes = [vp, vp, ctypes.c_int64, ctypes.c_ulong, ctypes.c_long]
        lib.aom_codec_get_cx_data.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.aom_codec_get_cx_data.argtypes = [vp, ctypes.POINTER(vp)]
        lib.aom_codec_error_detail.restype = ctypes.c_char_p
        lib.aom_codec_error_detail.argtypes = [vp]
        lib.aom_codec_destroy.argtypes = [vp]
        _AOM_ABI["lib"] = lib
    return _AOM_ABI["lib"]


def aom_default_config(usage: int = AOM_USAGE_ALL_INTRA) -> AomEncCfg:
    """``aom_codec_enc_config_default``'s configuration, the layout checked
    against the values libaom 3.x writes there: a wrong layout fails here
    instead of writing a file without superres."""
    lib = libaom()
    cfg = AomEncCfg()
    assert ctypes.sizeof(cfg) == 904
    assert lib.aom_codec_enc_config_default(lib.aom_codec_av1_cx(), ctypes.byref(cfg), usage) == 0
    assert (cfg.g_usage, cfg.g_w, cfg.g_h, cfg.g_bit_depth, cfg.g_input_bit_depth) == \
        (usage, 320, 240, 8, 8)
    assert (cfg.g_timebase_num, cfg.g_timebase_den) == (1, 30)
    assert (cfg.rc_resize_mode, cfg.rc_resize_denominator, cfg.rc_resize_kf_denominator) == \
        (0, 8, 8)
    assert (cfg.rc_superres_mode, cfg.rc_superres_denominator, cfg.rc_superres_kf_denominator,
            cfg.rc_superres_qthresh, cfg.rc_superres_kf_qthresh) == (0, 8, 8, 63, 32)
    assert (cfg.rc_target_bitrate, cfg.rc_min_quantizer, cfg.rc_max_quantizer) == (256, 0, 63)
    assert (cfg.rc_buf_sz, cfg.rc_buf_initial_sz, cfg.rc_buf_optimal_sz) == (6000, 4000, 5000)
    assert list(cfg.fixed_qp_offsets) == [-1] * 5
    assert list(cfg.encoder_cfg)[1:4] == [0, 128, 4]  # superblock, max and min partition
    return cfg


def _aom_init(lib, ctx, iface, cfg: AomEncCfg, flags: int) -> None:
    """``aom_codec_enc_init_ver`` at the library's encoder ABI version, which
    it establishes: any other version is refused as ABI_MISMATCH (3)."""
    versions = [_AOM_ABI["ver"]] if "ver" in _AOM_ABI else range(1, 100)
    for ver in versions:
        rc = lib.aom_codec_enc_init_ver(ctx, iface, ctypes.byref(cfg), flags, ver)
        if rc != 3:
            break
    assert rc == 0, (rc, lib.aom_codec_error_detail(ctx))
    _AOM_ABI["ver"] = ver


def aom_encode(yuv: Sequence[np.ndarray], depth: int = 8, subsampling: str = "4:2:0",
               q: int = 30, speed: int = 6, superres: int = 8,
               options: Sequence[Tuple[str, str]] = (), usage: int = AOM_USAGE_ALL_INTRA,
               grain_table_text: Optional[str] = None) -> bytes:
    """One AV1 key frame from libaom, as OBUs without the temporal
    delimiter.  ``yuv`` is the Y plane, or Y, U and V at the chroma size
    of ``subsampling`` (4:2:0, 4:2:2, 4:4:4; 4:0:0 is monochrome), samples
    of ``depth`` bits (8, 10 or 12, which is profile 2); ``q`` the
    quantiser (0-63); ``superres`` the key frame's superres denominator
    (9-16: FIXED mode; 8 none); ``options``
    libaom's named options (``enable-restoration``, ``tile-columns``,
    ``deltaq-mode``, ``delta-lf-mode``, ...); ``grain_table_text`` a film
    grain table, passed as ``film-grain-table``."""
    units = aom_encode_frames([yuv], depth, subsampling, q, speed, superres, options, usage,
                              grain_table_text=grain_table_text)
    return _av1_join([u for u in _av1_units(b"".join(units)) if u[0] != 2])


def aom_encode_frames(frames: Sequence[Sequence[np.ndarray]], depth: int = 8,
                      subsampling: str = "4:2:0", q: int = 30, speed: int = 6,
                      superres: int = 8, options: Sequence[Tuple[str, str]] = (),
                      usage: int = AOM_USAGE_GOOD_QUALITY, lag: int = 0,
                      grain_table_text: Optional[str] = None,
                      config: Optional[dict] = None) -> List[bytes]:
    """A sequence of frames through libaom: the temporal units it writes
    (each with its temporal delimiter), in order.  ``usage`` good quality
    (0) writes inter frames; ``lag`` is ``g_lag_in_frames`` (hidden
    ALTREF frames need it); ``superres`` sets FIXED superres on every
    frame; ``config`` other fields of ``aom_codec_enc_cfg_t`` by name
    (``rc_resize_mode``, ...); the rest as :func:`aom_encode`."""
    import os
    import tempfile

    lib = libaom()
    cfg = aom_default_config(usage)
    h, w = frames[0][0].shape
    mono = subsampling == "4:0:0"
    cfg.g_w, cfg.g_h = w, h
    cfg.g_profile = 2 if depth == 12 else {"4:2:0": 0, "4:0:0": 0, "4:4:4": 1,
                                           "4:2:2": 2}[subsampling]
    cfg.g_bit_depth = cfg.g_input_bit_depth = depth
    cfg.monochrome = int(mono)
    cfg.g_limit, cfg.g_lag_in_frames = len(frames), lag
    cfg.rc_end_usage = _AOM_Q
    cfg.rc_min_quantizer = cfg.rc_max_quantizer = q
    if superres != 8:
        cfg.rc_superres_mode = AOM_SUPERRES_FIXED
        cfg.rc_superres_denominator = cfg.rc_superres_kf_denominator = superres
    for name, value in (config or {}).items():
        setattr(cfg, name, value)
    iface = lib.aom_codec_av1_cx()
    ctx = ctypes.create_string_buffer(512)  # aom_codec_ctx_t, with room to spare
    _aom_init(lib, ctx, iface, cfg, _AOM_HIGHBITDEPTH_FLAG if depth > 8 else 0)
    with tempfile.TemporaryDirectory() as tmp:
        opts = [("cpu-used", str(speed)), ("cq-level", str(q))] + list(options)
        if grain_table_text is not None:
            path = os.path.join(tmp, "grain.tbl")
            with open(path, "w") as f:
                f.write(grain_table_text)
            opts.append(("film-grain-table", path))
        try:
            for name, value in opts:
                assert lib.aom_codec_set_option(ctx, name.encode(), value.encode()) == 0, \
                    (name, lib.aom_codec_error_detail(ctx))
            return _aom_frames(lib, ctx, frames, depth, subsampling)
        finally:
            lib.aom_codec_destroy(ctx)


def _aom_frames(lib, ctx, frames, depth: int, subsampling: str) -> List[bytes]:
    h, w = frames[0][0].shape
    sx, sy = {"4:2:0": (1, 1), "4:0:0": (1, 1), "4:4:4": (0, 0), "4:2:2": (1, 0)}[subsampling]
    high = depth > 8
    fmt = 0x100 | {(1, 1): 2, (1, 0): 5, (0, 0): 6}[(sx, sy)] | (0x800 if high else 0)
    dtype = np.uint16 if high else np.uint8
    buf = ctypes.create_string_buffer(6 * (w + 2) * (h + 2) * (2 if high else 1))
    img = AomImage()
    assert lib.aom_img_wrap(ctypes.byref(img), fmt, w, h, 1, buf)
    assert (img.d_w, img.d_h, img.x_chroma_shift, img.y_chroma_shift) == (w, h, sx, sy)
    assert img.planes[0] == ctypes.addressof(buf)
    img.monochrome = int(subsampling == "4:0:0")
    img.bit_depth = depth
    out: List[bytes] = []

    def drain() -> None:
        it = ctypes.c_void_p()
        while True:
            pkt = lib.aom_codec_get_cx_data(ctx, ctypes.byref(it))
            if not pkt:
                break
            base = ctypes.addressof(pkt.contents)
            if ctypes.c_int.from_address(base).value == 0:  # AOM_CODEC_CX_FRAME_PKT
                ptr = ctypes.c_void_p.from_address(base + 8).value
                size = ctypes.c_size_t.from_address(base + 16).value
                out.append(ctypes.string_at(ptr, size))

    for pts, yuv in enumerate(frames):
        if subsampling == "4:0:0":
            mid = np.full(((h + sy) >> sy, (w + sx) >> sx), 1 << (depth - 1))
            yuv = [yuv[0], mid, mid]
        for p, plane in enumerate(yuv):
            a = np.ascontiguousarray(plane, dtype)
            assert a.shape == (((h + sy) >> sy, (w + sx) >> sx) if p else (h, w))
            for row in range(a.shape[0]):
                ctypes.memmove(img.planes[p] + row * img.stride[p], a[row].ctypes.data,
                               a[row].nbytes)
        assert lib.aom_codec_encode(ctx, ctypes.addressof(img), pts, 1, 0) == 0, \
            lib.aom_codec_error_detail(ctx)
        drain()
    while True:  # flush
        before = len(out)
        assert lib.aom_codec_encode(ctx, None, 0, 1, 0) == 0, lib.aom_codec_error_detail(ctx)
        drain()
        if len(out) == before:
            break
    return out


def aom_avif(obus: bytes, full: bool = True, matrix: int = 6, **rebuild) -> bytes:
    """A one-item AVIF around libaom's OBUs: ``av1C``, ``pixi`` and ``ispe``
    (the upscaled size: the sequence header's) from the sequence header, an
    nclx ``colr`` of ``matrix`` and range; ``rebuild`` goes to
    :func:`avif_rebuild`."""
    from molnextr_tpu_torch.data import av1_obu

    seq = next(av1_obu.sequence_header(av1_obu.BitReader(body))
               for kind, _, body in _av1_units(obus) if kind == 1)
    flags = ((seq.bit_depth > 8) << 6) | ((seq.bit_depth == 12) << 5) | (seq.mono << 4) | \
        (seq.ss_x << 3) | (seq.ss_y << 2)
    av1c = _box(b"av1C", bytes([0x81, (seq.profile << 5) | 31, flags, 0]))
    pixi = _full(b"pixi", 0, 0, bytes([seq.planes] + [seq.bit_depth] * seq.planes))
    ispe = _full(b"ispe", 0, 0, struct.pack(">II", seq.max_width, seq.max_height))
    colr = _box(b"colr", b"nclx" + struct.pack(">HHHB", 1, 13, matrix, 0x80 if full else 0))
    return avif_rebuild(ispe + pixi + av1c + colr + _box(b"mdat", obus), **rebuild)


def avif_with_alpha(colour: bytes, alpha: bytes, alpha_payload: Optional[bytes] = None,
                    alpha_ispe: Optional[Tuple[int, int]] = None) -> bytes:
    """A one-item AVIF (``colour``) with an alpha item: the ``av01`` item
    of ``alpha`` (its ``ispe``, ``pixi``, ``av1C`` and AV1 payload, or
    ``alpha_payload``; its ``ispe`` replaced by ``alpha_ispe``) as an
    ``auxl`` of the colour item, with an ``auxC`` alpha URN."""
    props: List[bytes] = []

    def prop(box: bytes) -> int:
        if box not in props:
            props.append(box)
        return props.index(box) + 1

    items = []  # (id, [(property index, essential)], payload)
    for item_id, single in ((1, colour), (2, alpha)):
        boxes = avif_boxes(single)
        ps = []
        for kind in (b"ispe", b"pixi", b"av1C", b"colr"):
            if kind not in boxes or (item_id == 2 and kind == b"colr"):
                continue
            box = single[boxes[kind][0] : boxes[kind][1]]
            if kind == b"ispe" and item_id == 2 and alpha_ispe is not None:
                box = _full(b"ispe", 0, 0, struct.pack(">II", *alpha_ispe))
            ps.append((prop(box), kind in (b"av1C", b"colr")))
        payload = single[boxes[b"mdat"][0] + 8 : boxes[b"mdat"][1]]
        if item_id == 2:
            ps.append((prop(_full(b"auxC", 0, 0,
                                  b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0")), True))
            if alpha_payload is not None:
                payload = alpha_payload
        items.append((item_id, ps, payload))
    ftyp = _box(b"ftyp", b"avif\0\0\0\0avifmif1miaf")
    hdlr = _full(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 13)
    pitm = _full(b"pitm", 0, 0, struct.pack(">H", 1))
    iinf = _full(b"iinf", 0, 0, struct.pack(">H", 2) + b"".join(
        _full(b"infe", 2, 0, struct.pack(">HH", i, 0) + b"av01\0") for i, _, _ in items))
    iref = _full(b"iref", 0, 0, _box(b"auxl", struct.pack(">HHH", 2, 1, 1)))
    assoc = b"".join(struct.pack(">HB", i, len(ps)) + bytes(k | (0x80 if e else 0) for k, e in ps)
                     for i, ps, _ in items)
    iprp = _box(b"iprp", _box(b"ipco", b"".join(props))
                + _full(b"ipma", 0, 0, struct.pack(">I", 2) + assoc))

    def meta(offset: int) -> bytes:
        entries = b""
        for i, _, payload in items:
            entries += struct.pack(">HHHII", i, 0, 1, offset, len(payload))
            offset += len(payload)
        iloc = _full(b"iloc", 0, 0, bytes([0x44, 0x00]) + struct.pack(">H", 2) + entries)
        return _full(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iref + iprp)

    head = ftyp + meta(0)
    head = ftyp + meta(len(head) + 8)
    return head + _box(b"mdat", b"".join(p for _, _, p in items))


def aom_yuv(rgb: np.ndarray, subsampling: str = "4:2:0", depth: int = 8) -> List[np.ndarray]:
    """The planes of an RGB uint8 picture for :func:`aom_encode`: BT.601 at
    full range (the matrix :func:`aom_avif` names by default), chroma
    averaged over its 2 x 2 or 2 x 1 blocks, scaled to ``depth`` bits."""
    f = rgb.astype(np.float64)
    y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    u = (f[..., 2] - y) / 1.772 + 128
    v = (f[..., 0] - y) / 1.402 + 128
    top = (1 << depth) - 1

    def scale(a):
        return np.clip(np.rint(a * top / 255), 0, top).astype(np.int64)

    if subsampling == "4:0:0":
        return [scale(y)]
    sx, sy = {"4:2:0": (1, 1), "4:2:2": (1, 0), "4:4:4": (0, 0)}[subsampling]
    h, w = y.shape

    def sub(c):
        c = np.pad(c, ((0, (-h) % (1 << sy)), (0, (-w) % (1 << sx))), mode="edge")
        return c.reshape(c.shape[0] >> sy, 1 << sy, c.shape[1] >> sx, 1 << sx).mean((1, 3))

    return [scale(y), scale(sub(u)), scale(sub(v))]


class _AomDecCfg(ctypes.Structure):
    """``aom_codec_dec_cfg_t``."""
    _fields_ = [("threads", _U), ("w", _U), ("h", _U), ("allow_lowbitdepth", _U)]


def aom_decode_frames(obus: bytes, units: Optional[Sequence[bytes]] = None) -> List[List[np.ndarray]]:
    """Every frame libaom's own decoder (``aom_codec_av1_dx``) outputs for
    ``obus`` (one temporal unit), or for each temporal unit of ``units``:
    a list of the planes (Y, or Y, U and V, at the coded bit depth) per
    shown frame, in output order."""
    lib = libaom()
    vp = ctypes.c_void_p
    if "dx" not in _AOM_ABI:
        lib.aom_codec_av1_dx.restype = vp
        lib.aom_codec_dec_init_ver.argtypes = [vp, vp, ctypes.POINTER(_AomDecCfg), ctypes.c_long,
                                               _I]
        lib.aom_codec_decode.argtypes = [vp, ctypes.c_char_p, ctypes.c_size_t, vp]
        lib.aom_codec_get_frame.restype = ctypes.POINTER(AomImage)
        lib.aom_codec_get_frame.argtypes = [vp, ctypes.POINTER(vp)]
        _AOM_ABI["dx"] = None
    ctx = ctypes.create_string_buffer(512)
    cfg = _AomDecCfg(1, 0, 0, 0)
    versions = [_AOM_ABI["dx"]] if _AOM_ABI["dx"] is not None else range(1, 100)
    for ver in versions:
        rc = lib.aom_codec_dec_init_ver(ctx, lib.aom_codec_av1_dx(), ctypes.byref(cfg), 0, ver)
        if rc != 3:
            break
    assert rc == 0, rc
    _AOM_ABI["dx"] = ver
    out = []
    try:
        for tu in ([obus] if units is None else units):
            if lib.aom_codec_decode(ctx, tu, len(tu), None) != 0:
                out.append(None)
                continue
            it = ctypes.c_void_p()
            while True:
                img = lib.aom_codec_get_frame(ctx, ctypes.byref(it))
                if not img:
                    break
                im = img.contents
                high = bool(im.fmt & 0x800)
                planes = []
                for p in range(1 if im.monochrome else 3):
                    sx, sy = (im.x_chroma_shift, im.y_chroma_shift) if p else (0, 0)
                    w, h = (im.d_w + sx) >> sx, (im.d_h + sy) >> sy
                    rows = []
                    for y in range(h):
                        raw = ctypes.string_at(im.planes[p] + y * im.stride[p], w * (2 if high else 1))
                        rows.append(np.frombuffer(raw, np.uint16 if high else np.uint8))
                    planes.append(np.stack(rows).astype(np.int32))
                out.append(planes)
    finally:
        lib.aom_codec_destroy(ctx)
    return out


def moving_drawing(n: int, h: int, w: int, kind: str = "shift", seed: int = 0) -> List[np.ndarray]:
    """``n`` RGB frames of a seeded drawing (anti-aliased lines and discs,
    lightly blurred) moved from frame to frame: ``shift`` by sub-pixel
    steps (0.7, 0.45), ``rotate`` by 1.5 degrees, ``zoom`` by 3 percent."""
    import cv2

    rng = np.random.RandomState(seed)
    hh, ww = h + 32, w + 32
    base = np.full((hh, ww, 3), 255, np.uint8)
    for _ in range(12):
        c = tuple(int(v) for v in rng.randint(0, 255, 3))
        p = rng.randint(0, max(hh, ww), 4)
        cv2.line(base, (int(p[0]), int(p[1])), (int(p[2]), int(p[3])), c,
                 int(rng.randint(1, 5)), cv2.LINE_AA)
        cv2.circle(base, (int(rng.randint(0, ww)), int(rng.randint(0, hh))),
                   int(rng.randint(3, 20)), c, -1, cv2.LINE_AA)
    base = cv2.GaussianBlur(base, (3, 3), 0)
    frames = []
    for k in range(n):
        if kind == "shift":
            m = np.float32([[1, 0, -16 + 0.7 * k], [0, 1, -16 + 0.45 * k]])
        else:
            m = cv2.getRotationMatrix2D((ww / 2, hh / 2), 1.5 * k if kind == "rotate" else 0,
                                        1.0 if kind == "rotate" else 1 + 0.03 * k)
            m[:, 2] -= 16
        frames.append(cv2.warpAffine(base, m, (w, h), flags=cv2.INTER_LINEAR,
                                     borderMode=cv2.BORDER_REFLECT))
    return frames


def av1_hidden_before(units: Sequence[bytes], count: int = 2) -> bytes:
    """The first ``count`` temporal units of a libaom stream (a shown key
    frame, then units that may hold hidden frames, an ALTREF among them)
    as one, with the key frame hidden (``showable_frame`` 1, refreshing
    every slot) and no temporal delimiters: its first shown frame is then
    an inter frame after a hidden key frame and whatever hidden frames
    libaom wrote before it (compound prediction, skip mode)."""
    first = av1_hidden_key(b"".join(u for u in units[:1]))
    key = [u for u in _av1_units(first) if u[0] != 3]  # without the show_existing
    rest = [u for tu in units[1:count] for u in _av1_units(tu) if u[0] not in (1, 2)]
    return _av1_join([u for u in key if u[0] != 2] + rest)


def av1_intra_only(payload: bytes, refresh: int = 0x01) -> bytes:
    """A shown key frame's OBUs (``OBU_FRAME``, full sequence header, no
    frame ids or decoder model) rewritten as a shown INTRA_ONLY frame:
    ``frame_type`` 2, ``error_resilient_mode`` 1, ``refresh_frame_flags``
    as given, every ``ref_order_hint`` 0 (an intra-only frame codes its
    tiles as a key frame does)."""
    from molnextr_tpu_torch.data import av1_obu

    units, seq = [], None
    for kind, head, body in _av1_units(payload):
        if kind == 1:
            seq = av1_obu.sequence_header(av1_obu.BitReader(body))
        elif kind == 6:
            r = av1_obu.BitReader(body)
            av1_obu.frame_header(r, seq, 0, 0)
            bits = _bits(body)
            assert bits[:4] == "0001"
            p = 5
            p += seq.screen_tools == 2
            screen = int(bits[5]) if seq.screen_tools == 2 else seq.screen_tools
            p += bool(screen and seq.integer_mv == 2)
            p += 1 + seq.order_hint_bits
            hints = "0" * (8 * seq.order_hint_bits)  # ref_order_hint[]: every slot's is 0
            new = "0" + "10" + "1" + "1" + bits[4:p] + format(refresh, "08b") + hints + \
                bits[p : r.bit]
            body = _unbits(new) + body[(r.bit + 7) // 8 :]
        units.append((kind, head, body))
    return _av1_join(units)
