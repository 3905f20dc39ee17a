"""Hand encoders for the image-reader tests: files that ``cv2.imwrite`` and
PIL do not write, read back by ``cv2.imread`` as the reference.

* :func:`encode_tiff`: a TIFF from raw or already-compressed strips or
  tiles and any tags (both byte orders, a second page on request);
* :func:`encode_jpeg`: a baseline JPEG from component planes at any
  sampling factors (1-4), with any component ids, an Adobe APP14 marker
  and restart markers; fixed-length Huffman codes, so no table needs
  building;
* :func:`exif_block`, :func:`with_jpeg_exif`, :func:`with_png_exif`: an
  EXIF orientation in either byte order, put into a JPEG or a PNG.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II"}


def encode_tiff(chunks: Sequence[bytes], width: int, height: int,
                tags: Dict[int, Tuple[int, list]], order: str = "<",
                second_page: Optional[Dict[int, Tuple[int, list]]] = None) -> bytes:
    """A TIFF whose strips (or tiles, when ``tags`` has 322) are ``chunks``;
    the size and the chunks' offsets and counts are filled in.  A
    ``second_page`` is an IFD of its own tags, pointing at the same chunks."""
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
        tags[324 if tiled else 273] = (4, offsets)
        tags[325 if tiled else 279] = (4, [len(c) for c in chunks])
        entries = sorted(tags.items())
        size = 2 + 12 * len(entries) + 4
        head, extra = bytearray(struct.pack(order + "H", len(entries))), bytearray()
        for tag, (typ, vals) in entries:
            if typ == 2:
                raw = bytes(vals)
            elif typ == 5:
                raw = b"".join(struct.pack(order + "II", *v) for v in vals)
            else:
                raw = struct.pack(order + _TYPES[typ] * len(vals), *vals)
            n = len(raw) if typ == 2 else len(vals)
            if len(raw) <= 4:
                head += struct.pack(order + "HHI", tag, typ, n) + raw.ljust(4, b"\x00")
            else:
                head += struct.pack(order + "HHII", tag, typ, n, base + size + len(extra))
                extra += raw + b"\x00" * (len(raw) % 2)
        head += struct.pack(order + "I", next_ifd)
        return bytes(head + extra)

    first = len(out)
    struct.pack_into(order + "I", out, 4, first)
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
