"""A TIFF reader in Python and numpy, exact against ``cv2.imread``.

OpenCV reads an 8-bit colour TIFF through libtiff's RGBA interface
(``tif_getimage.c``) and drops the alpha it returns.  :func:`decode_tiff`
reads the first page the same way and returns RGB uint8 ``(H, W, 3)``:

* layout: classic TIFF and BigTIFF (8-byte offsets and counts, ``LONG8``,
  ``SLONG8`` and ``IFD8`` values), both byte orders, strips and tiles,
  planar configuration 1 and 2,
  ``FillOrder`` 2 (bits reversed in each byte before decoding);
* compressions: none (1), CCITT MH (2), T.4 1-D and 2-D (3) and T.6 (4)
  (``data/ccitt.py``), LZW (5), Deflate (8 and 32946), PackBits (32773);
  horizontal differencing (predictor 2) on 8- and 16-bit samples;
* samples (libtiff's maps): grey (MinIsBlack, MinIsWhite) at 1, 2, 4 and 8
  bits as ``v * 255 // max`` (MinIsWhite inverted), at 16 bits by the high
  byte; RGB at 8 bits as stored and at 16 bits as ``(v + 128) // 257``; a
  palette at 1, 2, 4 and 8 bits through its colour map, each entry shifted
  right by 8 unless every entry is below 256 (libtiff then assumes an 8-bit
  map); an unassociated alpha (``ExtraSamples`` 2) premultiplies RGB as
  ``(v * a + 127) // 255``, while other extra samples, and any beside grey,
  are dropped; more than four samples read as None, as in OpenCV;
* the orientation tag (274): 2-4 flip as OpenCV flips, 5-8 turn as the JPEG
  ones do (``data/exif.py``).

Differences by design, each pinned by a test: OpenCV 5.0 fails to read
orientations 5-8 (it returns None), and refuses grey at 2 and 4 bits and
palettes at 2 bits, which the port reads as libtiff's maps give them.

JPEG-in-TIFF (6, 7), LZMA, ZSTD, WebP, JBIG, JPEG 2000 and LERC
compressions, float, signed and 10-64-bit samples (predictor 3 included),
and the CMYK, YCbCr and CIE Lab photometric interpretations raise
:class:`UnsupportedFormat` naming the form.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List

import numpy as np

from molnextr_tpu_torch.data import ccitt
from molnextr_tpu_torch.data.exif import apply_orientation
from molnextr_tpu_torch.data.image import UnsupportedFormat

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
          11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}
_UNSUPPORTED_COMPRESSION = {
    6: "old-style JPEG", 7: "JPEG", 34892: "lossy JPEG", 34925: "LZMA", 50000: "ZSTD",
    34926: "ZSTD", 50001: "WebP", 34927: "WebP", 34661: "JBIG", 9: "JBIG", 10: "JBIG",
    34712: "JPEG 2000", 33003: "JPEG 2000", 33005: "JPEG 2000", 34887: "LERC",
}
_PHOTOMETRIC = {5: "CMYK", 6: "YCbCr", 8: "CIE Lab", 9: "ICC Lab", 10: "ITU Lab",
                32844: "LogL", 32845: "LogLuv", 4: "transparency mask"}
_CHUNK_TAGS = (273, 279, 324, 325)  # strip and tile offsets and byte counts
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _unsupported(path: str, what: str) -> UnsupportedFormat:
    return UnsupportedFormat(f"{path}: TIFF with {what} is not decoded by the port yet "
                             "(ROADMAP queue 1)")


def _tags(data: bytes, order: str, ifd: int, big: bool = False) -> Dict[int, List]:
    """Every tag of the IFD at ``ifd`` -> its values.  A BigTIFF IFD has an
    8-byte count, 20-byte entries and values of up to 8 bytes in place."""
    word, entry, inline = ("Q", 20, 8) if big else ("I", 12, 4)
    (count,) = struct.unpack_from(order + ("Q" if big else "H"), data, ifd)
    first = ifd + (8 if big else 2)
    tags: Dict[int, List] = {}
    for k in range(count):
        tag, typ, n = struct.unpack_from(order + "HH" + word, data, first + entry * k)
        if typ not in _TYPES or (typ == 18 and tag in _CHUNK_TAGS):
            continue  # libtiff refuses IFD8 strip or tile offsets and counts
        fmt = _TYPES[typ]
        size = struct.calcsize(order + fmt) * n
        at = first + entry * k + (12 if big else 8)  # after tag, type and count
        if size > inline:
            (at,) = struct.unpack_from(order + word, data, at)
        if at + size > len(data):
            raise ValueError("TIFF: tag data past the end of the file")
        vals = list(struct.unpack_from(order + fmt * n, data, at))
        tags[tag] = vals
    return tags


def _lzw(data: bytes, expected: int) -> bytes:
    """TIFF LZW (MSB first, code width grown one code early)."""
    if data[:2] == b"\x00\x01":
        raise ValueError("TIFF: old-style LZW")
    b = np.frombuffer(data + bytes(4), np.uint8).astype(np.int64)
    win = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
    nbits_total = len(data) * 8
    base = [bytes([i]) for i in range(256)] + [b"", b""]
    table = list(base)
    out = bytearray()
    pos, width, prev = 0, 9, None
    while len(out) < expected:
        if pos + width > nbits_total:
            break
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
                raise ValueError("TIFF: corrupt LZW data")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("TIFF: corrupt LZW data")
        out += entry
        prev = entry
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def _packbits(data: bytes, expected: int) -> bytes:
    out = bytearray()
    pos, n = 0, len(data)
    while pos < n and len(out) < expected:
        c = data[pos]
        pos += 1
        if c < 128:
            out += data[pos : pos + c + 1]
            pos += c + 1
        elif c > 128:
            if pos < n:
                out += bytes([data[pos]]) * (257 - c)
            pos += 1
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
        t = _tags(data, order, ifd, big)
        self.tags = t
        self.width, self.height = t[256][0], t[257][0]
        self.spp = t.get(277, [1])[0]
        bps = t.get(258, [1] * self.spp)
        self.bps = bps[0]
        self.compression = t.get(259, [1])[0]
        if 262 not in t:
            raise ValueError(f"{path}: TIFF without a photometric interpretation")
        self.photometric = t[262][0]
        self.planar = t.get(284, [1])[0]
        self.predictor = t.get(317, [1])[0]
        self.fill_order = t.get(266, [1])[0]
        self.orientation = t.get(274, [1])[0]
        self.extra = t.get(338, [])
        self.t4 = t.get(292, [0])[0]
        self._check(bps)

    def _check(self, bps: List[int]) -> None:
        path, t = self.path, self.tags
        if self.compression in _UNSUPPORTED_COMPRESSION:
            raise _unsupported(path, f"{_UNSUPPORTED_COMPRESSION[self.compression]} compression")
        if self.compression not in (1, 2, 3, 4, 5, 8, 32946, 32773):
            raise ValueError(f"{path}: TIFF compression {self.compression}")
        formats = set(t.get(339, [1]))
        if 3 in formats or self.predictor == 3:
            raise _unsupported(path, "float samples")
        if formats - {1}:
            raise _unsupported(path, "signed samples")
        if self.photometric in _PHOTOMETRIC:
            raise _unsupported(path, f"{_PHOTOMETRIC[self.photometric]} photometric "
                                     "interpretation")
        if self.photometric not in (0, 1, 2, 3):
            raise ValueError(f"{path}: TIFF photometric interpretation {self.photometric}")
        if len(set(bps)) != 1:
            raise ValueError(f"{path}: TIFF with mixed bit depths")
        if self.bps not in (1, 2, 4, 8, 16):
            raise _unsupported(path, f"{self.bps}-bit samples")
        if self.spp > 4 or self.spp < 1:
            raise ValueError(f"{path}: TIFF with {self.spp} samples a pixel")
        if self.photometric == 2 and (self.spp < 3 or self.bps not in (8, 16)):
            raise ValueError(f"{path}: RGB TIFF of {self.spp} samples at {self.bps} bits")
        if self.photometric == 3 and (self.bps > 8 or 320 not in t):
            raise ValueError(f"{path}: palette TIFF at {self.bps} bits")
        if self.predictor == 2 and self.bps not in (8, 16):
            raise ValueError(f"{path}: TIFF predictor 2 at {self.bps} bits")
        if self.compression in (2, 3, 4) and (self.bps != 1 or self.spp != 1):
            raise ValueError(f"{path}: CCITT TIFF that is not bilevel")
        if self.planar == 1 and self.spp > 1 and self.bps < 8 and self.photometric != 3:
            # tif_getimage: "can not handle contiguous data with ... BitsPerSample < 8"
            raise ValueError(f"{path}: contiguous TIFF with {self.spp} samples of "
                             f"{self.bps} bits")

    # -- chunks ------------------------------------------------------------
    def _decompress(self, raw: bytes, rows: int, width: int, spp: int) -> np.ndarray:
        """One strip or tile -> samples (rows, width, spp) (uint8 or uint16)."""
        if self.fill_order == 2:
            raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
        bps = self.bps
        stride = (width * spp * bps + 7) // 8
        expected = stride * rows
        c = self.compression
        if c in (2, 3, 4):
            bits = ccitt.rows_to_bits(ccitt.decode(raw, width, rows, c, self.t4), width)
            return bits[..., None]
        if c == 1:
            buf = raw
        elif c == 5:
            buf = _lzw(raw, expected)
        elif c in (8, 32946):
            buf = zlib.decompressobj().decompress(raw, expected)
        else:
            buf = _packbits(raw, expected)
        if len(buf) < expected:
            raise ValueError(f"{self.path}: TIFF strip or tile shorter than its rows")
        rowdata = np.frombuffer(buf[:expected], np.uint8).reshape(rows, stride)
        if bps == 16:
            samples = rowdata.view(self.order + "u2").reshape(rows, width, spp).astype(np.uint16)
        elif bps == 8:
            samples = rowdata.reshape(rows, width, spp)
        else:
            shifts = np.arange(8 - bps, -1, -bps, dtype=np.uint8)
            vals = (rowdata[:, :, None] >> shifts) & ((1 << bps) - 1)
            samples = vals.reshape(rows, -1)[:, : width * spp].reshape(rows, width, spp)
        if self.predictor == 2:
            mod = np.uint16 if bps == 16 else np.uint8
            samples = np.cumsum(samples.astype(np.int64), axis=1).astype(mod)
        return samples

    def samples(self) -> np.ndarray:
        """All samples of the page, (H, W, spp)."""
        t, h, w = self.tags, self.height, self.width
        planes = self.spp if self.planar == 2 else 1
        per = 1 if self.planar == 2 else self.spp
        dtype = np.uint16 if self.bps == 16 else np.uint8
        out = np.zeros((h, w, self.spp), dtype)
        if 322 in t:
            tw, th = t[322][0], t[323][0]
            offsets, counts = t[324], t[325]
            across, down = -(-w // tw), -(-h // th)
            if len(offsets) < across * down * planes or len(counts) < len(offsets):
                raise ValueError(f"{self.path}: TIFF with missing tiles")
            k = 0
            for p in range(planes):
                for ty in range(down):
                    for tx in range(across):
                        tile = self._decompress(self._chunk(offsets[k], counts[k]), th, tw, per)
                        k += 1
                        y0, x0 = ty * th, tx * tw
                        hh, ww = min(th, h - y0), min(tw, w - x0)
                        out[y0 : y0 + hh, x0 : x0 + ww, p : p + per] = tile[:hh, :ww]
            return out
        rps = min(t.get(278, [h])[0], h)
        offsets, counts = t[273], t[279]
        per_plane = -(-h // rps)
        if len(offsets) < per_plane * planes or len(counts) < len(offsets):
            raise ValueError(f"{self.path}: TIFF with missing strips")
        k = 0
        for p in range(planes):
            for s in range(per_plane):
                y0 = s * rps
                rows = min(rps, h - y0)
                out[y0 : y0 + rows, :, p : p + per] = self._decompress(
                    self._chunk(offsets[k], counts[k]), rows, w, per)
                k += 1
        return out

    def _chunk(self, offset: int, count: int) -> bytes:
        if offset + count > len(self.data):
            raise ValueError(f"{self.path}: TIFF data past the end of the file")
        return self.data[offset : offset + count]

    # -- libtiff's RGBA maps -----------------------------------------------
    def rgb(self) -> np.ndarray:
        s = self.samples()
        bps, ph = self.bps, self.photometric
        if ph in (0, 1):
            v = s[..., 0].astype(np.int64)
            if bps == 16:
                v = v >> 8
                top = 255
            else:
                top = (1 << bps) - 1
            grey = (v * 255) // top if ph == 1 else ((top - v) * 255) // top
            return np.repeat(grey.astype(np.uint8)[..., None], 3, axis=2)
        if ph == 3:
            cmap = np.asarray(self.tags[320], np.int64).reshape(3, -1)
            if cmap.shape[1] < 1 << bps:
                raise ValueError(f"{self.path}: TIFF colour map too short")
            if (cmap >= 256).any():
                cmap = cmap >> 8
            return cmap[:, s[..., 0].astype(np.int64)].transpose(1, 2, 0).astype(np.uint8)
        rgb = s[..., :3].astype(np.int64)
        if bps == 16:
            rgb = (rgb + 128) // 257
        if self.spp == 4 and self.extra[:1] == [2]:
            alpha = s[..., 3:4].astype(np.int64)
            if bps == 16:
                alpha = (alpha + 128) // 257
            rgb = (rgb * alpha + 127) // 255
        return rgb.astype(np.uint8)


def decode_tiff(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """RGB uint8 (H, W, 3) of the first page of a TIFF file's bytes, as
    OpenCV reads it (module doc)."""
    img = _Image(data, path)
    orientation = img.orientation if 1 <= img.orientation <= 8 else 1
    return apply_orientation(img.rgb(), orientation)
