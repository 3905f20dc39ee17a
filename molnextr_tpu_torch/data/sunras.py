"""A Sun raster reader in Python and numpy, exact against ``cv2.imread``.

:func:`decode_sunras` returns RGB uint8 ``(H, W, 3)`` as OpenCV's Sun raster
decoder (``grfmt_sunras.cpp``) gives it under ``IMREAD_COLOR``:

* the 32-byte big-endian header: magic, width, height, depth, length,
  type, colour-map type and length;
* types ``RT_OLD`` (0), ``RT_STANDARD`` (1), ``RT_BYTE_ENCODED`` (2, the
  RLE: ``0x80 0`` is one 0x80, ``0x80 n v`` is n + 1 copies of v, runs
  crossing rows) and ``RT_FORMAT_RGB`` (3);
* depths 1 and 8 through an ``RMT_EQUAL_RGB`` colour map (all reds, then
  greens, then blues; entries past a short map are black) or, with no map,
  as grey (1 bit: 1 is white); 24 bits as B, G, R (R, G, B under
  ``RT_FORMAT_RGB``); 32 bits as a pad byte then B, G, R (R, G, B);
* rows padded to 16 bits.

A truncated file, an unknown type or map, or a map longer than the depth
allows reads as None, as in OpenCV.  A difference by design, pinned by a
test: OpenCV 5 returns None for every ``RT_BYTE_ENCODED`` and
``RT_FORMAT_RGB`` file (its header check refuses both types), and the
port reads them, to the pixels
OpenCV gives the ``RT_STANDARD`` file of the same image.
"""

from __future__ import annotations

import struct

import numpy as np

RT_OLD, RT_STANDARD, RT_BYTE_ENCODED, RT_FORMAT_RGB = 0, 1, 2, 3
RMT_NONE, RMT_EQUAL_RGB = 0, 1


def _unrle(data: bytes, pos: int, size: int) -> bytes:
    """``size`` bytes of a Sun RLE stream starting at ``pos``."""
    out = bytearray()
    n = len(data)
    while len(out) < size:
        if pos >= n:
            raise ValueError("Sun raster: RLE data past the end of the file")
        b = data[pos]
        pos += 1
        if b != 0x80:
            out.append(b)
            continue
        if pos >= n:
            raise ValueError("Sun raster: RLE data past the end of the file")
        count = data[pos]
        pos += 1
        if count == 0:
            out.append(0x80)
            continue
        if pos >= n:
            raise ValueError("Sun raster: RLE data past the end of the file")
        out += bytes([data[pos]]) * (count + 1)
        pos += 1
    return bytes(out[:size])


def decode_sunras(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """RGB uint8 (H, W, 3) of a Sun raster file's bytes, as OpenCV reads it
    (module doc).  Raises ``ValueError`` where OpenCV gives None."""
    if len(data) < 32 or data[:4] != b"\x59\xa6\x6a\x95":
        raise ValueError(f"{path}: not a Sun raster file")
    width, height, bpp, _length, kind, maptype, maplength = struct.unpack_from(">7i", data, 4)
    if width <= 0 or height <= 0 or bpp not in (1, 8, 24, 32):
        raise ValueError(f"{path}: Sun raster of {bpp} bits")
    if kind not in (RT_OLD, RT_STANDARD, RT_BYTE_ENCODED, RT_FORMAT_RGB):
        raise ValueError(f"{path}: Sun raster type {kind}")
    palsize = 3 << bpp if bpp <= 8 else 0
    if not ((maptype == RMT_NONE and maplength == 0)
            or (maptype == RMT_EQUAL_RGB and 0 < maplength <= palsize)):
        raise ValueError(f"{path}: Sun raster colour map")
    offset = 32 + maplength
    if offset > len(data):
        raise ValueError(f"{path}: Sun raster colour map past the end of the file")
    palette = None
    if bpp <= 8:
        palette = np.zeros((256, 3), np.uint8)
        if maplength:
            n = maplength // 3
            cmap = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)
            palette[:n] = cmap.T
        else:
            levels = np.arange(1 << bpp) * 255 // ((1 << bpp) - 1)
            palette[: 1 << bpp] = levels[:, None]
    pitch = ((width * bpp + 7) // 8 + 1) & -2
    size = pitch * height
    if kind == RT_BYTE_ENCODED:
        raw = _unrle(data, offset, size)
    else:
        if offset + size > len(data):
            raise ValueError(f"{path}: Sun raster pixels past the end of the file")
        raw = data[offset : offset + size]
    rows = np.frombuffer(raw, np.uint8).reshape(height, pitch)
    if bpp == 1:
        return palette[np.unpackbits(rows, axis=1)[:, :width]]
    if bpp == 8:
        return palette[rows[:, :width]]
    nch = bpp // 8
    px = rows[:, : nch * width].reshape(height, width, nch)[:, :, nch - 3 :]
    return np.ascontiguousarray(px if kind == RT_FORMAT_RGB else px[:, :, ::-1])
