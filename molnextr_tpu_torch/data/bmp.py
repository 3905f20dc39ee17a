"""A BMP reader in Python and numpy, exact against ``cv2.imread``.

:func:`decode_bmp` returns RGB uint8 ``(H, W, 3)`` as OpenCV's BMP decoder
(``grfmt_bmp.cpp``) gives it under ``IMREAD_COLOR``:

* headers: OS/2 ``BITMAPCOREHEADER`` (12 bytes, 3-byte palette entries) and
  every header of 36 bytes or more (``BITMAPINFOHEADER``, v4, v5), read for
  their first 40 bytes; the palette is read right after the header, the
  pixels from the file's pixel offset;
* depths: 1, 4 and 8 bits through the palette (a short palette leaves the
  entries past it black), 16 bits as 555 (``BI_RGB``, or ``BI_BITFIELDS``
  with the 555 masks) and 565 (``BI_BITFIELDS``), each channel shifted up
  with its low bits zero; 24 bits; 32 bits with the fourth byte dropped,
  or, under ``BI_BITFIELDS`` with a header of 56 bytes or more whose red,
  green and blue masks are all set, each channel taken through its mask and
  scaled to 8 bits as ``v * 255 // max`` (alpha is dropped either way);
* ``BI_RLE8`` and ``BI_RLE4``: encoded and absolute runs, end of line, end
  of bitmap and delta; the pixels that an end of line, end of bitmap or
  delta skips take palette entry 0, as OpenCV fills them; a run that would
  cross the end of its line stops the decoding there, leaving the rest
  black;
* rows bottom-up (positive height) or top-down (negative), each padded to 4
  bytes.

A file cut short, a compression other than the above (``BI_JPEG``,
``BI_PNG``, ``BI_ALPHABITFIELDS``), 16-bit bit fields other than 555 and
565, or a header of another size reads as None, as in OpenCV.
"""

from __future__ import annotations

import struct

import numpy as np

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


def _header(data: bytes):
    """(width, height, bpp, compression, palette (256, 3) RGB, pixel offset,
    32-bit masks (red, green, blue) or None)."""
    (offset, size) = struct.unpack_from("<II", data, 10)
    palette = np.zeros((256, 3), np.uint8)
    masks = None
    if size >= 36:
        width, height, _planes, bpp, comp = struct.unpack_from("<iiHHi", data, 18)
        if not 0 <= comp <= BI_BITFIELDS:
            raise ValueError("BMP: unknown compression")
        (used,) = struct.unpack_from("<i", data, 46)
        if bpp == 32 and comp == BI_BITFIELDS and size >= 56:
            masks = struct.unpack_from("<III", data, 54)
            if not all(masks):
                masks = None
        pos = 14 + size
        if bpp <= 8:
            if not 0 <= used <= 256:
                raise ValueError("BMP: palette size")
            n = used or 1 << bpp
            raw = np.frombuffer(data, np.uint8, 4 * n, pos).reshape(n, 4)
            palette[:n] = raw[:, 2::-1]
        elif bpp == 16 and comp == BI_BITFIELDS:
            fields = struct.unpack_from("<III", data, pos)  # red, green, blue
            if fields == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            elif fields != (0xF800, 0x7E0, 0x1F):
                raise ValueError("BMP: 16-bit bit fields other than 555 and 565")
        elif bpp == 16 and comp == BI_RGB:
            bpp = 15
    elif size == 12:
        width, height, _planes, bpp = struct.unpack_from("<HHHH", data, 18)
        comp = BI_RGB
        if bpp <= 8:
            n = 1 << bpp
            raw = np.frombuffer(data, np.uint8, 3 * n, 26).reshape(n, 3)
            palette[:n] = raw[:, ::-1]
    else:
        raise ValueError("BMP: header size")
    ok = width > 0 and height != 0 and (
        (bpp in (1, 4, 8, 24, 32) and comp == BI_RGB) or (bpp == 15 and comp in (BI_RGB, BI_BITFIELDS))
        or (bpp in (16, 32) and comp == BI_BITFIELDS) or (bpp == 4 and comp == BI_RLE4)
        or (bpp == 8 and comp == BI_RLE8))
    if not ok:
        raise ValueError("BMP: unsupported depth and compression")
    return width, height, bpp, comp, palette, offset, masks


def _rows(data: bytes, offset: int, width: int, height: int, bpp: int) -> np.ndarray:
    pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
    if offset + pitch * height > len(data):
        raise ValueError("BMP: pixel data past the end of the file")
    return np.frombuffer(data, np.uint8, pitch * height, offset).reshape(height, pitch)


def _unpacked(rows: np.ndarray, width: int, bpp: int) -> np.ndarray:
    if bpp == 8:
        return rows[:, :width]
    shifts = np.arange(8 - bpp, -1, -bpp, dtype=np.uint8)
    return ((rows[:, :, None] >> shifts) & ((1 << bpp) - 1)).reshape(len(rows), -1)[:, :width]


def _rle(data: bytes, offset: int, width: int, height: int, four: bool,
         palette: np.ndarray) -> np.ndarray:
    """The decoded rows (first decoded first) of an RLE8 or RLE4 bitmap,
    following OpenCV's loop: ``x``/``y`` are the write position, skips fill
    with palette entry 0 and wrap to the next lines."""
    idx = np.zeros((height, width), np.int64)  # a skipped pixel keeps index 0
    written = np.zeros((height, width), bool)  # False where nothing was written: black
    n = len(data)
    pos, x, y = offset, 0, 0
    wrapped = False  # RLE8: the last run ended its line and moved to the next

    def fill(count):
        """OpenCV's FillUniColor with entry 0: ``count`` pixels, wrapping."""
        nonlocal x, y
        while True:
            take = min(count, width - x)
            written[y, x : x + take] = True
            x += take
            count -= take
            if x >= width:
                x = 0
                y += 1
                if y >= height:
                    return
            if count <= 0:
                return

    while True:
        if pos + 2 > n:
            raise ValueError("BMP: RLE data past the end of the file")
        length, code = data[pos], data[pos + 1]
        pos += 2
        if length:  # encoded run
            if x + length > width:
                raise ValueError("BMP: an RLE run crosses the end of its line")
            if four:
                pair = np.array([code >> 4, code & 15])
                idx[y, x : x + length] = pair[np.arange(length) & 1]
                written[y, x : x + length] = True
                x += length
            else:
                start = y
                idx[y, x : x + length] = code
                written[y, x : x + length] = True
                x += length
                if x >= width:
                    x = 0
                    y += 1
                wrapped = y != start
                if y >= height:
                    break
        elif code > 2:  # absolute run
            if x + code > width:
                raise ValueError("BMP: an RLE run crosses the end of its line")
            size = (((code + 1) >> 1) + 1) & ~1 if four else (code + 1) & ~1
            if pos + size > n:
                raise ValueError("BMP: RLE data past the end of the file")
            raw = np.frombuffer(data, np.uint8, size, pos)
            pos += size
            vals = np.stack([raw >> 4, raw & 15], 1).reshape(-1) if four else raw
            idx[y, x : x + code] = vals[:code]
            written[y, x : x + code] = True
            x += code
            wrapped = False
        else:  # 0 end of line, 1 end of bitmap, 2 delta
            skip, down = width - x, height - y
            if code == 2:
                if pos + 2 > n:
                    raise ValueError("BMP: RLE data past the end of the file")
                skip, down = data[pos], data[pos + 1]
                pos += 2
            if four or code or not wrapped or skip < width:
                # OpenCV 5's RLE4 loop never moves down: its end of bitmap
                # ends the line and its delta skips dx pixels only
                count = skip + (down * width if code and not four else 0)
                if not four and y >= height:
                    break
                fill(count)
                if y >= height:
                    break
            wrapped = False
            if y >= height:
                break
    rgb = palette[idx]
    rgb[~written] = 0
    return rgb


def decode_bmp(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """RGB uint8 (H, W, 3) of a BMP file's bytes, as OpenCV reads it
    (module doc).  Raises ``ValueError`` where OpenCV gives None."""
    if data[:2] != b"BM" or len(data) < 18:
        raise ValueError(f"{path}: not a BMP file")
    width, height, bpp, comp, palette, offset, masks = _header(data)
    top_down = height < 0
    height = abs(height)
    if comp in (BI_RLE8, BI_RLE4):
        out = _rle(data, offset, width, height, comp == BI_RLE4, palette)
    else:
        rows = _rows(data, offset, width, height, bpp)
        if bpp <= 8:
            out = palette[_unpacked(rows, width, bpp)]
        elif bpp in (15, 16):
            v = rows[:, : 2 * width].view("<u2").astype(np.int64)
            if bpp == 15:
                r, g, b = (v >> 7) & 0xF8, (v >> 2) & 0xF8, (v << 3) & 0xF8
            else:
                r, g, b = (v >> 8) & 0xF8, (v >> 3) & 0xFC, (v << 3) & 0xF8
            out = np.stack([r, g, b], -1).astype(np.uint8)
        elif masks is not None:
            v = rows[:, : 4 * width].view("<u4").astype(np.int64)
            chans = []
            for m in masks:
                shift = (m & -m).bit_length() - 1
                chans.append(((v & m) >> shift) * 255 // (m >> shift))
            out = np.stack(chans, -1).astype(np.uint8)
        else:
            nch = bpp // 8
            out = rows[:, : nch * width].reshape(height, width, nch)[:, :, 2::-1]
    return np.ascontiguousarray(out if top_down else out[::-1])
