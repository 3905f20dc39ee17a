"""A GIF reader in Python and numpy, exact against ``cv2.imread``.

:func:`decode_gif` returns RGB uint8 ``(H, W, 3)`` of a GIF87a or GIF89a
file's first frame as OpenCV 5's GIF decoder (``grfmt_gif.cpp``) gives it
under ``IMREAD_COLOR``:

* the canvas is the logical screen, filled with the global table's
  background colour; the first frame is drawn at its offset, through its
  local table or the global one, rows de-interlaced; its transparent index
  (a graphic control extension) leaves the background showing;
* LZW with the code width growing from the minimum code size + 1 to 12
  bits, clear and end codes, sub-blocks of up to 255 bytes; as in OpenCV,
  codes are read until the frame is full, then one more (whatever it is),
  after which less than a byte may remain; an end code, a code past the table, a string overflowing the frame or the
  data's end before the frame is full is an error.  The LZW loop runs in
  Python, a code at a time.

An animated file reads as its first frame, as ``cv2.imread`` reads it.  A
file cut short or corrupt, one without its trailer, one whose first frame
lies outside the logical screen, or whose background index lies past the
global table reads as None, as in OpenCV (which walks every block of the
file).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def _subblocks(data: bytes, pos: int) -> Tuple[bytes, int]:
    """The bytes of a run of sub-blocks at ``pos``, and the position after
    its terminating empty block."""
    parts = []
    n = len(data)
    while True:
        if pos >= n:
            raise ValueError("GIF: data past the end of the file")
        size = data[pos]
        pos += 1
        if size == 0:
            return b"".join(parts), pos
        if pos + size > n:
            raise ValueError("GIF: data past the end of the file")
        parts.append(data[pos : pos + size])
        pos += size


def _lzw(data: bytes, min_size: int, count: int) -> np.ndarray:
    """``count`` indices of a GIF LZW stream (LSB first)."""
    if not 1 <= min_size <= 11:
        raise ValueError("GIF: LZW minimum code size")
    clear, end = 1 << min_size, (1 << min_size) + 1
    b = np.frombuffer(data + bytes(4), np.uint8).astype(np.int64)
    win = (b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16) | (b[3:] << 24)).tolist()
    nbits = len(data) * 8
    base = [bytes([i]) for i in range(min(clear, 256))] + [b"", b""]
    table = list(base)
    out = bytearray()
    pos, width, prev = 0, min_size + 1, None
    # OpenCV reads codes until the frame is full and ignores the rest; an
    # end code or the data's end before that is an error
    while len(out) < count:
        if pos + width > nbits:
            raise ValueError("GIF: LZW data ends before the frame")
        code = (win[pos >> 3] >> (pos & 7)) & ((1 << width) - 1)
        pos += width
        if code == clear:
            table, width, prev = list(base), min_size + 1, None
            continue
        if code == end:
            raise ValueError("GIF: LZW end code before the frame is full")
        if prev is None:
            if code >= clear:
                raise ValueError("GIF: corrupt LZW data")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table) and len(table) < 4096:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("GIF: corrupt LZW data")
        if len(out) + len(entry) > count:
            raise ValueError("GIF: LZW data longer than the frame")
        out += entry
        prev = entry
        if len(table) >= 1 << width and width < 12:
            width += 1
    # OpenCV reads one more code when the data holds one, and refuses a
    # stream that has a whole byte left after it
    if nbits - pos >= width:
        pos += width
        if nbits - pos >= 8:
            raise ValueError("GIF: LZW data past the end of the frame")
    return np.frombuffer(bytes(out), np.uint8)


def decode_gif(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """RGB uint8 (H, W, 3) of a GIF file's first frame, as OpenCV reads it
    (module doc).  Raises ``ValueError`` where OpenCV gives None."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError(f"{path}: not a GIF file")
    width, height, flags, background, _aspect = struct.unpack_from("<HHBBB", data, 6)
    pos = 13
    gct = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        if pos + 3 * n > len(data):
            raise ValueError(f"{path}: GIF colour table past the end of the file")
        gct = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)
        pos += 3 * n
    if width == 0 or height == 0:
        raise ValueError(f"{path}: GIF of no pixels")
    if gct is not None and background >= len(gct):
        raise ValueError(f"{path}: GIF background index past its colour table")
    fill = gct[background] if gct is not None else np.zeros(3, np.uint8)
    canvas = np.empty((height, width, 3), np.uint8)
    canvas[:] = fill
    transparent = None
    while True:
        if pos >= len(data):
            raise ValueError(f"{path}: GIF without a frame")
        kind = data[pos]
        pos += 1
        if kind == 0x21:  # extension
            if pos >= len(data):
                raise ValueError(f"{path}: GIF extension past the end of the file")
            label = data[pos]
            body, pos = _subblocks(data, pos + 1)
            if label == 0xF9 and len(body) >= 4:
                transparent = body[3] if body[0] & 1 else None
            continue
        if kind != 0x2C:
            raise ValueError(f"{path}: GIF block {kind:#x} before the first frame")
        if pos + 9 > len(data):
            raise ValueError(f"{path}: GIF frame header past the end of the file")
        left, top, w, h, fflags = struct.unpack_from("<HHHHB", data, pos)
        pos += 9
        if left + w > width or top + h > height:
            raise ValueError(f"{path}: GIF frame outside the logical screen")
        table = gct
        if fflags & 0x80:
            n = 2 << (fflags & 7)
            if pos + 3 * n > len(data):
                raise ValueError(f"{path}: GIF colour table past the end of the file")
            table = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)
            pos += 3 * n
        if table is None:
            raise ValueError(f"{path}: GIF frame without a colour table")
        if pos >= len(data):
            raise ValueError(f"{path}: GIF frame past the end of the file")
        min_size = data[pos]
        stream, pos = _subblocks(data, pos + 1)
        idx = _lzw(stream, min_size, w * h).reshape(h, w)
        if fflags & 0x40:  # interlaced: passes of rows 0::8, 4::8, 2::4, 1::2
            rows = np.concatenate([np.arange(h)[0::8], np.arange(h)[4::8],
                                   np.arange(h)[2::4], np.arange(h)[1::2]])
            deinterlaced = np.empty_like(idx)
            deinterlaced[rows] = idx
            idx = deinterlaced
        full = np.zeros((256, 3), np.uint8)
        full[: len(table)] = table
        pixels = full[idx]
        keep = idx != transparent if transparent is not None else np.ones(idx.shape, bool)
        region = canvas[top : top + h, left : left + w]
        region[keep] = pixels[keep]
        _check_rest(data, pos, path)
        return canvas


def _check_rest(data: bytes, pos: int, path: str) -> None:
    """OpenCV reads the whole file: every later block must be whole, and the
    file must end in its trailer."""
    while True:
        if pos >= len(data):
            raise ValueError(f"{path}: GIF without its trailer")
        kind = data[pos]
        pos += 1
        if kind == 0x3B:
            return
        if kind == 0x21:
            _, pos = _subblocks(data, pos + 1)
        elif kind == 0x2C:
            if pos + 9 > len(data):
                raise ValueError(f"{path}: GIF frame header past the end of the file")
            fflags = data[pos + 8]
            pos += 9 + (3 * (2 << (fflags & 7)) if fflags & 0x80 else 0) + 1
            _, pos = _subblocks(data, pos)
        else:
            raise ValueError(f"{path}: GIF block {kind:#x}")
