"""A Radiance HDR reader in Python and numpy, exact against ``cv2.imread``.

OpenCV reads HDR with Bruce Walter's ``rgbe`` code and converts the float
result to 8 bits.  :func:`decode_hdr` does the same and returns RGB uint8
``(H, W, 3)``:

* header: a first line (OpenCV's signature check wants ``#?RADIANCE`` or
  ``#?RGBE``), then lines up to a blank one, among which one must be
  exactly ``FORMAT=32-bit_rle_rgbe`` (``32-bit_rle_xyze`` is refused), then
  the resolution line ``-Y <height> +X <width>`` (the only orientation the
  code takes);
* pixels: new-style run-length scanlines (``2 2 hi lo``, then each of the
  four channels in runs of ``>128`` and literals), and flat RGBE pixels: a
  width below 8 or above 32767 is read flat, and so is the rest of the file
  from the first scanline that does not start with ``2 2``.  Old-style
  runs (``1 1 1 n``) are no escape to this code: they read as the flat
  pixels they are;
* RGBE to float as ``c * 2^(e - 136)`` (0 when ``e`` is 0), then to uint8
  as OpenCV's ``convertTo(..., 255)`` rounds: ``v * 255`` in float32,
  rounded half to even and saturated (so 0.5 reads 128 and 1.5 reads 255;
  a value past int32, as cvRound gives INT_MIN, reads 0).

A header OpenCV refuses, or pixel data cut short, reads as None.  The
run-length loop runs in Python, a run at a time.
"""

from __future__ import annotations

import re

import numpy as np

# sscanf's "-Y %d +X %d"
_RESOLUTION = re.compile(rb"-Y\s*([-+]?\d+)\s*\+X\s*([-+]?\d+)")


def _line(data: bytes, pos: int):
    end = data.find(b"\n", pos)
    if end < 0:
        raise ValueError("HDR: header past the end of the file")
    return data[pos:end], end + 1


def _header(data: bytes):
    """(width, height, offset of the pixels)."""
    line, pos = _line(data, 0)
    seen = False
    while True:
        line, pos = _line(data, pos)
        if line == b"":
            break
        seen = seen or line == b"FORMAT=32-bit_rle_rgbe"
    if not seen:
        raise ValueError("HDR: no FORMAT=32-bit_rle_rgbe line")
    line, pos = _line(data, pos)
    m = _RESOLUTION.match(line)
    if m is None:
        raise ValueError("HDR: resolution line other than -Y h +X w")
    height, width = int(m.group(1)), int(m.group(2))
    if width <= 0 or height <= 0:
        raise ValueError("HDR: size")
    return width, height, pos


def _rle_scanline(data: bytes, pos: int, width: int):
    """One new-style scanline after its 4-byte start: (4, width) bytes and
    the position after it."""
    out = np.empty(4 * width, np.uint8)
    n = len(data)
    k = 0
    for ch in range(4):
        end = (ch + 1) * width
        while k < end:
            if pos + 2 > n:
                raise ValueError("HDR: scanline past the end of the file")
            count, value = data[pos], data[pos + 1]
            if count > 128:
                count -= 128
                if count > end - k:
                    raise ValueError("HDR: bad scanline data")
                out[k : k + count] = value
                k += count
                pos += 2
            else:
                if count == 0 or count > end - k:
                    raise ValueError("HDR: bad scanline data")
                if pos + 1 + count > n:
                    raise ValueError("HDR: scanline past the end of the file")
                out[k : k + count] = np.frombuffer(data, np.uint8, count, pos + 1)
                k += count
                pos += 1 + count
    return out.reshape(4, width).T, pos


def _rgbe(data: bytes, offset: int, width: int, height: int) -> np.ndarray:
    """(H * W, 4) RGBE bytes of the pixels, as ``RGBE_ReadPixels_RLE`` reads them."""
    total = width * height
    if width < 8 or width > 0x7FFF:
        rows, flat_from = [], offset
    else:
        rows, pos = [], offset
        flat_from = None
        for _ in range(height):
            if pos + 4 > len(data):
                raise ValueError("HDR: pixels past the end of the file")
            head = data[pos : pos + 4]
            if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
                flat_from = pos  # not run-length encoded: the rest is flat
                break
            if (head[2] << 8 | head[3]) != width:
                raise ValueError("HDR: wrong scanline width")
            row, pos = _rle_scanline(data, pos + 4, width)
            rows.append(row)
        if flat_from is None:
            return np.concatenate(rows)
    need = total - len(rows) * width
    if flat_from + 4 * need > len(data):
        raise ValueError("HDR: pixels past the end of the file")
    flat = np.frombuffer(data, np.uint8, 4 * need, flat_from).reshape(need, 4)
    return np.concatenate(rows + [flat]) if rows else flat


def decode_hdr(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """RGB uint8 (H, W, 3) of a Radiance HDR file's bytes, as OpenCV reads
    it (module doc).  Raises ``ValueError`` where OpenCV gives None."""
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    width, height, offset = _header(data)
    rgbe = _rgbe(data, offset, width, height)
    e = rgbe[:, 3].astype(np.int32)
    f = np.ldexp(np.float32(1.0), e - 136).astype(np.float32)
    with np.errstate(over="ignore"):  # a large exponent overflows float32: read as 0 below
        v = rgbe[:, :3].astype(np.float32) * f[:, None]
        v = np.where(e[:, None] == 0, np.float32(0), v) * np.float32(255)
    inside = np.abs(v.astype(np.float64)) < 2.0 ** 31
    out = np.where(inside, np.clip(np.rint(v), 0, 255), 0).astype(np.uint8)
    return out.reshape(height, width, 3)
