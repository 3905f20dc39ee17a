"""PNM, PAM and PFM readers in Python and numpy, exact against ``cv2.imread``.

:func:`decode_pnm` returns RGB uint8 ``(H, W, 3)`` as OpenCV's PxM, PAM and
PFM decoders (``grfmt_pxm.cpp``, ``grfmt_pam.cpp``, ``grfmt_pfm.cpp``) give
it under ``IMREAD_COLOR``:

* P1-P3 in ASCII and P4-P6 in binary, ``#`` comments anywhere in the
  header (and, in ASCII, between samples).  Header numbers are read as
  OpenCV reads them: digits after any whitespace and comments, ended by one
  byte that is consumed; a binary raster starts right after that byte;
* ASCII samples are clamped to maxval and scaled as ``v * 255 // maxval``;
  binary 8-bit samples are taken as stored, whatever the maxval; P1 reads
  one digit a sample, 1 is black; P4 packs 8 pixels a byte, 1 is black;
* maxval above 255 makes 16-bit samples (big-endian in binary), read as
  ``v >> 8`` (ASCII samples clamped to maxval first, never scaled);
* P7 PAM (header as ``_pam_header`` reads it) with ``TUPLTYPE``
  ``BLACKANDWHITE`` or ``GRAYSCALE`` (grey, repeated to RGB), ``RGB`` (whose
  samples OpenCV takes as B, G, R), or none (``DEPTH`` 1 grey, 3 RGB);
  samples taken as stored, 16-bit as ``v >> 8``; at maxval 1 OpenCV reads
  a row of ``WIDTH`` bytes and shows the first ``WIDTH`` bits, 1 as 255;
* ``PF`` (RGB) and ``Pf`` (grey) PFM, little-endian when the scale is
  negative, rows stored bottom-up; each float is cast to uint8 with
  rounding half to even and saturation after scaling by one over the
  scale's magnitude, and no other scaling (so a PFM of values in 0..1 reads almost
  black); a value outside int32, infinity or NaN reads as 0.

A truncated raster, or a header that OpenCV refuses, reads as None.
Differences by design, each pinned by a test: OpenCV 5 returns None for a
``Pf`` (grey) PFM under ``IMREAD_COLOR``, which the port reads; and it fills
only part of each row of a ``GRAYSCALE_ALPHA`` or ``RGB_ALPHA`` PAM, leaving
the rest uninitialised, where the port drops alpha from every pixel.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

_SPACE = b" \t\n\r\v\f"
_PLAIN = re.compile(rb"[0-9 \t\n\r\v\f]*")
_DIGITS = b"0123456789"


class _Reader:
    """OpenCV's ``ReadNumber`` over the file's bytes."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("PNM: unexpected end of the file")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def number(self, maxdigits: int = 0) -> int:
        code = self.byte()
        while code not in _DIGITS:
            if code == 0x23:  # '#': to the end of the line
                while code not in (0x0A, 0x0D):
                    code = self.byte()
                code = self.byte()
            elif code in _SPACE:
                while code in _SPACE:
                    code = self.byte()
            else:
                raise ValueError("PNM: unexpected byte in a number")
        val, digits = 0, 0
        while True:
            val = val * 10 + code - 0x30
            if val > 0x7FFFFFFF:
                raise ValueError("PNM: number too large")
            digits += 1
            if maxdigits and digits >= maxdigits:
                break
            code = self.byte()
            if code not in _DIGITS:
                break
        return val


def _ascii_samples(r: _Reader, n: int) -> np.ndarray:
    """``n`` ASCII numbers: whitespace-separated tokens when the file has no
    comment past the header (the fast path), else one ``ReadNumber`` each."""
    rest = r.data[r.pos :]
    if _PLAIN.fullmatch(rest):
        tokens = rest.split()
        if len(tokens) > n or (len(tokens) == n and rest[-1:] in _SPACE):
            return np.array([int(t) for t in tokens[:n]], np.int64)
    return np.array([r.number() for _ in range(n)], np.int64)


def _pxm(data: bytes) -> np.ndarray:
    kind = data[1:2]
    bpp = {b"1": 1, b"4": 1, b"2": 8, b"5": 8, b"3": 24, b"6": 24}[kind]
    binary = kind in b"456"
    r = _Reader(data, 2)
    width, height = r.number(), r.number()
    maxval = r.number() if bpp > 1 else 1
    if maxval > 65535 or width <= 0 or height <= 0 or maxval <= 0:
        raise ValueError("PNM: bad header")
    nch = 3 if bpp == 24 else 1
    if bpp == 1:
        if binary:
            pitch = (width + 7) // 8
            raw = np.frombuffer(_take(r, pitch * height), np.uint8).reshape(height, pitch)
            bits = np.unpackbits(raw, axis=1)[:, :width]
        else:
            bits = np.array([r.number(1) != 0 for _ in range(width * height)], np.uint8)
            bits = bits.reshape(height, width)
        grey = np.where(bits != 0, 0, 255).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=2)
    deep = maxval > 255
    n = width * height * nch
    if binary:
        raw = _take(r, n * (2 if deep else 1))
        v = np.frombuffer(raw, ">u2" if deep else np.uint8).astype(np.int64)
    else:
        v = np.minimum(_ascii_samples(r, n), maxval)
        if not deep:
            v = v * 255 // maxval
    if deep:
        v = v >> 8
    img = v.astype(np.uint8).reshape(height, width, nch)
    return img if nch == 3 else np.repeat(img, 3, axis=2)


def _take(r: _Reader, size: int) -> bytes:
    if r.pos + size > len(r.data):
        raise ValueError("PNM: raster past the end of the file")
    out = r.data[r.pos : r.pos + size]
    r.pos += size
    return out


# TUPLTYPE -> DEPTH; with none given, DEPTH 1 is grey and 3 is RGB
_TUPLTYPES = {"BLACKANDWHITE": 1, "GRAYSCALE": 1, "GRAYSCALE_ALPHA": 2, "RGB": 3,
              "RGB_ALPHA": 4}
_PAM_KEYS = ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL", "TUPLTYPE")


def _pam_header(data: bytes) -> Tuple[dict, int]:
    """The PAM header's fields and the raster's offset, read as OpenCV reads
    them: lines end at one CR or LF; blank lines and lines starting with
    ``#`` are skipped; a number is digits only; the last ``TUPLTYPE`` wins;
    the raster starts right after the terminator of the ``ENDHDR`` line."""
    fields, pos, n = {}, 3, len(data)
    while True:
        end = pos
        while end < n and data[end] not in (0x0A, 0x0D):
            end += 1
        if end >= n:
            raise ValueError("PAM: no ENDHDR")
        line, pos = data[pos:end], end + 1
        if not line.strip() or line[:1] == b"#":
            continue
        if line.startswith(b"ENDHDR"):
            return fields, pos
        parts = line.split(None, 1)
        key = parts[0].decode("latin-1")
        if key not in _PAM_KEYS or len(parts) < 2:
            raise ValueError(f"PAM: header line {line!r}")
        value = parts[1].strip().decode("latin-1")
        if key != "TUPLTYPE" and not value.isdigit():
            raise ValueError(f"PAM: header line {line!r}")
        fields[key] = value if key == "TUPLTYPE" else int(value)


def _pam(data: bytes) -> np.ndarray:
    if data[2:3] not in (b"\n", b"\r"):
        raise ValueError("PAM: bad signature")
    fields, offset = _pam_header(data)
    try:
        width, height, depth, maxval = (fields[k] for k in _PAM_KEYS[:4])
    except KeyError as e:
        raise ValueError("PAM: missing header field") from e
    tupl = fields.get("TUPLTYPE")
    if tupl is None:
        tupl = {1: "GRAYSCALE", 3: "RGB"}.get(depth)
    if _TUPLTYPES.get(tupl) != depth or width <= 0 or height <= 0 or not 0 < maxval <= 65535:
        raise ValueError("PAM: bad header")
    deep = maxval > 255
    size = width * height * depth * (2 if deep else 1)
    if offset + size > len(data):
        raise ValueError("PAM: raster past the end of the file")
    v = np.frombuffer(data, ">u2" if deep else np.uint8, width * height * depth, offset)
    v = v.astype(np.int64).reshape(height, width, depth)
    if maxval == 1:  # OpenCV reads a row's bytes and shows its first bits, 1 as 255
        rows = v.reshape(height, width * depth).astype(np.uint8)
        bits = np.unpackbits(rows, axis=1)[:, :width]
        return np.repeat((bits * 255)[..., None], 3, axis=2)
    if deep:
        v = v >> 8
    if depth == 3:  # OpenCV takes an RGB tuple's samples as B, G, R
        return v[..., ::-1].astype(np.uint8)
    # the alpha forms: OpenCV 5 fills only part of each row (the rest is
    # left uninitialised); the port drops alpha from every pixel
    colour = v[..., :3] if depth == 4 else np.repeat(v[..., :1], 3, axis=2)
    return colour.astype(np.uint8)


def _pfm(data: bytes) -> np.ndarray:
    nch = 3 if data[1:2] == b"F" else 1
    r = _Reader(data, 2)
    width, height = r.number(), r.number()
    # the scale: a signed decimal on its own line, ended by one whitespace byte
    start = r.pos
    while r.pos < len(data) and data[r.pos] in _SPACE:
        r.pos += 1
    tok_end = r.pos
    while tok_end < len(data) and data[tok_end] not in _SPACE:
        tok_end += 1
    try:
        scale = float(data[r.pos : tok_end])
    except ValueError as e:
        raise ValueError("PFM: bad scale") from e
    if tok_end >= len(data) or width <= 0 or height <= 0 or scale == 0 or tok_end == start:
        raise ValueError("PFM: bad header")
    r.pos = tok_end + 1
    raw = _take(r, width * height * nch * 4)
    v = np.frombuffer(raw, "<f4" if scale < 0 else ">f4").reshape(height, width, nch)[::-1]
    v = v.astype(np.float32) * np.float32(1.0 / abs(scale))  # convertTo's scale, in float32
    out = np.clip(np.rint(v.astype(np.float64)), 0, 255)
    # cvRound of a value outside int32 (inf and NaN too) is INT_MIN: 0
    inside = np.isfinite(v) & (np.abs(v.astype(np.float64)) < 2.0 ** 31)
    out = np.where(inside, out, 0).astype(np.uint8)
    return out if nch == 3 else np.repeat(out, 3, axis=2)


def decode_pnm(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """RGB uint8 (H, W, 3) of a PNM, PAM or PFM file's bytes, as OpenCV reads
    it (module doc).  Raises ``ValueError`` where OpenCV gives None."""
    kind = data[1:2]
    if data[:1] != b"P" or len(data) < 3:
        raise ValueError(f"{path}: not a PNM file")
    if kind == b"7":
        return _pam(data)
    if kind in (b"F", b"f"):
        return _pfm(data)
    return _pxm(data)
