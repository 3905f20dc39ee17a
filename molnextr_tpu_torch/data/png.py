"""A minimal PNG reader and writer (zlib + numpy), so the port reads and
writes image files without OpenCV.

Supports 8-bit, non-interlaced grey (0), RGB (2), grey+alpha (4) and RGBA
(6) images.  Returns RGB uint8 ``(H, W, 3)`` as ``cv2.imread`` followed by
``cv2.cvtColor(BGR2RGB)`` would: grey is replicated and alpha is dropped.
Every other format (palette, 16-bit, interlaced, non-PNG files) raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int64)
        pos += stride + 1
        if ftype == 0:
            cur = line
        elif ftype == 2:  # Up
            cur = (line + prior) & 0xFF
        elif ftype == 1:  # Sub: a running sum per byte lane of a pixel
            cur = np.empty_like(line)
            for c in range(bpp):
                cur[c::bpp] = np.cumsum(line[c::bpp]) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = line.copy()
            up = prior.tolist()
            vals = cur.tolist()
            for x in range(stride):
                a = vals[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    vals[x] = (vals[x] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    vals[x] = (vals[x] + pred) & 0xFF
            cur = np.asarray(vals, np.int64)
        else:
            raise ValueError(f"PNG: bad filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file (only PNG is supported)")
    pos = len(_SIGNATURE)
    header = None
    idat = []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _comp, _filt, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, color type {color}, "
            f"interlace {interlace}); 8-bit non-interlaced grey/RGB/RGBA only"
        )
    ch = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    img = _unfilter(raw, height, width * ch, ch).reshape(height, width, ch)
    if ch in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def write_png(path: str, image: np.ndarray) -> None:
    """Write uint8 (H, W, 3) RGB or (H, W) grey as an 8-bit PNG (filter 0)."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    color = 0 if img.ndim == 2 else 2
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(ctype: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)

    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))
