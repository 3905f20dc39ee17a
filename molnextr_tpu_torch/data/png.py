"""A PNG reader and writer (zlib + numpy), so the port reads and writes
image files without OpenCV.

:func:`read_png` reads every form the PNG standard allows: grey (colour
type 0) at 1, 2, 4, 8 and 16 bits, RGB (2) at 8 and 16, palette (3) at 1,
2, 4 and 8, grey+alpha (4) and RGBA (6) at 8 and 16, each with or without
Adam7 interlace, any of the five row filters.  It returns RGB uint8
``(H, W, 3)``, exactly what ``cv2.cvtColor(cv2.imread(path),
cv2.COLOR_BGR2RGB)`` returns, because it applies libpng's transforms in the
form OpenCV asks for them (``IMREAD_COLOR``):

* grey below 8 bits is expanded as ``png_set_expand_gray_1_2_4_to_8``
  does: the sample times 255, 85 or 17 (1 bit reads 0 and 255);
* 16-bit samples keep their high byte (``png_set_strip_16``: ``0x00ff``
  reads 0, ``0xff80`` reads 255), without rounding;
* palette indices go through ``PLTE`` (``png_set_palette_to_rgb``); an
  index past its entries reads black;
* alpha and ``tRNS`` are dropped (``png_set_strip_alpha``): the colour
  samples are returned as stored, never composited;
* grey is replicated to three channels (``png_set_gray_to_rgb``);
* the orientation of an ``eXIf`` chunk turns the result, as OpenCV turns
  it (``data/exif.py``).

Another file raises ``ValueError``; ``data/image.py::imread`` dispatches
every format by its first bytes.  :func:`write_png` writes 8-bit grey or
RGB.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

from molnextr_tpu_torch.data.exif import apply_orientation, exif_orientation
from molnextr_tpu_torch.data.image import sniff_format

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: first row, first column, row step, column step
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))
def _unfilter(raw: bytes, pos: int, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of ``height`` rows of ``stride`` bytes that start
    at ``raw[pos]`` (each row led by its filter-type byte)."""
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
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
            up = prior.tolist()
            vals = line.tolist()
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


def _samples(rows: np.ndarray, width: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> (h, width, ch) samples: packed sub-byte samples
    unpacked (most significant bits first), 16-bit ones big-endian."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(h, width, ch).astype(np.uint16)
    if depth == 8:
        return rows.reshape(h, width, ch)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width].reshape(h, width, 1)


def _chunks(data: bytes, path: str) -> Tuple[tuple, bytes, bytes, int]:
    """(IHDR fields, PLTE body, joined IDAT bodies, eXIf orientation)."""
    pos = len(_SIGNATURE)
    header, plte, idat, orientation = None, b"", [], 1
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"eXIf":  # libpng drops one without "II" or "MM" first
            orientation = exif_orientation(body) if body[:2] in (b"II", b"MM") else 1
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    return header, plte, b"".join(idat), orientation


def read_png(path: str) -> np.ndarray:
    """RGB uint8 (H, W, 3) of a PNG file, as OpenCV reads it (module doc)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """:func:`read_png` of a file's bytes; ``path`` names it in errors."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file ({sniff_format(data)}); "
                         "data/image.py::imread reads every format the port decodes "
                         "(ROADMAP queue 1 lists the rest)")
    (width, height, depth, color, _comp, _filt, interlace), plte, idat, orientation = \
        _chunks(data, path)
    if depth not in _DEPTHS.get(color, ()) or interlace not in (0, 1):
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {color}, "
                         f"interlace {interlace})")
    if color == 3 and not plte:
        raise ValueError(f"{path}: palette PNG without PLTE")
    ch = _CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    raw = zlib.decompress(idat)
    if interlace == 0:
        stride = (width * ch * depth + 7) // 8
        img = _samples(_unfilter(raw, 0, height, stride, bpp), width, ch, depth)
    else:
        img = np.zeros((height, width, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for y0, x0, dy, dx in _ADAM7:
            ph, pw = -(-(height - y0) // dy), -(-(width - x0) // dx)
            if ph <= 0 or pw <= 0:  # an empty pass has no rows, not even filter bytes
                continue
            stride = (pw * ch * depth + 7) // 8
            img[y0::dy, x0::dx] = _samples(_unfilter(raw, pos, ph, stride, bpp), pw, ch, depth)
            pos += ph * (stride + 1)
    return apply_orientation(_to_rgb(img, color, depth, ch, plte), orientation)


def _to_rgb(img: np.ndarray, color: int, depth: int, ch: int, plte: bytes) -> np.ndarray:
    """Samples (H, W, ch) -> RGB uint8 by libpng's transforms (module doc)."""
    if depth == 16:
        img = (img >> 8).astype(np.uint8)
    if color == 3:
        # libpng's palette has 256 entries, zero past PLTE's: an index beyond
        # them reads black
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte, np.uint8)[: min(len(plte) // 3, 256) * 3]
        pal[: len(entries) // 3] = entries.reshape(-1, 3)
        return pal[img[..., 0]]
    if color == 0 and depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
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
