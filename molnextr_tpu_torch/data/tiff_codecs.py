"""TIFF codecs that libtiff decodes for its RGBA interface beside the common
ones (``data/tiff.py``): ThunderScan and SGILog.

* ThunderScan (compression 32809), as ``tif_thunder.c``: 4-bit samples, one
  code byte at a time: runs of the last pixel, three 2-bit or two 3-bit
  deltas, raw values.  libtiff's quirks are kept: a run past the end of
  the row writes nothing; a row of too little or too much data has its
  rest zeroed and fails the strip.
* SGILog (34676 run-length, 34677 24-bit), as ``tif_luv.c`` decodes it
  under ``SGILOGDATAFMT_8BIT`` (which ``tif_getimage.c`` sets): LogL rows
  to 8-bit grey through ``LogL16toY`` and ``256 sqrt(Y)``; LogLuv rows to
  8-bit RGB through ``LogLuv32toXYZ`` or ``LogLuv24toXYZ`` (the ``uv_row``
  table of ``uvcode.h``) and ``XYZtoRGB24``, in double arithmetic.

Each decoder writes rows into the strip buffer it is given and returns
whether libtiff's decoder succeeded: on failure the buffer keeps what was
written and what an earlier strip left there, which is what the RGBA
interface (not stopping on errors) then reads.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

_LN2 = 0.6931471805599453  # M_LN2


def thunderscan(raw: bytes, rows: int, width: int, buf: bytearray) -> bool:
    """``ThunderDecodeRow`` over a strip or tile of ``rows`` rows."""
    stride = (width + 1) // 2
    bp, cc = 0, len(raw)
    two = (0, 1, 0, -1)
    three = (0, 1, 2, 3, 0, -3, -2, -1)
    for r in range(rows):
        op0 = op = r * stride
        last = npixels = 0
        while cc > 0 and npixels < width:
            n = raw[bp]
            bp += 1
            cc -= 1
            code = n & 0xC0
            if code == 0x00:  # run of the last pixel, n times
                if npixels & 1:
                    buf[op] |= last
                    last = buf[op]
                    op += 1
                    npixels += 1
                    n -= 1
                else:
                    last |= last << 4
                npixels += n
                if npixels <= width:
                    while n > 0:
                        buf[op] = last & 0xFF
                        op += 1
                        n -= 2
                if n == -1:
                    op -= 1
                    buf[op] &= 0xF0
                last &= 0xF
                continue
            if code == 0x40:  # three 2-bit deltas (2: skip)
                deltas = [two[(n >> s) & 3] for s in (4, 2, 0) if (n >> s) & 3 != 2]
            elif code == 0x80:  # two 3-bit deltas (4: skip)
                deltas = [three[(n >> s) & 7] for s in (3, 0) if (n >> s) & 7 != 4]
            else:  # a raw value
                deltas = [None]
            for d in deltas:  # SETPIXEL
                last = (n if d is None else last + d) & 0xF
                if npixels < width:
                    if npixels & 1:
                        buf[op] |= last
                        op += 1
                    else:
                        buf[op] = last << 4
                    npixels += 1
        if npixels != width:
            end = op0 + (width + 1) // 2
            buf[op:end] = bytes(max(0, end - op))
            return False
    return True


def _runs(raw: bytes, bp: int, cc: int, tp: np.ndarray, shifts) -> tuple:
    """``LogL16Decode``/``LogLuvDecode32``'s byte planes of one row: a byte
    of 128 or more repeats the next byte (it - 126) times, a smaller one is
    a count of literal bytes; returns (bp, cc, complete)."""
    npixels = len(tp)
    vals = [0] * npixels
    for shft in shifts:
        i = 0
        while i < npixels and cc > 0:
            if raw[bp] >= 128:  # run
                if cc < 2:
                    break
                rc = raw[bp] + (2 - 128)
                b = raw[bp + 1] << shft
                bp += 2
                cc -= 2
                while rc and i < npixels:
                    rc -= 1
                    vals[i] |= b
                    i += 1
            else:  # literal: "while (--cc && rc-- && i < npixels)"
                rc = raw[bp]
                bp += 1
                while True:
                    cc -= 1
                    if not cc:
                        break
                    rc -= 1
                    if rc < 0 or i >= npixels:
                        break
                    vals[i] |= raw[bp] << shft
                    bp += 1
                    i += 1
        if i != npixels:
            return bp, cc, False
    tp[:] = vals
    return bp, cc, True


@lru_cache(maxsize=None)
def _log_y() -> tuple:
    """``LogL16toY`` of every 16-bit code, and ``LogL10toY`` of every 10-bit one."""
    y16 = np.array([0.0 if not le else math.exp(_LN2 / 256.0 * (le + 0.5) - _LN2 * 64.0)
                    for le in range(32768)])
    y16 = np.concatenate([y16, -y16])
    y10 = np.array([0.0 if not p else math.exp(_LN2 / 64.0 * (p + 0.5) - _LN2 * 12.0)
                    for p in range(1024)])
    return y16, y10


def _to_8bit(v: np.ndarray) -> np.ndarray:
    """``(v <= 0) ? 0 : (v >= 1) ? 255 : (int)(256 sqrt(v))``."""
    root = (256.0 * np.sqrt(np.clip(v, 0.0, 1.0))).astype(np.int64)
    return np.where(v <= 0, 0, np.where(v >= 1, 255, root)).astype(np.uint8)


def _xyz_to_rgb(lum: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The (u', v') and luminance of ``LogLuv*toXYZ`` -> ``XYZtoRGB24``."""
    s = 1.0 / (6.0 * u - 16.0 * v + 12.0)
    x = 9.0 * u * s
    y = 4.0 * v * s
    big_x = (x / y * lum).astype(np.float32).astype(np.float64)
    big_y = lum.astype(np.float32).astype(np.float64)
    big_z = ((1.0 - x - y) / y * lum).astype(np.float32).astype(np.float64)
    zero = lum <= 0
    big_x[zero] = big_y[zero] = big_z[zero] = 0.0
    r = 2.690 * big_x + -1.276 * big_y + -0.414 * big_z
    g = -1.022 * big_x + 1.978 * big_y + 0.044 * big_z
    b = 0.061 * big_x + -0.224 * big_y + 1.163 * big_z
    return np.stack([_to_8bit(r), _to_8bit(g), _to_8bit(b)], axis=-1)


def sgilog(raw: bytes, rows: int, width: int, buf: bytearray, kind: str) -> bool:
    """``LogLuvDecodeStrip`` under ``SGILOGDATAFMT_8BIT``: ``kind`` ``"L"``
    (LogL, 1 byte a pixel), ``"Luv32"`` or ``"Luv24"`` (3 bytes a pixel)."""
    y16, y10 = _log_y()
    per = 1 if kind == "L" else 3
    bp, cc = 0, len(raw)
    for r in range(rows):
        if kind == "Luv24":
            n = min(width, cc // 3)
            if n < width:
                return False
            b = np.frombuffer(raw, np.uint8, 3 * width, bp).astype(np.int64).reshape(-1, 3)
            p = (b[:, 0] << 16) | (b[:, 1] << 8) | b[:, 2]
            bp += 3 * width
            cc -= 3 * width
        else:
            p = np.zeros(width, np.int64)
            shifts = (8, 0) if kind == "L" else (24, 16, 8, 0)
            bp, cc, ok = _runs(raw, bp, cc, p, shifts)
            if not ok:
                return False
        if kind == "L":
            out = _to_8bit(y16[p & 0xFFFF])
        elif kind == "Luv32":
            lum = y16[(p >> 16) & 0xFFFF]
            u = 1.0 / 410.0 * (((p >> 8) & 0xFF) + 0.5)
            v = 1.0 / 410.0 * ((p & 0xFF) + 0.5)
            out = _xyz_to_rgb(lum, u, v)
        else:
            lum = y10[(p >> 14) & 0x3FF]
            u, v = _uv_decode(p & 0x3FFF)
            out = _xyz_to_rgb(lum, u, v)
        at = r * width * per
        buf[at : at + width * per] = out.tobytes()
    return True


# uvcode.h's uv_row: (ustart, nus) of each of the 163 rows of (u', v') cells
_UV_ROW = [
    (0.247663, 4), (0.243779, 6), (0.241684, 7), (0.237874, 9), (0.235906, 10), (0.232153, 12),
    (0.228352, 14), (0.226259, 15), (0.222371, 17), (0.220410, 18), (0.214710, 21),
    (0.212714, 22), (0.210721, 23), (0.204976, 26), (0.202986, 27), (0.199245, 29),
    (0.195525, 31), (0.193560, 32), (0.189878, 34), (0.186216, 36), (0.186216, 36),
    (0.182592, 38), (0.179003, 40), (0.175466, 42), (0.172001, 44), (0.172001, 44),
    (0.168612, 46), (0.168612, 46), (0.163575, 49), (0.158642, 52), (0.158642, 52),
    (0.158642, 52), (0.153815, 55), (0.153815, 55), (0.149097, 58), (0.149097, 58),
    (0.142746, 62), (0.142746, 62), (0.142746, 62), (0.138270, 65), (0.138270, 65),
    (0.138270, 65), (0.132166, 69), (0.132166, 69), (0.126204, 73), (0.126204, 73),
    (0.126204, 73), (0.120381, 77), (0.120381, 77), (0.120381, 77), (0.120381, 77),
    (0.112962, 82), (0.112962, 82), (0.112962, 82), (0.107450, 86), (0.107450, 86),
    (0.107450, 86), (0.107450, 86), (0.100343, 91), (0.100343, 91), (0.100343, 91),
    (0.095126, 95), (0.095126, 95), (0.095126, 95), (0.095126, 95), (0.088276, 100),
    (0.088276, 100), (0.088276, 100), (0.088276, 100), (0.081523, 105), (0.081523, 105),
    (0.081523, 105), (0.081523, 105), (0.074861, 110), (0.074861, 110), (0.074861, 110),
    (0.074861, 110), (0.068290, 115), (0.068290, 115), (0.068290, 115), (0.068290, 115),
    (0.063573, 119), (0.063573, 119), (0.063573, 119), (0.063573, 119), (0.057219, 124),
    (0.057219, 124), (0.057219, 124), (0.057219, 124), (0.050985, 129), (0.050985, 129),
    (0.050985, 129), (0.050985, 129), (0.050985, 129), (0.044859, 134), (0.044859, 134),
    (0.044859, 134), (0.044859, 134), (0.040571, 138), (0.040571, 138), (0.040571, 138),
    (0.040571, 138), (0.036339, 142), (0.036339, 142), (0.036339, 142), (0.036339, 142),
    (0.032139, 146), (0.032139, 146), (0.032139, 146), (0.032139, 146), (0.027947, 150),
    (0.027947, 150), (0.027947, 150), (0.023739, 154), (0.023739, 154), (0.023739, 154),
    (0.023739, 154), (0.019504, 158), (0.019504, 158), (0.019504, 158), (0.016976, 161),
    (0.016976, 161), (0.016976, 161), (0.016976, 161), (0.012639, 165), (0.012639, 165),
    (0.012639, 165), (0.009991, 168), (0.009991, 168), (0.009991, 168), (0.009016, 170),
    (0.009016, 170), (0.009016, 170), (0.006217, 173), (0.006217, 173), (0.005097, 175),
    (0.005097, 175), (0.005097, 175), (0.003909, 177), (0.003909, 177), (0.002340, 177),
    (0.002389, 170), (0.001068, 164), (0.001653, 157), (0.000717, 150), (0.001614, 143),
    (0.000270, 136), (0.000484, 129), (0.001103, 123), (0.001242, 115), (0.001188, 109),
    (0.001011, 103), (0.000709, 97), (0.000301, 89), (0.002416, 82), (0.003251, 76),
    (0.003246, 69), (0.004141, 62), (0.005963, 55), (0.008839, 47), (0.010490, 40),
    (0.016994, 31), (0.023659, 21),
]
_UV_SQSIZ = float(np.float32(0.0035))
_UV_VSTART = float(np.float32(0.01694))


@lru_cache(maxsize=None)
def _uv_cells() -> tuple:
    """Each of the 16289 cells' (u', v') centre as ``uv_decode`` computes it."""
    us, vs = [], []
    for vi, (ustart, nus) in enumerate(_UV_ROW):
        start = float(np.float32(ustart))
        for ui in range(nus):
            us.append(start + (ui + 0.5) * _UV_SQSIZ)
            vs.append(_UV_VSTART + (vi + 0.5) * _UV_SQSIZ)
    return np.array(us), np.array(vs)


def _uv_decode(c: np.ndarray) -> tuple:
    """``uv_decode``: a cell index -> (u', v'); past the table, the neutral
    point (``U_NEU``, ``V_NEU``)."""
    us, vs = _uv_cells()
    inside = c < len(us)
    at = np.where(inside, c, 0)
    return (np.where(inside, us[at], 0.210526316), np.where(inside, vs[at], 0.473684211))
