"""libtiff's colour conversions for its RGBA interface (``tif_color.c`` and
``tif_getimage.c``), in the float and integer arithmetic libtiff uses, for
``data/tiff.py``:

* YCbCr -> RGB: ``TIFFYCbCrToRGBInit``'s tables from ``YCbCrCoefficients``
  and ``ReferenceBlackWhite`` (float32 ``Code2V``, ``FIX`` at 16 bits) and
  ``TIFFYCbCrtoRGB``;
* CIE L*a*b* -> RGB: ``TIFFCIELabToXYZ`` (8-bit) and ``TIFFCIELab16ToXYZ``
  against the white point of the ``WhitePoint`` tag (D50 by default), then
  ``TIFFXYZToRGB`` through ``display_sRGB``'s matrix and its 1501-entry
  gamma tables;
* CMYK -> RGB: ``(255 - K) (255 - C) / 255`` and so on, truncated.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np

f32 = np.float32


def ycbcr_tables(luma: Sequence[float], ref: Sequence[float]) -> tuple:
    """``TIFFYCbCrToRGBInit``: (Y, Cr->R, Cb->B, Cr->G, Cb->G) tables of 256."""
    lr, lg, lb = (f32(v) for v in luma)
    ref = [f32(v) for v in ref]

    def clamp(v, lo, hi):  # CLAMP: NaN goes to the minimum
        return lo if not v >= lo else (hi if v > hi else v)

    def fix(v):  # FIX: (int32)(x * 65536 + 0.5), the product in float
        return int(float(f32(v) * f32(65536)) + 0.5)

    f1 = f32(2) - f32(2) * lr
    d1 = fix(clamp(f1, f32(0), f32(2)))
    f2 = lr * f1 / lg
    d2 = -fix(clamp(f2, f32(0), f32(2)))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(clamp(f3, f32(0), f32(2)))
    f4 = lb * f3 / lg
    d4 = -fix(clamp(f4, f32(0), f32(2)))

    def code2v(c, rb, rw, cr):
        den = rw - rb
        return f32(f32(c - int(rb)) * f32(cr)) / (den if den != 0 else f32(1))

    y_tab, crr, cbb, crg, cbg = [], [], [], [], []
    for i in range(256):
        x = i - 128
        cr = int(clamp(code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127), f32(-4096),
                       f32(4096)))
        cb = int(clamp(code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127), f32(-4096),
                       f32(4096)))
        crr.append((d1 * cr + 32768) >> 16)
        cbb.append((d3 * cb + 32768) >> 16)
        crg.append(d2 * cr)
        cbg.append(d4 * cb + 32768)
        y_tab.append(int(clamp(code2v(i, ref[0], ref[1], 255), f32(-4096), f32(4096))))
    return tuple(np.array(t, np.int64) for t in (y_tab, crr, cbb, crg, cbg))


def ycbcr_to_rgb(ycc: np.ndarray, luma: Sequence[float], ref: Sequence[float]) -> np.ndarray:
    """``TIFFYCbCrtoRGB`` of (..., 3) Y, Cb, Cr samples -> uint8 RGB."""
    y_tab, crr, cbb, crg, cbg = ycbcr_tables(tuple(luma), tuple(ref))
    y, cb, cr = (ycc[..., k].astype(np.int64) for k in range(3))
    yv = y_tab[y]
    r = yv + crr[cr]
    g = yv + ((cbg[cb] + crg[cr]) >> 16)
    b = yv + cbb[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# display_sRGB: the XYZ -> RGB matrix, 100 cd/m2 white, 255 steps, residual
# light 1, gamma 2.4
_MATRIX = [[f32(3.2410), f32(-1.5374), f32(-0.4986)],
           [f32(-0.9692), f32(1.8760), f32(0.0416)],
           [f32(0.0556), f32(-0.2040), f32(1.0570)]]
_RANGE = 1500


@lru_cache(maxsize=None)
def _gamma_table() -> np.ndarray:
    """``TIFFCIELabToRGBInit``'s Rtable (the same for G and B): float32 of
    255 * (i / 1500) ** (1 / 2.4)."""
    gamma = 1.0 / float(f32(2.4))
    i = np.arange(_RANGE + 1, dtype=np.float64)
    return (255.0 * np.power(i / _RANGE, gamma)).astype(np.float32)


def _cielab_to_xyz(l: np.ndarray, a: np.ndarray, b: np.ndarray, white) -> tuple:
    """``TIFFCIELab16ToXYZ`` in float32: L 0-65535, a and b 256 times a*, b*."""
    x0, y0, z0 = white
    big_l = l.astype(np.float32) * f32(100) / f32(65535)
    low = big_l < f32(8.856)
    y_low = (big_l * y0) / f32(903.292)
    cby_low = f32(7.787) * (y_low / y0) + f32(16) / f32(116)
    cby_high = (big_l + f32(16)) / f32(116)
    y_high = y0 * cby_high * cby_high * cby_high
    big_y = np.where(low, y_low, y_high).astype(np.float32)
    cby = np.where(low, cby_low, cby_high).astype(np.float32)

    def lin(tmp, ref):
        return np.where(tmp < f32(0.2069), ref * (tmp - f32(0.13793)) / f32(7.787),
                        ref * tmp * tmp * tmp).astype(np.float32)

    tmp = a.astype(np.float32) / f32(256) / f32(500) + cby
    big_x = lin(tmp.astype(np.float32), x0)
    tmp = cby - b.astype(np.float32) / f32(256) / f32(200)
    big_z = lin(tmp.astype(np.float32), z0)
    return big_x, big_y, big_z


def _xyz_to_rgb(big_x, big_y, big_z) -> np.ndarray:
    """``TIFFXYZToRGB`` through ``display_sRGB``."""
    table = _gamma_table()
    step = (f32(100) - f32(1)) / f32(_RANGE)
    out = []
    for row in _MATRIX:
        lum = (row[0] * big_x + row[1] * big_y).astype(np.float32) + row[2] * big_z
        lum = np.minimum(np.maximum(lum.astype(np.float32), f32(1)), f32(100))
        i = ((lum - f32(1)) / step).astype(np.float32).astype(np.int64)
        i = np.minimum(i, _RANGE)
        v = table[i].astype(np.float64)
        rint = np.where(v > 0, v + 0.5, v - 0.5).astype(np.int64)
        out.append(np.minimum(rint, 255))
    return np.stack(out, axis=-1).astype(np.uint8)


def cielab_to_rgb(lab: np.ndarray, bits: int, white_point: Sequence[float]) -> np.ndarray:
    """``putcontig8bitCIELab8`` / ``putcontig8bitCIELab16`` of (..., 3)
    samples (as stored, unsigned) -> uint8 RGB."""
    wx, wy = f32(white_point[0]), f32(white_point[1])
    ref_y = f32(100)
    white = (wx / wy * ref_y, ref_y, (f32(1) - wx - wy) / wy * ref_y)
    s = lab.astype(np.int64)
    if bits == 8:  # TIFFCIELabToXYZ: L * 257, a and b signed bytes * 256
        l = s[..., 0] * 257
        a = ((s[..., 1] + 128) % 256 - 128) * 256
        b = ((s[..., 2] + 128) % 256 - 128) * 256
    else:
        l = s[..., 0]
        a = (s[..., 1] + 32768) % 65536 - 32768
        b = (s[..., 2] + 32768) % 65536 - 32768
    return _xyz_to_rgb(*_cielab_to_xyz(l, a, b, white))


def cmyk_to_rgb(c: np.ndarray, m: np.ndarray, y: np.ndarray, k: np.ndarray) -> np.ndarray:
    """``putRGBcontig8bitCMYKtile`` / ``putCMYKseparate8bittile``."""
    kk = 255 - k.astype(np.int64)
    return np.stack([kk * (255 - ch.astype(np.int64)) // 255 for ch in (c, m, y)],
                    axis=-1).astype(np.uint8)
