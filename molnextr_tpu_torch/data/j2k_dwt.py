"""JPEG 2000 dequantisation, inverse wavelets, inverse colour transforms and
the DC level shift, in numpy, as OpenJPEG 2.5 computes them (``t1.c``,
``dwt.c``, ``mct.c``, ``tcd.c``).

* :func:`dequantise`: the ROI max-shift, then the 5/3 coefficients halved
  (OpenJPEG's tier 1 keeps one more bit) or the 9/7 ones times half the
  band's step, in float32.
* :func:`idwt53` / :func:`idwt97`: the inverse lifting of each level, rows
  then columns, with symmetric extension at the tile-component's borders
  and the parity of its odd origins; the 9/7 with OpenJPEG's constants, its
  order of operations in float32 (``K`` on the low pass, ``2/K`` on the
  high pass), and its early returns for one-sample signals.
* :func:`inverse_rct` / :func:`inverse_ict`, and :func:`dc_shift` with its
  clamp and, for 9/7 data, the round to nearest even.
"""

from __future__ import annotations

import numpy as np

_K = np.float32(1.230174105)
_TWO_INV_K = np.float32(1.625732422)
_ALPHA = np.float32(-1.586134342)
_BETA = np.float32(-0.052980118)
_GAMMA = np.float32(0.882911075)
_DELTA = np.float32(0.443506852)


def band_stepsize(prec: int, expn: int, mant: int) -> np.float32:
    """A 9/7 band's step (OpenJPEG's ``band->stepsize``: no band gain for
    the irreversible decoder, which scales its high pass by 2/K)."""
    return np.float32((1.0 + mant / 2048.0) * 2.0 ** (prec - expn))


def dequantise(coeffs: np.ndarray, roishift: int, reversible: bool, stepsize) -> np.ndarray:
    """Tier 1's output (int64) of one code-block to tile samples: int32 for
    5/3, float32 for 9/7."""
    if roishift:
        if roishift >= 31:
            coeffs = np.zeros_like(coeffs)
        else:
            mag = np.abs(coeffs)
            big = mag >= (1 << roishift)
            coeffs = np.where(big, np.sign(coeffs) * (mag >> roishift), coeffs)
    if reversible:
        return (np.sign(coeffs) * (np.abs(coeffs) >> 1)).astype(np.int32)
    return coeffs.astype(np.float32) * np.float32(np.float32(0.5) * stepsize)


def _split(sn: int, dn: int, cas: int):
    """Positions of the low and high samples in a signal of sn + dn."""
    n = sn + dn
    return np.arange(cas, n, 2)[:sn], np.arange(1 - cas, n, 2)[:dn]


def _lift53_rows(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """Inverse 5/3 along axis 1 of ``a`` (low samples first, then high)."""
    n = a.shape[1]
    dn = n - sn
    if cas == 0 and n <= 1:
        return a
    if cas == 1 and n == 1:
        v = a[:, :1].astype(np.int64)
        return (np.sign(v) * (np.abs(v) >> 1)).astype(np.int32)
    low = a[:, :sn].astype(np.int64)
    high = a[:, sn:].astype(np.int64)
    out = np.empty((a.shape[0], n), np.int64)
    lo_pos, hi_pos = _split(sn, dn, cas)
    out[:, hi_pos] = high
    # low samples: neighbours are the high samples left and right (mirrored)
    left, right = _neighbours(out, lo_pos, n)
    out[:, lo_pos] = low - ((left + right + 2) >> 2)
    left, right = _neighbours(out, hi_pos, n)
    out[:, hi_pos] = high + ((left + right) >> 1)
    return out.astype(np.int32)


def _neighbours(x: np.ndarray, pos: np.ndarray, n: int):
    """x at pos - 1 and pos + 1, mirrored at the signal's ends."""
    left = pos - 1
    right = pos + 1
    left = np.where(left < 0, 1, left)
    right = np.where(right >= n, n - 2, right)
    return x[:, left], x[:, right]


def _lift97_rows(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """Inverse 9/7 along axis 1 (``opj_v8dwt_decode``)."""
    n = a.shape[1]
    dn = n - sn
    if (cas == 0 and not (dn > 0 or sn > 1)) or (cas == 1 and not (sn > 0 or dn > 1)):
        return a
    out = np.empty_like(a)
    lo_pos, hi_pos = _split(sn, dn, cas)
    out[:, lo_pos] = a[:, :sn] * _K
    out[:, hi_pos] = a[:, sn:] * _TWO_INV_K
    for pos, c in ((lo_pos, -_DELTA), (hi_pos, -_GAMMA), (lo_pos, -_BETA), (hi_pos, -_ALPHA)):
        left, right = _neighbours(out, pos, n)
        out[:, pos] = out[:, pos] + (left + right) * c
    return out


def _idwt(data: np.ndarray, res_bounds, lift) -> np.ndarray:
    """Levels of an inverse wavelet over ``data`` (the tile-component in
    OpenJPEG's layout); ``res_bounds`` are the (x0, y0, x1, y1) of the
    resolutions to reconstruct, from the lowest."""
    x0, y0, x1, y1 = res_bounds[0]
    rw, rh = x1 - x0, y1 - y0
    for x0, y0, x1, y1 in res_bounds[1:]:
        sn_h, sn_v = rw, rh
        rw, rh = x1 - x0, y1 - y0
        if rw and rh:
            data[:rh, :rw] = lift(data[:rh, :rw], sn_h, x0 % 2)
            data[:rh, :rw] = lift(data[:rh, :rw].T, sn_v, y0 % 2).T
    return data


def idwt53(data: np.ndarray, res_bounds) -> np.ndarray:
    return _idwt(data, res_bounds, _lift53_rows)


def idwt97(data: np.ndarray, res_bounds) -> np.ndarray:
    return _idwt(data, res_bounds, _lift97_rows)


def inverse_rct(c0, c1, c2):
    """``opj_mct_decode``: the reversible colour transform, in place."""
    y, u, v = c0.astype(np.int64), c1.astype(np.int64), c2.astype(np.int64)
    g = y - ((u + v) >> 2)
    c0[...] = v + g
    c1[...] = g
    c2[...] = u + g


def inverse_ict(c0, c1, c2):
    """``opj_mct_decode_real``: the irreversible colour transform, float32."""
    y, u, v = c0.copy(), c1.copy(), c2.copy()
    c0[...] = y + v * np.float32(1.402)
    c1[...] = y - u * np.float32(0.34413) - v * np.float32(0.71414)
    c2[...] = y + u * np.float32(1.772)


def dc_shift(data: np.ndarray, shift: int, prec: int, sgnd: bool) -> np.ndarray:
    """``opj_tcd_dc_level_shift_decode``: add the level shift and clamp to
    the component's range (9/7 data rounded to nearest even first)."""
    if sgnd:
        lo, hi = -(1 << (prec - 1)), (1 << (prec - 1)) - 1
    else:
        lo, hi = 0, (1 << prec) - 1
    if data.dtype == np.float32:
        big = data > np.float32(2 ** 31 - 1)
        small = data < np.float32(-2 ** 31)
        v = np.rint(np.where(big | small, 0, data)).astype(np.int64) + shift
        v = np.clip(v, lo, hi)
        v = np.where(big, hi, np.where(small, lo, v))
        return v.astype(np.int32)
    v = data.astype(np.int64) + shift  # in int32, as OpenJPEG adds (a Part 2 offset may wrap)
    return np.clip((v + 2 ** 31) % 2 ** 32 - 2 ** 31, lo, hi).astype(np.int32)
