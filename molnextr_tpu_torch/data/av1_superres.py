"""AV1 superres (the AV1 specification, section 7.16): a frame coded at a
reduced width and upscaled to its ``UpscaledWidth`` after CDEF, as libaom's
``av1_upscale_normative_rows`` gives it, in numpy.

Each output column ``x`` of a plane reads 8 samples of its row around the
position ``initialSubpelX + x * stepX`` (in 1/16384 of a sample, the first
tap 4 samples left of the whole part) and weighs them by the row of
``Upscale_Filter`` that the position's fraction (6 bits) selects, the sum
rounded over 128 and clipped to the bit depth.  Columns left of the plane
read its first column; columns past it read its last MI-aligned column
(``maxX``), as libaom pads each row at the MI-aligned edge.  libaom
upscales one tile column at a time, carrying the position across and
reading the neighbouring column's samples at inner edges, which is the
whole-row process here.  libaom also keeps a downscaled width of at least
16 (``calculate_scaled_size_helper``), which :func:`downscaled_width`
follows.
"""

from __future__ import annotations

import numpy as np

from molnextr_tpu_torch.data.av1_recon import _hit

SUPERRES_NUM = 8
SUPERRES_DENOM_MIN = 9
SUPERRES_SCALE_BITS = 14  # positions in 1/16384 of a sample
SUPERRES_FILTER_BITS = 6  # a position's fraction selects one of 64 filters
SUPERRES_EXTRA_BITS = SUPERRES_SCALE_BITS - SUPERRES_FILTER_BITS
FILTER_BITS = 7  # the taps' scale
SUPERRES_FILTER_TAPS = 8
SUPERRES_FILTER_OFFSET = 3

# libaom's av1_resize_filter_normative (av1/common/resize.c), the
# specification's Upscale_Filter: each row sums to 128, row 0 is the identity
UPSCALE_FILTER = np.array([
    (0, 0, 0, 128, 0, 0, 0, 0), (0, 0, -1, 128, 2, -1, 0, 0),
    (0, 1, -3, 127, 4, -2, 1, 0), (0, 1, -4, 127, 6, -3, 1, 0),
    (0, 2, -6, 126, 8, -3, 1, 0), (0, 2, -7, 125, 11, -4, 1, 0),
    (-1, 2, -8, 125, 13, -5, 2, 0), (-1, 3, -9, 124, 15, -6, 2, 0),
    (-1, 3, -10, 123, 18, -6, 2, -1), (-1, 3, -11, 122, 20, -7, 3, -1),
    (-1, 4, -12, 121, 22, -8, 3, -1), (-1, 4, -13, 120, 25, -9, 3, -1),
    (-1, 4, -14, 118, 28, -9, 3, -1), (-1, 4, -15, 117, 30, -10, 4, -1),
    (-1, 5, -16, 116, 32, -11, 4, -1), (-1, 5, -16, 114, 35, -12, 4, -1),
    (-1, 5, -17, 112, 38, -12, 4, -1), (-1, 5, -18, 111, 40, -13, 5, -1),
    (-1, 5, -18, 109, 43, -14, 5, -1), (-1, 6, -19, 107, 45, -14, 5, -1),
    (-1, 6, -19, 105, 48, -15, 5, -1), (-1, 6, -19, 103, 51, -16, 5, -1),
    (-1, 6, -20, 101, 53, -16, 6, -1), (-1, 6, -20, 99, 56, -17, 6, -1),
    (-1, 6, -20, 97, 58, -17, 6, -1), (-1, 6, -20, 95, 61, -18, 6, -1),
    (-2, 7, -20, 93, 64, -18, 6, -2), (-2, 7, -20, 91, 66, -19, 6, -1),
    (-2, 7, -20, 88, 69, -19, 6, -1), (-2, 7, -20, 86, 71, -19, 6, -1),
    (-2, 7, -20, 84, 74, -20, 7, -2), (-2, 7, -20, 81, 76, -20, 7, -1),
    (-2, 7, -20, 79, 79, -20, 7, -2), (-1, 7, -20, 76, 81, -20, 7, -2),
    (-2, 7, -20, 74, 84, -20, 7, -2), (-1, 6, -19, 71, 86, -20, 7, -2),
    (-1, 6, -19, 69, 88, -20, 7, -2), (-1, 6, -19, 66, 91, -20, 7, -2),
    (-2, 6, -18, 64, 93, -20, 7, -2), (-1, 6, -18, 61, 95, -20, 6, -1),
    (-1, 6, -17, 58, 97, -20, 6, -1), (-1, 6, -17, 56, 99, -20, 6, -1),
    (-1, 6, -16, 53, 101, -20, 6, -1), (-1, 5, -16, 51, 103, -19, 6, -1),
    (-1, 5, -15, 48, 105, -19, 6, -1), (-1, 5, -14, 45, 107, -19, 6, -1),
    (-1, 5, -14, 43, 109, -18, 5, -1), (-1, 5, -13, 40, 111, -18, 5, -1),
    (-1, 4, -12, 38, 112, -17, 5, -1), (-1, 4, -12, 35, 114, -16, 5, -1),
    (-1, 4, -11, 32, 116, -16, 5, -1), (-1, 4, -10, 30, 117, -15, 4, -1),
    (-1, 3, -9, 28, 118, -14, 4, -1), (-1, 3, -9, 25, 120, -13, 4, -1),
    (-1, 3, -8, 22, 121, -12, 4, -1), (-1, 3, -7, 20, 122, -11, 3, -1),
    (-1, 2, -6, 18, 123, -10, 3, -1), (0, 2, -6, 15, 124, -9, 3, -1),
    (0, 2, -5, 13, 125, -8, 2, -1), (0, 1, -4, 11, 125, -7, 2, 0),
    (0, 1, -3, 8, 126, -6, 2, 0), (0, 1, -3, 6, 127, -4, 1, 0),
    (0, 1, -2, 4, 127, -3, 1, 0), (0, 0, -1, 2, 128, -1, 0, 0),
], np.int64)


def downscaled_width(upscaled: int, denom: int) -> int:
    """``FrameWidth`` of a frame whose ``UpscaledWidth`` is ``upscaled`` at
    ``SuperresDenom`` ``denom``, kept at 16 or more (or at ``upscaled``
    below that) as libaom keeps it."""
    if denom == SUPERRES_NUM:
        return upscaled
    return max((upscaled * SUPERRES_NUM + denom // 2) // denom, min(16, upscaled))


def _cdiv(n: int, d: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(n) // abs(d)
    return q if (n >= 0) == (d > 0) else -q


def upscale(plane: np.ndarray, width: int, upscaled: int, bd: int) -> np.ndarray:
    """One plane's rows upscaled from ``width`` to ``upscaled`` columns
    (the module doc); ``plane`` holds the MI-aligned columns the process
    may read past ``width``."""
    _hit("superres")
    step = ((width << SUPERRES_SCALE_BITS) + upscaled // 2) // upscaled
    err = upscaled * step - (width << SUPERRES_SCALE_BITS)
    x0 = _cdiv(-((upscaled - width) << (SUPERRES_SCALE_BITS - 1)) + upscaled // 2, upscaled) \
        + (1 << (SUPERRES_EXTRA_BITS - 1)) - _cdiv(err, 2)
    x0 &= (1 << SUPERRES_SCALE_BITS) - 1
    pos = -(1 << SUPERRES_SCALE_BITS) + x0 + np.arange(upscaled, dtype=np.int64) * step
    whole = pos >> SUPERRES_SCALE_BITS
    taps = UPSCALE_FILTER[(pos & ((1 << SUPERRES_SCALE_BITS) - 1)) >> SUPERRES_EXTRA_BITS]
    src = plane.astype(np.int64)
    last = plane.shape[1] - 1
    total = np.zeros((plane.shape[0], upscaled), np.int64)
    for k in range(SUPERRES_FILTER_TAPS):
        cols = np.clip(whole + k - SUPERRES_FILTER_OFFSET, 0, last)
        total += src[:, cols] * taps[:, k]
    rounded = (total + (1 << (FILTER_BITS - 1))) >> FILTER_BITS
    return np.clip(rounded, 0, (1 << bd) - 1).astype(plane.dtype)


def upscale_planes(dec, planes):
    """Every plane of a decoded frame upscaled to the frame's
    ``UpscaledWidth``."""
    fr = dec.fr
    out = []
    for p, plane in enumerate(planes):
        sx = dec.ss[p][0]
        out.append(upscale(plane, (fr.width + sx) >> sx, (fr.upscaled_width + sx) >> sx, dec.bd))
    return out
