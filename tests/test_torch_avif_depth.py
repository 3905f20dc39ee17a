"""10- and 12-bit subsampled AVIF against ``cv2.imread``, exactly.

``cv2.imwrite`` at ``IMWRITE_AVIF_DEPTH`` 10 or 12 and a quality below 100
writes 4:2:0 YCbCr (matrix 6, full range); OpenCV 5.0 reads it to 8-bit
BGR through ``avifImageYUVToRGB``.  Probing that output settled libavif's
path: the samples are shifted down to 8 bits first (chroma too, before it
is upsampled), then converted as an 8-bit 4:2:0 image (libyuv's bilinear
upsampling and fixed-point matrix).  The survey: qualities 0-99 at both
depths, odd and even sizes from 1 x 1, gradients and random pictures, and
the ``colr`` box rewritten to the other matrices and to limited range
(the AV1 samples stay as coded).  Every file reads with 0 pixels
differing.
"""

import struct

import cv2
import numpy as np
import pytest
from test_torch_avif import check, picture

from molnextr_tpu_torch.data import avif

SIZES = [(1, 1), (2, 3), (37, 53), (64, 64), (70, 91), (131, 66)]


def cv2_deep(img16, depth, quality):
    params = [cv2.IMWRITE_AVIF_QUALITY, quality, cv2.IMWRITE_AVIF_DEPTH, depth]
    ok, buf = cv2.imencode(".avif", img16[..., ::-1].copy(), params)
    assert ok
    return buf.tobytes()


def deep_picture(kind, h, w, depth, seed):
    """A ``gradient`` scaled to the depth with a random band, or ``random``
    samples over the whole range."""
    top = (1 << depth) - 1
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.randint(0, top + 1, (h, w, 3)).astype(np.uint16)
    img = picture("gradient", h, w, seed).astype(np.int64) * top // 255
    img[: h // 3] = rng.randint(0, top + 1, img[: h // 3].shape)
    return img.astype(np.uint16)


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("quality", [0, 10, 25, 40, 55, 70, 85, 95, 99])
def test_cv2_qualities_read_exactly(tmp_path, depth, quality):
    data = cv2_deep(deep_picture("gradient", 70, 91, depth, quality), depth, quality)
    planes, bd, ss_x, ss_y, full, matrix, _w = avif.read_avif(data)
    assert (bd, ss_x, ss_y, full, matrix, len(planes)) == (depth, 1, 1, True, 6, 3)
    check(tmp_path, data)


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("kind", ["gradient", "random"])
@pytest.mark.parametrize("h,w", SIZES)
def test_sizes_and_pictures_read_exactly(tmp_path, depth, kind, h, w):
    check(tmp_path, cv2_deep(deep_picture(kind, h, w, depth, h * w), depth, 60))


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("matrix,full", [(1, True), (1, False), (2, False), (5, True),
                                         (6, False), (9, True), (9, False)])
def test_colour_matrices_from_nclx(tmp_path, depth, matrix, full):
    """The nclx ``colr`` box's matrix and range choose the conversion of
    the shifted samples, as at 8 bits."""
    data = bytearray(cv2_deep(deep_picture("gradient", 45, 61, depth, matrix), depth, 50))
    k = data.find(b"colrnclx") + 8
    struct.pack_into(">H", data, k + 4, matrix)
    data[k + 6] = 0x80 if full else 0
    check(tmp_path, bytes(data))
