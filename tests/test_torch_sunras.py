"""The port's Sun raster reader (``data/sunras.py``) against ``cv2.imread``,
exactly.

Files come from ``cv2.imwrite`` and the hand encoder of
``torch_image_writers`` (``RT_OLD`` and ``RT_STANDARD`` at depths 1, 8, 24
and 32, with and without ``RMT_EQUAL_RGB`` colour maps, short maps, odd
widths for the 16-bit row padding, truncations, unknown types and maps).
A difference by design has a test of its own: OpenCV 5 returns None for
every ``RT_BYTE_ENCODED`` (RLE) and ``RT_FORMAT_RGB`` file, which the port
reads, to the array cv2 gives the ``RT_STANDARD`` file of the same image.
"""

import cv2
import numpy as np
import pytest
from torch_image_writers import encode_sunras, sun_rle

from molnextr_tpu_torch.data.image import imread
from molnextr_tpu_torch.data.sunras import decode_sunras

SIZES = [(1, 1), (3, 5), (7, 9), (17, 33)]


def cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def check(tmp_path, data, name="x.ras"):
    """The port reads ``data`` as cv2 does (None included); returns cv2's array."""
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2_rgb(path)
    got = imread(str(path))
    if want is None:
        assert got is None
    else:
        assert got is not None and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(decode_sunras(data), want)
    return want


def _pixels(rng, bpp, h, w):
    if bpp <= 8:
        px = rng.randint(0, 1 << bpp, (h, w))
    else:
        px = rng.randint(0, 256, (h, w, bpp // 8))
    px[: h // 2] = 1  # runs, for the RLE
    return px


@pytest.mark.parametrize("size", SIZES)
def test_cv2_writes(tmp_path, size):
    rng = np.random.RandomState(size[1])
    for img in (rng.randint(0, 256, size), rng.randint(0, 256, size + (3,))):
        assert check(tmp_path, cv2.imencode(".ras", img.astype(np.uint8))[1].tobytes()) is not None


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("bpp", [1, 8, 24, 32])
def test_old_and_standard_types(tmp_path, kind, bpp):
    rng = np.random.RandomState(bpp + kind)
    for h, w in SIZES:
        px = _pixels(rng, bpp, h, w)
        maps = [None]
        if bpp <= 8:
            maps += [rng.randint(0, 256, (1 << bpp, 3)), rng.randint(0, 256, (max(1, (1 << bpp) // 3), 3))]
        for cmap in maps:
            assert check(tmp_path, encode_sunras(px, bpp, kind, cmap)) is not None


def test_unreadable_files_read_as_none(tmp_path):
    rng = np.random.RandomState(2)
    px = rng.randint(0, 256, (4, 5))
    data = encode_sunras(px, 8)
    for cut in (10, 31, len(data) - 1):
        assert check(tmp_path, data[:cut]) is None
    assert check(tmp_path, encode_sunras(px, 8, 4)) is None  # an unknown type
    assert check(tmp_path, encode_sunras(px, 8, 1, rng.randint(0, 256, (4, 3)), maptype=2)) is None
    assert check(tmp_path, encode_sunras(rng.randint(0, 256, (4, 5, 3)), 24, 1,
                                         rng.randint(0, 256, (3, 3)))) is None  # a map at 24 bits


def test_rle_decodes_runs_escapes_and_row_padding():
    """``0x80 n v`` is n + 1 copies of v, ``0x80 0`` one 0x80; runs cross
    rows, and each row of 5 pixels holds a sixth, padding byte."""
    raw = bytes([0x80, 6, 9, 1, 2, 0x80, 0, 0x80, 1, 3])
    got = decode_sunras(encode_sunras(np.zeros((2, 5)), 8, 2, raw=raw))
    assert got[..., 0].tolist() == [[9, 9, 9, 9, 9], [9, 1, 2, 128, 3]]


@pytest.mark.parametrize("kind", [2, 3])
@pytest.mark.parametrize("bpp", [1, 8, 24, 32])
def test_rle_and_rgb_types_read_where_opencv_5_fails(tmp_path, kind, bpp):
    """By design: OpenCV 5's header check refuses ``RT_BYTE_ENCODED`` and
    ``RT_FORMAT_RGB``; the port reads each to the array cv2 gives the
    ``RT_STANDARD`` file of the same image."""
    rng = np.random.RandomState(bpp * kind)
    for h, w in SIZES:
        px = _pixels(rng, bpp, h, w)
        cmap = rng.randint(0, 256, (1 << bpp, 3)) if bpp <= 8 else None
        data = encode_sunras(px, bpp, kind, cmap)
        path = tmp_path / "x.ras"
        path.write_bytes(data)
        assert cv2.imread(str(path)) is None
        standard = px
        if kind == 3 and bpp > 8:  # R, G, B in the file: the standard file holds B, G, R
            standard = np.concatenate([px[..., : bpp // 8 - 3], px[..., :-4:-1]], axis=2)
        want = check(tmp_path, encode_sunras(standard, bpp, 1, cmap), "y.ras")
        np.testing.assert_array_equal(imread(str(path)), want)
    assert check(tmp_path, encode_sunras(np.full((4, 4), 5), 8, 2)[:-1]) is None
