"""libavif's rescaling of an AV1 frame to its ``ispe`` in the port
(``data/yuv_scale.py``, ``data/avif.py``) against libyuv and
``cv2.imread``, exactly.

* Units: :func:`yuv_scale.filter_reduce` and :func:`yuv_scale.slope`
  against libyuv's ``ScaleFilterReduce`` and ``ScaleSlope``, and
  :func:`yuv_scale.scale_plane` against ``ScalePlane`` and
  ``ScalePlane_12`` with ``kFilterBox``, all exported by the libavif that
  cv2 ships (called through ``ctypes``): shape pairs that reach each path
  (a spy asserts the path is taken) at 8, 10 and 12 bits, and seeded
  random pairs.
* Files from ``torch_image_writers.rescaled_avif`` (libaom through
  ``ctypes``; Pillow for ``avis``) read through ``imread`` against
  ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` with no tolerance:
  8-, 10- and 12-bit frames at 4:2:0, 4:2:2, 4:4:4 and 4:0:0, smaller and
  larger than their ``ispe``, lossless and lossy, with an alpha item, in a
  grid and in an ``avis`` sequence (the ``tkhd`` size), and seeded byte
  flips; None where cv2 gives None.

Found by probing cv2 5.0 (libavif 1.4.2): libavif rescales with
``kFilterBox``; a frame past 16384 a side is not rescaled ("invalid width
scale for libyuv"), while 16384 is; an ``ispe`` past 16384 x 16384 pixels
(libavif's ``imageSizeLimit``, below OpenCV's 2^30) reads as None.
"""

import ctypes
import glob
import os
import struct

import cv2
import numpy as np
import pytest
from torch_image_writers import (aom_avif, aom_encode, aom_yuv, avif_boxes, avif_grid,
                                 film_grain_avif, rescaled_avif, with_ispe)

from molnextr_tpu_torch.data import yuv_scale
from molnextr_tpu_torch.data.image import UnsupportedFormat, imread

LIBAVIF = glob.glob(os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                                 "opencv_python.libs", "libavif-*.so*"))[0]


def _lib():
    lib = ctypes.CDLL(LIBAVIF)
    lib.ScaleFilterReduce.restype = ctypes.c_int
    return lib


def libyuv_scale(src, dw, dh, high):
    """``ScalePlane`` (uint8) or ``ScalePlane_12`` (uint16), ``kFilterBox``."""
    src = np.ascontiguousarray(src)
    h, w = src.shape
    dst = np.zeros((dh, dw), np.uint16 if high else np.uint8)
    fn = _lib().ScalePlane_12 if high else _lib().ScalePlane
    ptr = ctypes.c_void_p
    assert fn(src.ctypes.data_as(ptr), w, w, h, dst.ctypes.data_as(ptr), dw, dw, dh, 3) == 0
    return dst


def cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def check(tmp_path, data, name="x.avif"):
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
    return want


def picture(h, w, seed=0):
    """A smooth picture with edges: every filter's rounding shows."""
    rng = np.random.RandomState(seed)
    yy, xx = np.indices((h, w))
    base = np.stack([(7 * yy + 3 * xx) % 256, (5 * xx) % 256, (4 * yy + 9 * xx) % 256], axis=2)
    noise = cv2.GaussianBlur(rng.randint(0, 80, (h, w, 3)).astype(np.uint8), (3, 3), 0)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


# -- libyuv units ---------------------------------------------------------------------

SIZES = [1, 2, 3, 4, 5, 7, 8, 12, 16, 17, 24, 31, 32, 48, 64, 100]


def test_filter_reduce_and_slope_match_libyuv():
    lib = _lib()
    for sw in SIZES:
        for sh in SIZES[::3]:
            for dw in SIZES[::2]:
                for dh in SIZES[1::3]:
                    for f in range(4):
                        assert yuv_scale.filter_reduce(sw, sh, dw, dh, f) == \
                            lib.ScaleFilterReduce(sw, sh, dw, dh, f), (sw, sh, dw, dh, f)
                        v = [ctypes.c_int(0) for _ in range(4)]
                        lib.ScaleSlope(sw, sh, dw, dh, f, *[ctypes.byref(t) for t in v])
                        assert yuv_scale.slope(sw, sh, dw, dh, f) == tuple(t.value for t in v)


# path -> (source width, height, output width, height) pairs that reach it
PATHS = {
    "_vertical": [(20, 30, 20, 13), (20, 13, 20, 31), (20, 30, 20, 10), (9, 1, 9, 4)],
    "_down34": [(64, 48, 48, 36), (40, 40, 30, 30), (36, 12, 27, 9)],
    "_down2": [(40, 30, 20, 15), (66, 6, 33, 3)],
    "_down38": [(64, 32, 24, 12), (72, 40, 27, 15), (16, 8, 6, 3)],
    "_down4": [(64, 48, 16, 12), (132, 8, 33, 2)],
    "_box": [(50, 40, 7, 6), (60, 45, 6, 5), (70, 800, 3, 2), (33, 1000, 7, 1),
             (1000, 300, 1, 1), (130, 520, 40, 1)],
    "_up2_linear_rows": [(10, 1, 20, 1), (10, 12, 19, 12), (10, 30, 20, 10), (7, 1, 13, 2)],
    "up2_bilinear": [(10, 8, 20, 16), (10, 8, 19, 15), (5, 3, 10, 6), (64, 33, 127, 66)],
    "_bilinear_up": [(10, 8, 23, 17), (10, 1, 23, 5), (40, 9, 13, 30), (3, 2, 100, 90)],
    "_bilinear_down": [(30, 20, 17, 13), (30, 20, 17, 20), (8, 20, 30, 11), (100, 90, 60, 70)],
    "_simple": [(1, 10, 5, 4), (30, 10, 10, 10), (1, 1, 3, 3), (60, 7, 20, 7)],
}


@pytest.mark.parametrize("bits", [8, 10, 12])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_each_path_matches_scale_plane(monkeypatch, path, bits):
    """Each path of ``ScalePlane`` / ``ScalePlane_12`` on pairs that reach
    it, on random samples and on samples near the top of the range."""
    calls = []
    real = getattr(yuv_scale, path)

    def spy(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(yuv_scale, path, spy)
    rng = np.random.RandomState(bits)
    for sw, sh, dw, dh in PATHS[path]:
        for top in (False, True):
            src = rng.randint(0, 1 << bits, (sh, sw))
            if top:
                src = (1 << bits) - 1 - rng.randint(0, 3, (sh, sw))
            src = src.astype(np.uint8 if bits == 8 else np.uint16)
            calls.clear()
            got = yuv_scale.scale_plane(src, dw, dh, bits > 8)
            assert calls, (path, sw, sh, dw, dh)
            np.testing.assert_array_equal(got, libyuv_scale(src, dw, dh, bits > 8),
                                          err_msg=str((sw, sh, dw, dh)))


@pytest.mark.parametrize("seed", range(6))
def test_random_shapes_match_scale_plane(seed):
    rng = np.random.RandomState(100 + seed)
    for _ in range(60):
        sw, sh, dw, dh = (int(v) for v in rng.randint(1, 70, 4))
        if rng.rand() < 0.3:  # a fixed ratio
            k = int(rng.choice([2, 4, 8]))
            num = {2: 1, 4: int(rng.choice([1, 3])), 8: 3}[k]
            dw, dh = max(sw // k, 1) * num, max(sh // k, 1) * num
            sw, sh = dw * k // num, dh * k // num
        for bits in (8, 10, 12):
            src = rng.randint(0, 1 << bits, (sh, sw)).astype(np.uint8 if bits == 8 else np.uint16)
            np.testing.assert_array_equal(yuv_scale.scale_plane(src, dw, dh, bits > 8),
                                          libyuv_scale(src, dw, dh, bits > 8),
                                          err_msg=str((sw, sh, dw, dh, bits)))


# -- files ----------------------------------------------------------------------------

ISPES = {"down": [(36, 30), (24, 20), (12, 10)], "up": [(96, 80), (72, 60)],
         "odd": [(47, 41), (49, 39), (1, 1)]}


@pytest.mark.parametrize("kind", sorted(ISPES))
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_rescaled_items_read_as_cv2(tmp_path, depth, subsampling, kind):
    """A 48 x 40 frame at every depth and subsampling, lossless, under
    ``ispe`` sizes below, above and beside it; chroma goes to the
    subsampled size of the ``ispe``."""
    frame = picture(40, 48, depth)
    for ispe in ISPES[kind]:
        want = check(tmp_path, rescaled_avif(frame, ispe, depth, subsampling))
        assert want.shape == (ispe[1], ispe[0], 3)


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_lossy_frames_rescaled(tmp_path, depth):
    frame = picture(50, 60, 7)
    for ispe, subsampling in (((45, 37), "4:2:0"), ((120, 100), "4:4:4"), ((23, 60), "4:2:2")):
        assert check(tmp_path, rescaled_avif(frame, ispe, depth, subsampling, q=30)) is not None


def test_every_path_from_a_file(tmp_path, monkeypatch):
    """Files whose rescaling runs each path (luma or chroma)."""
    reached = set()
    for name in PATHS:
        real = getattr(yuv_scale, name)

        def spy(*args, _name=name, _real=real, **kw):
            reached.add(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(yuv_scale, name, spy)
    frame = picture(48, 64, 3)
    for ispe in ((48, 36), (32, 24), (24, 18), (16, 12), (9, 7), (64, 20), (128, 96), (127, 95),
                 (100, 90), (40, 30), (64, 16), (200, 16), (64, 70)):
        for subsampling in ("4:4:4", "4:2:0"):
            check(tmp_path, rescaled_avif(frame, ispe, 8, subsampling))
    check(tmp_path, rescaled_avif(picture(10, 30, 4), (10, 10), 8, "4:4:4"))
    check(tmp_path, rescaled_avif(picture(8, 8, 5), (16, 8), 10, "4:4:4"))
    assert reached == set(PATHS), set(PATHS) - reached


def test_alpha_items_rescaled_and_checked(tmp_path):
    """Colour and alpha frames of other sizes, both rescaled to one
    ``ispe``, read; an alpha ``ispe`` of another size than the colour's,
    or grey with alpha, reads as None, as in cv2."""
    frame = picture(40, 40, 8)
    for depth in (8, 10, 12):
        assert check(tmp_path, rescaled_avif(frame, (64, 64), depth, alpha=(24, 20))) is not None
        assert check(tmp_path, rescaled_avif(frame, (30, 30), depth, alpha=(40, 40),
                                             q=20)) is not None
    assert check(tmp_path, rescaled_avif(frame, (64, 64), alpha=(20, 20),
                                         alpha_ispe=(32, 32))) is None
    assert check(tmp_path, rescaled_avif(frame, (64, 64), subsampling="4:0:0",
                                         alpha=(20, 20))) is None


def test_grids_of_rescaled_tiles(tmp_path):
    """Each tile is rescaled to its own ``ispe`` before libavif's grid
    rules see it: a tile size that is odd under 4:2:0 or below 64 reads
    as None, as in cv2."""
    frame = picture(40, 48, 9)
    assert check(tmp_path, rescaled_avif(frame, (64, 70), grid=(2, 3))).shape == (140, 192, 3)
    assert check(tmp_path, rescaled_avif(frame, (96, 64), 10, "4:4:4", grid=(1, 2))) is not None
    assert check(tmp_path, rescaled_avif(frame, (65, 64), grid=(2, 2))) is None
    assert check(tmp_path, rescaled_avif(frame, (64, 32), grid=(2, 2))) is None


def test_superres_grain_and_mixed_tiles_rescaled(tmp_path):
    """The rescaling comes after libaom's superres upscaling and film
    grain; grid tiles of other frame sizes under one ``ispe`` read, of
    another depth or ``ispe`` read as None; an alpha grid of rescaled
    tiles reads, one of another size is None."""
    frame = picture(48, 64, 16)
    for denominator in (9, 16):
        obus = aom_encode(aom_yuv(frame), q=10, superres=denominator)
        for ispe in ((40, 30), (100, 75)):
            assert check(tmp_path, with_ispe(aom_avif(obus), ispe)) is not None
    for ispe in ((100, 90), (13, 17)):
        assert check(tmp_path, with_ispe(film_grain_avif(1, 25, 64), ispe)) is not None
    a = rescaled_avif(picture(40, 48, 17), (64, 70))
    b = rescaled_avif(picture(30, 36, 18), (64, 70))
    assert check(tmp_path, avif_grid([a, b, b, a], 2, 2)).shape == (140, 128, 3)
    assert check(tmp_path, avif_grid([a, rescaled_avif(frame, (64, 70), 10), a, a], 2, 2)) is None
    assert check(tmp_path, avif_grid([a, rescaled_avif(frame, (64, 72)), a, a], 2, 2)) is None
    for side, read in ((70, True), (64, False)):
        matte = rescaled_avif(picture(20, 20, 19), (64, side), subsampling="4:0:0")
        assert (check(tmp_path, avif_grid([a] * 4, 2, 2, alpha=[matte] * 4)) is None) != read


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
def test_sequences_rescaled_to_their_track_size(tmp_path, subsampling):
    frame = picture(30, 40, 10)
    for size in ((20, 16), (100, 60), (41, 29)):
        want = check(tmp_path, rescaled_avif(frame, size, subsampling=subsampling,
                                             sequence=True))
        assert want.shape == (size[1], size[0], 3)


def test_sequence_alpha_tracks_rescaled(tmp_path):
    """An alpha track is rescaled to its own ``tkhd`` size; where that is
    not the colour track's, libavif refuses the pair (None)."""
    frame = picture(24, 32, 15)
    for ispe, alpha_ispe in (((16, 12), (16, 12)), ((64, 48), (64, 48)), ((16, 12), (32, 24)),
                             ((32, 24), (16, 12)), ((32, 24), (32, 24))):
        want = check(tmp_path, rescaled_avif(frame, ispe, alpha=frame.shape[1::-1],
                                             alpha_ispe=alpha_ispe, sequence=True))
        assert (want is None) == (ispe != alpha_ispe)


def test_limits(tmp_path):
    """A frame of 16384 a side is rescaled, of 16385 not (None); an
    ``ispe`` past libavif's 16384 x 16384 pixels reads as None before any
    decoding; a frame far larger than its ``ispe`` is decoded and boxed
    down."""
    for w, h, iw, ih in ((16385, 8, 16384, 8), (8, 16385, 8, 16384), (16384, 8, 16383, 8),
                         (8, 16384, 8, 16383)):
        frame = np.full((h, w, 3), 90, np.uint8)
        frame[:, ::7] = 200
        want = check(tmp_path, rescaled_avif(frame, (iw, ih), q=40))
        assert (want is None) == (max(w, h) > 16384)
    small = picture(16, 16, 11)
    for ispe in ((32768, 8193), (16385, 16384), (32769, 2)):
        assert check(tmp_path, rescaled_avif(small, ispe)) is None
    assert check(tmp_path, rescaled_avif(picture(64, 80, 12), (8, 6))).shape == (6, 8, 3)


def test_fuzzed_rescaled_files_read_as_none_exactly_where_cv2_does(tmp_path):
    rng = np.random.RandomState(21)
    sources = [rescaled_avif(picture(24, 32, 13), (40, 30)),
               rescaled_avif(picture(24, 32, 14), (20, 15), 10, "4:4:4", q=20)]
    path = tmp_path / "x.avif"
    read = 0
    for data in sources:
        ispe = avif_boxes(data)[b"ispe"][0]
        variants = []
        for _ in range(40):
            d = bytearray(data)
            for _ in range(rng.randint(1, 3)):
                d[rng.randint(0, len(d))] = rng.randint(0, 256)
            variants.append(bytes(d))
        for _ in range(10):  # another ispe, maybe past the limits
            d = bytearray(data)
            struct.pack_into(">II", d, ispe + 12, *(int(v) for v in rng.randint(1, 300, 2)))
            variants.append(bytes(d))
        for v in variants:
            path.write_bytes(v)
            want = cv2_rgb(path)
            try:
                got = imread(str(path))
            except UnsupportedFormat:
                continue  # an inter frame the flips made; cv2's answer is not compared
            if want is None:
                assert got is None
            else:
                read += 1
                np.testing.assert_array_equal(got, want)
    assert read
