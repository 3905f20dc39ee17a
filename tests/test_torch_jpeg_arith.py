"""Arithmetic-coded and lossless JPEG, and libjpeg's block smoothing, against
``cv2.imread``, exactly.

Files come from the hand encoders of ``torch_image_writers``
(``encode_jpeg_arith``: ``jcarith.c``'s QM coder, sequential or
progressive under any scan script, restarts, ``DAC`` conditioning;
``encode_jpeg_lossless``: predictors 1-7 and point transforms) and from
``cv2.imwrite`` (progressive files cut short).  The reference is
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``; the port must equal
it with no tolerance, or read None where it reads None:

* SOF9 and SOF10 at every sampling factor, restart interval and
  conditioning bound, grey, YCbCr, RGB and CMYK; progressive scripts that
  stop before the AC coefficients are refined (smoothed), DC-only files
  (the DC interpolated too); files cut anywhere (zero data to the scan's
  end) and seeded corruptions (a magnitude or spectral overflow skips the
  rest of the interval);
* lossless SOF3: every predictor and point transform, restarts, RGB and
  CMYK, 2-8 bits; grey and YCbCr (which libjpeg-turbo will not convert in
  a lossless frame) and 9-16 bits read as None;
* block smoothing of cv2's progressive files cut at many points: the
  coefficient bits before the cut scan below the row where its data ran
  out, the bits after it above.
"""

import cv2
import numpy as np
import pytest
from torch_image_writers import encode_jpeg_arith, encode_jpeg_lossless

from molnextr_tpu_torch.data.image import imread
from molnextr_tpu_torch.data.jpeg import decode_jpeg

SIZES = [(1, 1), (7, 9), (21, 30), (40, 37)]
FACTORS = [[(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 2), (1, 1)],
           [(1, 2), (1, 1), (1, 1)], [(4, 1), (1, 1), (1, 1)]]
# a progressive script in the spirit of libjpeg's: DC (point transform 1),
# AC bands, then the refinements
SCRIPT = [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([1], 1, 63, 0, 1), ([2], 1, 63, 0, 1),
          ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1), ([0, 1, 2], 0, 0, 1, 0), ([0], 1, 63, 1, 0),
          ([1], 1, 63, 1, 0), ([2], 1, 63, 1, 0)]


def cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def same(tmp_path, data, name="x.jpg"):
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


def check(tmp_path, data):
    want = same(tmp_path, data)
    assert want is not None
    np.testing.assert_array_equal(decode_jpeg(data), want)
    return want


def _planes(h, w, seed, n=3):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    base = [(x * 7 + y * 3) % 256, (x * x + y) % 256, (y * 5 + 40) % 256, (x * 3 + 90) % 256]
    return [np.clip(base[k] + rng.randint(-30, 31, (h, w)), 0, 255).astype(np.uint8)
            for k in range(n)]


# -- arithmetic coding ------------------------------------------------------------------


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("factors", range(len(FACTORS)))
def test_arith_sequential(tmp_path, size, factors):
    planes = _planes(*size, seed=factors)
    f = FACTORS[factors]
    check(tmp_path, encode_jpeg_arith(planes, f))
    check(tmp_path, encode_jpeg_arith(planes, f, restart=2))
    check(tmp_path, encode_jpeg_arith(planes, f, quality_step=1))


@pytest.mark.parametrize("dac", [[(0x00, 0x00)], [(0x00, 0x50)], [(0x00, 0xF3), (0x10, 1)],
                                 [(0x10, 63)], [(0x00, 0x21), (0x10, 12)]])
def test_arith_conditioning(tmp_path, dac):
    """``DAC`` bounds L, U of the DC contexts and K of the AC ones."""
    planes = _planes(24, 40, 3)
    check(tmp_path, encode_jpeg_arith(planes, [(2, 2), (1, 1), (1, 1)], dac=dac, quality_step=2))
    check(tmp_path, encode_jpeg_arith(planes, [(1, 1)] * 3, dac=dac, scans=SCRIPT))


@pytest.mark.parametrize("options", [{"jfif": True}, {"adobe": 0}, {"ids": [82, 71, 66]},
                                     {"adobe": 1}])
def test_arith_colour_spaces_grey_and_cmyk(tmp_path, options):
    planes = _planes(19, 23, 4)
    check(tmp_path, encode_jpeg_arith(planes, [(2, 2), (1, 1), (1, 1)], **options))
    check(tmp_path, encode_jpeg_arith(planes[:1], [(1, 1)]))
    cmyk = _planes(19, 23, 5, 4)
    check(tmp_path, encode_jpeg_arith(cmyk, [(2, 2), (1, 1), (1, 1), (2, 2)],
                                      adobe=options.get("adobe")))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("factors", range(3))
@pytest.mark.parametrize("scans", [10, 7, 4, 1])
def test_arith_progressive(tmp_path, size, factors, scans):
    """The whole script, and scripts cut before the refinements (block
    smoothing) or after the DC scan (the DC interpolated too)."""
    planes = _planes(*size, seed=scans)
    f = FACTORS[factors]
    check(tmp_path, encode_jpeg_arith(planes, f, scans=SCRIPT[:scans]))
    check(tmp_path, encode_jpeg_arith(planes, f, scans=SCRIPT[:scans], restart=3))


@pytest.mark.parametrize("progressive", [False, True])
def test_arith_cut_anywhere(tmp_path, progressive):
    """A cut file: the arithmetic decoder reads zeros to its scan's end; the
    scans after the cut never come, and smoothing follows."""
    planes = _planes(40, 48, 6)
    data = encode_jpeg_arith(planes, [(2, 2), (1, 1), (1, 1)], restart=4,
                             scans=SCRIPT if progressive else None)
    for cut in range(len(data) // 10, len(data), max(1, len(data) // 25)):
        same(tmp_path, data[:cut])


@pytest.mark.parametrize("seed", range(60))
def test_arith_fuzz(tmp_path, seed):
    """Seeded corruption of the entropy data: overflows end an interval as
    ``jdarith.c``'s ``ct = -1`` does."""
    rng = np.random.RandomState(seed)
    planes = _planes(rng.randint(8, 33), rng.randint(8, 33), seed)
    data = bytearray(encode_jpeg_arith(planes, FACTORS[seed % 3], restart=rng.randint(0, 3),
                                       scans=SCRIPT if seed % 2 else None))
    start = data.rindex(b"\xff\xda")
    for _ in range(rng.randint(1, 6)):
        at = rng.randint(start + 12, len(data) - 2)
        data[at] = rng.randint(0, 255)
    same(tmp_path, bytes(data))


# -- lossless ---------------------------------------------------------------------------


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("pt", [0, 1, 5])
def test_lossless_predictors(tmp_path, predictor, pt):
    """RGB (a lossless frame without markers is RGB to libjpeg-turbo) and
    ids R, G, B; restarts every row and every three rows."""
    for size in SIZES:
        planes = _planes(*size, seed=predictor + pt)
        check(tmp_path, encode_jpeg_lossless(planes, predictor, pt))
        w = size[1]
        check(tmp_path, encode_jpeg_lossless(planes, predictor, pt, restart=w,
                                             ids=[82, 71, 66]))
        check(tmp_path, encode_jpeg_lossless(planes, predictor, pt, restart=3 * w))


def test_lossless_cmyk_and_what_libjpeg_turbo_will_not_convert(tmp_path):
    """CMYK reads; grey, YCbCr (JFIF, Adobe 1), YCCK and precisions above 8
    read as None, as cv2 reads them."""
    planes = _planes(11, 13, 1, 4)
    check(tmp_path, encode_jpeg_lossless(planes, 1))
    check(tmp_path, encode_jpeg_lossless(planes, 4, adobe=0))
    for data in (encode_jpeg_lossless(planes[:1], 1),
                 encode_jpeg_lossless(planes[:3], 1, jfif=True),
                 encode_jpeg_lossless(planes[:3], 1, adobe=1),
                 encode_jpeg_lossless(planes, 1, adobe=2),
                 encode_jpeg_lossless([p.astype(np.int64) * 2 for p in planes[:3]], 1,
                                      precision=9),
                 encode_jpeg_lossless([p.astype(np.int64) * 16 for p in planes[:3]], 1,
                                      precision=12)):
        assert same(tmp_path, data) is None


@pytest.mark.parametrize("precision", [2, 5, 7])
@pytest.mark.parametrize("pt", [0, 1])
def test_lossless_below_8_bits_reads_its_samples_as_they_are(tmp_path, precision, pt):
    """libjpeg-turbo's 8-bit reader takes a lossless frame of 2-7 bits and
    returns its samples unscaled (0 to 2**precision - 1)."""
    planes = [p >> (8 - precision) for p in _planes(9, 14, precision)]
    want = check(tmp_path, encode_jpeg_lossless(planes, 1 + precision % 7, pt,
                                                precision=precision))
    np.testing.assert_array_equal(want, np.stack([p >> pt << pt for p in planes], axis=2))


@pytest.mark.parametrize("seed", range(30))
def test_lossless_cut_and_corrupt(tmp_path, seed):
    """Cut files (rows after the data ran out are the centre value) and
    flipped bytes."""
    rng = np.random.RandomState(seed)
    h, w = rng.randint(2, 20), rng.randint(2, 20)
    data = bytearray(encode_jpeg_lossless(_planes(h, w, seed), 1 + seed % 7, seed % 3,
                                          restart=w * (seed % 3)))
    if seed % 2:
        data = data[: rng.randint(len(data) // 3, len(data))]
    else:
        start = data.rindex(b"\xff\xda") + 14
        for _ in range(3):
            data[rng.randint(start, len(data) - 2)] = rng.randint(0, 255)
    same(tmp_path, bytes(data))


# -- block smoothing of cut Huffman files -----------------------------------------------


@pytest.mark.parametrize("sampling", ["420", "422", "444"])
@pytest.mark.parametrize("quality", [40, 90])
def test_cut_progressive_files_are_smoothed(tmp_path, sampling, quality):
    """cv2's progressive files cut at 30 points each: smoothed with the
    coefficient bits libjpeg latched, those from before the cut scan below
    the iMCU row where its data ran out."""
    rng = np.random.RandomState(quality)
    h, w = 48 + quality % 7, 64 + quality % 5
    img = np.stack(_planes(h, w, quality), axis=2)
    img[rng.rand(h, w) < 0.05] = 255
    data = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")])[1].tobytes()
    for cut in np.linspace(len(data) // 8, len(data) - 1, 30).astype(int):
        same(tmp_path, data[:cut])
