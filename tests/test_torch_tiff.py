"""The port's TIFF reader against ``cv2.imread``, exactly.

Files come from ``cv2.imwrite`` (every compression it writes, predictor 2,
rows per strip, 8 and 16 bits, grey, BGR and BGRA), from PIL (palette,
1-bit, CCITT MH, T.4 1-D and 2-D, T.6 with both fill orders, grey+alpha,
RGBA, 16-bit grey) and from the hand encoder of ``torch_image_writers``
(tiles, planar configuration 2, MinIsWhite, both byte orders, extra
samples, colour maps, two pages), at odd sizes and under hypothesis.  The
reference is ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``; the
port must equal it with no tolerance.  Differences by design have tests of
their own: grey at 2 and 4 bits and palettes at 2 bits, which OpenCV 5.0
refuses (orientations 5-8: ``test_torch_imread.py``).  Forms OpenCV 5.0
refuses read as None, with cv2's None asserted beside; JPEG-in-TIFF,
YCbCr, CMYK, Lab, signed samples and the rarer codecs have
``test_torch_tiff_colour.py``.  BigTIFF files (``II+``/``MM\\0+``) come
from the hand encoder, since neither cv2 nor PIL writes them.
"""

import io
import itertools
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image
from torch_image_writers import encode_tiff, pack_bits

from molnextr_tpu_torch.data.image import imread
from molnextr_tpu_torch.data.tiff import decode_tiff

SIZES = [(1, 1), (7, 9), (17, 33), (255, 257)]


def cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def check(tmp_path, data, name="x.tif"):
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2_rgb(path)
    assert want is not None
    got = decode_tiff(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imread(str(path)), want)
    return want


def _content(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    top = np.iinfo(dtype).max
    img = rng.randint(0, top + 1, shape, dtype=np.int64)
    if shape[0] > 8:  # runs, so the compressors have something to find
        img[: shape[0] // 2] = img[: shape[0] // 2] // (top // 4 + 1) * (top // 4 + 1)
    return img.astype(dtype)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("compression", [1, 5, 8, 32773, 32946])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_cv2_compressions_and_channels(tmp_path, size, compression, channels):
    h, w = size
    for dtype, predictor, rows in itertools.product((np.uint8, np.uint16), (1, 2), (0, 1, 5)):
        if size == (255, 257) and rows == 1:
            continue
        shape = (h, w) if channels == 1 else (h, w, channels)
        params = [cv2.IMWRITE_TIFF_COMPRESSION, compression, cv2.IMWRITE_TIFF_PREDICTOR, predictor]
        if rows:
            params += [cv2.IMWRITE_TIFF_ROWSPERSTRIP, rows]
        ok, buf = cv2.imencode(".tiff", _content(shape, dtype, h + w + rows), params)
        assert ok
        check(tmp_path, buf.tobytes())


def _bilevel(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    runs = ((x // (3 + seed % 5) + y // 4) % 3 == 0) | (rng.rand(h, w) < 0.03)
    runs[:, (w // 3) : (w // 3 + min(w // 2, 2600))] &= y[:, (w // 3) : (w // 3 + min(
        w // 2, 2600))] % 7 != 0  # long runs, for the make-up codes
    return runs


CCITT = [("tiff_ccitt", {}), ("group3", {}), ("group3", {292: 1}), ("group3", {292: 5}),
         ("group3", {292: 4}), ("group4", {}), ("group4", {266: 2}), ("group3", {266: 2, 292: 1}),
         ("tiff_ccitt", {266: 2})]


@pytest.mark.parametrize("compression,info", CCITT)
@pytest.mark.parametrize("size", [(1, 1), (7, 9), (64, 77), (40, 3000)])
def test_pil_ccitt(tmp_path, compression, info, size):
    buf = io.BytesIO()
    Image.fromarray(_bilevel(*size, seed=size[1])).convert("1").save(
        buf, "TIFF", compression=compression, tiffinfo=info)
    check(tmp_path, buf.getvalue())


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "packbits", "tiff_adobe_deflate",
                                         "tiff_deflate"])
def test_pil_bilevel_palette_and_alpha(tmp_path, compression):
    for h, w in ((7, 9), (17, 33)):
        rng = np.random.RandomState(h)
        check(tmp_path, _save(Image.fromarray(_bilevel(h, w, 1)).convert("1"), compression))
        pal = Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        for colours in (2, 16, 200):
            check(tmp_path, _save(pal.quantize(colours), compression))
        rgba = Image.fromarray(rng.randint(0, 256, (h, w, 4)).astype(np.uint8), "RGBA")
        for mode in ("L", "LA", "RGB", "RGBA"):
            check(tmp_path, _save(rgba.convert(mode), compression))
        check(tmp_path, _save(Image.fromarray(rng.randint(0, 65536, (h, w)).astype(np.uint16)),
                              compression))


def _save(img, compression):
    buf = io.BytesIO()
    img.save(buf, "TIFF", compression=compression)
    return buf.getvalue()


def _tags(bps, spp, photometric, extra=None):
    tags = {258: (3, [bps] * spp), 259: (3, [1]), 262: (3, [photometric]), 277: (3, [spp])}
    tags.update(extra or {})
    return tags


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("bps", [8, 16])
@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("tile", [16, 32, 48])
def test_hand_tiles_planar_and_byte_order(tmp_path, order, bps, planar, tile):
    h, w, spp = 37, 53, 3
    dtype = np.uint8 if bps == 8 else np.dtype(order + "u2")
    img = _content((h, w, spp), np.uint8 if bps == 8 else np.uint16, tile)
    planes = [img] if planar == 1 else [img[..., k : k + 1] for k in range(spp)]
    chunks = []
    for plane in planes:
        for ty in range(0, h, tile):
            for tx in range(0, w, tile):
                block = np.zeros((tile, tile, plane.shape[2]), img.dtype)
                part = plane[ty : ty + tile, tx : tx + tile]
                block[: part.shape[0], : part.shape[1]] = part
                chunks.append(zlib.compress(block.astype(dtype).tobytes()))
    tags = _tags(bps, spp, 2, {259: (3, [8]), 284: (3, [planar]), 322: (3, [tile]),
                                 323: (3, [tile])})
    check(tmp_path, encode_tiff(chunks, w, h, tags, order=order))


@pytest.mark.parametrize("bps", [8, 16])
@pytest.mark.parametrize("rows", [1, 4, 37])
def test_hand_planar_strips(tmp_path, bps, rows):
    h, w = 37, 21
    img = _content((h, w, 3), np.uint8 if bps == 8 else np.uint16, rows)
    chunks = [img[y : y + rows, :, k].astype("<u2" if bps == 16 else np.uint8).tobytes()
              for k in range(3) for y in range(0, h, rows)]
    check(tmp_path, encode_tiff(chunks, w, h, _tags(bps, 3, 2, {284: (3, [2]),
                                                                   278: (4, [rows])})))


@pytest.mark.parametrize("bps", [1, 8, 16])
@pytest.mark.parametrize("photometric", [0, 1])
def test_hand_grey_min_is_white_and_black(tmp_path, bps, photometric):
    h, w = 9, 13
    v = _content((h, w), np.uint16, bps) >> (16 - bps)
    if bps == 16:
        raw = v.astype("<u2").tobytes()
    else:
        raw = pack_bits(v, bps).tobytes()
    check(tmp_path, encode_tiff([raw], w, h, _tags(bps, 1, photometric, {278: (4, [h])})))


@pytest.mark.parametrize("bps", [1, 4, 8])
@pytest.mark.parametrize("eight_bit_map", [False, True])
def test_hand_palettes(tmp_path, bps, eight_bit_map):
    """A colour map is shifted right by 8 unless all its entries are below
    256: libtiff then assumes an 8-bit map."""
    h, w = 11, 15
    rng = np.random.RandomState(bps)
    v = rng.randint(0, 1 << bps, (h, w))
    cmap = rng.randint(0, 256 if eight_bit_map else 65536, 3 << bps)
    check(tmp_path, encode_tiff([pack_bits(v, bps).tobytes()], w, h,
                                _tags(bps, 1, 3, {320: (3, cmap.tolist())})))


@pytest.mark.parametrize("bps", [8, 16])
@pytest.mark.parametrize("extra", [None, [0], [1], [2]])
def test_hand_extra_samples(tmp_path, bps, extra):
    """An unassociated alpha (ExtraSamples 2) premultiplies RGB; another
    extra sample, or any beside grey, is dropped."""
    h, w = 6, 10
    dt = np.uint8 if bps == 8 else np.uint16
    rgba = _content((h, w, 4), dt, 7)
    grey_alpha = _content((h, w, 2), dt, 8)
    raw = (lambda a: a.astype("<u2").tobytes()) if bps == 16 else (lambda a: a.tobytes())
    more = {} if extra is None else {338: (3, extra)}
    check(tmp_path, encode_tiff([raw(rgba)], w, h, _tags(bps, 4, 2, more)))
    check(tmp_path, encode_tiff([raw(grey_alpha)], w, h, _tags(bps, 2, 1, more)))


def test_first_page_of_two(tmp_path):
    h, w = 8, 12
    img = _content((h, w, 3), np.uint8, 1)
    second = _tags(8, 1, 1)
    data = encode_tiff([img.tobytes()], w, h, _tags(8, 3, 2), second_page=second)
    np.testing.assert_array_equal(check(tmp_path, data), img)


@pytest.mark.parametrize("bps,photometric", [(2, 0), (2, 1), (4, 0), (4, 1), (2, 3)])
def test_depths_opencv_5_refuses_read_as_libtiff_maps_them(tmp_path, bps, photometric):
    """By design: OpenCV 5.0 refuses grey at 2 and 4 bits and palettes at 2
    bits ("Invalid bitsperpixel value"); the port reads them as libtiff's
    RGBA interface maps them: grey ``v * 255 // max`` (MinIsWhite inverted),
    a palette through its map."""
    h, w = 5, 7
    rng = np.random.RandomState(bps)
    v = rng.randint(0, 1 << bps, (h, w))
    tags = _tags(bps, 1, photometric)
    cmap = rng.randint(0, 65536, 3 << bps)
    if photometric == 3:
        tags[320] = (3, cmap.tolist())
    path = tmp_path / "x.tif"
    path.write_bytes(encode_tiff([pack_bits(v, bps).tobytes()], w, h, tags))
    assert cv2.imread(str(path)) is None
    top = (1 << bps) - 1
    if photometric == 3:
        want = (cmap.reshape(3, -1) >> 8)[:, v].transpose(1, 2, 0)
    else:
        grey = v * 255 // top if photometric == 1 else (top - v) * 255 // top
        want = np.repeat(grey[..., None], 3, axis=2)
    np.testing.assert_array_equal(imread(str(path)), want.astype(np.uint8))


def test_more_than_four_samples_reads_as_none(tmp_path):
    h, w = 4, 5
    img = _content((h, w, 5), np.uint8, 2)
    path = tmp_path / "x.tif"
    path.write_bytes(encode_tiff([img.tobytes()], w, h, _tags(8, 5, 2, {338: (3, [2, 0])})))
    assert cv2.imread(str(path)) is None and imread(str(path)) is None


@pytest.mark.parametrize("compression,name", [
    (6, "old-style JPEG"), (7, "JPEG"), (34925, "LZMA"), (50000, "ZSTD"), (50001, "WebP"),
    (34661, "JBIG"), (34712, "JPEG 2000"), (34887, "LERC")])
def test_compressions_opencv_5_lacks_read_as_none(tmp_path, compression, name):
    """LZMA, ZSTD, WebP, JBIG and LERC are "not configured" in OpenCV 5.0's
    libtiff and old-style JPEG is refused: None, as cv2 reads them; a JPEG
    strip that is no JPEG stream is refused too.  JPEG 2000 (34712) is no
    libtiff codec at all: every strip fails and reads as zero samples."""
    path = tmp_path / "x.tif"
    path.write_bytes(encode_tiff([bytes(12)], 2, 2, _tags(8, 3, 2, {259: (3, [compression])})))
    want = cv2_rgb(path)
    if name == "JPEG 2000":
        np.testing.assert_array_equal(want, np.zeros((2, 2, 3), np.uint8))
        np.testing.assert_array_equal(imread(str(path)), want)
    else:
        assert want is None and imread(str(path)) is None


@pytest.mark.parametrize("tags,name", [
    ({339: (3, [3])}, "float"), ({262: (3, [5])}, "CMYK"), ({258: (3, [12, 12, 12])}, "12-bit")])
def test_samples_opencv_5_refuses_read_as_none(tmp_path, tags, name):
    """Float samples, CMYK of three samples and 12-bit samples: None, as cv2."""
    path = tmp_path / "x.tif"
    path.write_bytes(encode_tiff([bytes(24)], 2, 2, {**_tags(8, 3, 2), **tags}))
    assert cv2.imread(str(path)) is None and imread(str(path)) is None


@pytest.mark.parametrize("tags,name", [
    ({317: (3, [3])}, "float predictor"), ({339: (3, [2])}, "signed"),
    ({262: (3, [6])}, "YCbCr"), ({262: (3, [8])}, "Lab")])
def test_samples_libtiff_maps_read_as_cv2(tmp_path, tags, name):
    """The floating-point predictor on integer samples (ignored), signed
    samples, YCbCr (2x2 by default) and CIE Lab read as cv2 reads them
    (``test_torch_tiff_colour.py`` holds each form at length)."""
    rng = np.random.RandomState(len(name))
    data = rng.randint(0, 256, 24).astype(np.uint8).tobytes()
    check(tmp_path, encode_tiff([data], 2, 2, {**_tags(8, 3, 2), **tags}))


def test_pil_jpeg_in_tiff_reads_and_float_reads_as_none(tmp_path):
    rgb = Image.fromarray(_content((8, 8, 3), np.uint8, 4))
    check(tmp_path, _save(rgb, "jpeg"))
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.float32)).save(buf, "TIFF")
    path = _write(tmp_path / "f.tif", buf.getvalue())
    assert cv2.imread(str(path)) is None and imread(str(path)) is None


def _write(path, data):
    path.write_bytes(data)
    return path


def test_truncated_and_corrupt_files_read_as_none(tmp_path):
    img = _content((30, 40, 3), np.uint8, 3)
    for params in ([cv2.IMWRITE_TIFF_COMPRESSION, 1], [cv2.IMWRITE_TIFF_COMPRESSION, 5],
                   [cv2.IMWRITE_TIFF_COMPRESSION, 8]):
        data = cv2.imencode(".tiff", img, params)[1].tobytes()
        for cut in (20, len(data) // 2):
            path = _write(tmp_path / f"cut{cut}.tif", data[:cut])
            assert cv2.imread(str(path)) is None and imread(str(path)) is None


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2**16),
       compression=st.sampled_from([1, 5, 8, 32773]), predictor=st.sampled_from([1, 2]),
       channels=st.sampled_from([1, 3, 4]), sixteen=st.booleans())
def test_hypothesis_sizes_and_contents(tmp_path, h, w, seed, compression, predictor, channels,
                                       sixteen):
    shape = (h, w) if channels == 1 else (h, w, channels)
    img = _content(shape, np.uint16 if sixteen else np.uint8, seed)
    buf = cv2.imencode(".tiff", img, [cv2.IMWRITE_TIFF_COMPRESSION, compression,
                                      cv2.IMWRITE_TIFF_PREDICTOR, predictor])[1]
    check(tmp_path, buf.tobytes())


@settings(max_examples=20, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 30), w=st.integers(1, 200), seed=st.integers(0, 2**16),
       compression=st.sampled_from(["group3", "group4", "tiff_ccitt"]), two_d=st.booleans())
def test_hypothesis_ccitt(tmp_path, h, w, seed, compression, two_d):
    rng = np.random.RandomState(seed)
    bits = rng.rand(h, w) < rng.uniform(0.02, 0.6)
    buf = io.BytesIO()
    info = {292: 1} if two_d and compression == "group3" else {}
    Image.fromarray(bits).convert("1").save(buf, "TIFF", compression=compression, tiffinfo=info)
    check(tmp_path, buf.getvalue())


# -- BigTIFF -------------------------------------------------------------------------


def _bigtiff_cases(rng, h, w):
    rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    grey = rng.randint(0, 256, (h, w)).astype(np.uint8)
    base = {258: (3, [8, 8, 8]), 262: (3, [2]), 277: (3, [3]), 278: (4, [h])}
    grey_tags = {258: (3, [8]), 259: (3, [1]), 262: (3, [1]), 277: (3, [1]), 278: (4, [h])}
    rows = 3
    return {
        "raw": ([rgb.tobytes()], {**base, 259: (3, [1])}, {}),
        "deflate": ([zlib.compress(rgb.tobytes())], {**base, 259: (3, [8])}, {}),
        "LONG offsets": ([rgb.tobytes()], {**base, 259: (3, [1])}, {"offset_type": 4}),
        "IFD8 offsets": ([rgb.tobytes()], {**base, 259: (3, [1])}, {"offset_type": 18}),
        "strips": ([rgb[i:i + rows].tobytes() for i in range(0, h, rows)],
                   {**base, 259: (3, [1]), 278: (4, [rows])}, {}),
        "two pages": ([grey.tobytes()], grey_tags,
                      {"second_page": {258: (3, [8]), 262: (3, [0]), 277: (3, [1])}}),
        "palette": ([grey.tobytes()], {**grey_tags, 262: (3, [3]),
                                       320: (3, list(rng.randint(0, 65536, 3 * 256)))}, {}),
    }


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("name", ["raw", "deflate", "LONG offsets", "IFD8 offsets", "strips",
                                  "two pages", "palette"])
def test_bigtiff(tmp_path, order, name):
    """8-byte offsets and counts, 20-byte IFD entries, ``LONG8`` chunk
    offsets (``LONG`` ones too; libtiff refuses ``IFD8`` ones: None)."""
    for h, w in ((1, 1), (7, 9), (40, 33)):
        chunks, tags, extra = _bigtiff_cases(np.random.RandomState(h + w), h, w)[name]
        data = encode_tiff(chunks, w, h, tags, order, big=True, **extra)
        path = tmp_path / "x.tif"
        path.write_bytes(data)
        want = cv2_rgb(path)
        assert (want is None) == (name == "IFD8 offsets")
        if want is None:
            assert imread(str(path)) is None
        else:
            check(tmp_path, data)


def test_bigtiff_lzw_and_a_bad_header(tmp_path):
    rng = np.random.RandomState(5)
    rgb = rng.randint(0, 4, (30, 20, 3)).astype(np.uint8) * 60
    classic = cv2.imencode(".tiff", rgb, [cv2.IMWRITE_TIFF_COMPRESSION, 5])[1].tobytes()
    lzw, predictor = _lzw_strip(classic)  # the LZW strip, re-wrapped as a BigTIFF
    tags = {258: (3, [8, 8, 8]), 259: (3, [5]), 262: (3, [2]), 277: (3, [3]), 278: (4, [30]),
            317: (3, [predictor])}
    data = encode_tiff([lzw], 20, 30, tags, big=True)
    strip = decode_tiff(classic)
    np.testing.assert_array_equal(check(tmp_path, data), strip)
    path = tmp_path / "y.tif"
    path.write_bytes(data[:4] + b"\x04" + data[5:])  # offset size 4: not a BigTIFF
    assert cv2.imread(str(path)) is None and imread(str(path)) is None


def _lzw_strip(classic: bytes):
    """The one LZW strip of a one-strip classic TIFF, and its predictor."""
    from molnextr_tpu_torch.data.tiff import _tags

    t = _tags(classic, "<", int.from_bytes(classic[4:8], "little"))
    assert len(t[273]) == 1 and t[259] == [5]
    return classic[t[273][0] : t[273][0] + t[279][0]], t.get(317, [1])[0]
