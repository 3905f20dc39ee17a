"""The port's JPEG reader against ``cv2.imread``, exactly.

Files come from ``cv2.imwrite`` (quality, sampling factor, progressive,
restart interval, optimized tables), from PIL (CMYK, grey, RGB) and from
the hand encoder of ``torch_image_writers`` (sampling factors up to 4x4,
component ids, Adobe transforms, JFIF beside Adobe, restarts, CMYK and
YCCK), at odd sizes and under hypothesis.  The reference is
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``; the port must equal
it with no tolerance.  Truncated files: sequential ones read as cv2 reads
them; a truncated progressive file, which libjpeg block-smooths, raises
(a difference by design).  Unported forms raise naming the form.
"""

import io
import itertools

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image
from torch_image_writers import encode_jpeg

from molnextr_tpu_torch.data.image import UnsupportedFormat, imread
from molnextr_tpu_torch.data.jpeg import decode_jpeg

SIZES = [(1, 1), (7, 9), (17, 33), (64, 48)]
SAMPLING = ["411", "420", "422", "440", "444"]


def cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _content(h, w, seed, kind="mixed"):
    rng = np.random.RandomState(seed)
    if kind == "noise":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    y, x = np.mgrid[:h, :w]
    img = np.stack([(x * 7 + y * 3) % 256, (x * x + y) % 256, (y * 5 + 40) % 256], axis=2)
    img = img + rng.randint(-20, 21, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def check(tmp_path, data, name="x.jpg"):
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2_rgb(path)
    assert want is not None
    got = decode_jpeg(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imread(str(path)), want)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sampling", SAMPLING)
@pytest.mark.parametrize("progressive", [0, 1])
def test_cv2_sampling_and_progressive(tmp_path, size, sampling, progressive):
    h, w = size
    for quality, kind in ((10, "mixed"), (75, "noise"), (100, "mixed")):
        img = _content(h, w, quality, kind)
        params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                  getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}"),
                  cv2.IMWRITE_JPEG_PROGRESSIVE, progressive]
        check(tmp_path, cv2.imencode(".jpg", img, params)[1].tobytes())


@pytest.mark.parametrize("restart,optimize,progressive",
                         list(itertools.product([1, 3, 7], [0, 1], [0, 1])))
def test_cv2_restart_intervals_and_optimized_tables(tmp_path, restart, optimize, progressive):
    for size, sampling in (((17, 33), "420"), ((40, 24), "422"), ((9, 70), "444")):
        img = _content(*size, seed=restart)
        params = [cv2.IMWRITE_JPEG_RST_INTERVAL, restart, cv2.IMWRITE_JPEG_OPTIMIZE, optimize,
                  cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                  getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
        check(tmp_path, cv2.imencode(".jpg", img, params)[1].tobytes())


@pytest.mark.parametrize("quality", [30, 95])
def test_cv2_grey_and_a_large_odd_size(tmp_path, quality):
    img = _content(255, 257, quality)
    check(tmp_path, cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes())
    grey = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    for progressive in (0, 1):
        check(tmp_path, cv2.imencode(".jpg", grey, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                                    cv2.IMWRITE_JPEG_PROGRESSIVE,
                                                    progressive])[1].tobytes())


@pytest.mark.parametrize("mode", ["CMYK", "RGB", "L"])
@pytest.mark.parametrize("options", [{}, {"subsampling": 0}, {"subsampling": 2},
                                     {"progressive": True}])
def test_pil_cmyk_rgb_grey(tmp_path, mode, options):
    img = Image.fromarray(_content(37, 29, 1)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=90, **options)
    check(tmp_path, buf.getvalue())


# (luma, chroma) sampling factors; libjpeg takes at most 10 blocks an MCU
FACTORS = [((1, 1), (1, 1)), ((2, 1), (1, 1)), ((1, 2), (1, 1)), ((2, 2), (1, 1)),
           ((3, 1), (1, 1)), ((4, 1), (1, 1)), ((1, 4), (1, 1)), ((3, 2), (1, 1)),
           ((4, 2), (1, 1)), ((2, 2), (1, 2)), ((2, 2), (2, 1)), ((1, 1), (2, 2)),
           ((4, 1), (2, 1)), ((2, 4), (1, 1)), ((2, 3), (1, 1))]


@pytest.mark.parametrize("luma,chroma", FACTORS)
def test_hand_encoded_sampling_factors(tmp_path, luma, chroma):
    for h, w in ((1, 1), (7, 9), (17, 33), (40, 37)):
        rng = np.random.RandomState(h * w)
        planes = [rng.randint(0, 256, (h, w)).astype(np.uint8) for _ in range(3)]
        check(tmp_path, encode_jpeg(planes, [luma, chroma, chroma]))
        check(tmp_path, encode_jpeg(planes, [luma, chroma, chroma], restart=2))


@pytest.mark.parametrize("luma", [(1, 1), (2, 2), (4, 1), (4, 4), (3, 2)])
def test_hand_encoded_grey_at_any_factor(tmp_path, luma):
    plane = np.random.RandomState(3).randint(0, 256, (23, 19)).astype(np.uint8)
    check(tmp_path, encode_jpeg([plane], [luma]))


@pytest.mark.parametrize("options", [
    {"adobe": 0}, {"adobe": 1}, {"adobe": 2}, {"ids": [82, 71, 66]}, {"ids": [7, 8, 9]},
    {"jfif": True, "adobe": 0}, {"jfif": True, "ids": [82, 71, 66]}])
def test_hand_encoded_colour_spaces(tmp_path, options):
    """Adobe transform 0 or ids R, G, B are RGB; JFIF wins over both."""
    rng = np.random.RandomState(4)
    planes = [rng.randint(0, 256, (20, 30)).astype(np.uint8) for _ in range(3)]
    check(tmp_path, encode_jpeg(planes, [(2, 2), (1, 1), (1, 1)], **options))


@pytest.mark.parametrize("adobe", [None, 0, 1, 2])
def test_hand_encoded_cmyk_and_ycck(tmp_path, adobe):
    rng = np.random.RandomState(5)
    planes = [rng.randint(0, 256, (21, 26)).astype(np.uint8) for _ in range(4)]
    factors = [(2, 2), (1, 1), (1, 1), (2, 2)]
    check(tmp_path, encode_jpeg(planes, factors, adobe=adobe))


def test_more_than_ten_blocks_in_an_mcu_reads_as_none(tmp_path):
    """libjpeg refuses an MCU of more than 10 blocks; so does the port."""
    planes = [np.zeros((9, 9), np.uint8)] * 3
    path = tmp_path / "x.jpg"
    path.write_bytes(encode_jpeg(planes, [(2, 2), (2, 2), (2, 2)]))
    assert cv2.imread(str(path)) is None and imread(str(path)) is None


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2**16),
       quality=st.integers(1, 100), sampling=st.sampled_from(SAMPLING),
       progressive=st.booleans(), restart=st.integers(0, 4))
def test_hypothesis_sizes_and_contents(tmp_path, h, w, seed, quality, sampling, progressive,
                                       restart):
    img = _content(h, w, seed, "noise" if seed % 2 else "mixed")
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}"),
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive), cv2.IMWRITE_JPEG_RST_INTERVAL,
              restart]
    check(tmp_path, cv2.imencode(".jpg", img, params)[1].tobytes())


@pytest.mark.parametrize("restart", [0, 2])
def test_truncated_sequential_file_reads_as_cv2(tmp_path, restart):
    """libjpeg warns and fills: zero bits to the end of the MCU where the
    data ends, the rest of the scan grey (all-zero blocks)."""
    img = _content(40, 56, 9, "noise")
    data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, restart])[1].tobytes()
    for cut in (len(data) - 2, len(data) - 100, len(data) // 2, len(data) // 3, 700):
        path = tmp_path / f"cut{cut}.jpg"
        path.write_bytes(data[:cut])
        want = cv2_rgb(path)
        np.testing.assert_array_equal(imread(str(path)), want, err_msg=str(cut))
    for cut in (300, 100, 20, 3):  # headers cut: None, as cv2
        path = tmp_path / f"head{cut}.jpg"
        path.write_bytes(data[:cut])
        assert cv2.imread(str(path)) is None and imread(str(path)) is None


def test_truncated_progressive_file_raises_where_libjpeg_smooths(tmp_path):
    """By design: a progressive file that ends before its low AC
    coefficients are refined is block-smoothed by libjpeg; the port does
    not smooth, and raises ``UnsupportedFormat`` instead of differing."""
    img = _content(40, 56, 9, "noise")
    data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[: len(data) // 2])
    assert cv2.imread(str(path)) is not None
    with pytest.raises(UnsupportedFormat, match="block"):
        imread(str(path))
    path.write_bytes(data[:-2])  # only the EOI is missing: every scan is whole
    np.testing.assert_array_equal(imread(str(path)), cv2_rgb(path))


@pytest.mark.parametrize("marker,name", [
    (0xC3, "lossless"), (0xC5, "hierarchical"), (0xC9, "arithmetic"), (0xCA, "arithmetic"),
    (0xCB, "arithmetic"), (0xCD, "arithmetic")])
def test_unported_frames_raise_naming_them(marker, name):
    data = bytearray(cv2.imencode(".jpg", _content(8, 8, 0))[1].tobytes())
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = marker
    with pytest.raises(UnsupportedFormat, match=name):
        decode_jpeg(bytes(data))


def test_twelve_bit_and_dnl_frames_raise_naming_them():
    data = bytearray(cv2.imencode(".jpg", _content(8, 8, 0))[1].tobytes())
    sof = data.index(b"\xff\xc0")
    twelve = bytearray(data)
    twelve[sof + 4] = 12
    with pytest.raises(UnsupportedFormat, match="12-bit"):
        decode_jpeg(bytes(twelve))
    dnl = bytearray(data)
    dnl[sof + 5 : sof + 7] = b"\x00\x00"
    with pytest.raises(UnsupportedFormat, match="DNL"):
        decode_jpeg(bytes(dnl))
