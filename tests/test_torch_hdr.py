"""The port's Radiance HDR reader (``data/hdr.py``) against ``cv2.imread``,
exactly.

Files come from ``cv2.imwrite`` (run-length and flat, from float and uint8
images, widths below 8 and above) and by hand (``#?RGBE``, header lines,
a FORMAT line away from the blank line, ``32-bit_rle_xyze``, resolution
lines of every orientation, flat and old-style-run pixels, scanlines that
switch to flat, bad scanline widths and counts, truncations).  Behaviours
found by test: only ``-Y h +X w`` is read; an old-style run ``1 1 1 n`` is
a flat pixel; values convert as ``v * 255`` rounded half to even and
saturated (0.5 -> 128, 1.5 -> 255), and past int32 to 0.
"""

import cv2
import numpy as np
import pytest

from molnextr_tpu_torch.data.hdr import decode_hdr
from molnextr_tpu_torch.data.image import imread

SIZES = [(1, 1), (3, 5), (4, 8), (7, 9), (17, 33), (2, 300)]
HEAD = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n"


def cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def check(tmp_path, data, name="x.hdr"):
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
        np.testing.assert_array_equal(decode_hdr(data), want)
    return want


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("compression", [cv2.IMWRITE_HDR_COMPRESSION_RLE,
                                         cv2.IMWRITE_HDR_COMPRESSION_NONE])
def test_cv2_writes(tmp_path, size, compression):
    rng = np.random.RandomState(size[1])
    for scale in (1.0, 0.004, 3.0):
        f = (rng.rand(*size, 3) * scale).astype(np.float32)
        f[0, 0] = [0.5, 1.5, 127.5 / 255]
        buf = cv2.imencode(".hdr", f, [cv2.IMWRITE_HDR_COMPRESSION, compression])[1]
        assert check(tmp_path, buf.tobytes()) is not None
    u8 = rng.randint(0, 256, size + (3,)).astype(np.uint8)
    assert check(tmp_path, cv2.imencode(".hdr", u8)[1].tobytes()) is not None


PIXELS = bytes([128, 64, 32, 129, 255, 255, 255, 128, 1, 2, 3, 200, 10, 20, 30, 0])


@pytest.mark.parametrize("head", [
    HEAD % (1, 4), b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 4\n",
    b"#?RADIANCE\n# made by\nGAMMA=2.2\nEXPOSURE=1.0\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 4\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nGAMMA=1\n\n-Y 1 +X 4\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 1 +X 4\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n-Y 1 +X 4\n",
    b"#?RADIANCE\n\n-Y 1 +X 4\n",
    HEAD.replace(b"-Y %d +X %d", b"+Y 1 +X 4"), HEAD.replace(b"-Y %d +X %d", b"-Y 1 -X 4"),
    HEAD.replace(b"-Y %d +X %d", b"+X 4 -Y 1"), HEAD.replace(b"-Y %d +X %d", b"-Y  1 +X 4"),
    HEAD.replace(b"-Y %d +X %d", b"-Y 1 +X 4x"), HEAD.replace(b"-Y %d +X %d", b"-Y 0 +X 4")])
def test_headers(tmp_path, head):
    check(tmp_path, head + PIXELS)


def test_rgbe_to_8_bits(tmp_path):
    want = check(tmp_path, HEAD % (1, 4) + PIXELS)
    assert want.tolist() == [[[255, 128, 64], [254, 254, 254], [0, 0, 0], [0, 0, 0]]]
    huge = check(tmp_path, HEAD % (1, 4) + bytes([255, 100, 1, 160, 255, 255, 255, 255,
                                                  200, 200, 200, 140, 1, 1, 1, 100]))
    assert huge[0, :, 0].tolist() == [0, 0, 255, 0]


def _rle_row(row):
    out = bytes([2, 2, len(row) >> 8, len(row) & 255])
    for ch in range(4):
        vals = row[:, ch]
        same = len(set(vals.tolist())) == 1
        out += bytes([128 + len(vals), vals[0]]) if same else bytes([len(vals)]) + vals.tobytes()
    return out


def test_scanlines(tmp_path):
    rng = np.random.RandomState(4)
    row = np.array([[100, 50, 25, 128]] * 10, np.uint8)
    row[:, 0] = rng.randint(0, 256, 10)
    flat = bytes([10, 20, 30, 129]) * 10
    cases = {
        "run-length": HEAD % (1, 10) + _rle_row(row),
        "run-length then flat": HEAD % (2, 10) + _rle_row(row) + flat,
        "flat then run-length-looking": HEAD % (2, 10) + flat + _rle_row(row).ljust(40, b"\x01"),
        "old-style runs read flat": HEAD % (1, 10) + bytes([100, 50, 25, 128, 1, 1, 1, 3])
                                    + bytes([10, 20, 30, 129]) * 8,
        "wrong scanline width": HEAD % (1, 10) + bytes([2, 2, 0, 9]) + _rle_row(row)[4:],
        "zero count": HEAD % (1, 10) + bytes([2, 2, 0, 10, 0, 5]) + _rle_row(row)[4:],
        "run past the scanline": HEAD % (1, 10) + bytes([2, 2, 0, 10, 140, 5]) + _rle_row(row)[6:],
        "cut": (HEAD % (1, 10) + _rle_row(row))[:-1],
        "flat cut": HEAD % (1, 4) + PIXELS[:-1],
        "flat with bytes after": HEAD % (1, 4) + PIXELS + b"zz",
    }
    read = {name: check(tmp_path, data) is not None for name, data in cases.items()}
    assert read == {name: name not in ("wrong scanline width", "zero count",
                                       "run past the scanline", "cut", "flat cut")
                    for name in cases}
