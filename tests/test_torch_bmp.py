"""The port's BMP reader (``data/bmp.py``) against ``cv2.imread``, exactly.

Files come from ``cv2.imwrite``, PIL and the hand encoder of
``torch_image_writers`` (every header size, 1/4/8-bit palettes, short
palettes, 16-bit 555 and 565, 32-bit with and without bit fields, RLE8 and
RLE4 streams with end of line, end of bitmap and deltas, top-down rows).
The reference is ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``;
the port must equal it with no tolerance, and read as None where it does.
Behaviours found by test: a 32-bit ``BI_BITFIELDS`` file with a header of
56 bytes or more goes through its masks (scaled as ``v * 255 // max``);
pixels that an escape skips take palette entry 0; an RLE run that crosses
its line makes the file unreadable; OpenCV 5's RLE4 end of bitmap ends
only the line, and its delta moves right only.
"""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_image_writers import encode_bmp, rle4, rle8

from molnextr_tpu_torch.data.bmp import decode_bmp
from molnextr_tpu_torch.data.image import imread

SIZES = [(1, 1), (3, 5), (7, 9), (17, 33)]


def cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def check(tmp_path, data, name="x.bmp"):
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
        np.testing.assert_array_equal(decode_bmp(data), want)
    return want


@pytest.mark.parametrize("size", SIZES)
def test_cv2_and_pil_writes(tmp_path, size):
    rng = np.random.RandomState(size[1])
    h, w = size
    for img in (rng.randint(0, 256, (h, w)).astype(np.uint8),
                rng.randint(0, 256, (h, w, 3)).astype(np.uint8)):
        assert check(tmp_path, cv2.imencode(".bmp", img)[1].tobytes()) is not None
    rgba = Image.fromarray(rng.randint(0, 256, (h, w, 4)).astype(np.uint8), "RGBA")
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        buf = io.BytesIO()
        rgba.convert(mode).save(buf, "BMP")
        assert check(tmp_path, buf.getvalue()) is not None


@pytest.mark.parametrize("bpp", [1, 4, 8])
@pytest.mark.parametrize("header", [12, 40, 108, 124])
def test_palette_depths_under_every_header(tmp_path, bpp, header):
    rng = np.random.RandomState(bpp * header)
    for h, w in SIZES:
        for top_down in ((False,) if header == 12 else (False, True)):
            pal = rng.randint(0, 256, (1 << bpp, 3))
            idx = rng.randint(0, 1 << bpp, (h, w))
            want = check(tmp_path, encode_bmp(idx, bpp, pal, header=header, top_down=top_down))
            np.testing.assert_array_equal(want, pal[idx])


@pytest.mark.parametrize("bpp", [4, 8])
def test_short_palettes_leave_later_entries_black(tmp_path, bpp):
    rng = np.random.RandomState(bpp)
    pal = rng.randint(1, 256, (3, 3))
    idx = rng.randint(0, 1 << bpp, (9, 11))
    want = check(tmp_path, encode_bmp(idx, bpp, pal, used=3))
    assert (want[idx >= 3] == 0).all()


@pytest.mark.parametrize("form", ["555", "555 bit fields", "565 bit fields", "565 in a v4 header",
                                  "444 bit fields"])
def test_16_bit(tmp_path, form):
    rng = np.random.RandomState(len(form))
    masks = {"555 bit fields": (0x7C00, 0x3E0, 0x1F), "565 bit fields": (0xF800, 0x7E0, 0x1F),
             "565 in a v4 header": (0xF800, 0x7E0, 0x1F), "444 bit fields": (0xF00, 0xF0, 0xF)}
    for h, w in SIZES:
        for top_down in (False, True):
            v = rng.randint(0, 65536, (h, w))
            data = encode_bmp(v, 16, compression=0 if form == "555" else 3, masks=masks.get(form),
                              header=108 if "v4" in form else 40, top_down=top_down,
                              masks_after="v4" not in form)
            want = check(tmp_path, data)
            assert (want is None) == (form in ("444 bit fields", "565 in a v4 header"))


@pytest.mark.parametrize("masks", [None, (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                                   (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                                   (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000),
                                   (0xF0, 0xF000, 0xF00000, 0), (0, 0xFF00, 0xFF, 0)])
@pytest.mark.parametrize("header", [40, 56, 108, 124])
def test_32_bit_with_and_without_bit_fields(tmp_path, masks, header):
    rng = np.random.RandomState(header)
    for h, w in SIZES:
        bgra = rng.randint(0, 256, (h, w, 4))
        data = encode_bmp(bgra, 32, header=header, compression=0 if masks is None else 3,
                          masks=masks, masks_after=header == 40)
        want = check(tmp_path, data)
        if masks is None or header == 40 or not all(masks[:3]):
            np.testing.assert_array_equal(want, bgra[..., 2::-1])  # alpha dropped


def test_32_bit_masks_swap_channels_under_a_v5_header(tmp_path):
    bgra = np.array([[[0x11, 0x22, 0x33, 0x44]]])
    data = encode_bmp(bgra, 32, header=124, compression=3,
                      masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000), masks_after=False)
    np.testing.assert_array_equal(check(tmp_path, data), [[[0x11, 0x22, 0x33]]])


@pytest.mark.parametrize("four", [False, True])
@pytest.mark.parametrize("size", SIZES + [(40, 300)])
def test_rle_of_pictures(tmp_path, four, size):
    rng = np.random.RandomState(size[1])
    h, w = size
    pal = rng.randint(0, 256, (16 if four else 256, 3))
    idx = rng.randint(0, 4, (h, w)) * rng.randint(0, 2, (h, w))
    idx[:, : w // 2] = 2
    for top_down in (False, True):
        raw = (rle4 if four else rle8)(idx, top_down=top_down)
        data = encode_bmp(idx, 4 if four else 8, pal, compression=2 if four else 1, raw=raw,
                          top_down=top_down)
        np.testing.assert_array_equal(check(tmp_path, data), pal[idx])


def _random_rle(rng, four, h, w):
    """A stream of runs that fit their line, absolute runs, ends of line,
    deltas and ends of bitmap."""
    ops, x = b"", 0
    for _ in range(rng.randint(1, 40)):
        k, room = rng.rand(), w - x
        if k < 0.4 and room > 0:
            n = rng.randint(1, room + 1)
            ops += bytes([n, rng.randint(0, 256)])
            x += n
            if x >= w and not four:
                x = 0
        elif k < 0.6 and room >= 3:
            c = rng.randint(3, room + 1)
            data = bytes(rng.randint(0, 256, (c + 1) // 2 if four else c).tolist())
            pad = (((c + 1) >> 1) + 1) & ~1 if four else (c + 1) & ~1
            ops += bytes([0, c]) + data.ljust(pad, b"\x00")
            x += c
        elif k < 0.85:
            ops, x = ops + b"\x00\x00", 0
        elif k < 0.97:
            dx = rng.randint(0, w + 1)
            ops += bytes([0, 2, dx, rng.randint(0, 3)])
            x = (x + dx) % w
        else:
            ops, x = ops + b"\x00\x01", 0
    return ops + (b"\x00\x01" if rng.rand() < 0.5 else b"")


@pytest.mark.parametrize("four", [False, True])
def test_random_rle_streams(tmp_path, four):
    """Escapes fill with entry 0 and wrap; a run past its line, or a stream
    that ends before the bitmap does, reads as None; RLE4's end of bitmap
    and delta stay on their line."""
    rng = np.random.RandomState(7 + four)
    read = 0
    for _ in range(300):
        h, w = rng.randint(1, 9), rng.randint(1, 13)
        pal = rng.randint(0, 256, (rng.randint(1, 17 if four else 40), 3))
        data = encode_bmp(np.zeros((h, w), np.int64), 4 if four else 8, pal,
                          compression=2 if four else 1, raw=_random_rle(rng, four, h, w),
                          top_down=rng.rand() < 0.3)
        read += check(tmp_path, data) is not None
    assert read > 150


def test_rle_escapes_pinned(tmp_path):
    pal = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    h, w = 6, 4
    row, row4 = bytes([w, 1, 0, 0]), bytes([w, 0x11, 0, 0])
    # RLE8: an end of bitmap on row 2 fills the rest with entry 0
    got = check(tmp_path, encode_bmp(np.zeros((h, w)), 8, pal, compression=1,
                                     raw=row * 2 + b"\x00\x01", top_down=True))
    np.testing.assert_array_equal(got[:, :, 2], [[6] * 4] * 2 + [[3] * 4] * 4)
    # RLE4: the same end of bitmap ends only its line; the stream must go on
    assert check(tmp_path, encode_bmp(np.zeros((h, w)), 4, pal, compression=2,
                                      raw=row4 * 2 + b"\x00\x01", top_down=True)) is None
    got = check(tmp_path, encode_bmp(np.zeros((h, w)), 4, pal, compression=2,
                                     raw=row4 * 2 + b"\x00\x01" + b"\x00\x00" * 3, top_down=True))
    np.testing.assert_array_equal(got[:, :, 2], [[6] * 4] * 2 + [[3] * 4] * 4)
    # a run past the end of its line: unreadable
    assert check(tmp_path, encode_bmp(np.zeros((h, w)), 8, pal, compression=1,
                                      raw=bytes([w + 1, 1]) + b"\x00\x01")) is None


def test_truncated_and_unsupported_files_read_as_none(tmp_path):
    rng = np.random.RandomState(3)
    full = encode_bmp(rng.randint(0, 256, (9, 11, 3)), 24)
    for cut in (2, 14, 30, 54, len(full) - 1):
        assert check(tmp_path, full[:cut]) is None
    pal = rng.randint(0, 256, (256, 3))
    idx = rng.randint(0, 256, (5, 6))
    assert check(tmp_path, encode_bmp(idx, 8, pal, compression=1, raw=rle8(idx))[:-5]) is None
    for comp in (4, 5, 6):  # BI_JPEG, BI_PNG, BI_ALPHABITFIELDS
        assert check(tmp_path, encode_bmp(idx, 8, pal, compression=comp)) is None
    odd_header = full[:14] + struct.pack("<I", 20) + full[18:]
    assert check(tmp_path, odd_header) is None
    assert check(tmp_path, encode_bmp(idx, 8, pal, used=300)) is None
