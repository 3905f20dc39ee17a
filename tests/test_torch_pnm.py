"""The port's PNM, PAM and PFM reader (``data/pnm.py``) against
``cv2.imread``, exactly.

Files come from ``cv2.imwrite`` (PBM, PGM, PPM in ASCII and binary at 8 and
16 bits, PAM of every tuple type OpenCV writes, PFM) and by hand (comments,
maxvals, CR line ends, ASCII quirks, PAM headers, PFM scales and byte
orders, truncations).  Behaviours found by test: binary 8-bit samples are
taken as stored whatever the maxval, ASCII ones scaled ``v * 255 // maxval``;
16-bit samples read as ``v >> 8`` (256 -> 1, 40000 -> 156); a PAM's RGB
samples are taken as B, G, R; a PFM's floats are divided by the scale's
magnitude and rounded half to even (0.5 -> 0, 1.5 -> 2, 2.7 -> 3).
Differences by design have tests of their own: OpenCV 5 returns None for a
grey ``Pf`` PFM and leaves most of an alpha PAM's row uninitialised.
"""

import struct

import cv2
import numpy as np
import pytest

from molnextr_tpu_torch.data.image import imread
from molnextr_tpu_torch.data.pnm import decode_pnm

SIZES = [(1, 1), (3, 5), (7, 9), (17, 33)]


def cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def check(tmp_path, data, name="x.pnm"):
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
        np.testing.assert_array_equal(decode_pnm(data), want)
    return want


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("binary", [0, 1])
def test_cv2_pnm_writes(tmp_path, size, binary):
    rng = np.random.RandomState(size[1] + binary)
    h, w = size
    grey, colour = rng.randint(0, 256, (h, w)), rng.randint(0, 256, (h, w, 3))
    for ext, img in ((".pbm", grey), (".pgm", grey), (".ppm", colour), (".pnm", colour),
                     (".pnm", grey)):
        for dtype in (np.uint8, np.uint16):
            if ext == ".pbm" and dtype == np.uint16:
                continue
            data = img.astype(dtype) * (257 if dtype == np.uint16 else 1)
            ok, buf = cv2.imencode(ext, data, [cv2.IMWRITE_PXM_BINARY, binary])
            assert ok and check(tmp_path, buf.tobytes(), "x" + ext) is not None


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("tupltype", [1, 2, 4])  # BLACKANDWHITE, GRAYSCALE, RGB
def test_cv2_pam_writes(tmp_path, size, tupltype):
    rng = np.random.RandomState(size[0] * tupltype)
    h, w = size
    shape = (h, w, 3) if tupltype == 4 else (h, w)
    for dtype, top in ((np.uint8, 256), (np.uint16, 65536)):
        img = rng.randint(0, top, shape).astype(dtype)
        buf = cv2.imencode(".pam", img, [cv2.IMWRITE_PAM_TUPLETYPE, tupltype])[1]
        want = check(tmp_path, buf.tobytes(), "x.pam")
        scaled = (img >> 8 if dtype == np.uint16 else img).astype(np.uint8)
        np.testing.assert_array_equal(want, scaled[..., ::-1] if tupltype == 4 else
                                      np.repeat(scaled[..., None], 3, axis=2))


@pytest.mark.parametrize("size", SIZES)
def test_cv2_pfm_writes(tmp_path, size):
    rng = np.random.RandomState(size[1])
    f = (rng.rand(*size, 3) * 300 - 20).astype(np.float32)
    f[0, 0] = [0.5, 1.5, 2.5]
    check(tmp_path, cv2.imencode(".pfm", f)[1].tobytes(), "x.pfm")


HAND = {
    "P2 maxval 100": b"P2\n# c\n3 1\n100\n0 50 100\n",
    "P2 above maxval": b"P2\n3 1\n100\n0 150 100\n",
    "P5 maxval 100 as stored": b"P5\n3 1\n100\n" + bytes([0, 50, 200]),
    "P2 16-bit": b"P2\n4 1\n1000\n0 256 999 40000\n",
    "P5 16-bit": b"P5\n4 1\n65535\n" + struct.pack(">4H", 256, 40000, 255, 384),
    "P5 16-bit maxval 1000": b"P5\n4 1\n1000\n" + struct.pack(">4H", 256, 40000, 255, 999),
    "P2 no final newline": b"P2\n3 1\n255\n1 2 3",
    "P2 comments between samples": b"P2\n3 1\n255\n1 # x\n 2 #y\n3\n",
    "P1 digits run together": b"P1\n4 2\n0101\n1100",
    "P1 spaced": b"P1\n4 2\n0 1 0 1\n1 1 0 0\n",
    "P1 comment": b"P1\n# hi\n4 1\n0 1 # c\n 0 1\n",
    "P4": b"P4\n10 2\n" + bytes([0b10101010, 0b11000000, 0xFF, 0x00]),
    "P4 cut": b"P4\n10 2\n" + bytes([0b10101010, 0b11000000, 0xFF]),
    "P5 cut": b"P5\n3 2\n255\n" + bytes(5),
    "P6 comments in the header": b"P6 # c\n2 # w\n1 255\n" + bytes(range(6)),
    "P6 CR line ends": b"P6\r2 1\r255\r" + bytes(range(6)),
    "P6 maxval 0": b"P6\n2 1\n0\n" + bytes(range(6)),
    "P6 maxval 70000": b"P6\n1 1\n70000\n" + bytes(6),
    "P3": b"P3\n2 1\n15\n1 2 3 4 5 15\n",
    "P3 extra samples": b"P3\n2 1\n15\n1 2 3 4 5 15 7 7\n",
    "P5 width 0": b"P5\n0 1\n255\n",
    "P5 a letter in the header": b"P5\n2 x 1\n255\n\x00\x00",
    "P2 a minus sign": b"P2\n2 1\n255\n-1 2\n",
    "P6 a second whitespace byte is data": b"P6\n1 1\n255\n\n\x01\x02\x03",
    "PAM BLACKANDWHITE at maxval 1 (bits of a row of WIDTH bytes)":
        b"P7\nWIDTH 10\nHEIGHT 2\nDEPTH 1\nMAXVAL 1\nTUPLTYPE BLACKANDWHITE\nENDHDR\n"
        + bytes([0xFF, 0x40] + [0] * 8 + [0x81, 0xC0] + [0] * 8),
    "PAM maxval 1 one byte short": b"P7\nWIDTH 10\nHEIGHT 2\nDEPTH 1\nMAXVAL 1\nENDHDR\n"
                                   + bytes(19),
    "PAM comment line": b"P7\n#c\nWIDTH 2\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB\nENDHDR\n"
                        + bytes(range(6)),
    "PAM comment after a value": b"P7\nWIDTH 2 #x\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\nENDHDR\n"
                                 + bytes(range(6)),
    "PAM fields in another order": b"P7\nHEIGHT 1\nWIDTH 2\nMAXVAL 255\nDEPTH 3\nENDHDR\n"
                                   + bytes(range(6)),
    "PAM CRLF": b"P7\r\nWIDTH 2\r\nHEIGHT 1\r\nDEPTH 3\r\nMAXVAL 255\r\nTUPLTYPE RGB\r\nENDHDR\r\n"
                + bytes(range(6)),
    "PAM maxval 100 as stored": b"P7\nWIDTH 3\nHEIGHT 1\nDEPTH 1\nMAXVAL 100\nENDHDR\n"
                                + bytes([0, 50, 200]),
    "PAM 16-bit grey": b"P7\nWIDTH 3\nHEIGHT 1\nDEPTH 1\nMAXVAL 300\nTUPLTYPE GRAYSCALE\nENDHDR\n"
                       + bytes([0, 0, 1, 0, 255, 255]),
    "PAM cut": b"P7\nWIDTH 3\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n" + bytes(2),
    "PAM DEPTH 2 with no TUPLTYPE": b"P7\nWIDTH 3\nHEIGHT 1\nDEPTH 2\nMAXVAL 255\nENDHDR\n"
                                    + bytes(6),
    "PAM unknown TUPLTYPE": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\nTUPLTYPE FOO\nENDHDR\n"
                            + bytes(6),
    "PAM TUPLTYPE against DEPTH": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\n"
                                  b"TUPLTYPE GRAYSCALE\nENDHDR\n" + bytes(6),
    "PAM lowercase key": b"P7\nwidth 2\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\nENDHDR\n" + bytes(6),
    "PAM no MAXVAL": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 3\nENDHDR\n" + bytes(6),
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_hand_written_files(tmp_path, name):
    check(tmp_path, HAND[name], "x.pam" if HAND[name].startswith(b"P7") else "x.pnm")


def test_16_bit_reads_as_the_high_byte(tmp_path):
    want = check(tmp_path, HAND["P5 16-bit"])
    assert want[0, :, 0].tolist() == [1, 156, 0, 1]


@pytest.mark.parametrize("scale", [1.0, -1.0, 2.5, -0.3, 0.7, 1 / 255])
def test_pfm_scales_and_byte_orders(tmp_path, scale):
    rng = np.random.RandomState(int(abs(scale) * 100))
    vals = (rng.rand(3, 5, 3) * 600 - 10).astype(np.float32)
    vals[0, 0] = [0.5, 1.5, 2.7]
    vals[1, 1] = [np.nan, np.inf, -np.inf]
    vals[2, 2] = [3e9, -3e9, 255.5]
    data = (b"PF\n5 3\n" + repr(scale).encode() + b"\n"
            + vals.astype("<f4" if scale < 0 else ">f4").tobytes())
    want = check(tmp_path, data, "x.pfm")
    if abs(scale) == 1.0:
        assert want[-1, 0].tolist() == [0, 2, 3] and want[1, 1].tolist() == [0, 0, 0]


def test_grey_pfm_reads_where_opencv_5_fails(tmp_path):
    """By design: OpenCV 5 returns None for a ``Pf`` file under
    ``IMREAD_COLOR`` (``'original_ptr == real_mat.data'``); the port reads
    it as the ``PF`` file of the same grey does."""
    g = np.array([[0.5, 1.5, 2.5], [127.5, 300, -4]], np.float32)
    path = tmp_path / "x.pfm"
    path.write_bytes(b"Pf\n3 2\n-1.0\n" + g.astype("<f4").tobytes())
    assert cv2.imread(str(path)) is None
    colour = check(tmp_path, b"PF\n3 2\n-1.0\n" + np.repeat(g[..., None], 3, 2).astype("<f4")
                   .tobytes(), "y.pfm")
    np.testing.assert_array_equal(imread(str(path)), colour)


@pytest.mark.parametrize("tupl,depth", [("GRAYSCALE_ALPHA", 2), ("RGB_ALPHA", 4)])
def test_alpha_pam_drops_alpha_where_opencv_5_leaves_rows_unfilled(tmp_path, tupl, depth):
    """By design: OpenCV 5 converts only part of each row of an alpha PAM
    and leaves the rest uninitialised; the port drops alpha from every pixel
    (the pixel OpenCV does fill agrees)."""
    rng = np.random.RandomState(depth)
    v = rng.randint(0, 256, (4, 9, depth)).astype(np.uint8)
    path = tmp_path / "x.pam"
    path.write_bytes(f"P7\nWIDTH 9\nHEIGHT 4\nDEPTH {depth}\nMAXVAL 255\nTUPLTYPE {tupl}\n"
                     "ENDHDR\n".encode() + v.tobytes())
    got = imread(str(path))
    want = v[..., :3] if depth == 4 else np.repeat(v[..., :1], 3, axis=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cv2_rgb(path)[0, 0], got[0, 0])
