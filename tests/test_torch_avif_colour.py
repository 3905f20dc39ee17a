"""The port's AVIF colour conversion (``data/avif.py::yuv_to_rgb``) on every
``matrix_coefficients`` an nclx ``colr`` box can name, against
``cv2.imread``, exactly.

libavif 1.4.2 hands BT.709, BT.601 (5, 6, 2) and BT.2020 (9) to libyuv,
and chroma-derived NCL (12) too where the primaries are one of those
(``test_torch_avif.py`` and ``test_torch_avif_depth.py`` hold the libyuv
path).  The rest go through its own float path
(``avifImageYUVAnyToRGBAnySlow``): FCC (4), SMPTE 240 (7), 15 (no table
entry: BT.601's coefficients), chroma-derived NCL on other primaries (Kr
and Kb from them), YCgCo (8) at full range and YCgCo-Re (16) at full range
and 10 bits; it refuses 3, 10, 11, 13, 14, 17 and up, YCgCo at limited
range and YCgCo-Re otherwise, so the read is None, and grey reads whatever
the matrix.  The nclx box of committed fixtures (8 and 10 bits, 4:4:4 and
4:2:0) and of seeded noise (Pillow's 4:4:4, 4:2:2 and 4:2:0, libaom's 10-
and 12-bit files, a grey file) is rewritten to each matrix (and primaries
for 12), at full and limited range; each read equals cv2's, or is None
where cv2's is.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image
from test_torch_avif import FORMS, cv2_rgb
from torch_image_writers import aom_avif, aom_encode

from molnextr_tpu_torch.data import avif
from molnextr_tpu_torch.data.image import imread

FIXTURES = ("demo_0_444_lossy.avif", "demo_0_q40_lossy.avif", "demo_0_10bit.avif",
            "demo_0_10bit_lossless.avif")
# (matrix, primaries): every matrix libavif's float path takes or refuses,
# chroma-derived NCL on primaries libyuv takes (1, 9) and others
MATRICES = [(3, 1), (4, 1), (7, 1), (8, 1), (10, 1), (11, 1), (12, 1), (12, 4), (12, 9), (12, 10),
            (12, 22), (13, 1), (14, 1), (15, 1), (16, 1), (17, 1), (255, 1)]


def _noise(name):
    rng = np.random.RandomState(len(name))
    if name.startswith("pillow"):
        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 256, (30, 41, 3)).astype(np.uint8)).save(
            buf, "AVIF", quality=70, subsampling=name.split()[1])
        return buf.getvalue()
    depth, sub = int(name.split()[1]), name.split()[2]
    sx, sy = {"4:2:0": (1, 1), "4:4:4": (0, 0), "4:0:0": (1, 1)}[sub]
    planes = [rng.randint(0, 1 << depth, (30, 41))]
    if sub != "4:0:0":
        planes += [rng.randint(0, 1 << depth, ((30 + sy) >> sy, (41 + sx) >> sx)) for _ in "uv"]
    return aom_avif(aom_encode(planes, depth, sub, q=20))


NOISE = ("pillow 4:4:4", "pillow 4:2:2", "pillow 4:2:0", "libaom 10 4:4:4", "libaom 10 4:2:0",
         "libaom 12 4:2:0", "libaom 8 4:0:0")


def renclx(data, matrix, primaries, full):
    d = bytearray(data)
    k = d.find(b"colrnclx") + 8
    struct.pack_into(">HHHB", d, k, primaries, 13 if primaries == 1 else 2, matrix,
                     0x80 if full else 0)
    return bytes(d)


def _compare(tmp_path, data, matrix, primaries):
    read = 0
    for full in (True, False):
        path = tmp_path / f"{int(full)}.avif"
        path.write_bytes(renclx(data, matrix, primaries, full))
        want = cv2_rgb(path)
        got = imread(str(path))
        if want is None:
            assert got is None, full
        else:
            read += 1
            np.testing.assert_array_equal(got, want, err_msg=str(full))
    return read


@pytest.mark.parametrize("matrix,primaries", MATRICES, ids=str)
@pytest.mark.parametrize("name", FIXTURES)
def test_committed_forms_in_every_matrix(tmp_path, name, matrix, primaries):
    _compare(tmp_path, (FORMS / name).read_bytes(), matrix, primaries)


@pytest.mark.parametrize("matrix,primaries", MATRICES, ids=str)
@pytest.mark.parametrize("name", NOISE)
def test_seeded_noise_in_every_matrix(tmp_path, name, matrix, primaries):
    _compare(tmp_path, _noise(name), matrix, primaries)


def test_each_path_is_taken(tmp_path):
    """cv2 reads the float path's matrices and refuses the others, so the
    survey holds both: FCC, SMPTE 240, YCgCo, 15, chroma-derived NCL and
    YCgCo-Re read; 3, 10, 11, 13, 14, 17 and YCgCo at limited range do
    not."""
    ten = _noise("libaom 10 4:2:0")
    for matrix, primaries in ((4, 1), (7, 1), (8, 1), (12, 10), (15, 1)):
        assert _compare(tmp_path, ten, matrix, primaries) >= 1
    assert _compare(tmp_path, ten, 16, 1) == 1  # full range only
    eight = _noise("pillow 4:2:0")
    assert _compare(tmp_path, eight, 16, 1) == 0  # YCgCo-Re wants 10 bits
    for matrix in (3, 10, 11, 13, 14, 17):
        assert _compare(tmp_path, ten, matrix, 1) == 0


def test_kr_kb_from_primaries_follow_h273():
    """Chroma-derived NCL: Kr and Kb from BT.709's primaries are BT.709's
    table values within float32 rounding, BT.2020's likewise."""
    for primaries, matrix in ((1, 1), (9, 9)):
        kr, kb = avif._kr_kb(12, primaries)
        want = avif._kr_kb(matrix, 2)
        assert abs(float(kr) - float(want[0])) < 2e-4 and abs(float(kb) - float(want[1])) < 2e-4
