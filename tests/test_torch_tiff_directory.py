"""The TIFF reader's directory (``data/tiff.py::_directory``) against
``cv2.imread`` on corrupted directories.

A seeded survey writes 400 files from the 15 committed ``demo_0_*.tif`` forms,
each with one or two bytes of one IFD entry replaced (tag, type, count or
value), and requires every read to equal cv2's: the same array, or None
where cv2 gives None or raises ``cv2.error``; no exception may leave
``imread`` (a corrupted width makes the G4 form's strips decodable only
through libtiff's error recovery, which ``data/ccitt.py`` ports).  Named
cases pin each class the survey found:
``TIFFReadDirEntry*`` type and count failures of the tags libtiff lays the
image out by (None) and of the others (ignored), values past the end of
the file (ignored, where the reader used to raise), later duplicates of a
tag (ignored), strip arrays read up to their number, ``TIFFSetField`` refusals, sizes that no longer fit (a
corrupted width past OpenCV's limits, a TileLength of 0, a missing
ImageLength: None, where ``MemoryError`` and ``ZeroDivisionError`` used to
escape), a bad predictor, a predictor not undone after a failed strip, and
a G4 strip read through libtiff's error recovery.
"""

import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from molnextr_tpu_torch.data.image import imread

FORMS = Path(__file__).resolve().parents[1] / "molnextr_tpu_torch" / "fixtures" / "forms"
TIFFS = sorted(FORMS.glob("demo_0_*.tif"))


def cv2_rgb(path):
    try:
        img = cv2.imread(str(path))
    except cv2.error:
        return None
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def entries(data):
    """(tag, offset of the 12-byte entry) of a classic TIFF's first IFD."""
    order = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(order + "I", data, 4)
    (n,) = struct.unpack_from(order + "H", data, ifd)
    return order, [(struct.unpack_from(order + "H", data, ifd + 2 + 12 * k)[0],
                    ifd + 2 + 12 * k) for k in range(n)]


def same_as_cv2(path):
    """imread equals cv2's read; returns whether cv2 read the file."""
    want = cv2_rgb(path)
    got = imread(str(path))
    if want is None:
        assert got is None, path
    else:
        assert got is not None, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    return "none" if want is None else "read"


def test_seeded_directory_survey_reads_as_cv2(tmp_path):
    assert len(TIFFS) == 15
    rng = np.random.RandomState(0)
    blobs = [p.read_bytes() for p in TIFFS]
    outcome = {"none": 0, "read": 0}
    for i in range(400):
        j = rng.randint(len(TIFFS))
        data = bytearray(blobs[j])
        _, ents = entries(data)
        at = ents[rng.randint(len(ents))][1]
        for _ in range(rng.randint(1, 3)):
            data[at + rng.randint(12)] = rng.randint(256)
        path = tmp_path / f"{i}.tif"
        path.write_bytes(bytes(data))
        outcome[same_as_cv2(path)] += 1
    assert outcome["none"] > 200 and outcome["read"] > 30, outcome


def _edit(data, tag, typ=None, count=None, value=None, new_tag=None):
    data = bytearray(data)
    order, ents = entries(data)
    at = dict(ents)[tag]
    if new_tag is not None:
        struct.pack_into(order + "H", data, at, new_tag)
    if typ is not None:
        struct.pack_into(order + "H", data, at + 2, typ)
    if count is not None:
        struct.pack_into(order + "I", data, at + 4, count)
    if value is not None:
        struct.pack_into(order + "I", data, at + 8, value)
    return bytes(data)


# (form, edit, what cv2 gives) for each class the survey found
CASES = {
    "BitsPerSample of type ASCII: the directory fails": (
        "demo_0_logl.tif", dict(tag=258, typ=2), None),
    "Compression of type FLOAT: the directory fails": (
        "demo_0_tiled.tif", dict(tag=259, typ=11), None),
    "SamplesPerPixel of type UNDEFINED: the directory fails": (
        "demo_0_signed16.tif", dict(tag=277, typ=7), None),
    "RowsPerStrip of count 2: the directory fails": (
        "demo_0_packbits.tif", dict(tag=278, count=2), None),
    "RowsPerStrip 0: TIFFSetField refuses it": (
        "demo_0_packbits.tif", dict(tag=278, value=0), None),
    "PlanarConfiguration 3: TIFFSetField refuses it": (
        "demo_0_g4.tif", dict(tag=284, value=3), None),
    "StripByteCounts of a larger count: read up to the strips": (
        "demo_0_jpeg_ycc420.tif", dict(tag=279, count=0xE8), "read"),
    "a tag whose values lie past the end: ignored": (
        "demo_0_packbits.tif", dict(tag=339, new_tag=343, count=0x10000), "read"),
    "YCbCrSubsampling of count 6: ignored": (
        "demo_0_ycbcr11.tif", dict(tag=530, count=6), "read"),
    "ImageWidth past 2^20: None before allocating": (
        "demo_0_lab.tif", dict(tag=256, value=0x13000080), None),
    "TileLength 0: no tiles": (
        "demo_0_tiled.tif", dict(tag=323, value=0), None),
    "ImageLength missing: zero strip size": (
        "demo_0_lab.tif", dict(tag=257, new_tag=0xB9), None),
    "Predictor 3 on integer samples: PredictorSetup fails": (
        "demo_0_lzw_pred2.tif", dict(tag=317, value=3), None),
    "a wider Deflate strip fails: its predictor is not undone": (
        "demo_0_deflate.tif", dict(tag=256, value=53632), "read"),
    "RowsPerStrip dropped: one bogus strip estimated": (
        "demo_0_16bit.tif", dict(tag=278, value=0x6FD90A), "read"),
    "Compression dropped on tiles: counts estimated, past the file": (
        "demo_0_tiled.tif", dict(tag=259, new_tag=0xD1), None),
    "a later duplicate of BitsPerSample, of a huge count: ignored": (
        "demo_0_16bit.tif", dict(tag=284, new_tag=258, count=1795162113), "read"),
    "a wider G4 image: bad codes and lengths repaired as libtiff repairs them": (
        "demo_0_g4.tif", dict(tag=256, value=12672), "read"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_named_directory_faults(tmp_path, name):
    form, edit, expect = CASES[name]
    path = tmp_path / "x.tif"
    path.write_bytes(_edit((FORMS / form).read_bytes(), **edit))
    assert same_as_cv2(path) == ("none" if expect is None else expect)
