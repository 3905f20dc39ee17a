"""JPEG 2000 Part 2's ``CBD``, ``MCT``, ``MCC`` and ``MCO`` markers in the
port (``data/j2k.py``) against ``cv2.imread``, exactly.

OpenJPEG 2.5 inside cv2 parses all four (``opj_j2k_read_cbd/mct/mcc/mco``)
and its ``COD`` reader refuses the custom component transform (``mct`` 2)
that would apply a decorrelation matrix, so the matrices are read and
never applied; what the markers still change:

* ``CBD`` sets each component's precision and sign: signed reads as None
  ("Component is signed"), below 8 bits as None, above 8 bits takes
  OpenCV's deeper path (samples shifted down by the precision less 8); a
  body of the wrong length or component count, or a precision past 31,
  reads as None;
* ``MCO`` sets every level shift to 0 and then, when its stage names the
  first ``MCC`` collection of the tile (``opj_j2k_add_mct`` looks at no
  other), to the collection's offset array (int16 and int32 read unsigned,
  floats truncated); arrays of the wrong size read as None;
* ``MCT`` and ``MCC`` are validated as OpenJPEG validates them (lengths,
  ``Zmct``/``Ymct``, ``Zmcc``/``Ymcc``, collection kinds and counts,
  component order, the arrays they name); what OpenJPEG does not take in
  charge is ignored.

Files: the hand J2K writer of ``torch_image_writers`` with the segments of
``cbd_segment``, ``mct_segment``, ``mcc_segment``, ``mco_segment`` and
``part2_identity`` in the main header or tile-part headers, in a JP2 box
or raw, lossless and 9/7; OpenJPEG's own Part 2 encoder
(``openjpeg_part2``: Pillow's ``libopenjp2`` through ``ctypes``,
``opj_set_MCT``), whose ``mct`` 2 reads as None, and with its ``COD``
rewritten to 0 and 1; and seeded random segments.
"""

import cv2
import numpy as np
import pytest
from torch_image_writers import (cbd_segment, encode_j2k, encode_jp2, j2k_segment, mcc_segment,
                                 mco_segment, mct_segment, openjpeg_part2, part2_identity)

from molnextr_tpu_torch.data.image import imread


def cv2_rgb(path):
    try:
        img = cv2.imread(str(path))
    except cv2.error:
        return None
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def check(tmp_path, data, name="x.j2k"):
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


def picture(h=16, w=16, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.indices((h, w))
    base = (5 * yy + 3 * xx)[..., None] + rng.randint(0, 60, (h, w, 3))
    return np.clip(base, 0, 255).astype(np.uint8)


def planes(img):
    return [img[..., i] for i in range(img.shape[2])]


OFFSETS = [mct_segment(2, 2, 0, [100, 50, 200]), mcc_segment(1, 3, offset=2), mco_segment([1])]

# name -> (main header segments, what cv2 reads: "same" as the picture,
# "none", or "other")
MAIN = {
    "identity": (part2_identity(), "same"),
    "identity_int16": (part2_identity(element_type=0), "same"),
    "identity_int32": (part2_identity(element_type=1), "same"),
    "identity_float64": (part2_identity(element_type=3), "same"),
    "cbd_signed": ([cbd_segment([(8, True)] * 3)], "none"),
    "cbd_one_signed": ([cbd_segment([(8, False), (8, True), (8, False)])], "none"),
    "cbd_7_bits": ([cbd_segment([(7, False)] * 3)], "none"),
    "cbd_count": ([cbd_segment([(8, False)] * 3, count=2)], "none"),
    "cbd_short": ([cbd_segment([(8, False)] * 2, count=3)], "none"),
    "cbd_32_bits": ([cbd_segment([(32, False)] * 3)], "none"),
    "cbd_12_bits": ([cbd_segment([(12, False)] * 3)], "other"),
    "cbd_mixed": ([cbd_segment([(8, False), (12, False), (8, False)])], "other"),
    "mct_alone": ([mct_segment(1, 1, 2, np.eye(3).ravel())], "same"),
    "mct_dependency": ([mct_segment(1, 0, 0, [1, 2, 3])], "same"),
    "mct_short": ([mct_segment(1, 1, 2, body=b"")], "none"),
    "mct_tiny": ([j2k_segment(0xFF74, b"\x00")], "none"),
    "mct_zmct": ([mct_segment(1, 1, 2, body=b"", zmct=1)], "same"),
    "mct_ymct": ([mct_segment(1, 1, 2, [1.0], ymct=1)], "same"),
    "mct_twice": ([mct_segment(2, 2, 0, [1, 2]), mct_segment(2, 2, 0, [100, 50, 200]),
                   mcc_segment(1, 3, offset=2), mco_segment([1])], "other"),
    "mco_no_stage": ([mco_segment([])], "other"),
    "mco_two_stages": ([mco_segment([1, 2])], "same"),
    "mco_wrong_length": ([mco_segment([1], count=0)], "none"),
    "mco_empty": ([j2k_segment(0xFF77, b"")], "none"),
    "mco_unknown_collection": ([mco_segment([5])], "other"),
    "offsets_int16": (OFFSETS, "other"),
    "offsets_int16_unsigned": ([mct_segment(2, 2, 0, [-1, 128, 128]), mcc_segment(1, 3, offset=2),
                                mco_segment([1])], "other"),
    "offsets_int32_wrap": ([mct_segment(2, 2, 1, [2 ** 31 - 1, -5, 128]),
                            mcc_segment(1, 3, offset=2), mco_segment([1])], "other"),
    "offsets_float32": ([mct_segment(2, 2, 2, [127.9, -3.7, 1e12]), mcc_segment(1, 3, offset=2),
                         mco_segment([1])], "other"),
    "offsets_float64_nan": ([mct_segment(2, 2, 3, [np.nan, 128.5, -1e300]),
                             mcc_segment(1, 3, offset=2), mco_segment([1])], "other"),
    "offsets_wrong_size": ([mct_segment(2, 2, 0, [100, 50]), mcc_segment(1, 3, offset=2),
                            mco_segment([1])], "none"),
    "offsets_without_data": ([mct_segment(2, 2, 0, [1, 2, 3], ymct=1),
                              mcc_segment(1, 3, offset=2), mco_segment([1])], "none"),
    "matrix_wrong_size": ([mct_segment(1, 1, 2, [1.0] * 8), mcc_segment(1, 3, decorrelation=1),
                           mco_segment([1])], "none"),
    "matrix_int16": ([mct_segment(1, 1, 0, [3] * 9), mcc_segment(1, 3, decorrelation=1),
                      mco_segment([1])], "other"),
    "mcc_missing_array": ([mcc_segment(1, 3, decorrelation=4), mco_segment([1])], "none"),
    "mcc_missing_offsets": ([mcc_segment(1, 3, offset=4), mco_segment([1])], "none"),
    "mcc_second_record": ([mct_segment(2, 2, 0, [100, 50, 200]), mcc_segment(7, 3),
                           mcc_segment(1, 3, offset=2), mco_segment([1])], "other"),
    "mcc_replaced": ([mct_segment(2, 2, 0, [100, 50, 200]), mcc_segment(1, 3),
                      mcc_segment(1, 3, offset=2), mco_segment([1])], "other"),
    "mcc_two_components": ([mct_segment(2, 2, 0, [100, 50]), mcc_segment(1, 2, offset=2),
                            mco_segment([1])], "other"),
    "mcc_shuffled": ([mcc_segment(1, 3, order=[1, 0, 2]), mco_segment([1])], "other"),
    "mcc_kind": ([mcc_segment(1, 3, kind=2), mco_segment([1])], "other"),
    "mcc_no_collection": ([mcc_segment(1, 3, collections=0), mco_segment([1])], "other"),
    "mcc_two_collections": ([mcc_segment(1, 3, collections=2)], "same"),
    "mcc_trailing_byte": ([mcc_segment(1, 3, tail=b"\x00")], "none"),
    "mcc_short": ([j2k_segment(0xFF75, b"\x00\x00\x01")], "none"),
    "mcc_zmcc": ([mcc_segment(1, 3, zmcc=1), mco_segment([1])], "other"),
    "mcc_ymcc": ([mcc_segment(1, 3, ymcc=1), mco_segment([1])], "other"),
    "mcc_wide": ([mct_segment(2, 2, 0, [10, 20, 30]), mcc_segment(1, 3, offset=2, wide=True),
                  mco_segment([1])], "other"),
    "mcc_two_outputs": ([mcc_segment(1, 3, outputs=2), mco_segment([1])], "other"),
    "mcc_reversible": ([mct_segment(2, 2, 0, [128] * 3), mcc_segment(1, 3, offset=2,
                                                                      reversible=True),
                        mco_segment([1])], "same"),
}


@pytest.mark.parametrize("case", sorted(MAIN))
def test_main_header_segments(tmp_path, case):
    segments, expect = MAIN[case]
    img = picture(seed=len(case))
    want = check(tmp_path, encode_j2k(planes(img), main_markers=segments))
    if expect == "none":
        assert want is None
    else:
        assert want is not None and np.array_equal(want, img) == (expect == "same")


@pytest.mark.parametrize("case", ["identity", "offsets", "offsets_then_none", "cbd"])
def test_tile_part_header_segments(tmp_path, case):
    """``MCT``, ``MCC`` and ``MCO`` act on their tile (after the main
    header's, which every tile copies); ``CBD`` there is misplaced (None)."""
    img = picture(16, 16, 3)
    kw = {"identity": dict(tile_header=part2_identity()[1:]),
          "offsets": dict(tile_header=OFFSETS),
          "offsets_then_none": dict(main_markers=[mco_segment([])], tile_header=[
              mct_segment(2, 2, 0, [128] * 3), mcc_segment(1, 3, offset=2), mco_segment([1])]),
          "cbd": dict(tile_header=[cbd_segment([(8, False)] * 3)])}[case]
    want = check(tmp_path, encode_j2k(planes(img), tile=(8, 16), **kw))
    if case == "cbd":
        assert want is None
    elif case in ("identity", "offsets_then_none"):
        np.testing.assert_array_equal(want, img)


@pytest.mark.parametrize("prec", [8, 9, 10, 12, 15, 16, 17, 20, 24, 31])
@pytest.mark.parametrize("container", ["j2k", "jp2"])
def test_cbd_precisions(tmp_path, prec, container):
    """``CBD`` over 8-bit data: the clamp after the level shift and
    OpenCV's depth take the new precision (cv2 reads 16 bits and more
    through its deeper types, and ``imread``'s default flags bring them to
    8 bits)."""
    img = picture(12, 10, prec)
    code = encode_j2k(planes(img), main_markers=[cbd_segment([(prec, False)] * 3)])
    data = encode_jp2(code, 10, 12, 3) if container == "jp2" else code
    assert check(tmp_path, data, "x." + container) is not None


def test_wide_samples_under_a_cbd(tmp_path):
    """12-bit samples coded at 12 bits with a ``CBD`` of 8, 12 and 16."""
    img = picture(12, 10, 4)
    wide = [p.astype(np.uint16) * 16 + 7 for p in planes(img)]
    for prec in (8, 12, 16):
        check(tmp_path, encode_j2k(wide, prec=12,
                                   main_markers=[cbd_segment([(prec, False)] * 3)]))


@pytest.mark.parametrize("segments", ["identity", "cbd_12", "offsets"])
def test_irreversible_files(tmp_path, segments):
    img = picture(16, 16, 5)
    seg = {"identity": part2_identity(), "cbd_12": [cbd_segment([(12, False)] * 3)],
           "offsets": OFFSETS}[segments]
    check(tmp_path, encode_j2k(planes(img), reversible=False, qntsty=2, expn0=9, mant=300,
                               main_markers=seg))


def test_jp2_files(tmp_path):
    img = picture(16, 16, 6)
    for seg in (part2_identity(), OFFSETS, [cbd_segment([(8, True)] * 3)]):
        check(tmp_path, encode_jp2(encode_j2k(planes(img), main_markers=seg), 16, 16, 3),
              "x.jp2")


@pytest.mark.parametrize("jp2", [False, True])
@pytest.mark.parametrize("matrix", ["identity", "mix"])
def test_openjpeg_part2_files(tmp_path, matrix, jp2):
    """OpenJPEG's own Part 2 encoder writes ``CBD``, ``MCT`` (matrix and
    offsets, float32), ``MCC``, ``MCO`` and ``COD`` ``mct`` 2, which its
    decoder refuses: None.  With ``COD`` rewritten to no transform or the
    RCT the file reads, the markers as OpenJPEG wrote them."""
    img = picture(40, 36, 7)
    mat, shifts = {"identity": (np.eye(3), None),
                   "mix": (np.array([[0.5, 0.3, 0.2], [0.1, 0.8, 0.1], [0.3, 0.3, 0.4]]),
                           [100, -20, 3])}[matrix]
    data = openjpeg_part2(planes(img), mat, shifts, jp2=jp2)
    name = "x.jp2" if jp2 else "x.j2k"
    assert check(tmp_path, data, name) is None
    cod = data.index(b"\xff\x52") + 4
    assert data[cod + 4] == 2
    for mct in (0, 1):
        rewritten = bytearray(data)
        rewritten[cod + 4] = mct
        assert check(tmp_path, bytes(rewritten), name) is not None


def _random_segments(rng):
    """Part 2 segments of random fields: well-formed ones mixed with cut,
    padded and random bodies."""
    out = []
    for _ in range(rng.randint(1, 5)):
        kind = rng.randint(5)
        n = int(rng.choice([1, 2, 3, 3, 3, 4]))
        et = int(rng.randint(4))
        if kind == 0:
            out.append(cbd_segment([(int(rng.choice([1, 7, 8, 8, 9, 12, 16, 31, 32])),
                                     bool(rng.rand() < 0.2)) for _ in range(n)]))
        elif kind == 1:
            values = rng.randint(-300, 300, n * n if rng.rand() < 0.5 else n)
            out.append(mct_segment(int(rng.randint(0, 4)), int(rng.randint(0, 3)), et, values,
                                   zmct=int(rng.rand() < 0.1), ymct=int(rng.rand() < 0.1)))
        elif kind == 2:
            out.append(mcc_segment(int(rng.randint(0, 4)), n, int(rng.randint(0, 4)),
                                   int(rng.randint(0, 4)), bool(rng.rand() < 0.5),
                                   collections=int(rng.choice([0, 1, 1, 1, 2])),
                                   kind=int(rng.choice([1, 1, 1, 0, 2])),
                                   wide=bool(rng.rand() < 0.2)))
        elif kind == 3:
            out.append(mco_segment([int(rng.randint(0, 4)) for _ in range(rng.randint(0, 3))]))
        else:
            marker = int(rng.choice([0xFF74, 0xFF75, 0xFF77, 0xFF78]))
            out.append(j2k_segment(marker, bytes(rng.randint(0, 256, rng.randint(0, 14)).tolist())))
        if rng.rand() < 0.15:  # cut or padded
            s = out[-1]
            body = s[4:]
            body = body[: rng.randint(0, len(body) + 1)] if rng.rand() < 0.5 else body + b"\x00"
            out[-1] = j2k_segment(int.from_bytes(s[:2], "big"), body)
    return out


@pytest.mark.parametrize("part", range(4))
def test_random_segments_read_as_cv2(tmp_path, part):
    rng = np.random.RandomState(40 + part)
    img = picture(12, 12, part)
    read = 0
    for _ in range(40):
        main = _random_segments(rng)
        tile = _random_segments(rng) if rng.rand() < 0.3 else []
        if tile:
            data = encode_j2k(planes(img), tile=(12, 6), main_markers=main, tile_header=tile)
        else:
            data = encode_j2k(planes(img), main_markers=main)
        read += check(tmp_path, data) is not None
    assert read
