"""The port's JPEG 2000 reader (``data/jp2.py``, ``data/j2k.py``,
``data/j2k_t2.py``, ``data/j2k_t1.py``, ``data/j2k_dwt.py``) against
``cv2.imread``, exactly.

Files come from PIL (OpenJPEG's encoder: the JP2 container and the raw
codestream, 5/3 and 9/7, ``mct`` 0 and 1, the five progressions, tiles that
do and do not divide the image, code-blocks down to 4 x 64, precincts, 1-6
resolutions, quality layers, grey, LA, RGB, RGBA and 16-bit grey, ``PLT``
and comments) and from the hand J2K writer of ``torch_image_writers`` for
what PIL cannot set: every code-block style bit, ``SOP``/``EPH``, ``POC``,
``PPM``/``PPT``, several tile-parts a tile in any order, ``COC``/``QCC``
(also in tile-part headers), scalar-derived quantisation, subsampled
components, ``RGN``, and JP2 boxes with ``pclr``, ``cmap``, ``cdef``, each
``colr`` form, extended and open box lengths; and a seeded corpus of cut,
flipped and rewritten files, where the port reads None exactly where cv2
does.

Behaviours found by test (OpenCV 5.0 on OpenJPEG 2.5.3): 9/7 files read
exactly too (OpenJPEG's float order is kept); a raw codestream or an sRGB
JP2 needs three components (one or two read as None, where a grey ``colr``
reads the first component); sYCC goes through OpenCV's ``COLOR_YUV2BGR``;
e-sYCC and CMYK read as None, other enumerations, ICC profiles and no
``colr`` as sRGB; precisions below 8, signed or subsampled components, an
image offset, more than four components, a codestream without ``EOC``, a
cut one and a missing ``EPH`` read as None; samples are shifted by the
largest precision less 8 and cut to 8 bits (a 16-bit palette entry reads as
its low byte).
"""

import io
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_image_writers import (J2K_LAZY, J2K_PTERM, J2K_RESET, J2K_SEGSYM, J2K_TERMALL,
                                 J2K_VSC, _HeaderBits, _lift, _MQEncoder, _TagEncoder,
                                 cdef_box, cmap_box, encode_j2k, encode_jp2, j2k_segment, jp2_box,
                                 pclr_box)

from molnextr_tpu_torch.data.image import decode, imread
from molnextr_tpu_torch.data.j2k_dwt import idwt53
from molnextr_tpu_torch.data.j2k_t1 import MQDecoder, _reset_states
from molnextr_tpu_torch.data.j2k_t2 import BitReader, TagTree

GREY = b"\x01\x00\x00" + struct.pack(">I", 17)


def cv2_rgb(path):
    try:
        img = cv2.imread(str(path))
    except cv2.error:
        return None
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def check(tmp_path, data, name="x.jp2"):
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


def picture(h, w, seed=0, channels=3):
    """Gradients and noise: every band has coefficients."""
    rng = np.random.RandomState(seed)
    yy, xx = np.indices((h, w))
    base = (5 * yy + 3 * xx)[..., None] + rng.randint(0, 60, (h, w, channels))
    return np.clip(base, 0, 255).astype(np.uint8)


def pil_j2k(img, mode=None, **kw):
    buf = io.BytesIO()
    image = Image.fromarray(img) if mode is None else Image.frombytes(
        mode, img.shape[1::-1], img.tobytes())
    image.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


# -- files from PIL ------------------------------------------------------------------

PIL_CASES = {
    "jp2_53": {}, "j2k_53": {"no_jp2": True}, "jp2_97": {"irreversible": True},
    "j2k_97": {"irreversible": True, "no_jp2": True}, "mct0_53": {"mct": 0},
    "mct0_97": {"mct": 0, "irreversible": True}, "lrcp": {"progression": "LRCP"},
    "rlcp": {"progression": "RLCP"}, "rpcl": {"progression": "RPCL"},
    "pcrl": {"progression": "PCRL"}, "cprl": {"progression": "CPRL"},
    "tiles_16": {"tile_size": (16, 16)}, "tiles_20x24_97": {"tile_size": (20, 24),
                                                           "irreversible": True,
                                                           "num_resolutions": 3},
    "tiles_13x29": {"tile_size": (13, 29), "num_resolutions": 2},
    "cblk_4x64": {"codeblock_size": (4, 64)}, "cblk_64x4": {"codeblock_size": (64, 4)},
    "cblk_8x8_97": {"codeblock_size": (8, 8), "irreversible": True},
    "precincts_16": {"precinct_size": (16, 16), "num_resolutions": 3},
    "precincts_rpcl_97": {"precinct_size": (32, 16), "num_resolutions": 4,
                          "progression": "RPCL", "irreversible": True},
    "precincts_cprl": {"precinct_size": (16, 32), "num_resolutions": 3, "progression": "CPRL"},
    "res_1": {"num_resolutions": 1}, "res_2": {"num_resolutions": 2},
    "res_4": {"num_resolutions": 4}, "res_5": {"num_resolutions": 5},
    "res_6": {"num_resolutions": 6}, "layers_3": {"quality_layers": [40, 20, 10],
                                                  "quality_mode": "rates"},
    "layers_2_97": {"quality_layers": [30, 8], "quality_mode": "rates", "irreversible": True},
    "layers_db": {"quality_layers": [30, 45], "quality_mode": "dB"},
    "plt": {"plt": True}, "comment": {"comment": "molnextr"},
    "everything": {"tile_size": (32, 32), "progression": "PCRL", "precinct_size": (16, 16),
                   "num_resolutions": 3, "codeblock_size": (8, 16), "plt": True,
                   "quality_layers": [25, 10], "quality_mode": "rates", "comment": "x"},
}


@pytest.mark.parametrize("case", sorted(PIL_CASES))
def test_pil_rgb(tmp_path, case):
    img = picture(45, 61, 1)
    want = check(tmp_path, pil_j2k(img, **PIL_CASES[case]))
    if not PIL_CASES[case].get("irreversible") and "quality_layers" not in PIL_CASES[case]:
        np.testing.assert_array_equal(want, img)  # reversible: the source itself


@pytest.mark.parametrize("mode", ["L", "LA", "RGBA", "I;16"])
@pytest.mark.parametrize("kind", ["53", "97"])
def test_pil_modes(tmp_path, mode, kind):
    """Grey, grey with alpha, RGBA (alpha dropped) and 16-bit grey
    (``value >> 8``)."""
    channels = {"L": 1, "LA": 2, "RGBA": 4}.get(mode, 1)
    img = picture(33, 40, 2, channels)
    if mode == "I;16":
        img = (img[..., 0].astype(np.uint16) * 257 + np.arange(40, dtype=np.uint16)).astype("<u2")
    elif channels == 1:
        img = img[..., 0]
    want = check(tmp_path, pil_j2k(img, mode=mode, irreversible=kind == "97"))
    assert want is not None
    if kind == "53":
        grey = img >> 8 if mode == "I;16" else (img if img.ndim == 2 else img[..., 0])
        expect = img[..., :3] if mode == "RGBA" else np.dstack([grey] * 3)
        np.testing.assert_array_equal(want, expect)


@pytest.mark.parametrize("size", [(1, 1), (1, 7), (9, 1), (2, 3), (64, 64)])
def test_pil_sizes(tmp_path, size):
    check(tmp_path, pil_j2k(picture(*size, 3)))


def test_grey_codestream_reads_as_none_as_cv2(tmp_path):
    """A raw codestream has no colour space: OpenCV takes it for sRGB and
    needs three components, so grey or grey with alpha reads as None."""
    img = picture(20, 24, 4)
    for data in (pil_j2k(img[..., 0], no_jp2=True),
                 pil_j2k(img[..., :2].copy(), mode="LA", no_jp2=True)):
        assert check(tmp_path, data) is None


def test_signed_components_read_as_none(tmp_path):
    assert check(tmp_path, pil_j2k(picture(16, 16, 5), signed=True)) is None


# -- the hand writer: what PIL cannot set ----------------------------------------------

def planes(h=23, w=29, seed=0):
    img = picture(h, w, seed)
    return img, [img[..., i] for i in range(3)]


STYLES = {"lazy": J2K_LAZY, "reset": J2K_RESET, "termall": J2K_TERMALL, "vsc": J2K_VSC,
          "pterm": J2K_PTERM, "segsym": J2K_SEGSYM, "lazy_termall": J2K_LAZY | J2K_TERMALL,
          "reset_vsc_segsym": J2K_RESET | J2K_VSC | J2K_SEGSYM, "all": 63}


@pytest.mark.parametrize("style", sorted(STYLES))
def test_code_block_styles(tmp_path, style):
    img, p = planes()
    want = check(tmp_path, encode_j2k(p, style=STYLES[style], numres=2, cblk=(3, 3), layers=2),
                 "x.j2k")
    np.testing.assert_array_equal(want, img)


WRITER_CASES = {
    "sop_eph": dict(sop=True, eph=True, layers=3),
    "sop_eph_tiles": dict(sop=True, eph=True, layers=2, tile=(10, 12), parts=2),
    "ppm": dict(headers="ppm", layers=2, tile=(16, 16), parts=2),
    "ppt": dict(headers="ppt", layers=2, tile=(16, 16), parts=3),
    "ppt_eph": dict(headers="ppt", eph=True, sop=True, layers=2),
    "parts_interleaved": dict(tile=(10, 12), parts=3, interleave=True, layers=2),
    "poc": dict(layers=2, pocs=[(0, 0, 2, 2, 3, 1), (0, 0, 2, 3, 3, 0)]),
    "poc_cprl": dict(layers=2, pocs=[(1, 1, 1, 3, 3, 4), (0, 0, 2, 3, 3, 2)]),
    "poc_tile_header": dict(layers=2, pocs=[(0, 0, 2, 3, 2, 0), (0, 0, 2, 3, 3, 1)],
                            tile=(16, 12), tile_markers=True),
    "coc_qcc": dict(coc={1: dict(numres=2, cblk=(3, 4)), 2: dict(numres=4, cblk=(2, 5))}),
    "coc_tile_header": dict(coc={1: dict(numres=2)}, tile_markers=True, tile=(16, 16)),
    "rgn": dict(roi={0: (4, 4, 12, 12)}),
    "rgn_tiles": dict(roi={1: (0, 0, 9, 30)}, tile=(12, 12), tile_markers=True),
    "rct": dict(mct=1, layers=2),
    "progressions": dict(progression=3, layers=2, tile=(12, 16)),
}


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_writer_reversible(tmp_path, case):
    img, p = planes(seed=1)
    want = check(tmp_path, encode_j2k(p, **WRITER_CASES[case]), "x.j2k")
    np.testing.assert_array_equal(want, img)


@pytest.mark.parametrize("qntsty", [1, 2])
@pytest.mark.parametrize("mct", [0, 1])
def test_writer_irreversible_quantisation(tmp_path, qntsty, mct):
    """Scalar derived (one step, the others from it per level) and
    expounded steps, with and without the ICT."""
    img, p = planes(seed=2)
    want = check(tmp_path, encode_j2k(p, reversible=False, qntsty=qntsty, mct=mct, expn0=9,
                                      mant=300), "x.j2k")
    assert np.abs(want.astype(int) - img).max() <= 40


def test_writer_mixed_filters(tmp_path):
    """A 9/7 component beside 5/3 ones (``COC``, ``QCC``)."""
    _, p = planes(seed=3)
    check(tmp_path, encode_j2k(p, coc={2: dict(reversible=False, qntsty=2)}), "x.j2k")


MAIN_MARKERS = {
    "tlm": [j2k_segment(0xFF55, bytes([0, 0x50]) + bytes([0]) + struct.pack(">I", 100))],
    "tlm_st3": [j2k_segment(0xFF55, bytes([0, 0x30]) + bytes(4))],
    "tlm_bad_size": [j2k_segment(0xFF55, bytes([0, 0x50, 0, 0, 0]))],
    "plm": [j2k_segment(0xFF57, bytes([0, 0, 0, 0, 2, 0x81, 0x05]))],
    "plm_empty": [j2k_segment(0xFF57, b"")],
    "crg": [j2k_segment(0xFF63, bytes(12))], "crg_bad": [j2k_segment(0xFF63, bytes(8))],
    "com_binary": [j2k_segment(0xFF64, b"\x00\x00\xff\x90\x01")],
    "unknown": [j2k_segment(0xFF30, b"\x00\x11\x22\x33")],
    "sop_in_main": [j2k_segment(0xFF91, b"\x00\x00")],
    "plt_in_main": [j2k_segment(0xFF58, b"\x00\x05")],
    "cap": [j2k_segment(0xFF50, bytes(4))], "cpf": [j2k_segment(0xFF59, b"\x00\x01\x02")],
}


@pytest.mark.parametrize("case", sorted(MAIN_MARKERS))
def test_main_header_markers(tmp_path, case):
    """``TLM``, ``PLM``, ``CRG``, ``COM``, ``CAP`` and ``CPF`` are read and
    checked, not used; an unknown marker is skipped; ``SOP`` or ``PLT``
    there fails."""
    img, p = planes(12, 10, 19)
    got = check(tmp_path, encode_j2k(p, main_markers=MAIN_MARKERS[case]), "x.j2k")
    if got is not None:
        np.testing.assert_array_equal(got, img)


def _cod_qcd(data):
    """The main header's ``COD`` and ``QCD`` segments of a codestream."""
    out = []
    for marker in (b"\xff\x52", b"\xff\x5c"):
        pos = data.index(marker)
        out.append(data[pos : pos + 2 + struct.unpack(">H", data[pos + 2 : pos + 4])[0]])
    return out


def test_tile_part_header_markers(tmp_path):
    """A tile's ``COD`` sets every component of the tile, over the main
    header's ``COC`` (as OpenJPEG applies it); ``QCD`` and ``COM`` there;
    an unknown marker or a ``PPM`` there fails."""
    img, p = planes(16, 16, 20)
    plain = encode_j2k(p, tile=(8, 16))
    cod, qcd = _cod_qcd(plain)
    np.testing.assert_array_equal(check(tmp_path, encode_j2k(p, tile=(8, 16), tile_header=[
        cod, qcd, j2k_segment(0xFF64, b"\x00\x01tile")]), "x.j2k"), img)
    check(tmp_path, encode_j2k(p, tile=(8, 16), coc={1: dict(numres=2)}, tile_header=[cod]),
          "x.j2k")
    for bad in (j2k_segment(0xFF30, b"\x00\x00"), j2k_segment(0xFF60, b"\x00\x00\x00")):
        assert check(tmp_path, encode_j2k(p, tile=(8, 16), tile_header=[bad]), "x.j2k") is None


def test_subsampled_components_read_as_none(tmp_path):
    _, p = planes(seed=4)
    data = encode_j2k([p[0], p[1][::2, ::2], p[2][::2, ::2]], sub=[(1, 1), (2, 2), (2, 2)])
    assert check(tmp_path, data, "x.j2k") is None


def test_precisions(tmp_path):
    """Below 8 bits: None; 12 bits: >> 4; components of 12 and 8 bits: every
    one shifted by 4."""
    img, p = planes(12, 10, 5)
    grey = encode_jp2(encode_j2k([p[0] >> 4], prec=4), 10, 12, 1, colr=GREY)
    assert check(tmp_path, grey) is None
    wide = [q.astype(np.uint16) * 16 + 7 for q in p]
    np.testing.assert_array_equal(check(tmp_path, encode_j2k(wide, prec=12), "x.j2k"), img)
    mixed = bytearray(encode_j2k(wide, prec=12))
    siz = mixed.index(b"\xff\x51") + 4
    mixed[siz + 36 + 3] = mixed[siz + 36 + 6] = 7  # Ssiz: components 1 and 2 at 8 bits
    got = check(tmp_path, bytes(mixed), "x.j2k")
    assert (got[..., 1:] < 16).all()


def test_more_than_four_components_and_image_offset_read_as_none(tmp_path):
    _, p = planes(12, 10, 6)
    assert check(tmp_path, encode_j2k(p + p[:2]), "x.j2k") is None
    data = bytearray(encode_j2k(p))
    siz = data.index(b"\xff\x51") + 4
    data[siz + 2 : siz + 6] = struct.pack(">I", 11)
    data[siz + 10 : siz + 14] = struct.pack(">I", 1)  # XOsiz 1
    assert check(tmp_path, bytes(data), "x.j2k") is None


def test_sizes_past_opencvs_limits_read_as_none(tmp_path):
    _, p = planes(12, 10, 6)
    for field in (struct.pack(">I", 1 << 21), struct.pack(">II", 40000, 40000)):
        data = bytearray(encode_j2k(p))
        siz = data.index(b"\xff\x51") + 4
        data[siz + 2 : siz + 2 + len(field)] = field
        assert check(tmp_path, bytes(data), "x.j2k") is None


def test_missing_eoc_and_cuts(tmp_path):
    """No ``EOC``: None; cut after a tile: None, unless the cut falls just
    after the next ``SOT`` marker, where OpenJPEG keeps the tiles read."""
    img, p = planes(12, 10, 7)
    assert check(tmp_path, encode_j2k(p, eoc=False), "x.j2k") is None
    assert check(tmp_path, encode_j2k(p, tile=(5, 12), eoc=False), "x.j2k") is None
    data = encode_j2k(p, tile=(5, 12))
    sot = data.index(b"\xff\x90", data.index(b"\xff\x93"))
    for cut in (0, 1, 3, 4, 12):
        assert check(tmp_path, data[: sot + cut], "x.j2k") is None
    got = check(tmp_path, data[: sot + 2], "x.j2k")
    np.testing.assert_array_equal(got[:, :5], img[:, :5])
    assert not got[:, 5:].any()


# -- JP2 boxes -----------------------------------------------------------------------

def test_palette_and_component_mapping(tmp_path):
    rng = np.random.RandomState(8)
    index = rng.randint(0, 6, (12, 10)).astype(np.uint8)
    cs = encode_j2k([index])
    pal = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [10, 20, 30], [200, 100, 50],
                    [7, 7, 7]])
    rgb = encode_jp2(cs, 10, 12, 1, header_boxes=[pclr_box(pal, [8, 8, 8]),
                                                  cmap_box([(0, 1, 0), (0, 1, 1), (0, 1, 2)])])
    np.testing.assert_array_equal(check(tmp_path, rgb), pal[index])
    deep = encode_jp2(cs, 10, 12, 1, header_boxes=[pclr_box(pal * 256 + 3, [16, 16, 16]),
                                                   cmap_box([(0, 1, 0), (0, 1, 1), (0, 1, 2)])])
    np.testing.assert_array_equal(check(tmp_path, deep), np.full(pal[index].shape, 3))
    no_cmap = encode_jp2(cs, 10, 12, 1, colr=GREY, header_boxes=[pclr_box(pal, [8, 8, 8])])
    np.testing.assert_array_equal(check(tmp_path, no_cmap), np.dstack([index] * 3))
    for cols in (2, 4, 5):
        table = np.c_[pal, pal][:, :cols]
        check(tmp_path, encode_jp2(cs, 10, 12, 1, header_boxes=[
            pclr_box(table, [8] * cols), cmap_box([(0, 1, i) for i in range(cols)])]))
    bad = encode_jp2(cs, 10, 12, 1, header_boxes=[pclr_box(pal, [8, 8, 8]),
                                                  cmap_box([(0, 1, 0), (0, 1, 2), (0, 1, 1)])])
    assert check(tmp_path, bad) is None


CDEFS = {"reversed": [(0, 0, 3), (1, 0, 2), (2, 0, 1)], "identity": [(0, 0, 1), (1, 0, 2),
                                                                     (2, 0, 3)],
         "swap01": [(0, 0, 2), (1, 0, 1), (2, 0, 3)], "incomplete": [(0, 0, 1), (1, 0, 2)],
         "out_of_order": [(2, 0, 1), (1, 0, 2), (0, 0, 3)],
         "opacity_first": [(0, 1, 0), (1, 0, 2), (2, 0, 3)],
         "whole_image": [(0, 0, 65535), (1, 0, 2), (2, 0, 3)]}


@pytest.mark.parametrize("case", sorted(CDEFS))
def test_channel_definitions(tmp_path, case):
    img, p = planes(12, 10, 9)
    check(tmp_path, encode_jp2(encode_j2k(p), 10, 12, 3, header_boxes=[cdef_box(CDEFS[case])]))


def test_alpha_first_of_four(tmp_path):
    _, p = planes(12, 10, 10)
    check(tmp_path, encode_jp2(encode_j2k(p + [p[0] // 2]), 10, 12, 4, header_boxes=[
        cdef_box([(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)])]))


COLRS = {"srgb": b"\x01\x00\x00" + struct.pack(">I", 16), "grey": GREY,
         "sycc": b"\x01\x00\x00" + struct.pack(">I", 18),
         "esycc": b"\x01\x00\x00" + struct.pack(">I", 24),
         "cmyk": b"\x01\x00\x00" + struct.pack(">I", 12),
         "cielab": b"\x01\x00\x00" + struct.pack(">I", 14), "other": b"\x01\x00\x00"
         + struct.pack(">I", 99), "restricted_icc": b"\x02\x00\x00" + bytes(132),
         "meth3": b"\x03\x00\x00abcd", "precedence": b"\x01\x01\x02" + struct.pack(">I", 17),
         "none": None}


@pytest.mark.parametrize("case", sorted(COLRS))
def test_colour_specifications(tmp_path, case):
    img, p = planes(12, 10, 11)
    got = check(tmp_path, encode_jp2(encode_j2k(p), 10, 12, 3, colr=COLRS[case]))
    if case in ("esycc", "cmyk"):
        assert got is None
    elif case == "sycc":
        np.testing.assert_array_equal(got, cv2.cvtColor(img, cv2.COLOR_YUV2RGB))
    elif case in ("grey", "precedence"):
        np.testing.assert_array_equal(got, np.dstack([img[..., 0]] * 3))
    else:
        np.testing.assert_array_equal(got, img)


def test_box_forms(tmp_path):
    """Extended and open ``jp2c`` lengths, a second ``colr`` (ignored),
    ``res `` and unknown boxes, and an ``ihdr`` that disagrees with ``SIZ``."""
    img, p = planes(12, 10, 12)
    cs = encode_j2k(p)
    for data in (encode_jp2(cs, 10, 12, 3, jp2c_form="xl"),
                 encode_jp2(cs, 10, 12, 3, jp2c_form="open"),
                 encode_jp2(cs, 10, 12, 3, header_boxes=[jp2_box(b"colr", GREY)]),
                 encode_jp2(cs, 10, 12, 3, header_boxes=[jp2_box(b"res ", jp2_box(
                     b"resc", bytes(10)))], before=[jp2_box(b"xml ", b"<a/>")])):
        np.testing.assert_array_equal(check(tmp_path, data), img)
    assert check(tmp_path, encode_jp2(cs, 11, 12, 3)) is None


def test_unported_features_raise_naming_them(tmp_path):
    """No JPEG 2000 form raises ``UnsupportedFormat`` any more.  A Part 1
    codestream whose ``SPcod`` says HT code-blocks raised it until the port
    decoded HTJ2K (``test_torch_htj2k.py``): it now reads as cv2 reads it.
    Part 2 markers raised too until the port read them as OpenJPEG does:
    this ``MCT`` of no array reads as None, as in cv2
    (``test_torch_jpeg2000_part2.py`` holds the Part 2 survey)."""
    _, p = planes(12, 10, 13)
    data = bytearray(encode_j2k(p))
    cod = data.index(b"\xff\x52") + 4
    data[cod + 5 + 3] = 0x40  # SPcod code-block style: HT
    check(tmp_path, bytes(data), "x.j2k")
    data = encode_j2k(p)
    qcd = data.index(b"\xff\x5c")
    part2 = data[:qcd] + struct.pack(">HHH", 0xFF74, 4, 0) + data[qcd:]
    assert check(tmp_path, part2, "x.j2k") is None


# -- units: MQ decoder, tag tree, 5/3 lifting --------------------------------------------

def test_mq_decoder_reads_what_the_encoder_wrote():
    rng = np.random.RandomState(14)
    for n in (1, 50, 3000):
        contexts = rng.randint(0, 19, n)
        bits = (rng.rand(n) < rng.choice([0.02, 0.3, 0.5, 0.9])).astype(int)
        enc = _MQEncoder()
        for d, cx in zip(bits, contexts):
            enc.encode(int(d), int(cx))
        dec = MQDecoder(_reset_states())
        dec.init(enc.flush())
        assert [dec.decode(int(cx)) for cx in contexts] == bits.tolist()


def test_tag_tree_reads_what_the_encoder_wrote():
    rng = np.random.RandomState(15)
    for h, w in ((1, 1), (3, 5), (8, 7)):
        values = rng.randint(0, 6, (h, w))
        enc, bits = _TagEncoder(values), _HeaderBits()
        for j in range(h):
            for i in range(w):
                enc.encode(bits, j, i, 1 << 30)
        data = bits.flush()
        tree, bio = TagTree(w, h), BitReader(data, 0, len(data))
        got = []
        for leaf in range(h * w):
            v = 0
            while not tree.decode(bio, leaf, v + 1):
                v += 1
            got.append(v)
        assert got == values.ravel().tolist()


def _inverse_53_direct(low, high, cas):
    """Annex F's inverse 5/3 on one signal, sample by sample."""
    n = len(low) + len(high)
    x = [0] * n
    for i, v in enumerate(low):
        x[cas + 2 * i] = int(v)
    for i, v in enumerate(high):
        x[1 - cas + 2 * i] = int(v)

    def at(k):
        return x[-k if k < 0 else (2 * (n - 1) - k if k >= n else k)]

    for k in range(cas, n, 2):
        x[k] = x[k] - ((at(k - 1) + at(k + 1) + 2) >> 2)
    for k in range(1 - cas, n, 2):
        x[k] = x[k] + ((at(k - 1) + at(k + 1)) >> 1)
    return x


@pytest.mark.parametrize("origin", [0, 1])
def test_53_lifting_against_a_direct_implementation(origin):
    rng = np.random.RandomState(16 + origin)
    for n in range(2, 12):
        row = rng.randint(-300, 300, (1, n))
        coeffs = _lift(row, origin, True)  # the writer's forward transform
        sn = len(range(origin % 2, n, 2))
        got = idwt53(np.zeros((1, n), np.int32) + coeffs.astype(np.int32),
                     [((origin + 1) >> 1, 0, (origin + n + 1) >> 1, 1), (origin, 0, origin + n, 1)])
        want = _inverse_53_direct(coeffs[0, :sn], coeffs[0, sn:], origin % 2)
        assert got[0].tolist() == want == row[0].tolist()


# -- seeded fuzz ---------------------------------------------------------------------

def _fuzz_seeds():
    img, p = planes(24, 20, 17)
    return [pil_j2k(img), pil_j2k(img, irreversible=True, no_jp2=True),
            pil_j2k(img, tile_size=(12, 12), progression="RPCL", precinct_size=(16, 16),
                    num_resolutions=3, quality_layers=[30, 10], quality_mode="rates"),
            encode_j2k(p, sop=True, eph=True, layers=3, tile=(10, 12), parts=2),
            encode_j2k(p, headers="ppt", style=J2K_LAZY | J2K_VSC, numres=2, cblk=(3, 3)),
            encode_jp2(encode_j2k(p, headers="ppm", style=J2K_TERMALL | J2K_RESET | J2K_SEGSYM,
                                  mct=1), 20, 24, 3),
            encode_j2k(p, layers=2, pocs=[(0, 0, 2, 2, 3, 1), (0, 0, 2, 3, 3, 0)],
                       coc={1: dict(numres=2)})]


@pytest.mark.parametrize("part", range(4))
def test_fuzzed_files_read_as_none_exactly_where_cv2_does(tmp_path, part):
    """60 cases a part (240 in all): cut files, flipped bits, overwritten
    bytes, marker segment lengths off by a little, bytes inserted or
    dropped."""
    rng = np.random.RandomState(2000 + part)
    seeds = _fuzz_seeds()
    for k in range(60):
        data = bytearray(seeds[k % len(seeds)])
        kind = rng.randint(5)
        if kind == 0:
            data = data[: rng.randint(1, len(data))]
        elif kind == 1:
            for _ in range(rng.randint(1, 4)):
                data[rng.randint(len(data))] ^= 1 << rng.randint(8)
        elif kind == 2:
            data[rng.randint(len(data))] = rng.randint(256)
        elif kind == 3:
            marks = [i for i in range(len(data) - 3) if data[i] == 0xFF
                     and 0x51 <= data[i + 1] <= 0x64]
            pos = marks[rng.randint(len(marks))] + 2
            size = max(0, struct.unpack(">H", data[pos : pos + 2])[0] + rng.randint(-3, 4))
            data[pos : pos + 2] = struct.pack(">H", min(size, 0xFFFF))
        else:
            cut = rng.randint(2, len(data))
            data = data[:cut] + bytes(rng.randint(0, 256, rng.randint(0, 8)).astype(np.uint8)) \
                + data[cut + rng.randint(0, 6) :]
        check(tmp_path, bytes(data), "x.jp2")


def test_imread_dispatches_both_signatures(tmp_path):
    img, p = planes(12, 10, 18)
    for name, data in (("x.jp2", encode_jp2(encode_j2k(p), 10, 12, 3)),
                       ("x.j2k", encode_j2k(p))):
        path = tmp_path / name
        path.write_bytes(data)
        np.testing.assert_array_equal(imread(str(path)), img)
    assert os.path.exists(path)
