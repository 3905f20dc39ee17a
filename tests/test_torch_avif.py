"""The port's AVIF reader (``data/avif.py`` over ``data/av1_*.py``) against
``cv2.imread``, exactly.

Files come from ``cv2.imwrite`` at ``IMWRITE_AVIF_QUALITY`` 100 (4:4:4
GBR, monochrome, 8, 10 and 12 bits) and from Pillow at quality 100 (4:4:4,
4:2:2, 4:2:0 and 4:0:0 in BT.601, full and limited range, speeds 0-10,
several tiles, ``tune-content=screen``, 128 x 128 superblocks, alpha),
written at test time from seeded pictures: gradients (directional, smooth,
Paeth, CfL and filter intra), a few flat colours (palette) and repeated
motifs (intra block copy), sized 1 x 1, odd, over 64 and over 128.  Every
such frame is coded lossless, and every read must equal cv2's.  The
committed ``fixtures/forms/*.avif`` files read to cv2's arrays; a test
asserts that across the files every intra tool and both superblock sizes
were reached.  Cut and corrupted files read as None or as cv2 reads them;
a ``grid``, an ``avis`` sequence and a lossy frame read as cv2 reads them
(``test_torch_avif_grid.py``, ``test_torch_avif_sequence.py`` and
``test_torch_avif_lossy.py`` hold those readers).
"""

import io
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_image_writers import avif_boxes, avif_grid, avif_rebuild

from molnextr_tpu_torch.data import av1_obu, av1_recon, avif
from molnextr_tpu_torch.data.image import UnsupportedFormat, decode, imread, sniff_format

FORMS = Path(__file__).resolve().parents[1] / "molnextr_tpu_torch" / "fixtures" / "forms"
SIZES = [(1, 1), (37, 53), (70, 90), (130, 150)]


def cv2_rgb(path):
    try:
        img = cv2.imread(str(path))
    except cv2.error:
        return None
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def check(tmp_path, data, name="x.avif"):
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2_rgb(path)
    assert want is not None
    got = imread(str(path))
    assert got is not None and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return want


def picture(kind, h, w, seed=0):
    """A seeded RGB picture: ``gradient``, ``flat`` (a few flat colours) or
    ``motif`` (a small drawing repeated at odd steps)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "gradient":
        img = np.stack([(xx * 3 + yy) % 256, (yy * 4) % 256, (xx + 2 * yy) % 256], -1)
        img[h // 3 : h // 2, w // 4 : w // 2] = rng.randint(0, 256, (h // 2 - h // 3,
                                                                 w // 2 - w // 4, 3))
        return img.astype(np.uint8)
    if kind == "flat":
        img = np.full((h, w, 3), 255, np.uint8)
        colours = rng.randint(0, 256, (5, 3))
        for k, col in enumerate(colours):
            y0, x0 = rng.randint(0, max(1, h - 4)), rng.randint(0, max(1, w - 4))
            img[y0 : y0 + 2 + k * h // 9, x0 : x0 + 3 + k * w // 11] = col
        return img
    motif = np.full((33, 35, 3), 255, np.uint8)
    motif[4:28, 6:10] = (200, 30, 30)
    motif[8:12, 4:28] = (20, 40, 200)
    motif[20:26, 14:26] = (30, 160, 40)
    return np.tile(motif, (h // 33 + 1, w // 35 + 1, 1))[:h, :w]


def pil_avif(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "AVIF", quality=100, **kw)
    return buf.getvalue()


def cv2_avif(img, depth=8):
    params = [cv2.IMWRITE_AVIF_QUALITY, 100, cv2.IMWRITE_AVIF_DEPTH, depth]
    ok, buf = cv2.imencode(".avif", img[..., ::-1].copy() if img.ndim == 3 else img, params)
    assert ok
    return buf.tobytes()


def first_headers(payload):
    """The sequence header and the first frame's header of an AV1 payload,
    that frame read against empty reference slots."""
    seq = None
    for obu_type, temporal_id, spatial_id, pos, end in av1_obu.obus(payload):
        r = av1_obu.BitReader(payload, pos, end)
        if obu_type == 1:
            seq = av1_obu.sequence_header(r)
        elif obu_type in (3, 6):
            return seq, av1_obu.frame_header(r, seq, temporal_id, spatial_id)
    raise AssertionError("no frame header")


@pytest.mark.parametrize("path", sorted(FORMS.glob("*.avif")), ids=lambda p: p.name)
def test_committed_forms_read_exactly(path):
    want = cv2_rgb(path)
    got = imread(str(path))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("h,w", SIZES)
def test_cv2_lossless_gbr_and_grey_read_exactly(tmp_path, depth, h, w):
    rng = np.random.RandomState(h * w + depth)
    top = (1 << depth) - 1
    img = picture("gradient", h, w, depth).astype(np.int64) * top // 255
    img[: h // 2] = rng.randint(0, top + 1, img[: h // 2].shape)
    dtype = np.uint8 if depth == 8 else np.uint16
    check(tmp_path, cv2_avif(img.astype(dtype), depth))
    check(tmp_path, cv2_avif(img[..., 1].astype(dtype), depth), "grey.avif")


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0", "4:0:0"])
@pytest.mark.parametrize("kind", ["gradient", "flat", "motif"])
@pytest.mark.parametrize("h,w", SIZES)
def test_pillow_lossless_subsamplings_read_exactly(tmp_path, subsampling, kind, h, w):
    check(tmp_path, pil_avif(picture(kind, h, w), subsampling=subsampling))


@pytest.mark.parametrize("speed", [0, 2, 4, 6, 8, 10])
def test_pillow_speeds_read_exactly(tmp_path, speed):
    img = picture("gradient", 70, 90, speed)
    check(tmp_path, pil_avif(img, speed=speed, subsampling="4:4:4"))
    check(tmp_path, pil_avif(img, speed=speed), "420.avif")


@pytest.mark.parametrize("options", [
    {"range": "limited"}, {"range": "limited", "subsampling": "4:4:4"},
    {"range": "limited", "subsampling": "4:0:0"}, {"tile_rows": 1, "tile_cols": 1},
    {"tile_rows": 1, "tile_cols": 2, "subsampling": "4:4:4"},
    {"advanced": [("tune-content", "screen")]},
    {"advanced": [("tune-content", "screen")], "subsampling": "4:4:4", "speed": 3},
    {"advanced": [("sb-size", "128")]}, {"advanced": [("sb-size", "128")], "speed": 0}],
    ids=repr)
@pytest.mark.parametrize("kind", ["gradient", "motif"])
def test_pillow_options_read_exactly(tmp_path, options, kind):
    check(tmp_path, pil_avif(picture(kind, 140, 150), **options))


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("matrix,full", [(1, True), (1, False), (2, True), (5, False),
                                         (6, False), (9, True), (9, False), (0, False)])
def test_colour_matrices_from_nclx(tmp_path, depth, matrix, full):
    """The nclx ``colr`` box's matrix and range choose the conversion (the
    box rewritten on a Pillow 4:2:0 file at 8 bits, on a cv2 4:4:4 one at
    10 and 12: the AV1 samples stay as coded)."""
    if depth == 8:
        data = pil_avif(picture("gradient", 45, 61),
                        subsampling="4:4:4" if matrix == 0 else "4:2:0")
    else:
        rng = np.random.RandomState(depth + matrix)
        data = cv2_avif(rng.randint(0, 1 << depth, (30, 41, 3)).astype(np.uint16), depth)
    data = bytearray(data)
    k = data.find(b"colrnclx") + 8
    struct.pack_into(">H", data, k + 4, matrix)
    data[k + 6] = 0x80 if full else 0
    check(tmp_path, bytes(data))


def test_icc_colr_is_not_applied(tmp_path):
    """An ICC ``colr`` box is not applied: beside Pillow's nclx box the nclx
    matrix converts, and without it (the box renamed to a type libavif does
    not know, not essential) the AV1 sequence header's matrix and range."""
    icc = b"\0\0\x02\x0cappl\x02\x10\0\0mntrRGB XYZ " + bytes(500)
    data = pil_avif(picture("gradient", 40, 50), icc_profile=icc)
    assert b"colrnclx" in data and b"colrprof" in data
    check(tmp_path, data)
    check(tmp_path, data.replace(b"colrnclx", b"zzzznclx"), "icc_only.avif")


def test_alpha_is_dropped(tmp_path):
    rgba = np.dstack([picture("gradient", 40, 50), np.arange(2000).reshape(40, 50) % 256])
    data = pil_avif(rgba.astype(np.uint8))
    assert b"auxC" in data and b"auxl" in data
    check(tmp_path, data)
    params = [cv2.IMWRITE_AVIF_QUALITY, 100]
    ok, buf = cv2.imencode(".avif", rgba[..., [2, 1, 0, 3]].astype(np.uint8).copy(), params)
    check(tmp_path, buf.tobytes(), "cv2.avif")


def test_orientation_boxes_are_not_applied(tmp_path):
    """Pillow writes ``irot``/``imir`` for an EXIF orientation; OpenCV 5.0
    reads the image as coded, and so does the port."""
    img = picture("gradient", 30, 50)
    for orientation in (2, 3, 6, 8):
        exif = Image.Exif()
        exif[0x0112] = orientation
        data = pil_avif(img, exif=exif)
        assert b"irot" in data or b"imir" in data
        check(tmp_path, data)


CONTAINER_FORMS = {
    "iloc v1 in idat": dict(iloc_version=1, method=1),
    "iloc v2": dict(iloc_version=2), "iloc v2 in idat": dict(iloc_version=2, method=1),
    "three extents": dict(extents=3), "infe v3": dict(infe_version=3),
    "ipma v1, 16-bit indices": dict(ipma_version=1, ipma_flags=1),
    "pitm and iinf v1": dict(pitm_version=1, iinf_version=1),
    "clap (not applied)": dict(clap=struct.pack(">8I", 30, 1, 20, 1, 2, 1, 0, 1)),
}


@pytest.mark.parametrize("name", sorted(CONTAINER_FORMS))
def test_container_forms_read_as_cv2(tmp_path, name):
    """The item in every ``iloc``/``infe``/``ipma``/``pitm`` form libavif
    reads, a ``clap`` crop that OpenCV 5.0 does not apply; each read to
    cv2's array."""
    single = cv2_avif(picture("gradient", 40, 50))
    check(tmp_path, avif_rebuild(single, **CONTAINER_FORMS[name]))


def test_missing_primary_and_unknown_essential_property_read_as_none(tmp_path):
    path = tmp_path / "x.avif"
    data = bytearray(avif_rebuild(cv2_avif(picture("flat", 20, 30))))
    data[data.find(b"pitm") + 9] = 5  # the primary item is not there
    path.write_bytes(bytes(data))
    assert cv2_rgb(path) is None and imread(str(path)) is None
    data = avif_rebuild(cv2_avif(picture("flat", 20, 30)), clap=b"")
    data = data.replace(b"clap", b"zzzz")  # an essential property libavif does not know
    path.write_bytes(data)
    assert cv2_rgb(path) is None and imread(str(path)) is None


def test_major_brand_and_signature(tmp_path):
    """``mif1`` as the major brand with ``avif`` compatible reads; a cut
    ``ftyp`` is still AVIF for the sniffer and reads as None."""
    data = bytearray(cv2_avif(picture("flat", 20, 30)))
    data[8:12] = b"mif1"
    assert sniff_format(bytes(data)) == "AVIF"
    check(tmp_path, bytes(data))
    stub = b"\x00\x00\x00\x1cftypavif" + bytes(8)
    assert sniff_format(stub) == "AVIF" and decode(stub) is None


def test_tools_and_superblock_sizes_are_reached(tmp_path):
    """Every intra tool of a key frame, and both superblock sizes, across
    files the writers emit: each read equal to cv2's."""
    av1_recon.REACHED.clear()
    sb = set()
    files = [pil_avif(picture("gradient", 96, 112), speed=0, subsampling="4:4:4"),
             pil_avif(picture("gradient", 96, 112), speed=0),
             pil_avif(picture("motif", 128, 160), speed=6,
                      advanced=[("tune-content", "screen")]),
             pil_avif(picture("motif", 128, 160), speed=3, subsampling="4:4:4",
                      advanced=[("tune-content", "screen")]),
             pil_avif(picture("gradient", 140, 150), advanced=[("sb-size", "128")]),
             cv2_avif(picture("flat", 256, 256))]
    for k, data in enumerate(files):
        check(tmp_path, data, f"{k}.avif")
        f = avif._Avif(data)
        sb.add(128 if first_headers(f.payload(avif._primary(f)))[0].use_128 else 64)
    tools = {"dc", "paeth", "smooth", "smooth_v", "smooth_h", "cfl", "filter_intra",
             "palette", "intrabc", "intrabc_subpel", "edge_filter", "edge_upsample",
             "angle_delta"} | {f"mode_{m}" for m in range(1, 9)}
    assert tools <= set(av1_recon.REACHED), sorted(tools - set(av1_recon.REACHED))
    assert sb == {64, 128}


def test_cut_and_corrupted_files_read_as_cv2(tmp_path):
    rng = np.random.RandomState(7)
    sources = [pil_avif(picture("gradient", 40, 50)), cv2_avif(picture("flat", 33, 41)),
               pil_avif(picture("motif", 70, 80), advanced=[("tune-content", "screen")])]
    path = tmp_path / "f.avif"
    for data in sources:
        boxes = avif_boxes(data)
        cuts = sorted({int(c) for c in rng.randint(1, len(data), 12)} | {
            start for start, _ in boxes.values()})
        variants = [data[:c] for c in cuts]
        for _ in range(40):
            d = bytearray(data)
            for _ in range(rng.randint(1, 3)):
                d[rng.randint(0, len(d))] = rng.randint(0, 256)
            variants.append(bytes(d))
        for v in variants:
            path.write_bytes(v)
            want = cv2_rgb(path)
            try:
                got = imread(str(path))
            except UnsupportedFormat:
                continue  # a form the port names; cv2's answer is not compared
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)


def test_lossy_grid_and_sequence_raise_naming_them(tmp_path):
    """A lossy file, a ``grid`` and Pillow's ``avis`` sequence raised
    naming themselves until the port read them: each now reads to cv2's
    array (``test_torch_avif_grid.py`` and ``test_torch_avif_sequence.py``
    hold the surveys)."""
    lossy = tmp_path / "lossy.avif"
    assert cv2.imwrite(str(lossy), picture("gradient", 40, 50))
    assert cv2_rgb(lossy) is not None  # now read, to cv2's pixels
    np.testing.assert_array_equal(imread(str(lossy)), cv2_rgb(lossy))
    grid = avif_grid(cv2_avif(picture("flat", 64, 64)), 2, 3)
    assert check(tmp_path, grid, "grid.avif").shape == (128, 192, 3)
    frames = [Image.fromarray(picture("gradient", 20, 30, k)) for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:], quality=100)
    assert avif._Avif(buf.getvalue()).from_track
    check(tmp_path, buf.getvalue(), "anim.avif")


def test_demo_avif_forms_predict_the_jax_packages_smiles():
    """On the committed lossless demo AVIF forms (the lossy ones are
    ``test_torch_avif_lossy.py``'s), the JAX package's
    ``predict_image_files`` (through ``cv2.imread``) and the port's give the
    same SMILES, demo_0.png's."""
    from molnextr_tpu.api import MolNexTR as JaxMolNexTR

    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.chem import canonicalize_smiles

    bundle = str(Path(__file__).resolve().parents[1] / "examples" / "demo_model")
    paths = [str(p) for p in sorted(FORMS.glob("demo_0_*lossless.avif"))]
    assert len(paths) == 8  # the key-frame-filtered inter form among them
    jax = JaxMolNexTR(model_path=bundle).predict_image_files(paths)
    port = MolNexTR(model_path=bundle, device="cpu", num_workers=1).predict_image_files(paths)
    got = [canonicalize_smiles(p["predicted_smiles"])[0] for p in port]
    want = [canonicalize_smiles(p["predicted_smiles"])[0] for p in jax]
    assert got == want == [canonicalize_smiles("CC(C)O")[0]] * len(paths)
