"""The port's superres (``data/av1_superres.py`` and the superres syntax of
``data/av1_obu.py`` and ``data/av1_block.py``) against ``cv2.imread``,
exactly.

Files come from the libaom that cv2 ships, driven through ``ctypes``
(``torch_image_writers.aom_encode``: superres is set in
``aom_codec_enc_cfg_t``, FIXED mode at a key-frame denominator of 9-16),
put into an AVIF (``aom_avif``) at test time from seeded pictures:

* **A seeded survey**: all eight denominators; 4:2:0, 4:4:4, 4:2:2 and
  monochrome at 8, 10 and 12 bits with CDEF and loop restoration on;
  several tile columns; Wiener, self-guided and switchable restoration
  units; widths that are and are not multiples of 8; film grain (libaom's
  test set and a grain table); a ``grid`` of superres tiles; a
  coded-lossless frame under superres (whose restoration syntax is read);
  CDEF at 4:2:2; ``delta_lf`` (unscaled: libaom sets no ``delta_q`` under
  superres); frames under 16 wide, which libaom does not shrink below 16.
  Each reads to cv2's array, 0 pixels differing, or to None where cv2
  gives None (inner tile columns under 128 samples).
* **The right edge**: the upscaling reads past the frame to its
  MI-aligned last column, as libaom pads each row there; clamping at the
  frame's own last column differs from cv2.
* **The process**: :func:`av1_superres.upscale` (the specification's
  whole-row process) against a transcription of libaom's
  ``av1_upscale_normative_rows``, one tile column at a time with the
  position carried across; the filter table's rows.
* Cut and byte-flipped superres files read as cv2 reads them; the writer's
  configuration layout is checked against ``aom_codec_enc_config_default``
  and its files carry ``enable_superres`` and ``use_superres``; the
  committed superres demo forms give the JAX package's SMILES.
"""

from pathlib import Path

import numpy as np
import pytest
from test_torch_avif import FORMS, check, cv2_rgb, first_headers, picture
from torch_image_writers import (AOM_USAGE_ALL_INTRA, aom_avif, aom_default_config, aom_encode,
                                 aom_yuv, avif_boxes, avif_grid, grain_table)

from molnextr_tpu_torch.data import av1_recon, av1_superres, avif
from molnextr_tpu_torch.data.image import UnsupportedFormat, imread

LR = [("enable-cdef", "1"), ("enable-restoration", "1")]


def write(rgb, subsampling="4:2:0", depth=8, **kw):
    return aom_avif(aom_encode(aom_yuv(rgb, subsampling, depth), depth, subsampling, **kw))


def headers(data):
    f = avif._Avif(data)
    return first_headers(f.payload(avif._primary(f)))


def quad(seed, h, w):
    """Three regions restoration treats apart: blurred noise, a sharp
    pattern, noise (as RGB, equal channels)."""
    import cv2

    rng = np.random.RandomState(seed)
    out = cv2.GaussianBlur(rng.randint(0, 256, (h, w)).astype(np.uint8), (5, 5), 2)
    yy, xx = np.mgrid[0:h, 0:w]
    out[:, w // 3 : 2 * w // 3] = (((xx // 3 + yy // 5) % 2) * 200 + 20)[:, w // 3 : 2 * w // 3]
    out[: h // 2, 2 * w // 3 :] = rng.randint(0, 256, (h // 2, w - 2 * w // 3))
    return np.repeat(out[..., None], 3, axis=2)


def _survey():
    rng = np.random.RandomState(19)
    cases = {f"denominator {d}": (lambda d=d: write(picture("gradient", 72, 90 + 3 * d, d), q=40,
                                                     superres=d))
             for d in range(9, 17)}
    for sub in ("4:2:0", "4:4:4", "4:2:2", "4:0:0"):
        for depth in (8, 10, 12):
            d = int(rng.randint(9, 17))
            cases[f"{sub} {depth}-bit /{d}"] = (
                lambda sub=sub, depth=depth, d=d: write(picture("gradient", 66, 131, d), sub,
                                                        depth, q=40, speed=4, superres=d,
                                                        options=LR))
    cases.update({
        "4 tile columns": lambda: write(picture("gradient", 90, 517, 1), q=40, speed=4,
                                        superres=9, options=[("tile-columns", "2"),
                                                             ("sb-size", "64")] + LR),
        "2 tile columns, 10-bit 4:4:4": lambda: write(
            picture("motif", 70, 330), "4:4:4", 10, q=30, speed=4, superres=10,
            options=[("tile-columns", "1"), ("sb-size", "64")] + LR),
        "wiener": lambda: write(quad(2, 96, 164), q=35, speed=2, superres=11,
                                options=[("enable-restoration", "1")]),
        "self-guided": lambda: write(picture("gradient", 96, 157, 1), q=28, speed=2,
                                     superres=10, options=[("enable-restoration", "1")]),
        "switchable": lambda: write(quad(0, 130, 300), q=10, speed=1, superres=9,
                                    options=[("enable-restoration", "1")]),
        "film grain test set": lambda: write(picture("gradient", 64, 90, 3), q=40, superres=10,
                                             options=[("film-grain-test", "3")]),
        "film grain table, 4:4:4": lambda: write(picture("gradient", 64, 90, 4), "4:4:4", q=40,
                                                 superres=16, grain_table_text=grain_table()),
        "grid": lambda: avif_grid([write(picture("gradient", 80, 96, k), q=40, superres=12)
                                   for k in range(4)], 2, 2),
        "coded lossless": lambda: write(picture("gradient", 64, 90, 5), q=0, superres=16,
                                        options=[("enable-restoration", "1")]),
        # libaom sets no delta_q (so no delta_lf) under superres
        "delta_lf, unscaled": lambda: write(picture("gradient", 160, 200, 6), q=40, options=[
            ("deltaq-mode", "3"), ("delta-lf-mode", "1")]),
        "4:2:2 CDEF": lambda: write(picture("gradient", 100, 130, 7), "4:2:2", q=40, speed=2,
                                    superres=13, options=[("enable-cdef", "1")]),
        "30 wide, kept at 16": lambda: write(picture("gradient", 20, 30, 8), q=30, superres=16),
        "12 wide, not shrunk": lambda: write(picture("gradient", 9, 12, 9), q=30, superres=12),
    })
    return cases


SURVEY = _survey()


@pytest.mark.parametrize("name", sorted(SURVEY))
def test_survey_reads_exactly(tmp_path, name):
    data = SURVEY[name]()
    seq, fr = headers(data) if name != "grid" else (None, None)
    if fr is not None and name not in ("12 wide, not shrunk", "delta_lf, unscaled"):
        assert seq.enable_superres and fr.use_superres and fr.width < fr.upscaled_width
    check(tmp_path, data)


def test_survey_reaches_every_restoration_type_and_tool(tmp_path):
    """Across the survey's restoration files the frame-level types
    Wiener (1), self-guided (2) and switchable (3) occur, with units of
    each type filtered; superres, 4:2:2 CDEF and ``delta_lf`` are reached."""
    av1_recon.REACHED.clear()
    types = set()
    for name in ("wiener", "self-guided", "switchable", "4:2:2 CDEF", "delta_lf, unscaled"):
        data = SURVEY[name]()
        types |= set(headers(data)[1].lr_type)
        check(tmp_path, data)
    assert {1, 2, 3} <= types
    tools = {"superres", "lr_wiener", "lr_sgrproj", "lr_switchable", "cdef_422", "delta_lf"}
    assert tools <= set(av1_recon.REACHED), sorted(tools - set(av1_recon.REACHED))


def test_tile_columns_under_128_read_as_none(tmp_path):
    """libaom refuses a superres frame whose inner tile columns are under
    128 samples (``av1_is_min_tile_width_satisfied``): 64-wide columns of a
    150-wide frame read as None in cv2 and in the port."""
    data = write(picture("gradient", 90, 300), q=40, superres=16,
                 options=[("tile-columns", "2"), ("sb-size", "64")])
    path = tmp_path / "narrow.avif"
    path.write_bytes(data)
    assert cv2_rgb(path) is None
    assert imread(str(path)) is None


def test_right_edge_reads_the_mi_aligned_column(tmp_path, monkeypatch):
    """Widths whose downscaled plane ends short of its MI-aligned width:
    the port (clamping at the MI-aligned column) reads every one to cv2's
    array; clamping at the plane's own last column differs from cv2."""
    files = [write(picture("gradient", 50, w, w), sub, q=50, speed=2, superres=d)
             for w, d in ((83, 9), (61, 16), (75, 10)) for sub in ("4:2:0", "4:4:4")]
    wants = [check(tmp_path, data, f"{k}.avif") for k, data in enumerate(files)]
    upscale = av1_superres.upscale
    monkeypatch.setattr(av1_superres, "upscale", lambda plane, width, up, bd: upscale(
        plane[:, :width], width, up, bd))
    differ = [not np.array_equal(imread(str(tmp_path / f"{k}.avif")), want)
              for k, want in enumerate(wants)]
    assert sum(differ) >= 4


def _trunc_div(n, d):
    q = abs(n) // abs(d)
    return q if (n < 0) == (d < 0) else -q


def libaom_upscale(plane, width, upscaled, bd, starts, denom):
    """``av1_upscale_normative_rows``: per tile column (``starts``, the
    columns' first samples and the MI-aligned end), its own source and
    destination span, padded only at the frame's edges, the position
    ``x0_qn`` carried to the next column."""
    step = ((width << 14) + upscaled // 2) // upscaled
    err = upscaled * step - (width << 14)
    x0 = _trunc_div(-((upscaled - width) << 13) + upscaled // 2, upscaled) + 128 - \
        _trunc_div(err, 2)
    x0 &= (1 << 14) - 1
    filters = av1_superres.UPSCALE_FILTER
    out = np.zeros((plane.shape[0], upscaled), np.int64)
    ncols = len(starts) - 1
    for j in range(ncols):
        a, b = starts[j], starts[j + 1]
        up0 = a * denom // 8
        up1 = upscaled if j == ncols - 1 else b * denom // 8
        for x in range(up1 - up0):
            qn = x0 + x * step
            total = 0
            for k in range(8):
                col = a + (qn >> 14) - 4 + k
                if j == 0:
                    col = max(col, 0)
                if j == ncols - 1:
                    col = min(col, b - 1)
                total = total + plane[:, col].astype(np.int64) * filters[(qn & 16383) >> 8][k]
            out[:, up0 + x] = np.clip((total + 64) >> 7, 0, (1 << bd) - 1)
        x0 += (up1 - up0) * step - ((b - a) << 14)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_whole_rows_equal_libaoms_tile_columns(seed):
    rng = np.random.RandomState(seed)
    denom = int(rng.randint(9, 17))
    bd = (8, 10)[seed % 2]
    upscaled = int(rng.randint(300, 700))
    width = av1_superres.downscaled_width(upscaled, denom)
    aligned = (width + 7) & ~7
    plane = rng.randint(0, 1 << bd, (3, aligned))
    cuts = sorted(set(rng.choice(np.arange(8, aligned - 8, 8), rng.randint(1, 4), False)))
    starts = [0] + [int(c) for c in cuts] + [aligned]
    got = av1_superres.upscale(plane, width, upscaled, bd)
    np.testing.assert_array_equal(got, libaom_upscale(plane, width, upscaled, bd, starts, denom))


def test_upscale_filter_rows():
    f = av1_superres.UPSCALE_FILTER
    assert f.shape == (64, 8) and (f.sum(1) == 128).all()
    assert f[0].tolist() == [0, 0, 0, 128, 0, 0, 0, 0]
    # phase k and phase 64 - k are mirror images about the half-sample point
    np.testing.assert_array_equal(f[1:], f[:0:-1][:, ::-1])


def test_cut_and_flipped_superres_files_read_as_cv2(tmp_path):
    rng = np.random.RandomState(23)
    sources = [write(picture("gradient", 40, 70), q=40, superres=12),
               write(picture("gradient", 48, 90, 2), q=30, speed=2, superres=15, options=LR)]
    path = tmp_path / "f.avif"
    read = 0
    for data in sources:
        mdat = avif_boxes(data)[b"mdat"][0]
        variants = [data[:c] for c in sorted(set(rng.randint(mdat, len(data), 8)))]
        for _ in range(30):
            d = bytearray(data)
            for _ in range(rng.randint(1, 3)):
                d[rng.randint(mdat + 8, len(d))] = rng.randint(0, 256)
            variants.append(bytes(d))
        for v in variants:
            path.write_bytes(v)
            want = cv2_rgb(path)
            try:
                got = imread(str(path))
            except UnsupportedFormat:
                continue
            if want is None:
                assert got is None
            else:
                read += 1
                np.testing.assert_array_equal(got, want)
    assert read


@pytest.mark.parametrize("usage", [0, AOM_USAGE_ALL_INTRA])
def test_writer_config_layout_and_superres_headers(usage):
    """``aom_default_config`` asserts the ``aom_codec_enc_cfg_t`` layout
    against the values libaom writes (at good quality and all intra);
    a file written at denominator 14 carries ``enable_superres`` and
    ``use_superres`` with that denominator and its ``ispe`` is the upscaled
    size; at 8 neither."""
    cfg = aom_default_config(usage)
    assert cfg.g_usage == usage and cfg.rc_superres_kf_denominator == 8
    rgb = picture("gradient", 40, 100)
    seq, fr = headers(write(rgb, q=30, superres=14, usage=usage))
    assert seq.enable_superres and fr.superres_denom == 14
    assert (fr.upscaled_width, fr.width) == (100, 57)
    data = write(rgb, q=30)
    seq, fr = headers(data)
    assert not seq.enable_superres and not fr.use_superres
    f = avif._Avif(data)
    assert avif._ispe(f, avif._primary(f)) == (100, 40)


def test_superres_demo_forms_predict_the_jax_packages_smiles():
    """The committed superres demo forms (libaom at two denominators, and
    one with loop restoration) give demo_0.png's SMILES in the JAX package
    (through ``cv2.imread``) and in the port, float32 on the CPU."""
    from molnextr_tpu.api import MolNexTR as JaxMolNexTR

    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.chem import canonicalize_smiles

    bundle = str(Path(__file__).resolve().parents[1] / "examples" / "demo_model")
    paths = [str(p) for p in sorted(FORMS.glob("demo_0_*_superres.avif"))]
    assert len(paths) == 3
    for p in paths:
        assert headers(Path(p).read_bytes())[1].use_superres
    jax = JaxMolNexTR(model_path=bundle).predict_image_files(paths)
    port = MolNexTR(model_path=bundle, device="cpu", num_workers=1).predict_image_files(paths)
    got = [canonicalize_smiles(p["predicted_smiles"])[0] for p in port]
    want = [canonicalize_smiles(p["predicted_smiles"])[0] for p in jax]
    assert got == want == [canonicalize_smiles("CC(C)O")[0]] * len(paths)
