"""AV1 film grain parameters against ``cv2.imread``, exactly: what
libaom's test sets (``test_torch_avif_grain.py``) do not reach.

* **Grain tables**: Pillow's libaom given a film grain table
  (``torch_image_writers.grain_table``, the encoder's
  ``film-grain-table``): AR lags 0-3, every AR and grain scale shift,
  every scaling shift, ``chroma_scaling_from_luma``, no luma points (4:4:4
  and 4:2:2, where chroma grain stands alone), one point and the most
  points, the ``cb``/``cr`` multipliers and offsets, overlap off, at each
  subsampling (grey without chroma points, which libaom's encoder would
  write into a header that cannot carry them).
* **Rewritten frame headers** (``torch_image_writers.av1_with_grain``):
  grain put into files ``cv2.imwrite`` writes at 8, 10 and 12 bits, lossy
  4:2:0 and lossless GBR (matrix 0, where the restricted range clips
  chroma as luma), with ``clip_to_restricted_range`` and every lag.  No
  writer here makes grain above 8 bits or that clip; the rewrite reaches
  both.
* **``denoise-noise-level``**: Pillow's libaom estimating the grain of a
  noisy flat picture, at several levels and sizes.
* Units: the random register and the scaling lookup against the
  specification's text; the committed Gaussian sequence's ends.
* ``test_every_parameter_is_reached`` reads a set of files that reaches
  every ``film_grain_params`` field at each of its values (or both sides
  of a point count), every bit depth and subsampling, each read to cv2's
  array.
* Corrupt grain headers (more scaling points than libaom allows, points
  not increasing, one chroma plane at 4:2:0) read as None, as in cv2.
"""

import cv2
import numpy as np
import pytest
from PIL import Image
from test_torch_avif import check, cv2_rgb, first_headers, picture
from torch_image_writers import (av1_with_grain, avif_boxes, avif_rebuild, film_grain_avif,
                                 grain_table)

from molnextr_tpu_torch.data import av1_grain, avif
from molnextr_tpu_torch.data.image import imread


def pil_table_avif(tmp_path, img, subsampling, **table):
    path = tmp_path / "grain.tbl"
    path.write_text(grain_table(**table))
    import io

    buf = io.BytesIO()
    options = dict(quality=50, advanced={"film-grain-table": str(path)})
    grey = subsampling == "4:0:0"
    Image.fromarray(img[..., 1].copy() if grey else img).save(buf, "AVIF",
                                                              subsampling=subsampling, **options)
    return buf.getvalue()


def cv2_file(img, depth, quality):
    if depth > 8:
        img = (img.astype(np.int64) * ((1 << depth) - 1) // 255).astype(np.uint16)
    params = [cv2.IMWRITE_AVIF_QUALITY, quality, cv2.IMWRITE_AVIF_DEPTH, depth]
    ok, buf = cv2.imencode(".avif", img[..., ::-1].copy(), params)
    assert ok
    return buf.tobytes()


def payload(data):
    boxes = avif_boxes(data)
    return data[boxes[b"mdat"][0] + 8 : boxes[b"mdat"][1]]


def regrained(data, **params):
    return avif_rebuild(data, payload=av1_with_grain(payload(data), **params))


def header(data):
    f = avif._Avif(data)
    seq, fr = first_headers(f.payload(avif._primary(f)))
    return seq, fr.grain


def ar(rng, lag, luma):
    n = 2 * lag * (lag + 1)
    return dict(ar_y=[int(v) for v in rng.randint(-60, 60, n)],
                ar_cb=[int(v) for v in rng.randint(-60, 60, n + luma)],
                ar_cr=[int(v) for v in rng.randint(-60, 60, n + luma)])


TABLES = {
    "lag 0": dict(lag=0), "lag 1": dict(lag=1), "lag 2, AR shift 6": dict(lag=2, ar_shift=6),
    "lag 3, AR shift 9": dict(lag=3, ar_shift=9), "grain scale shift 3": dict(scale_shift=3),
    "grain scale shift 1": dict(scale_shift=1), "scaling shift 8": dict(scaling_shift=8),
    "scaling shift 11": dict(scaling_shift=11),
    "chroma from luma": dict(from_luma=True, point_cb=(), point_cr=()),
    "no luma points": dict(point_y=()), "one point": dict(point_y=((100, 60),)),
    "most points": dict(point_y=tuple((18 * k, (37 * k) % 200) for k in range(14)),
                        point_cb=tuple((25 * k, 20 + 9 * k) for k in range(10)),
                        point_cr=tuple((25 * k + 3, 110 - 9 * k) for k in range(10))),
    "multipliers": dict(cb=(30, 250, 100), cr=(200, 0, 500)), "overlap off": dict(overlap=False),
    "seed 0": dict(seed=0), "seed 65535": dict(seed=65535),
}


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
@pytest.mark.parametrize("name", sorted(TABLES))
def test_grain_tables_read_as_cv2(tmp_path, name, subsampling):
    """Each table at each subsampling; where libaom's encoder writes a
    table the syntax cannot carry (no luma points at 4:2:0 with chroma
    points), cv2 reads None and so does the port."""
    table = dict(TABLES[name])
    if subsampling == "4:0:0":  # libaom's encoder writes chroma grain a grey frame cannot carry
        table.update(point_cb=(), point_cr=(), from_luma=False)
    data = pil_table_avif(tmp_path, picture("gradient", 70, 90, len(name)), subsampling, **table)
    path = tmp_path / "x.avif"
    path.write_bytes(data)
    want = cv2_rgb(path)
    if want is None:
        assert imread(str(path)) is None
        assert name == "no luma points" and subsampling in ("4:2:0", "4:0:0")
        return
    assert header(data)[1] is not None
    check(tmp_path, data)


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("lag", [0, 1, 2, 3])
def test_rewritten_grain_at_every_depth_reads_exactly(tmp_path, depth, lag):
    rng = np.random.RandomState(10 * depth + lag)
    data = cv2_file(picture("gradient", 70, 91, lag), depth, 55)
    params = dict(seed=int(rng.randint(1 << 16)), point_y=[(0, 40), (128, 90), (255, 60)],
                  point_cb=[(0, 50), (255, 70)], point_cr=[(20, 30), (200, 80)], lag=lag,
                  ar_shift_minus_6=lag, scaling_minus_8=3 - lag, scale_shift=(lag + depth) % 4,
                  clip=bool(lag % 2), overlap=lag != 2, cb=(100, 170, 300), cr=(150, 90, 200),
                  **ar(rng, lag, 1))
    check(tmp_path, regrained(data, **params))


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_rewritten_grain_on_gbr_and_from_luma_reads_exactly(tmp_path, depth):
    """Lossless GBR (matrix 0): the restricted-range clip bounds chroma at
    the luma's 235; and ``chroma_scaling_from_luma`` clipped, on 4:2:0."""
    rng = np.random.RandomState(depth)
    gbr = cv2_file(picture("gradient", 40, 50, depth), depth, 100)
    assert header(gbr)[0].matrix == 0
    check(tmp_path, regrained(gbr, seed=9, point_y=[(0, 255), (255, 255)],
                              point_cb=[(0, 255)], point_cr=[(0, 200)], lag=1, clip=True,
                              **ar(rng, 1, 1)), "gbr.avif")
    lossy = cv2_file(picture("gradient", 45, 61, depth), depth, 40)
    check(tmp_path, regrained(lossy, seed=5, point_y=[(0, 60), (255, 60)], from_luma=True,
                              lag=1, clip=True, **ar(rng, 1, 1)), "cfl.avif")


@pytest.mark.parametrize("level,size", [(5, 64), (10, 96), (25, 64), (50, 128), (25, 200)])
def test_denoise_noise_levels_read_exactly(tmp_path, level, size):
    data = film_grain_avif(seed=level, level=level, size=size)
    assert header(data)[1] is not None
    check(tmp_path, data)


def test_corrupt_grain_headers_read_as_none(tmp_path):
    """libaom's ``read_film_grain_params`` refuses 15 luma points, points
    not increasing, and grain on one chroma plane at 4:2:0; cv2 then reads
    None, and so does the port."""
    data = cv2_file(picture("gradient", 30, 40), 8, 50)
    path = tmp_path / "x.avif"
    for params in (dict(point_y=[(k, 10) for k in range(15)]),
                   dict(point_y=[(10, 10), (10, 20)]),
                   dict(point_y=[(0, 10)], point_cb=[(0, 10)], point_cr=[], ar_cb=[0])):
        path.write_bytes(regrained(data, **params))
        assert cv2_rgb(path) is None and imread(str(path)) is None


def test_random_register_and_scaling_lut_follow_the_specification():
    """``get_random_number`` and the scaling function of section 7.18.3,
    transcribed here, against the module's."""
    reg = 0xB524
    rand = av1_grain._Random(reg)
    for bits in (11, 8, 11, 1, 16, 11):
        bit = ((reg >> 0) ^ (reg >> 1) ^ (reg >> 3) ^ (reg >> 12)) & 1
        reg = (reg >> 1) | (bit << 15)
        assert rand.take(bits) == (reg >> (16 - bits)) & ((1 << bits) - 1)
    points = [(0, 20), (40, 200), (41, 0), (255, 255)]
    lut = av1_grain._scaling_lut(points)
    want = [points[0][1]] * 256
    for (x0, y0), (x1, y1) in zip(points, points[1:]):
        delta = (y1 - y0) * ((65536 + ((x1 - x0) >> 1)) // (x1 - x0))
        for x in range(x1 - x0):
            want[x0 + x] = y0 + ((x * delta + 32768) >> 16)
    want[255] = 255
    np.testing.assert_array_equal(lut, want)
    index = np.arange(1 << 10)
    start, end = lut[index >> 2], lut[np.minimum((index >> 2) + 1, 255)]
    np.testing.assert_array_equal(av1_grain._scale(lut, index, 10),
                                  start + (((end - start) * (index & 3) + 2) >> 2))


def test_gaussian_sequence_is_the_specifications():
    g = av1_grain._GAUSSIAN
    assert g.shape == (2048,) and (g % 4 == 0).all()
    assert g[:8].tolist() == [56, 568, -180, 172, 124, -84, 172, -64]
    assert g[-4:].tolist() == [288, 944, 428, -484] and (g.min(), g.max()) == (-1752, 1688)


FIELDS = ("ar_coeff_lag", "ar_coeff_shift_minus_6", "grain_scale_shift",
          "grain_scaling_minus_8", "chroma_scaling_from_luma", "overlap_flag",
          "clip_to_restricted_range")


def test_every_parameter_is_reached(tmp_path):
    """Across these files, each field of ``film_grain_params`` takes each
    of its values (the scaling point lists, empty and not, up to the most
    libaom allows; ``grain_seed`` 0 and 65535; the multipliers and offsets
    off their neutral values), at 8, 10 and 12 bits, at 4:2:0, 4:2:2,
    4:4:4, grey and GBR; every file reads to cv2's array."""
    rng = np.random.RandomState(1)
    img = picture("gradient", 40, 50, 3)
    files = [pil_table_avif(tmp_path, img, s, lag=lag, ar_shift=6 + lag, scale_shift=lag,
                            scaling_shift=8 + lag, overlap=bool(lag % 2), seed=lag * 21845,
                            **(dict(point_cb=(), point_cr=()) if s == "4:0:0" else {}))
             for lag, s in zip(range(4), ("4:2:0", "4:2:2", "4:4:4", "4:0:0"))]
    files.append(pil_table_avif(tmp_path, img, "4:4:4", point_y=(), cb=(0, 255, 0)))
    files.append(pil_table_avif(tmp_path, img, "4:2:0", from_luma=True, point_cb=(),
                                point_cr=(), point_y=TABLES["most points"]["point_y"]))
    files.append(pil_table_avif(tmp_path, img, "4:2:0", **TABLES["most points"]))
    for depth in (10, 12):
        files.append(regrained(cv2_file(img, depth, 100), seed=3, point_y=[(0, 90)],
                               point_cb=[(9, 80)], point_cr=[(0, 70)], lag=2, clip=True,
                               cr=(255, 128, 511), **ar(rng, 2, 1)))
    seen = {k: set() for k in FIELDS + ("point_y", "point_cb", "point_cr", "seed", "mult")}
    forms = set()
    for k, data in enumerate(files):
        check(tmp_path, data, f"{k}.avif")
        seq, g = header(data)
        forms.add((seq.bit_depth, "mono" if seq.mono else (seq.ss_x, seq.ss_y), seq.matrix == 0))
        for name in FIELDS:
            seen[name].add(int(getattr(g, name)))
        for name in ("point_y", "point_cb", "point_cr"):
            seen[name].add(len(getattr(g, name)))
        seen["seed"].add(g.grain_seed)
        seen["mult"] |= {(name, getattr(g, name)) for name in
                         ("cb_mult", "cb_luma_mult", "cb_offset", "cr_mult", "cr_luma_mult",
                          "cr_offset") if getattr(g, "point_" + name[:2])}
    for name in FIELDS:
        assert seen[name] == set(range(4 if name[0] in "ag" else 2)), (name, seen[name])
    assert {0, 1, 14} <= seen["point_y"] and {0, 1, 10} <= seen["point_cb"] & seen["point_cr"]
    assert {0, 65535} <= seen["seed"]
    assert {("cb_mult", 0), ("cb_luma_mult", 255), ("cr_mult", 255), ("cr_offset", 511)} \
        <= seen["mult"]
    assert {d for d, _, _ in forms} == {8, 10, 12}
    assert {s for _, s, _ in forms} == {(1, 1), (1, 0), (0, 0), "mono"}
    assert (10, (0, 0), True) in forms  # GBR: chroma clipped as luma


def test_grain_writer_writes_the_parameters_given():
    """``av1_with_grain`` sets the sequence header's flag and writes every
    field given, as the port's header parser reads them back."""
    data = cv2_file(picture("gradient", 30, 40), 10, 50)
    params = dict(seed=4321, point_y=[(0, 40), (255, 60)], point_cb=[(3, 50)],
                  point_cr=[(9, 70), (200, 10)], lag=1, ar_y=[1, -2, 3, -4],
                  ar_cb=[5, 6, 7, 8, -9], ar_cr=[-1, 0, 1, 2, 3], ar_shift_minus_6=2,
                  scaling_minus_8=1, scale_shift=3, cb=(1, 2, 3), cr=(4, 5, 6), overlap=False,
                  clip=True)
    seq, g = header(regrained(data, **params))
    assert seq.film_grain and seq.bit_depth == 10
    assert (g.grain_seed, g.point_y, g.point_cb, g.point_cr, g.ar_coeff_lag) == (
        4321, [(0, 40), (255, 60)], [(3, 50)], [(9, 70), (200, 10)], 1)
    assert (g.ar_coeffs_y, g.ar_coeffs_cb, g.ar_coeffs_cr) == (
        params["ar_y"], params["ar_cb"], params["ar_cr"])
    assert (g.ar_coeff_shift_minus_6, g.grain_scaling_minus_8, g.grain_scale_shift) == (2, 1, 3)
    assert (g.cb_mult, g.cb_luma_mult, g.cb_offset, g.cr_mult, g.cr_luma_mult,
            g.cr_offset) == (1, 2, 3, 4, 5, 6)
    assert not g.overlap_flag and g.clip_to_restricted_range and not g.chroma_scaling_from_luma
