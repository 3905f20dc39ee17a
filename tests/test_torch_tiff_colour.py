"""The TIFF forms beyond grey, RGB and palettes against ``cv2.imread``, exactly.

Files come from the hand encoders of ``torch_image_writers``
(``encode_tiff`` with ``thunderscan``, ``sgilog_rle``, ``ycbcr_blocks``,
``mh_to_rlew``, and JPEG-in-TIFF strips and tiles cut from ``encode_jpeg``
by ``jpeg_tables_and_body``) and from PIL's libtiff writer (JPEG-in-TIFF
RGB, grey, CMYK and YCbCr).  The reference is
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``; the port must equal
it with no tolerance, or read None where it reads None:

* ThunderScan 4-bit palettes (runs, 2- and 3-bit deltas, raw values, runs
  that reach the row end, short and long rows) and SGILog LogL, LogLuv
  (run-length) and LogLuv 24-bit, hand-encoded and fuzzed; CCITT RLE/W
  (``test_torch_tiff_rlew.py`` holds its survey);
* JPEG-in-TIFF (compression 7): YCbCr at every subsampling, in strips and
  tiles, with and without the subsampling tag, RGB, grey and CMYK, planar
  2, streams smaller than their strips, and what libtiff refuses (None);
* YCbCr raw data at every subsampling libtiff's RGBA interface reads, with
  ``ReferenceBlackWhite`` and ``YCbCrCoefficients``; CMYK contiguous and
  planar; CIE L*a*b* at 8 and 16 bits with a ``WhitePoint``; signed
  samples;
* the forms OpenCV 5.0 returns None for (each asserted on cv2 here) and
  compressions libtiff does not know (read as all-zero samples).
"""

import io
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_image_writers import (encode_jpeg, encode_tiff, jpeg_tables_and_body, lzw_compat,
                                 mh_to_rlew, sgilog_rle, thunderscan, ycbcr_blocks)

from molnextr_tpu_torch.data.image import imread
from molnextr_tpu_torch.data.tiff import decode_tiff

SIZES = [(1, 1), (5, 7), (17, 33), (40, 37)]


def cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def same(tmp_path, data, name="x.tif"):
    """The port reads ``data`` as cv2 does (None included); returns cv2's."""
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


def check(tmp_path, data):
    want = same(tmp_path, data)
    assert want is not None
    return want


def _tags(bps, spp, photometric, extra=None):
    tags = {258: (3, [bps] * spp), 259: (3, [1]), 262: (3, [photometric]), 277: (3, [spp])}
    tags.update(extra or {})
    return tags


def _picture(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    img = np.stack([(x * 7 + y * 3) % 256, (x * x + y) % 256, (y * 5 + 40) % 256], axis=2)
    return np.clip(img + rng.randint(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)


# -- ThunderScan ----------------------------------------------------------------------


def _cmap(seed, bits=4):
    return np.random.RandomState(seed).randint(0, 65536, 3 << bits).tolist()


@pytest.mark.parametrize("size", SIZES + [(3, 64), (2, 130)])
@pytest.mark.parametrize("runs", [False, True])
def test_thunderscan_palette(tmp_path, size, runs):
    """Runs (some reaching the row end), deltas and raw values; rows of
    several strips."""
    h, w = size
    rng = np.random.RandomState(h * w)
    v = (np.cumsum(rng.choice([-1, 0, 0, 0, 1, 3], (h, w)), axis=1) % 16).astype(np.int64)
    v[:, w // 2 :] = v[:, w // 2 : w // 2 + 1]  # runs to the row end
    for rows in (h, 2):
        chunks = [thunderscan(v[y : y + rows], runs, seed=y) for y in range(0, h, rows)]
        tags = _tags(4, 1, 3, {259: (3, [32809]), 320: (3, _cmap(w)), 278: (4, [rows])})
        check(tmp_path, encode_tiff(chunks, w, h, tags))


def test_thunderscan_grey_and_8_bits(tmp_path):
    """Grey at 4 bits: OpenCV 5.0 refuses it and the port reads libtiff's map
    (the 4-bit difference by design); ThunderScan at 8 bits reads as None."""
    h, w = 4, 9
    v = np.arange(h * w).reshape(h, w) % 16
    path = tmp_path / "g.tif"
    path.write_bytes(encode_tiff([thunderscan(v)], w, h, _tags(4, 1, 1, {259: (3, [32809])})))
    assert cv2.imread(str(path)) is None
    np.testing.assert_array_equal(imread(str(path))[..., 0], (v * 255 // 15).astype(np.uint8))
    same(tmp_path, encode_tiff([bytes(range(0xC0, 0xC0 + 36))], w, h,
                               _tags(8, 1, 1, {259: (3, [32809])})))


@pytest.mark.parametrize("seed", range(120))
def test_thunderscan_fuzz(tmp_path, seed):
    """Random code bytes: short and long rows (the rest of the row zeroed,
    and of the strip left zero), and empty strips (None), as libtiff
    decodes them."""
    rng = np.random.RandomState(seed)
    h, w = rng.randint(1, 9), rng.randint(1, 40)
    rows = rng.randint(1, h + 1)
    chunks = []
    for _ in range(0, h, rows):
        n = rng.randint(0, 3 * w * rows)
        chunks.append(rng.randint(0, 256, n).astype(np.uint8).tobytes())
    tags = _tags(4, 1, 3, {259: (3, [32809]), 320: (3, _cmap(seed)), 278: (4, [rows])})
    same(tmp_path, encode_tiff(chunks, w, h, tags))


# -- SGILog ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("runs", [False, True])
@pytest.mark.parametrize("form", [(1, 16), (2, 16), (1, 8)])
def test_logl(tmp_path, size, runs, form):
    """LogL (photometric 32844) read as ``256 sqrt(Y)`` of ``LogL16toY``;
    SampleFormat 1 or 2, 16 or 8 bits in the header."""
    h, w = size
    rng = np.random.RandomState(w)
    le = rng.randint(0, 32768, (h, w))
    le[:, ::3] = rng.randint(20000, 24000)  # runs of one luminance
    le[0, 0] |= 0x8000  # a negative luminance
    fmt, bits = form
    for rows in (h, 3):
        chunks = [sgilog_rle(le[y : y + rows], 2, runs) for y in range(0, h, rows)]
        tags = _tags(bits, 1, 32844, {259: (3, [34676]), 339: (3, [fmt]), 278: (4, [rows])})
        check(tmp_path, encode_tiff(chunks, w, h, tags))


@pytest.mark.parametrize("size", SIZES)
def test_logluv_run_length_and_24_bit(tmp_path, size):
    """LogLuv through ``LogLuv32toXYZ`` and ``LogLuv24toXYZ`` (the ``uv_row``
    cells, past them the neutral point) to ``XYZtoRGB24``."""
    h, w = size
    rng = np.random.RandomState(h)
    luv = (rng.randint(0x4000, 0x5200, (h, w)).astype(np.int64) << 16) \
        | (rng.randint(60, 120, (h, w)) << 8) | rng.randint(150, 200, (h, w))
    tags = _tags(16, 3, 32845, {259: (3, [34676]), 339: (3, [2] * 3)})
    check(tmp_path, encode_tiff([sgilog_rle(luv, 4)], w, h, tags))
    p24 = (rng.randint(300, 800, (h, w)).astype(np.int64) << 14) | rng.randint(0, 16400, (h, w))
    raw = b"".join(int(v).to_bytes(3, "big") for v in p24.ravel())
    tags = _tags(16, 3, 32845, {259: (3, [34677]), 339: (3, [2] * 3)})
    check(tmp_path, encode_tiff([raw], w, h, tags))


@pytest.mark.parametrize("seed", range(60))
def test_sgilog_fuzz(tmp_path, seed):
    """Random run-length bytes (short rows fail the strip) and cut 24-bit
    data, in LogL and LogLuv."""
    rng = np.random.RandomState(seed)
    h, w = rng.randint(1, 6), rng.randint(1, 20)
    kind = seed % 3
    per = (2, 4, 3)[kind] * w * h
    data = rng.randint(0, 256, rng.randint(per // 2, 2 * per + 2)).astype(np.uint8)
    if kind < 2:
        data[::5] = rng.randint(0, 140, len(data[::5]))
    ph, comp, spp = [(32844, 34676, 1), (32845, 34676, 3), (32845, 34677, 3)][kind]
    tags = _tags(16, spp, ph, {259: (3, [comp]), 339: (3, [2] * spp)})
    same(tmp_path, encode_tiff([data.tobytes()], w, h, tags))


# -- JPEG-in-TIFF ---------------------------------------------------------------------


def _jpeg_tiff(planes, factors, photometric, rows=None, tile=None, sub=None, tables=True,
               planar=1, extra=None):
    """Strips (``rows`` each) or tiles of abbreviated JPEG streams (or whole
    ones, ``tables`` False) and the ``JPEGTables`` stream."""
    h, w = planes[0].shape
    chunks, table = [], None
    groups = [planes] if planar == 1 else [[p] for p in planes]
    for group in groups:
        gf = factors if planar == 1 else [(1, 1)]
        if tile:
            for ty in range(0, h, tile):
                for tx in range(0, w, tile):
                    part = [np.pad(p[ty : ty + tile, tx : tx + tile],
                                   ((0, max(0, ty + tile - h)), (0, max(0, tx + tile - w))),
                                   mode="edge") for p in group]
                    table, body = jpeg_tables_and_body(encode_jpeg(part, gf))
                    chunks.append(body if tables else encode_jpeg(part, gf))
        else:
            step = rows or h
            for y in range(0, h, step):
                j = encode_jpeg([p[y : y + step] for p in group], gf)
                table, body = jpeg_tables_and_body(j)
                chunks.append(body if tables else j)
    n = len(planes)
    tags = _tags(8, n, photometric, {259: (3, [7]), 284: (3, [planar])})
    if tile:
        tags.update({322: (3, [tile]), 323: (3, [tile])})
    else:
        tags[278] = (4, [rows or h])
    if tables:
        tags[347] = (7, list(table))
    if sub:
        tags[530] = (3, list(sub))
    tags.update(extra or {})
    return encode_tiff(chunks, w, h, tags)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2), (4, 2), (1, 2), (4, 1)])
def test_jpeg_ycbcr_strips_and_tiles(tmp_path, size, sub):
    """YCbCr converted by libjpeg (fancy upsampling) as ``JPEGCOLORMODE_RGB``
    asks: strips, the last one short; tiles cropped at the edges; the
    subsampling tag or, without it, the first strip's own factors."""
    h, w = size
    planes = [_picture(h, w, h + w)[..., k] for k in range(3)]
    factors = [sub, (1, 1), (1, 1)]
    rows = 8 * sub[1]
    check(tmp_path, _jpeg_tiff(planes, factors, 6, rows=rows, sub=sub))
    check(tmp_path, _jpeg_tiff(planes, factors, 6, rows=rows, sub=None if sub != (2, 2) else sub))
    check(tmp_path, _jpeg_tiff(planes, factors, 6, tile=16, sub=sub))
    check(tmp_path, _jpeg_tiff(planes, factors, 6, sub=sub, tables=False))


@pytest.mark.parametrize("photometric,n", [(2, 3), (1, 1), (5, 4)])
@pytest.mark.parametrize("layout", ["strips", "tiles", "planar"])
def test_jpeg_rgb_grey_cmyk(tmp_path, photometric, n, layout):
    """Other photometrics come out of libjpeg unconverted, then through
    libtiff's map (CMYK's included); planar 2 has one stream a plane."""
    h, w = 37, 45
    img = _picture(h, w, n)
    planes = [img[..., k % 3] // (k + 1) for k in range(n)]
    if layout == "planar" and n == 1:
        return
    kw = {"strips": {"rows": 16}, "tiles": {"tile": 32}, "planar": {"planar": 2, "rows": 8}}
    check(tmp_path, _jpeg_tiff(planes, [(1, 1)] * n, photometric, **kw[layout]))


@pytest.mark.parametrize("mode", ["RGB", "L", "CMYK", "YCbCr"])
@pytest.mark.parametrize("options", [{}, {"tile": (32, 32)}])
def test_pil_jpeg_in_tiff(tmp_path, mode, options):
    img = Image.fromarray(_picture(50, 70, 3)).convert(mode)
    buf = io.BytesIO()
    try:
        img.save(buf, "TIFF", compression="jpeg", quality=80, **options)
    except (TypeError, OSError):  # this PIL's libtiff writer takes no tiles
        img.save(buf, "TIFF", compression="jpeg", quality=80)
    check(tmp_path, buf.getvalue())


def test_jpeg_in_tiff_planar_ycbcr_and_orientation(tmp_path):
    """Planar YCbCr JPEG streams are not converted by libjpeg but by
    libtiff's YCbCr tables; the orientation tag turns the result."""
    planes = [_picture(24, 30, 5)[..., k] for k in range(3)]
    check(tmp_path, _jpeg_tiff(planes, [(1, 1)] * 3, 6, planar=2, sub=(1, 1)))
    for orientation in (2, 3, 4):
        check(tmp_path, _jpeg_tiff(planes, [(2, 2), (1, 1), (1, 1)], 6, sub=(2, 2),
                                   extra={274: (3, [orientation])}))


@pytest.mark.parametrize("case", ["factors differ from the tag", "RGB subsampled",
                                  "stream taller than its strip", "wider stream",
                                  "12-bit stream", "bad tables"])
def test_jpeg_in_tiff_libtiff_refuses(tmp_path, case):
    """``JPEGPreDecode`` refuses a stream whose header does not fit the strip:
    cv2 reads None."""
    planes = [_picture(32, 40, 2)[..., k] for k in range(3)]
    if case == "factors differ from the tag":
        data = _jpeg_tiff(planes, [(1, 1)] * 3, 6, rows=16, sub=(2, 2))
    elif case == "RGB subsampled":
        data = _jpeg_tiff(planes, [(2, 2), (1, 1), (1, 1)], 2, rows=16)
    elif case == "stream taller than its strip":
        data = _jpeg_tiff(planes, [(1, 1)] * 3, 2, rows=32, extra={278: (4, [16])})
    elif case == "wider stream":
        table, body = jpeg_tables_and_body(encode_jpeg(planes, [(1, 1)] * 3))
        data = encode_tiff([body], 32, 32, _tags(8, 3, 2, {259: (3, [7]),
                                                           347: (7, list(table))}))
    elif case == "12-bit stream":
        j = encode_jpeg([p.astype(np.int64) * 16 for p in planes], [(1, 1)] * 3, precision=12)
        data = encode_tiff([j], 40, 32, _tags(8, 3, 2, {259: (3, [7])}))
    else:
        data = _jpeg_tiff(planes, [(1, 1)] * 3, 2, rows=16)
        data = data.replace(b"\xff\xc4", b"\xff\xc4\xff", 1)
    assert same(tmp_path, data) is None or case == "bad tables"


@pytest.mark.parametrize("seed", range(80))
def test_jpeg_in_tiff_fuzz(tmp_path, seed):
    """Seeded corruption of the strips' JPEG streams and of ``JPEGTables``:
    what libjpeg decodes, warns past or refuses (None), as cv2 reads it."""
    from molnextr_tpu_torch.data.tiff import _tags as read_tags

    rng = np.random.RandomState(seed)
    h, w = rng.randint(8, 40), rng.randint(8, 40)
    sub = [(1, 1), (2, 1), (2, 2)][seed % 3]
    planes = [_picture(h, w, seed)[..., k] for k in range(3)]
    data = bytearray(_jpeg_tiff(planes, [sub, (1, 1), (1, 1)], 6, rows=8 * sub[1], sub=sub))
    t = read_tags(bytes(data), "<", int.from_bytes(data[4:8], "little"))
    spans = [(o, o + n) for o, n in zip(t[273], t[279])]
    table = bytes(t[347])
    at = bytes(data).index(table)
    spans.append((at, at + len(table)))
    for _ in range(rng.randint(1, 4)):
        lo, hi = spans[rng.randint(len(spans))]
        data[rng.randint(lo, hi)] = rng.randint(0, 256)
    same(tmp_path, bytes(data))


@pytest.mark.parametrize("width,height", [(40, 32), (24, 40), (30, 36), (24, 29), (30, 29)])
def test_jpeg_in_tiff_smaller_stream_fills_what_it_has(tmp_path, width, height):
    """A stream narrower or shorter than its strip is only a warning in
    libtiff: its rows and columns are read, the rest is zero samples; a
    taller last strip is cut when its width is the image's, and refused
    (None) otherwise."""
    planes = [_picture(32, 24, 9)[..., k] for k in range(3)]
    table, body = jpeg_tables_and_body(encode_jpeg(planes, [(1, 1)] * 3))
    want = same(tmp_path, encode_tiff([body], width, height, _tags(8, 3, 2, {
        259: (3, [7]), 347: (7, list(table))})))
    assert (want is None) == (height < 32 and width != 24)


# -- YCbCr, CMYK, Lab, signed samples -------------------------------------------------


YCBCR_SUB = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sub", YCBCR_SUB)
def test_ycbcr_raw_subsampling(tmp_path, size, sub):
    """Raw YCbCr blocks (Deflate or none, strips and tiles), every
    subsampling of ``putcontig8bitYCbCr*tile``, each pixel with its block's
    chroma; a strip is read as whole block rows of libtiff's truncated
    scanline size."""
    h, w = size
    ycc = np.random.RandomState(h + w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    data = ycbcr_blocks(ycc, *sub)
    tags = _tags(8, 3, 6, {530: (3, list(sub)), 278: (4, [h])})
    check(tmp_path, encode_tiff([data], w, h, tags))
    tags[259] = (3, [8])
    check(tmp_path, encode_tiff([zlib.compress(data)], w, h, tags))
    tile = 16
    tiles = [ycbcr_blocks(np.pad(ycc[ty : ty + tile, tx : tx + tile],
                                 ((0, max(0, ty + tile - h)), (0, max(0, tx + tile - w)), (0, 0)),
                                 mode="edge"), *sub)
             for ty in range(0, h, tile) for tx in range(0, w, tile)]
    check(tmp_path, encode_tiff(tiles, w, h, _tags(8, 3, 6, {530: (3, list(sub)),
                                                              322: (3, [tile]), 323: (3, [tile])})))


@pytest.mark.parametrize("coefficients,reference", [
    (None, None), ([(299, 1000), (587, 1000), (114, 1000)], None),
    ([(2126, 10000), (7152, 10000), (722, 10000)], None),
    (None, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)]),
    ([(2990, 10000), (5870, 10000), (1140, 10000)],
     [(15, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)]),
    (None, [(0, 1), (255, 1), (0, 1), (255, 1), (0, 1), (255, 1)])])
def test_ycbcr_coefficients_and_reference_black_white(tmp_path, coefficients, reference):
    """``TIFFYCbCrToRGBInit``'s float tables from the two tags, in strips and
    planar 2 at 1x1."""
    h, w = 16, 256
    ycc = np.zeros((h, w, 3), np.uint8)
    ycc[..., 0] = np.arange(w)
    ycc[..., 1] = (np.arange(w)[None] * 7 + np.arange(h)[:, None] * 16) % 256
    ycc[..., 2] = (np.arange(w)[None] * 13 + np.arange(h)[:, None] * 40) % 256
    extra = {530: (3, [1, 1])}
    if coefficients:
        extra[529] = (5, coefficients)
    if reference:
        extra[532] = (5, reference)
    check(tmp_path, encode_tiff([ycc.tobytes()], w, h, _tags(8, 3, 6, extra)))
    extra[284] = (3, [2])
    check(tmp_path, encode_tiff([ycc[..., k].tobytes() for k in range(3)], w, h,
                                _tags(8, 3, 6, extra)))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("planar", [1, 2])
def test_cmyk(tmp_path, size, planar):
    h, w = size
    cmyk = np.random.RandomState(w).randint(0, 256, (h, w, 4)).astype(np.uint8)
    chunks = [cmyk.tobytes()] if planar == 1 else [cmyk[..., k].tobytes() for k in range(4)]
    check(tmp_path, encode_tiff(chunks, w, h, _tags(8, 4, 5, {284: (3, [planar])})))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("white", [None, [(3457, 10000), (3585, 10000)],
                                   [(31271, 100000), (32902, 100000)]])
def test_cielab(tmp_path, bits, white):
    """Every L and a grid of a*, b* (signed), through ``TIFFCIELabToXYZ`` and
    ``TIFFXYZToRGB`` with the white point of the tag (D50 without it)."""
    rng = np.random.RandomState(bits)
    h, w = 64, 64
    lab = np.zeros((h, w, 3), np.int64)
    lab[..., 0] = np.arange(h * w).reshape(h, w) % 256
    lab[..., 1] = rng.randint(0, 256, (h, w))
    lab[..., 2] = rng.randint(0, 256, (h, w))
    if bits == 16:
        lab = lab * 257 + rng.randint(0, 257, (h, w, 3))
        raw = lab.astype("<u2").tobytes()
    else:
        raw = lab.astype(np.uint8).tobytes()
    extra = {} if white is None else {318: (5, white)}
    check(tmp_path, encode_tiff([raw], w, h, _tags(bits, 3, 8, extra)))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("photometric,spp", [(1, 1), (0, 1), (2, 3), (3, 1), (1, 2)])
def test_signed_samples_read_as_their_bytes(tmp_path, bits, photometric, spp):
    """SampleFormat 2: libtiff's RGBA interface reads the unsigned bytes."""
    if photometric == 3 and bits == 16:
        return
    h, w = 9, 11
    top = (1 << bits) - 1
    v = np.random.RandomState(spp).randint(0, top + 1, (h, w, spp))
    raw = v.astype("<u2" if bits == 16 else np.uint8).tobytes()
    extra = {339: (3, [2] * spp)}
    if photometric == 3:
        extra[320] = (3, _cmap(1, 8))
    check(tmp_path, encode_tiff([raw], w, h, _tags(bits, spp, photometric, extra)))


@pytest.mark.parametrize("predictor", [3, 4])
def test_other_predictors_on_integers_are_ignored(tmp_path, predictor):
    img = _picture(7, 9, predictor)
    check(tmp_path, encode_tiff([img.tobytes()], 9, 7, _tags(8, 3, 2, {317: (3, [predictor])})))
    pal = bytes(range(1, 33))
    check(tmp_path, encode_tiff([pal], 8, 8, _tags(4, 1, 3, {317: (3, [2]),
                                                           320: (3, _cmap(2))})))


def test_ccitt_rle_w_raises_naming_it(tmp_path):
    """CCITT RLE/W (32771) raised naming it until the port decoded it: it
    now reads to cv2's array (libtiff aligns its rows by how many bytes its
    bit accumulator happened to load and by the parity of the strip's
    offset in the file; ``test_torch_tiff_rlew.py`` holds the survey)."""
    from molnextr_tpu_torch.data.tiff import _tags as read_tags

    h, w = 30, 77
    bits = np.random.RandomState(3).rand(h, w) < 0.2
    buf = io.BytesIO()
    Image.fromarray(bits).convert("1").save(buf, "TIFF", compression="tiff_ccitt")
    mh = buf.getvalue()
    t = read_tags(mh, "<", int.from_bytes(mh[4:8], "little"))
    strip = b"".join(mh[o : o + n] for o, n in zip(t[273], t[279]))
    path = tmp_path / "x.tif"
    path.write_bytes(encode_tiff([mh_to_rlew(strip, w, h)], w, h,
                                 _tags(1, 1, t[262][0], {259: (3, [32771])})))
    want = cv2.imread(str(path))
    assert want is not None
    np.testing.assert_array_equal(imread(str(path)), cv2.cvtColor(want, cv2.COLOR_BGR2RGB))


# -- None where OpenCV refuses, zeros where libtiff knows no codec ---------------------


NONE_FORMS = {
    "LZMA": {259: (3, [34925])}, "ZSTD": {259: (3, [50000])}, "WebP": {259: (3, [50001])},
    "JBIG": {259: (3, [34661])}, "LERC": {259: (3, [34887])}, "PixarLog": {259: (3, [32909])},
    "old-style JPEG": {259: (3, [6])}, "NeXT": {259: (3, [32766])},
    "12-bit": {258: (3, [12] * 3)}, "24-bit": {258: (3, [24] * 3)},
    "32-bit": {258: (3, [32] * 3)}, "64-bit": {258: (3, [64] * 3)},
    "float": {339: (3, [3] * 3)}, "float predictor": {339: (3, [3] * 3), 317: (3, [3])},
    "void samples": {339: (3, [4] * 3)}, "mixed formats": {339: (3, [1, 2, 1])},
    "ICC Lab": {262: (3, [9])}, "ITU Lab": {262: (3, [10])},
    "CMYK 16-bit": {262: (3, [5]), 277: (3, [4]), 258: (3, [16] * 4)},
    "CMYK of 3 inks": {262: (3, [5])}, "CMYK ink set 2": {262: (3, [5]), 277: (3, [4]),
                                                          258: (3, [8] * 4), 332: (3, [2])},
    "YCbCr 16-bit": {262: (3, [6]), 258: (3, [16] * 3), 530: (3, [1, 1])},
    "planar YCbCr 2x2": {262: (3, [6]), 284: (3, [2]), 530: (3, [2, 2])},
    "YCbCr 2x4": {262: (3, [6]), 530: (3, [2, 4])},
    "planar Lab": {262: (3, [8]), 284: (3, [2])},
    "Lab of 4 samples": {262: (3, [8]), 277: (3, [4]), 258: (3, [8] * 4), 338: (3, [0])},
    "YCbCr green coefficient 0": {262: (3, [6]), 530: (3, [1, 1]),
                                  529: (5, [(299, 1000), (0, 1), (114, 1000)])},
    "YCbCr reference of 2**31 - 1": {262: (3, [6]), 530: (3, [1, 1]), 532: (5, [
        (0, 1), (2**31 - 1, 1), (128, 1), (255, 1), (128, 1), (255, 1)])},
    "LogL without SGILog": {262: (3, [32844]), 277: (3, [1]), 258: (3, [16])},
    "SGILog RGB": {259: (3, [34676])}, "mask": {262: (3, [4]), 277: (3, [1]), 258: (3, [1])},
    "mixed depths": {258: (3, [8, 16, 8])}, "CCITT of RGB": {259: (3, [4])},
    "grey and alpha at 4 bits": {262: (3, [1]), 277: (3, [2]), 258: (3, [4, 4])},
    "palette at 4 bits without its map": {262: (3, [3]), 277: (3, [1]), 258: (3, [4])},
    "RGB of two samples": {277: (3, [2]), 258: (3, [8, 8])},
    "RGB at 4 bits": {258: (3, [4] * 3), 284: (3, [2])},
    "LogLuv without SGILog": {262: (3, [32845]), 258: (3, [16] * 3)},
    "photometric 7": {262: (3, [7])},
}


@pytest.mark.parametrize("name", sorted(NONE_FORMS))
def test_forms_opencv_5_refuses_read_as_none(tmp_path, name):
    path = tmp_path / "x.tif"
    tags = {**_tags(8, 3, 2), **NONE_FORMS[name]}
    path.write_bytes(encode_tiff([bytes(range(256)) * 4], 8, 8, tags))
    assert cv2.imread(str(path)) is None
    assert imread(str(path)) is None


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("rows", [1, 3, 0])
def test_old_style_lzw(tmp_path, size, rows):
    """LZW codes of before TIFF 5 (LSB first, widened at the width's
    limit), which libtiff's ``LZWDecodeCompat`` reads."""
    h, w = size
    rows = rows or h
    img = (np.random.RandomState(w).randint(0, 4, (h, w, 3)) * 60).astype(np.uint8)
    chunks = [lzw_compat(img[y : y + rows].tobytes()) for y in range(0, h, rows)]
    check(tmp_path, encode_tiff(chunks, w, h, _tags(8, 3, 2, {259: (3, [5]),
                                                             278: (4, [rows])})))


@pytest.mark.parametrize("seed", range(80))
def test_cut_and_corrupt_strips_read_as_far_as_libtiff_decodes(tmp_path, seed):
    """Strips of LZW (new and old style), Deflate, PackBits or none, cut or
    with bytes flipped, the IFD whole: libtiff decodes each as far as it
    can and the rest of the strip reads as zero samples (an uncompressed
    strip cut short is all zero, and its byte counts may look bad enough
    for libtiff to estimate them anew)."""
    rng = np.random.RandomState(seed)
    h, w, rows = rng.randint(2, 20), rng.randint(2, 20), rng.randint(1, 6)
    img = (np.random.RandomState(seed).randint(0, 6, (h, w, 3)) * 40).astype(np.uint8)
    kind = ["lzw", "old lzw", "deflate", "packbits", "none"][seed % 5]
    pack = {"lzw": None, "old lzw": lzw_compat, "deflate": zlib.compress, "none": bytes,
            "packbits": lambda b: pack_bits_runs(b)}[kind]
    code = {"lzw": 5, "old lzw": 5, "deflate": 8, "packbits": 32773, "none": 1}[kind]
    chunks = []
    for y in range(0, h, rows):
        part = img[y : y + rows]
        if kind == "lzw":
            enc = cv2.imencode(".tiff", part[..., ::-1], [cv2.IMWRITE_TIFF_COMPRESSION, 5,
                                                          cv2.IMWRITE_TIFF_ROWSPERSTRIP, rows])[1]
            from molnextr_tpu_torch.data.tiff import _tags as read_tags

            t = read_tags(enc.tobytes(), "<", int.from_bytes(enc[4:8].tobytes(), "little"))
            chunk = enc.tobytes()[t[273][0] : t[273][0] + t[279][0]]
        else:
            chunk = pack(part.tobytes())
        chunk = bytearray(chunk)
        if rng.rand() < 0.5 and len(chunk) > 1:
            chunk = chunk[: rng.randint(1, len(chunk))]
        else:
            for _ in range(rng.randint(1, 3)):
                chunk[rng.randint(len(chunk))] = rng.randint(0, 256)
        chunks.append(bytes(chunk))
    same(tmp_path, encode_tiff(chunks, w, h, _tags(8, 3, 2, {259: (3, [code]),
                                                             278: (4, [rows])})))


def pack_bits_runs(raw: bytes) -> bytes:
    """PackBits: runs of two or more as runs, the rest as literals of up to
    128 bytes."""
    out, i = bytearray(), 0
    while i < len(raw):
        n = 1
        while i + n < len(raw) and raw[i + n] == raw[i] and n < 128:
            n += 1
        if n >= 2:
            out += bytes([257 - n, raw[i]])
            i += n
            continue
        j = i + 1
        while j < len(raw) and j - i < 128 and not (j + 1 < len(raw) and raw[j] == raw[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + raw[i:j]
        i = j
    return bytes(out)


@pytest.mark.parametrize("bits,spp,count", [(8, 1, None), (8, 1, 700), (16, 1, 768),
                                            (8, 3, None), (8, 1, 768)])
def test_palette_without_a_valid_map_reads_as_grey(tmp_path, bits, spp, count):
    """A ColorMap of another count than 3 * 2**bits is ignored; a palette
    image at 8 bits or more without one reads as grey, as
    ``TIFFReadDirectory`` redefines it (of three samples: None, two of
    them made extra samples first)."""
    rng = np.random.RandomState(bits + spp)
    raw = rng.randint(0, 256, 6 * 7 * spp * bits // 8).astype(np.uint8).tobytes()
    extra = {} if count is None else {320: (3, rng.randint(0, 65536, count).tolist())}
    want = same(tmp_path, encode_tiff([raw], 7, 6, _tags(bits, spp, 3, extra)))
    assert (want is None) == (spp == 3)


def _without_byte_counts(data: bytes) -> bytes:
    """The TIFF with its StripByteCounts or TileByteCounts tag renumbered to
    a private tag libtiff ignores."""
    import struct

    ifd = struct.unpack_from("<I", data, 4)[0]
    out = bytearray(data)
    for k in range(struct.unpack_from("<H", data, ifd)[0]):
        at = ifd + 2 + 12 * k
        if struct.unpack_from("<H", out, at)[0] in (279, 325):
            struct.pack_into("<H", out, at, 40000)
    return bytes(out)


@pytest.mark.parametrize("layout", ["raw", "deflate", "two strips", "planar deflate",
                                    "planar raw", "tile", "tall strip"])
def test_missing_byte_counts_are_estimated_as_libtiff_does(tmp_path, layout):
    """Without byte counts libtiff estimates them for one strip or tile (one
    a plane): the file past its header, IFD and tag values when
    compressed, the rows' bytes when not; more strips read as None."""
    img = _picture(20, 30, 4)
    base = _tags(8, 3, 2)
    if layout in ("raw", "tall strip"):
        data = encode_tiff([img.tobytes()], 30, 20, {**base, 278: (4, [40 if layout != "raw"
                                                                        else 20])})
    elif layout == "deflate":
        data = encode_tiff([zlib.compress(img.tobytes())], 30, 20, {**base, 259: (3, [8])})
    elif layout == "two strips":
        data = encode_tiff([zlib.compress(img[:10].tobytes()), zlib.compress(img[10:].tobytes())],
                           30, 20, {**base, 259: (3, [8]), 278: (4, [10])})
    elif layout.startswith("planar"):
        pack = zlib.compress if layout == "planar deflate" else bytes
        data = encode_tiff([pack(img[..., k].tobytes()) for k in range(3)], 30, 20,
                           {**base, 259: (3, [8 if layout == "planar deflate" else 1]),
                            284: (3, [2])})
    else:
        tile = np.pad(img, ((0, 12), (0, 2), (0, 0)))
        data = encode_tiff([zlib.compress(tile.tobytes())], 30, 20,
                           {**base, 259: (3, [8]), 322: (3, [32]), 323: (3, [32])})
    want = same(tmp_path, _without_byte_counts(data))
    assert (want is None) == (layout == "two strips")


@pytest.mark.parametrize("rows_per_strip", [20, 8947848, 8947849, 2**31, 2**32 - 2, 2**32 - 1])
def test_rows_per_strip_past_opencvs_buffer_limit_reads_as_none(tmp_path, rows_per_strip):
    """OpenCV sizes its RGBA buffer by RowsPerStrip as written (2**32 - 1:
    the whole image) and refuses one of 1 GiB or more: None."""
    img = _picture(20, 30, 1)
    want = same(tmp_path, encode_tiff([img.tobytes()], 30, 20,
                                      _tags(8, 3, 2, {278: (4, [rows_per_strip])})))
    assert (want is None) == (rows_per_strip != 2**32 - 1 and rows_per_strip * 30 * 4 >= 1 << 30)


@pytest.mark.parametrize("compression", [9, 10, 34712, 33003, 33005, 34892, 34926, 34927, 32908,
                                         32767, 65000])
@pytest.mark.parametrize("photometric", [1, 0, 2, 3])
def test_compressions_libtiff_does_not_know_read_as_zero_samples(tmp_path, compression,
                                                                 photometric):
    """libtiff's default codec fails every strip and the RGBA interface goes
    on: each pixel is what sample 0 maps to (black, white, the first
    palette entry)."""
    spp = 3 if photometric == 2 else 1
    extra = {259: (3, [compression])}
    if photometric == 3:
        extra[320] = (3, _cmap(7, 8))
    want = check(tmp_path, encode_tiff([bytes(range(1, 100))], 6, 5,
                                       _tags(8, spp, photometric, extra)))
    assert (want == want[0, 0]).all()
