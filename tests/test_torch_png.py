"""The port's PNG reader against ``cv2.imread`` on every PNG form.

Files come from three writers: a hand encoder (:func:`encode_png`: every
colour type and bit depth, Adam7 interlace, each row filter, ``PLTE`` and
``tRNS``), ``cv2.imwrite`` (8/16-bit grey, BGR, BGRA, bilevel) and PIL
(palette at 1/2/4/8 bits, grey+alpha, 16-bit grey, transparency).  The
reference is ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``, and the
port must equal it exactly.  Other formats raise a ``ValueError`` that
names them.
"""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from molnextr_tpu_torch.data.png import read_png

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
FORMS = [(c, d) for c, ds in DEPTHS.items() for d in ds]
# tRNS where the PNG standard allows it: not beside an alpha channel
TRNS_CASES = [(c, d, t) for c, d in FORMS for t in ((False, True) if c in (0, 2, 3) else (False,))]
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
         (0, 1, 2, 2), (1, 0, 2, 1))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples -> (h, stride) bytes of packed rows."""
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * ch)
    per = 8 // depth
    flat = samples.reshape(h, w * ch).astype(np.uint8)
    pad = (-flat.shape[1]) % per
    flat = np.concatenate([flat, np.zeros((h, pad), np.uint8)], axis=1).reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (flat << shifts).sum(axis=2).astype(np.uint8)


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Filter each row with ``filters[y % len(filters)]`` (PNG types 0-4)."""
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        ftype = filters[y % len(filters)]
        res = []
        for x in range(len(row)):
            a = int(row[x - bpp]) if x >= bpp else 0
            b = int(prior[x])
            c = int(prior[x - bpp]) if x >= bpp else 0
            if ftype == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            else:
                pred = (0, a, b, (a + b) // 2)[ftype]
            res.append((int(row[x]) - pred) & 0xFF)
        out += bytes([ftype]) + bytes(res)
        prior = row
    return bytes(out)


def encode_png(samples: np.ndarray, color: int, depth: int, interlace: bool = False,
               filters=(0, 1, 2, 3, 4), plte: bytes = b"", trns: bytes = b"") -> bytes:
    """A PNG file of ``samples`` (h, w, channels of ``color``), values below
    ``2 ** depth``; rows filtered in turn by ``filters``."""
    h, w, ch = samples.shape
    assert ch == CHANNELS[color] and depth in DEPTHS[color]
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b""
        for y0, x0, dy, dx in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filter_rows(_pack(sub, depth), bpp, filters)
    else:
        raw = _filter_rows(_pack(samples, depth), bpp, filters)
    out = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                                  int(interlace)))
    if plte:
        out += _chunk(b"PLTE", plte)
    if trns:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def random_png(rng: np.random.RandomState, h: int, w: int, color: int, depth: int,
               interlace: bool, with_trns: bool, filters=(0, 1, 2, 3, 4)) -> bytes:
    """Seeded samples of one PNG form; palette images get a random PLTE
    with as many entries as the depth allows, at most 256."""
    ch = CHANNELS[color]
    plte = trns = b""
    if color == 3:
        n = 1 << depth
        plte = rng.randint(0, 256, 3 * n).astype(np.uint8).tobytes()
        samples = rng.randint(0, n, (h, w, 1))
        if with_trns:
            trns = rng.randint(0, 256, rng.randint(1, n + 1)).astype(np.uint8).tobytes()
    else:
        samples = rng.randint(0, 1 << depth, (h, w, ch))
        # smooth ramps too, so the filters see more than noise
        samples[::3] = (np.arange(w)[:, None] * 7 % (1 << depth))[None]
        if with_trns and color in (0, 2):
            trns = struct.pack(">" + "H" * ch, *[int(v) for v in samples[0, 0]])
    return encode_png(samples, color, depth, interlace, filters, plte, trns)


def cv2_rgb(path) -> np.ndarray:
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


def check_equal(path):
    want = cv2_rgb(path)
    got = read_png(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("color,depth,with_trns", TRNS_CASES)
def test_every_form_equals_cv2(tmp_path, color, depth, interlace, with_trns):
    """Every colour type x bit depth, with and without Adam7, each row
    filter in turn, with and without ``tRNS`` where the type allows it."""
    rng = np.random.RandomState(color * 100 + depth * 4 + 2 * interlace + with_trns)
    path = tmp_path / "x.png"
    path.write_bytes(random_png(rng, 19, 23, color, depth, interlace, with_trns))
    check_equal(path)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("color,depth", [(2, 8), (0, 2), (6, 16)])
def test_single_filter_images(tmp_path, color, depth, ftype):
    """Whole images under one filter type, interlaced, at widths where the
    last byte of a row is partly padding."""
    rng = np.random.RandomState(ftype)
    path = tmp_path / "f.png"
    path.write_bytes(random_png(rng, 13, 29, color, depth, True, False, (ftype,)))
    check_equal(path)


def test_sixteen_bit_keeps_the_high_byte(tmp_path):
    vals = np.array([[0x00FF, 0x0100, 0xFF80, 0x7F7F, 0xFFFF, 0x0000]], np.uint16)
    path = tmp_path / "g16.png"
    path.write_bytes(encode_png(vals[..., None], 0, 16))
    got = read_png(str(path))[..., 0]
    assert got.tolist() == [[0, 1, 255, 127, 255, 0]]
    check_equal(path)


def test_palette_index_past_plte_reads_black(tmp_path):
    idx = np.array([[0, 1, 2, 3]])[..., None]
    path = tmp_path / "p.png"
    path.write_bytes(encode_png(idx, 3, 2, plte=bytes([10, 20, 30, 40, 50, 60])))
    assert read_png(str(path))[0].tolist() == [[10, 20, 30], [40, 50, 60], [0, 0, 0], [0, 0, 0]]
    check_equal(path)


def test_bilevel_reads_0_and_255(tmp_path):
    bits = np.array([[0, 1, 1, 0, 1, 0, 0, 1, 1]])[..., None]
    path = tmp_path / "b.png"
    path.write_bytes(encode_png(bits, 0, 1))
    assert read_png(str(path))[..., 0].tolist() == [[0, 255, 255, 0, 255, 0, 0, 255, 255]]
    check_equal(path)


@pytest.mark.parametrize("form", ["grey8", "grey16", "bgr8", "bgr16", "bgra8", "bgra16",
                                  "bilevel"])
def test_files_written_by_cv2(tmp_path, form):
    rng = np.random.RandomState(len(form))
    h, w = 31, 45
    params = []
    if form.startswith("grey") or form == "bilevel":
        shape = (h, w)
    else:
        shape = (h, w, 3 if form.startswith("bgr8") or form == "bgr16" else 4)
    dtype = np.uint16 if form.endswith("16") else np.uint8
    img = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    if form == "bilevel":
        img = (img > 127).astype(np.uint8) * 255
        params = [cv2.IMWRITE_PNG_BILEVEL, 1]
    path = tmp_path / f"{form}.png"
    assert cv2.imwrite(str(path), img, params)
    if form == "bilevel":
        with open(path, "rb") as f:
            assert f.read()[24] == 1  # IHDR bit depth
    check_equal(path)


@pytest.mark.parametrize("form", ["P1", "P2", "P4", "P8", "P8-trns", "L-trns", "LA", "I;16",
                                  "RGBA", "RGB-trns"])
def test_files_written_by_pil(tmp_path, form):
    rng = np.random.RandomState(len(form) + 7)
    h, w = 17, 26
    path = tmp_path / "p.png"
    if form.startswith("P"):
        bits = int(form[1])
        n = 1 << bits
        img = Image.fromarray(rng.randint(0, n, (h, w)).astype(np.uint8), "P")
        img.putpalette(rng.randint(0, 256, 3 * n).astype(np.uint8).tolist())
        kw = {"bits": bits}
        if form.endswith("trns"):
            kw["transparency"] = bytes(rng.randint(0, 256, n).astype(np.uint8))
        img.save(path, **kw)
    elif form == "L-trns":
        Image.fromarray(rng.randint(0, 256, (h, w)).astype(np.uint8), "L").save(
            path, transparency=17)
    elif form == "LA":
        Image.fromarray(rng.randint(0, 256, (h, w, 2)).astype(np.uint8), "LA").save(path)
    elif form == "I;16":
        Image.fromarray(rng.randint(0, 65536, (h, w)).astype(np.uint16)).save(path)
    elif form == "RGBA":
        Image.fromarray(rng.randint(0, 256, (h, w, 4)).astype(np.uint8), "RGBA").save(path)
    else:
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8), "RGB").save(
            path, transparency=(1, 2, 3))
    check_equal(path)


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 21), w=st.integers(1, 21), form=st.sampled_from(FORMS),
       interlace=st.booleans(), trns=st.booleans(), seed=st.integers(0, 2 ** 31 - 1))
def test_random_sizes_equal_cv2(tmp_path_factory, h, w, form, interlace, trns, seed):
    """Sizes below one Adam7 block leave passes empty; one-pixel rows and
    columns reach every packing edge."""
    color, depth = form
    filters = tuple(np.random.RandomState(seed).randint(0, 5, 4))
    path = tmp_path_factory.mktemp("h") / "r.png"
    path.write_bytes(random_png(np.random.RandomState(seed), h, w, color, depth, interlace,
                                trns and color in (0, 2, 3), filters))
    check_equal(path)


def test_other_formats_raise_naming_them(tmp_path):
    from PIL import Image as PILImage

    img = np.zeros((8, 8, 3), np.uint8)
    jpg, tif, bmp = tmp_path / "x.jpg", tmp_path / "x.tif", tmp_path / "x.bmp"
    cv2.imwrite(str(jpg), img)
    cv2.imwrite(str(bmp), img)
    buf = io.BytesIO()
    PILImage.fromarray(img).save(buf, format="TIFF")
    tif.write_bytes(buf.getvalue())
    for path, name in ((jpg, "JPEG"), (tif, "TIFF"), (bmp, "BMP")):
        with pytest.raises(ValueError, match=f"not a PNG file \\({name}\\).*ROADMAP"):
            read_png(str(path))
    bad = tmp_path / "bad.png"
    bad.write_bytes(SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 16, 3, 0, 0, 0))
                    + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="unsupported PNG"):
        read_png(str(bad))
