"""CCITT RLE/W (TIFF compression 32771) in the port (``data/ccitt.py``
through ``data/tiff.py``) against ``cv2.imread`` of a file, exactly.

RLE/W is Modified Huffman with each row aligned to a 16-bit word.  libtiff
(``Fax3DecodeRLE`` under ``FAXMODE_WORDALIGN``) drops the bits its
accumulator holds past a multiple of 16 at the end of a row and, when none
are left and its byte pointer is odd, skips a byte.  The fax codecs read
the strip where libtiff maps the file, so that parity is the byte's offset
in the file: the same strip reads differently at an even and an odd offset
(``cv2.imdecode``, which reads from a buffer of its own, does not see the
offset; the JAX package calls ``cv2.imread``).  Files come from
``torch_image_writers.rlew_strips`` (Pillow's MH strips re-aligned to
words: each row padded to a word of its strip, a layout libtiff misreads
where its accumulator holds a word at a row's end, or each row where
libtiff reads it at the strip's offset parity) and ``rlew_tiff`` (the
strips at chosen offsets): several strips a file at even, odd and mixed
offsets, every photometric and fill order, strips cut mid-row and seeded
byte flips, which libtiff repairs as ``tif_fax3.h`` does ("Bad code
word", "Premature EOL", "Line length mismatch") and cv2 still reads.
"""

import cv2
import numpy as np
import pytest
from torch_image_writers import encode_tiff, rlew_strips, rlew_tiff

from molnextr_tpu_torch.data import ccitt
from molnextr_tpu_torch.data.image import imread


def cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def check(tmp_path, data, name="x.tif"):
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


def bits(h, w, seed, density=None):
    rng = np.random.RandomState(seed)
    p = density if density is not None else rng.choice([0.03, 0.2, 0.5])
    out = rng.rand(h, w) < p
    out[rng.randint(0, h), :] = True  # a long black run
    return out


def offsets_for(strips, parity, rng):
    """Ascending offsets from 8 with the given parity ("even", "odd",
    "mixed") and gaps of 0-5 bytes."""
    out, at = [], 8
    for k, strip in enumerate(strips):
        want = {"even": 0, "odd": 1}.get(parity, k % 2)
        at += rng.randint(0, 4)
        if at % 2 != want:
            at += 1
        out.append(at)
        at += len(strip)
    return out


@pytest.mark.parametrize("parity", ["even", "odd", "mixed"])
@pytest.mark.parametrize("seed", range(8))
def test_strips_at_even_and_odd_offsets(tmp_path, seed, parity):
    rng = np.random.RandomState(seed)
    h, w = int(rng.randint(2, 40)), int(rng.randint(1, 140))
    rps = int(rng.randint(1, h + 1))
    strips, photometric = rlew_strips(bits(h, w, seed), rps)
    data = rlew_tiff(strips, w, h, rps, photometric, offsets_for(strips, parity, rng))
    assert check(tmp_path, data) is not None


def test_the_offset_parity_changes_what_cv2_reads(tmp_path):
    """A strip whose rows end with the accumulator empty reads differently
    at an even and an odd offset; the port follows both."""
    seen = 0
    for seed in range(12):
        h, w = 20, 37 + seed
        strips, photometric = rlew_strips(bits(h, w, 50 + seed, 0.3), h)
        reads = [check(tmp_path, rlew_tiff(strips, w, h, h, photometric, [8 + k]))
                 for k in (0, 1)]
        seen += not np.array_equal(*reads)
    assert seen


@pytest.mark.parametrize("rows_per_strip", [1, 3, 16, 40])
def test_rows_laid_where_libtiff_reads_them(tmp_path, rows_per_strip):
    """Strips laid out for libtiff at their offset's parity
    (``rlew_strips(..., odd=...)``) read intact in cv2 and the port, at even,
    odd and mixed offsets; each strip placed at the other parity reads
    otherwise, in both alike."""
    rng = np.random.RandomState(rows_per_strip)
    h, w = 40, 75
    picture = bits(h, w, rows_per_strip, 0.25)
    n = -(-h // rows_per_strip)
    rows, photometric = rlew_strips(picture, 1)  # one row a strip: no row ends inside one
    reference = check(tmp_path, rlew_tiff(rows, w, h, 1, photometric))
    for parity in ("even", "odd", "mixed"):
        odd = [{"even": False, "odd": True}.get(parity, bool(k % 2)) for k in range(n)]
        strips, photometric = rlew_strips(picture, rows_per_strip, odd)
        placed = offsets_for(strips, parity, rng)
        intact = check(tmp_path, rlew_tiff(strips, w, h, rows_per_strip, photometric, placed))
        flipped = [at + 1 for at in placed]
        other = check(tmp_path, rlew_tiff(strips, w, h, rows_per_strip, photometric, flipped))
        np.testing.assert_array_equal(intact, reference)
        assert rows_per_strip == 1 or not np.array_equal(other, intact)


@pytest.mark.parametrize("layout", ["libtiff", "words"])
def test_tiles(tmp_path, layout):
    """RLE/W tiles (each a strip of the tile's rows, edge tiles padded),
    laid out for libtiff or padded to words of the tile."""
    rng = np.random.RandomState(len(layout))
    h, w, tw, th = 40, 50, 32, 16
    picture = rng.rand(h, w) < 0.2
    tiles, photometric = [], 0
    for ty in range(0, h, th):
        for tx in range(0, w, tw):
            block = np.zeros((th, tw), bool)
            part = picture[ty : ty + th, tx : tx + tw]
            block[: part.shape[0], : part.shape[1]] = part
            (tile,), photometric = rlew_strips(block, th, False if layout == "libtiff" else None)
            tiles.append(tile)
    assert check(tmp_path, encode_tiff(tiles, w, h, {
        258: (3, [1]), 259: (3, [32771]), 262: (3, [photometric]), 277: (3, [1]),
        322: (3, [tw]), 323: (3, [th])})) is not None


@pytest.mark.parametrize("fill_order", [1, 2])
@pytest.mark.parametrize("photometric", [0, 1])
def test_photometric_and_fill_order(tmp_path, photometric, fill_order):
    rng = np.random.RandomState(photometric * 2 + fill_order)
    h, w = 31, 53
    strips, _ = rlew_strips(bits(h, w, 7), 8)
    data = rlew_tiff(strips, w, h, 8, photometric, offsets_for(strips, "mixed", rng),
                     fill_order)
    check(tmp_path, data)


@pytest.mark.parametrize("width", [1, 2, 7, 8, 15, 16, 17, 31, 32, 33, 63, 64, 65])
def test_widths_around_words(tmp_path, width):
    """Rows whose codes end on, before and after a word boundary."""
    for parity in ("even", "odd"):
        strips, photometric = rlew_strips(bits(12, width, width), 5)
        data = rlew_tiff(strips, width, 12, 5, photometric,
                         offsets_for(strips, parity, np.random.RandomState(width)))
        check(tmp_path, data)


@pytest.mark.parametrize("seed", range(6))
def test_cut_and_damaged_strips(tmp_path, seed):
    """Strips cut mid-row and bytes flipped: libtiff repairs the rows (runs
    padded or clipped, a bad code ending its row) and stops a strip at its
    data's end, the rest zero; cv2 still reads the file."""
    rng = np.random.RandomState(100 + seed)
    h, w = 24, int(rng.randint(20, 90))
    strips, photometric = rlew_strips(bits(h, w, seed), 6)
    for _ in range(6):
        damaged = []
        for strip in strips:
            s = bytearray(strip)
            if rng.rand() < 0.5:
                s = s[: rng.randint(1, len(s) + 1)]
            for _ in range(rng.randint(0, 3)):
                s[rng.randint(0, len(s))] = rng.randint(0, 256)
            damaged.append(bytes(s))
        for parity in ("even", "odd"):
            check(tmp_path, rlew_tiff(damaged, w, h, 6, photometric,
                                      offsets_for(damaged, parity, rng)))


def test_decode_strip_reads_word_aligned_rows():
    """``decode_strip`` on an RLE/W strip at an even offset reads every
    row back (each starts on a word of the strip); at an odd offset the
    rows after one that left the accumulator empty start a byte late, as
    libtiff's do, and the strip reads otherwise."""
    h, w = 6, 16
    rows = np.zeros((h, w), bool)
    rows[:, :8] = True
    strip = rlew_strips(rows, h)[0][0]
    even, ok = ccitt.decode_strip(strip, w, h, 32771, 0, ccitt.FaxState(w, False), False)
    assert ok and (even == even[0]).all() and sorted(np.bincount(even[0])) == [8, 8]
    odd, _ = ccitt.decode_strip(strip, w, h, 32771, 0, ccitt.FaxState(w, False), True)
    assert not np.array_equal(odd, even)
