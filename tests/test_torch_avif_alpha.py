"""The port's AVIF alpha item (``data/avif.py::_decode_alpha``) against
``cv2.imread``, exactly.

libavif decodes the alpha item of the primary image (an ``av01`` item or a
grid of them, found by its ``auxl`` reference and its ``auxC`` URN) before
OpenCV drops it, so a file whose alpha libavif refuses reads as None.  The
port decodes it too and drops the planes.  Probed on cv2 5.0 (libavif
1.4.2 over libaom 3.14.1), from Pillow's files and items put together by
``torch_image_writers.avif_with_alpha`` and ``avif_grid``:

* an alpha stream cut or with bytes flipped, an alpha of another ``ispe``
  size than the colour image, of another decoded depth (8 against 10
  bits), or whose ``pixi`` disagrees with its ``av1C``: None;
* an alpha frame of another size than its own ``ispe`` (libavif rescales
  it to the ``ispe``), an ``av1C`` depth that disagrees with the stream
  where there is no ``pixi``, and a monochrome, 4:2:0 or 4:4:4 alpha
  against any colour format: read;
* an alpha grid whose tiles differ in size, format or depth, or one of
  whose tiles is cut or flipped, or whose tiles do not cover it: None;
  an alpha grid of 4:2:0 tiles: read;
* with alpha OpenCV asks libavif for BGRA, and the colour converts
  otherwise above 8 bits: libyuv takes 10-bit samples as they are (chroma
  filtered at 10 bits) and 12-bit 4:2:0 unfiltered (libaom's files at 10
  and 12 bits, 4:2:0, 4:2:2 and 4:4:4, read exactly); grey with alpha
  reads as None;
* a sequence's alpha track (Pillow's RGBA ``avis``): its first sample
  decoded, flipped bytes reading as None where cv2 reads None.

Before the port decoded the alpha item it read an image for every file
that reads as None here (the test that pins it puts the old behaviour
back: alpha located, not decoded).
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image
from test_torch_avif import check, cv2_rgb
from torch_image_writers import aom_avif, aom_encode, avif_boxes, avif_grid, avif_with_alpha

from molnextr_tpu_torch.data import avif
from molnextr_tpu_torch.data.image import imread


def pil(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "AVIF", **kw)
    return buf.getvalue()


def colour(h=40, w=50, subsampling="4:2:0", seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([(xx * 3 + yy + seed * 30) % 256, yy * 4 % 256, (xx + 2 * yy) % 256], -1)
    return pil(rgb.astype(np.uint8), quality=60, subsampling=subsampling)


def grey(h=40, w=50, subsampling="4:0:0", seed=0):
    ramp = ((np.mgrid[0:h, 0:w][1] * 5 + seed * 30) % 256).astype(np.uint8)
    return pil(np.dstack([ramp] * 3), quality=60, subsampling=subsampling)


def ten_bit(h=40, w=50, channels=1):
    ramp = (np.mgrid[0:h, 0:w][1] * 20 % 1024).astype(np.uint16)
    img = ramp if channels == 1 else np.dstack([ramp] * channels)
    ok, buf = cv2.imencode(".avif", img, [cv2.IMWRITE_AVIF_DEPTH, 10, cv2.IMWRITE_AVIF_QUALITY, 60])
    assert ok
    return buf.tobytes()


def payload(single):
    boxes = avif_boxes(single)
    return single[boxes[b"mdat"][0] + 8 : boxes[b"mdat"][1]]


def flipped(data, seed, start=0):
    """A byte flipped in the second half of ``data[start:]``."""
    rng = np.random.RandomState(seed)
    d = bytearray(data)
    d[rng.randint(start + (len(d) - start) // 2, len(d))] ^= 0xFF
    return bytes(d)


def alpha_av1c(data, set_bits=0, clear_bits=0):
    """The alpha item's ``av1C`` flags byte changed (its box is the second)."""
    d = bytearray(data)
    k = d.find(b"av1C", d.find(b"av1C") + 1) + 6
    d[k] = (d[k] | set_bits) & ~clear_bits & 0xFF
    return bytes(d)


def aom(depth, subsampling, seed=0, h=40, w=50):
    """libaom's file of seeded samples at ``depth`` bits (grey for 4:0:0)."""
    rng = np.random.RandomState(seed)
    sx, sy = {"4:2:0": (1, 1), "4:2:2": (1, 0), "4:4:4": (0, 0), "4:0:0": (1, 1)}[subsampling]
    planes = [rng.randint(0, 1 << depth, (h, w))]
    if subsampling != "4:0:0":
        planes += [rng.randint(0, 1 << depth, ((h + sy) >> sy, (w + sx) >> sx)) for _ in "uv"]
    return aom_avif(aom_encode(planes, depth, subsampling, q=20))


def tiles(kind, n=6, h=80, w=96):
    make = {"colour": lambda k: colour(h, w, seed=k), "grey": lambda k: grey(h, w, seed=k),
            "grey 4:2:0": lambda k: grey(h, w, "4:2:0", seed=k)}[kind]
    return [make(k) for k in range(n)]


def _cases():
    a = grey()
    cases = {
        "sound": lambda: avif_with_alpha(colour(), a),
        "alpha of another ispe than its frame": lambda: avif_with_alpha(
            colour(), grey(40, 52), alpha_ispe=(50, 40)),
        "4:2:0 alpha": lambda: avif_with_alpha(colour(), grey(subsampling="4:2:0")),
        "4:4:4 alpha": lambda: avif_with_alpha(colour(), grey(subsampling="4:4:4")),
        "monochrome alpha, 4:4:4 colour": lambda: avif_with_alpha(
            colour(subsampling="4:4:4"), a),
        "10-bit colour and alpha": lambda: avif_with_alpha(ten_bit(channels=3), ten_bit()),
        "alpha av1C says 10 bits, no pixi": lambda: alpha_av1c(
            avif_with_alpha(colour(), a), set_bits=0x40).replace(b"pixi", b"zzzz"),
        "alpha av1C not monochrome": lambda: alpha_av1c(avif_with_alpha(colour(), a),
                                                        clear_bits=0x10),
        "alpha grid": lambda: avif_grid(tiles("colour"), 2, 3, alpha=tiles("grey")),
        "alpha grid of 4:2:0 tiles": lambda: avif_grid(tiles("colour"), 2, 3,
                                                       alpha=tiles("grey 4:2:0")),
        "alpha grid, output cropped": lambda: avif_grid(tiles("colour"), 2, 3,
                                                        alpha=tiles("grey"), size=(280, 160)),
    }
    for depth in (10, 12):
        for sub in ("4:2:0", "4:2:2", "4:4:4"):
            cases[f"{depth}-bit {sub} with alpha"] = (
                lambda depth=depth, sub=sub: avif_with_alpha(aom(depth, sub, 1),
                                                             aom(depth, "4:0:0", 2)))
    refused = {
        "alpha wider": lambda: avif_with_alpha(colour(), grey(40, 52)),
        "alpha shorter": lambda: avif_with_alpha(colour(), grey(38, 50)),
        "alpha twice the size": lambda: avif_with_alpha(colour(), grey(80, 100)),
        "10-bit alpha, 8-bit colour": lambda: avif_with_alpha(colour(), ten_bit()),
        "8-bit alpha, 10-bit colour": lambda: avif_with_alpha(ten_bit(channels=3), a),
        "alpha av1C says 10 bits against its pixi": lambda: alpha_av1c(
            avif_with_alpha(colour(), a), set_bits=0x40),
        "alpha grid tile of another size": lambda: avif_grid(
            tiles("colour"), 2, 3, alpha=tiles("grey")[:5] + [grey(80, 98)]),
        "alpha grid 4:2:0 tile among monochrome": lambda: avif_grid(
            tiles("colour"), 2, 3, alpha=tiles("grey")[:5] + [colour(80, 96)]),
        "alpha grid tile flipped": lambda: avif_grid(
            tiles("colour"), 2, 3, alpha=tiles("grey")[:5] + [flipped(grey(80, 96), 1, avif_boxes(
                grey(80, 96))[b"mdat"][0] + 8)]),
        "alpha grid tile cut": lambda: avif_grid(
            tiles("colour"), 2, 3, alpha=tiles("grey")[:5] + [grey(80, 96)[:-20]]),
        "alpha grid 10-bit tile among 8-bit": lambda: avif_grid(
            tiles("colour"), 2, 3, alpha=tiles("grey")[:5] + [ten_bit(80, 96)]),
        "10-bit alpha grid, 8-bit colour": lambda: avif_grid(
            tiles("colour"), 2, 3, alpha=[ten_bit(80, 96)] * 6),
        "grey with alpha": lambda: avif_with_alpha(grey(), a),
        "10-bit grey with alpha": lambda: avif_with_alpha(aom(10, "4:0:0", 3),
                                                          aom(10, "4:0:0", 4)),
    }
    for cut in (45, 23, 5):
        refused[f"alpha stream cut to {cut} bytes"] = (
            lambda cut=cut: avif_with_alpha(colour(), a, alpha_payload=payload(a)[:cut]))
    for seed in range(6):
        refused[f"alpha stream flipped, seed {seed}"] = (
            lambda seed=seed: avif_with_alpha(colour(), a, alpha_payload=flipped(payload(a), seed)))
    return cases, refused


READ, REFUSED = _cases()


@pytest.mark.parametrize("name", sorted(READ))
def test_sound_alpha_reads_exactly(tmp_path, name):
    check(tmp_path, READ[name]())


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_alpha_reads_as_none(tmp_path, name):
    path = tmp_path / "x.avif"
    path.write_bytes(REFUSED[name]())
    assert cv2_rgb(path) is None
    assert imread(str(path)) is None


def test_the_port_read_these_before_it_decoded_alpha(tmp_path, monkeypatch):
    """With the alpha item located and not decoded (the port before this
    reader decoded it), every refused file but grey with alpha (which the
    colour conversion refuses) reads as an image: the fault."""
    monkeypatch.setattr(avif, "_decode_alpha", lambda *args: None)
    path = tmp_path / "x.avif"
    for name in sorted(n for n in REFUSED if "grey" not in n):
        path.write_bytes(REFUSED[name]())
        assert imread(str(path)) is not None, name


def test_alpha_writer_lays_out_two_items():
    data = avif_with_alpha(colour(), grey())
    f = avif._Avif(data)
    item = f.items[f.primary]
    alpha = avif._alpha_item(f, item)
    assert item.type == alpha.type == b"av01" and alpha.id == 2
    assert f.payload(alpha) == payload(grey())


def test_sequence_alpha_track_reads_as_cv2(tmp_path):
    """Pillow's RGBA sequence: its alpha track's first sample decoded, so
    flipped bytes there read as None where cv2 reads None (and a flip in
    a later sample is not read at all)."""
    yy, xx = np.mgrid[0:40, 0:50]
    rgb = np.stack([(xx * 3 + yy) % 256, yy * 4 % 256, (xx + 2 * yy) % 256], -1)
    frames = [Image.fromarray(np.dstack([np.roll(rgb, k, 1), xx * 3 % 256]).astype(np.uint8))
              for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:], quality=60)
    data = buf.getvalue()
    check(tmp_path, data)
    f = avif._Avif(data)
    (track,) = [t for t in f.tracks if t.auxl]
    rng = np.random.RandomState(0)
    path = tmp_path / "x.avif"
    nones = 0
    for k in range(8):
        offset, size = track.samples[min(k, 7) // 7]  # the first sample, then the second
        d = bytearray(data)
        d[offset + rng.randint(size // 2, size)] ^= 0xFF
        path.write_bytes(bytes(d))
        want = cv2_rgb(path)
        got = imread(str(path))
        if want is None:
            nones += 1
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    assert nones
