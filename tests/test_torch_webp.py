"""The port's WebP reader (``data/webp.py``, ``data/vp8.py``, ``data/vp8l.py``)
against ``cv2.imread``, exactly.

Files come from ``cv2.imwrite`` and PIL (lossy at qualities 0-100 and
methods 0-6, lossless, alpha, animations, EXIF orientations 1-8, ICC and
XMP chunks, sizes 1 x 1 to 67 x 131) and from the hand encoders of
``torch_image_writers`` for what those encoders never write: VP8 key frames
with the simple filter, filter level 0, sharpness 1-7, loop-filter deltas,
2, 4 and 8 token partitions, segment maps with absolute and delta values,
no skip probability, coefficient probability updates, every 16 x 16,
chroma and 4 x 4 mode on the frame's edges, sizes off the 16 grid and
coefficients whose products overflow 16 bits; VP8L streams with each
predictor, cross colour, subtract green, palettes of 2, 4, 16 and 256
colours, colour caches of 1-11 bits, meta prefix codes, simple and normal
codes and copies at short and long distances, overlapping; ``ALPH`` chunks
of each filter, raw and lossless; animations with offset and smaller first
frames; and a seeded corpus of cut, flipped and mis-sized files, where the
port reads None exactly where cv2 does.

Behaviours found by test (OpenCV 5.0 on libwebp 1.6): a file under 32
bytes reads as None; the decoder reads the last bitstream to the end of the
file, past its chunk and the RIFF size; a bad ``ALPH`` chunk fails a lossy
image even without the alpha flag, and alpha is dropped uncomposited; an
animation reads as its first frame on a black canvas, its blend bit and
background colour unused; EXIF turns the image only with the ``VP8X``
EXIF flag and a layout ``WebPDemux`` accepts, and OpenCV's EXIF reader
takes Motorola order unless the block starts ``II``, keeps the entries
before one that runs past the block, and reads the orientation as a SHORT
whatever its type; ICC profiles are not applied.  One difference by design:
for a ``VP8X`` canvas beyond OpenCV's size limits ``cv2.imread`` raises
``cv2.error`` where the port reads None.
"""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_image_writers import (alph_chunk, encode_vp8, encode_vp8l, encode_webp,
                                 exif_block, vp8x)

from molnextr_tpu_torch.data.exif import apply_orientation
from molnextr_tpu_torch.data.image import imread
from molnextr_tpu_torch.data.webp import decode_webp, read_webp

SIZES = [(1, 1), (3, 5), (16, 16), (17, 33), (67, 131)]


def cv2_rgb(path):
    try:
        img = cv2.imread(str(path))
    except cv2.error:  # beyond OpenCV's size limits (module doc)
        return None
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def check(tmp_path, data, name="x.webp"):
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
        np.testing.assert_array_equal(decode_webp(data), want)
    return want


def picture(h, w, seed=0):
    """Gradients, noise and a flat band: every predictor and filter has work."""
    rng = np.random.RandomState(seed)
    yy, xx = np.indices((h, w))
    img = np.stack([(5 * yy + 3 * xx) % 256, rng.randint(0, 256, (h, w)),
                    (7 * xx * yy) % 256], 2)
    img[h // 3 : h // 3 + 2] = 250
    return img.astype(np.uint8)


def pil_webp(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def chunks(data):
    """(fourcc, payload) of a RIFF file's chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, size = data[pos : pos + 4], struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        out.append((tag, data[pos + 8 : pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


# -- files from cv2 and PIL ------------------------------------------------------


@pytest.mark.parametrize("quality", [0, 1, 10, 25, 50, 75, 90, 100])
def test_cv2_lossy_qualities(tmp_path, quality):
    for h, w in SIZES:
        img = picture(h, w, quality)
        data = cv2.imencode(".webp", img[..., ::-1],
                            [cv2.IMWRITE_WEBP_QUALITY, max(quality, 1)])[1].tobytes()
        assert check(tmp_path, data) is not None


@pytest.mark.parametrize("method", range(7))
def test_pil_lossy_methods(tmp_path, method):
    for quality in (0, 50, 100):
        for h, w in SIZES[1:]:
            check(tmp_path, pil_webp(picture(h, w, method), quality=quality, method=method))


@pytest.mark.parametrize("method", range(7))
def test_pil_lossless_methods(tmp_path, method):
    for quality in (0, 60, 100):
        for h, w in SIZES:
            img = picture(h, w, method)
            data = pil_webp(img, lossless=True, quality=quality, method=method)
            _exact(check(tmp_path, data), img, data)


def test_cv2_lossless_is_exact(tmp_path):
    for h, w in SIZES:
        img = picture(h, w, 7)
        data = cv2.imencode(".webp", img[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, 101])[1].tobytes()
        _exact(check(tmp_path, data), img, data)


def _exact(got, img, data):
    """A lossless file reads as its picture, or as None under 32 bytes."""
    if len(data) < 32:
        assert got is None
    else:
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("lossless", [False, True])
def test_alpha_is_decoded_and_dropped(tmp_path, lossless):
    """RGB as cv2 reads it, uncomposited; the port's alpha plane is PIL's."""
    for h, w in SIZES[1:]:
        img = picture(h, w, 3)
        alpha = ((np.indices((h, w)).sum(0) * 11) % 256).astype(np.uint8)
        alpha[: h // 2, : w // 2] = 0
        rgba = np.dstack([img, alpha])
        for kw in ({"quality": 40, "alpha_quality": 100}, {"quality": 90, "alpha_quality": 30,
                                                           "method": 6}):
            data = pil_webp(rgba, lossless=lossless, exact=True, **kw)
            want = check(tmp_path, data)
            pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
            np.testing.assert_array_equal(want, pil[..., :3])
            np.testing.assert_array_equal(read_webp(data)[1], pil[..., 3])


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientations(tmp_path, orientation):
    img = picture(4, 6, orientation)
    exif = Image.Exif()
    exif[0x0112] = orientation
    for kw in ({"lossless": True}, {"quality": 90}):
        want = check(tmp_path, pil_webp(img, exif=exif.tobytes(), **kw))
        if kw.get("lossless"):
            np.testing.assert_array_equal(want, apply_orientation(img, orientation))
    for order in "<>":  # a hand EXIF chunk in both byte orders
        lossless = chunks(pil_webp(img, lossless=True))[0][1]
        data = encode_webp([(b"VP8X", vp8x(0x08, 6, 4)), (b"VP8L", lossless),
                            (b"EXIF", exif_block(orientation, order))])
        np.testing.assert_array_equal(check(tmp_path, data), apply_orientation(img, orientation))


def _exif(entries, order="<", head=None, count=None):
    o = order
    out = (head or (b"II" if o == "<" else b"MM")) + struct.pack(o + "HI", 42, 8)
    out += struct.pack(o + "H", len(entries) if count is None else count)
    for tag, typ, n, value in entries:
        out += struct.pack(o + "HHI", tag, typ, n) + value
    return out + bytes(4)


@pytest.mark.parametrize("case", ["flag_off", "alph_before_vp8l", "second_image", "prefix",
                                  "long_type", "head_mi", "count_past_end", "bad_string_first",
                                  "bad_string_after", "two_orientations", "cut_value"])
def test_exif_where_opencv_applies_it(tmp_path, case):
    img = picture(4, 6, 1)
    lossless = chunks(pil_webp(img, lossless=True))[0][1]
    short = lambda v, o="<": struct.pack(o + "HH", v, 0)  # noqa: E731
    block, flags, extra = exif_block(6, "<"), 0x08, []
    if case == "flag_off":
        flags = 0
    elif case == "alph_before_vp8l":
        extra = [(b"ALPH", b"\x00" + bytes(24))]
    elif case == "prefix":
        block = b"Exif\x00\x00" + block
    elif case == "long_type":
        block = _exif([(0x112, 4, 1, struct.pack(">I", 6))], ">")
    elif case == "head_mi":
        block = _exif([(0x112, 3, 1, short(6, ">"))], ">", head=b"MI")
    elif case == "count_past_end":
        block = _exif([(0x112, 3, 1, short(6))], count=3)
    elif case == "bad_string_first":
        block = _exif([(0x10F, 2, 20, struct.pack("<I", 100)), (0x112, 3, 1, short(6))])
    elif case == "bad_string_after":
        block = _exif([(0x112, 3, 1, short(6)), (0x10F, 2, 20, struct.pack("<I", 100))])
    elif case == "two_orientations":
        block = _exif([(0x112, 3, 1, short(6)), (0x112, 3, 1, short(3))])
    elif case == "cut_value":
        block = _exif([(0x112, 3, 1, short(6))])[:19]
    image = [(b"VP8L", lossless)] * (2 if case == "second_image" else 1)
    data = encode_webp([(b"VP8X", vp8x(flags, 6, 4))] + extra + image + [(b"EXIF", block)])
    check(tmp_path, data)


@pytest.mark.parametrize("lossless", [False, True])
def test_pil_animation_reads_as_first_frame(tmp_path, lossless):
    frames = [Image.fromarray(picture(20, 30, k)) for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=100,
                   lossless=lossless, quality=80)
    want = check(tmp_path, buf.getvalue())
    if lossless:
        np.testing.assert_array_equal(want, np.asarray(frames[0]))


def _anim(canvas, frames, flags=0x12, background=0xFFFFFFFF):
    out = [(b"VP8X", vp8x(flags, *canvas)), (b"ANIM", struct.pack("<IH", background, 0))]
    for x, y, w, h, bits, sub in frames:
        body = b"".join(struct.pack("<I", v)[:3] for v in (x // 2, y // 2, w - 1, h - 1, 100))
        body += bytes([bits]) + b"".join(tag + struct.pack("<I", len(p)) + p + bytes(len(p) & 1)
                                         for tag, p in sub)
        out.append((b"ANMF", body))
    return encode_webp(out)


@pytest.mark.parametrize("bits", range(4))
def test_animation_canvas_offsets_and_blending(tmp_path, bits):
    """Black around a smaller, offset first frame; its RGB even where its
    alpha is 0, whatever the blend and dispose bits."""
    img = picture(6, 8, bits)
    alpha = np.where(np.indices((6, 8)).sum(0) % 3 == 0, 0, 200).astype(np.uint8)
    frame = chunks(pil_webp(np.dstack([img, alpha]), lossless=True, exact=True))
    lossy = chunks(pil_webp(np.dstack([img, alpha]), quality=70))
    lossy = [c for c in lossy if c[0] in (b"ALPH", b"VP8 ")]
    for x, y, canvas in ((0, 0, (8, 6)), (4, 2, (13, 11)), (3, 5, (12, 12))):
        want = check(tmp_path, _anim(canvas, [(x, y, 8, 6, bits, frame)]))
        x0, y0 = x // 2 * 2, y // 2 * 2
        np.testing.assert_array_equal(want[y0 : y0 + 6, x0 : x0 + 8], img)
        assert want.sum() == img.astype(np.int64).sum()
        check(tmp_path, _anim(canvas, [(x, y, 8, 6, bits, lossy), (0, 0, 8, 6, 0, frame)]))
    for bad in ((4, 0, (8, 6)), (0, 0, (7, 6))):  # outside the canvas
        assert check(tmp_path, _anim(bad[2], [(bad[0], bad[1], 8, 6, bits, frame)])) is None
    orient = _anim((8, 6), [(0, 0, 8, 6, bits, frame)], flags=0x1A)
    orient = orient[:4] + struct.pack("<I", len(orient) - 8 + 34) + orient[8:] \
        + b"EXIF" + struct.pack("<I", 26) + exif_block(6, "<")
    np.testing.assert_array_equal(check(tmp_path, orient), apply_orientation(img, 6))


def test_container_chunks_and_sizes(tmp_path):
    img = picture(9, 14, 2)
    lossless = chunks(pil_webp(img, lossless=True))[0][1]
    lossy = chunks(pil_webp(img, quality=60))[0][1]
    from PIL import ImageCms

    lab = ImageCms.ImageCmsProfile(ImageCms.createProfile("LAB")).tobytes()
    with_icc = pil_webp(img, lossless=True, icc_profile=lab)
    assert chunks(with_icc)[1][0] == b"ICCP"
    np.testing.assert_array_equal(check(tmp_path, with_icc), img)  # ICC not applied
    for tag, payload in ((b"VP8L", lossless), (b"VP8 ", lossy)):
        plain = encode_webp([(tag, payload)])
        assert check(tmp_path, plain) is not None
        assert check(tmp_path, plain + b"trailing bytes") is not None
        assert check(tmp_path, plain[:-3]) is None
        for flags in (0, 0x04, 0x20, 0x3E, 0x01, 0xC0):
            for extra in ([], [(b"ICCP", b"abc")], [(b"XMP ", b"<x/>")], [(b"ABCD", b"q")]):
                check(tmp_path, encode_webp([(b"VP8X", vp8x(flags, 14, 9))] + extra
                                            + [(tag, payload), (b"ZZZZ", b"tail")]))
        assert check(tmp_path, encode_webp([(b"VP8X", vp8x(0, 15, 9)), (tag, payload)])) is None
        riff = bytearray(plain)
        for delta in (-9, -2, -1, 1, 2):
            riff[4:8] = struct.pack("<I", len(plain) - 8 + delta)
            check(tmp_path, bytes(riff))
        short_chunk = bytearray(plain)  # the bitstream is read past its chunk
        short_chunk[16:20] = struct.pack("<I", len(payload) - 10)
        assert check(tmp_path, bytes(short_chunk)) is not None
    assert check(tmp_path, encode_webp([(b"VP8L", lossless)])[:31]) is None


def test_canvas_past_opencvs_limits_reads_as_none(tmp_path):
    """By design: ``cv2.imread`` raises ``cv2.error`` on a ``VP8X`` canvas
    past its size limits (2^20 a side, 2^30 pixels); the port reads None,
    for a still image (which cannot match such a canvas) and for an
    animation whose small first frame would fit it."""
    lossless = chunks(pil_webp(picture(6, 8), lossless=True))[0][1]
    for data in (encode_webp([(b"VP8X", vp8x(0, 8, 1 << 21)), (b"VP8L", lossless)]),
                 _anim((8, (1 << 20) + 2), [(0, 0, 8, 6, 0, [(b"VP8L", lossless)])]),
                 _anim((1 << 15, (1 << 15) + 2), [(0, 0, 8, 6, 0, [(b"VP8L", lossless)])])):
        path = tmp_path / "big.webp"
        path.write_bytes(data)
        with pytest.raises(cv2.error):
            cv2.imread(str(path))
        assert imread(str(path)) is None


# -- hand-encoded VP8 -------------------------------------------------------------


def _mbs(w, h, seed, ymodes=None, big=False, skip=0.0):
    rng = np.random.RandomState(seed)
    out = []
    for k in range(((w + 15) // 16) * ((h + 15) // 16)):
        levels = np.zeros((25, 16), int)
        mask = rng.rand(25, 16) < 0.35
        levels[mask] = rng.randint(-2114 if big else -40, 2115 if big else 41, mask.sum())
        y = ymodes(k) if ymodes else (int(rng.randint(4)) if rng.rand() < 0.5
                                      else [int(v) for v in rng.randint(0, 10, 16)])
        out.append({"y": y, "uv": int(rng.randint(4)), "levels": levels,
                    "segment": int(rng.randint(4)), "skip": bool(rng.rand() < skip),
                    "eob": bool(rng.rand() < 0.8)})
    return out


VP8_FORMS = {
    "simple_filter": dict(simple=1, level=30),
    "level_0": dict(level=0),
    "level_63": dict(level=63),
    "no_skip_probability": dict(skip_prob=None),
    "skip_probability": dict(skip_prob=100, skip=0.4),
    "partitions_2": dict(partitions=2),
    "partitions_4": dict(partitions=4),
    "partitions_8": dict(partitions=8),
    "segments_absolute": dict(segments={"absolute": True, "quant": [5, 40, 90, 127],
                                        "filter": [0, 10, 40, 63], "probs": [120, 30, 200]}),
    "segments_delta": dict(segments={"absolute": False, "quant": [-30, -5, 20, 60],
                                     "filter": [-20, 0, 15, 30], "probs": [0, 255, 1]}),
    "segments_no_map": dict(segments={"absolute": True, "quant": [60, 1, 1, 1],
                                      "filter": [20, 0, 0, 0], "probs": None}),
    "lf_deltas": dict(lf_deltas=([10, -3, 4, 5], [-12, 7, 1, 2]), level=25),
    "q_deltas": dict(q_deltas=[-7, 5, -15, 15, 3], q_index=70),
    "q_0_and_127": dict(q_index=0, q_deltas=[-15, -15, -15, -15, -15]),
    "proba_updates": dict(proba_updates={(t, b, c, p): (t * 37 + b * 11 + c * 5 + p) % 256
                                         for t in range(4) for b in range(8)
                                         for c in range(3) for p in range(11)
                                         if (t + b + c + p) % 3 == 0}),
    "overflowing_coefficients": dict(big=True, q_index=127, q_deltas=[15, 15, 15, 15, 15]),
    "profile_3": dict(profile=3),
    "colour_space_and_clamping_bits": dict(colour_bits=(1, 1)),
}
VP8_FORMS.update({f"sharpness_{s}": dict(sharpness=s, level=20 + 5 * s) for s in range(1, 8)})


@pytest.mark.parametrize("form", sorted(VP8_FORMS))
def test_hand_vp8_forms(tmp_path, form):
    kw = dict(VP8_FORMS[form])
    big, skip = kw.pop("big", False), kw.pop("skip", 0.0)
    for k, (w, h) in enumerate([(37, 21), (16, 16), (5, 67), (64, 48)]):
        frame = encode_vp8(w, h, _mbs(w, h, k, big=big, skip=skip), **kw)
        assert check(tmp_path, encode_webp([(b"VP8 ", frame)])) is not None


@pytest.mark.parametrize("mode", range(4))
def test_hand_vp8_16x16_and_chroma_modes_on_every_edge(tmp_path, mode):
    for w, h in ((48, 48), (33, 17), (1, 1)):
        mbs = _mbs(w, h, mode, ymodes=lambda k: mode)
        for mb in mbs:
            mb["uv"] = mode
        assert check(tmp_path, encode_webp([(b"VP8 ", encode_vp8(w, h, mbs))])) is not None


@pytest.mark.parametrize("mode", range(10))
def test_hand_vp8_4x4_modes_on_every_edge(tmp_path, mode):
    """A 4 x 4 mode in every block of a 3 x 3 macroblock frame: the top row,
    the left column and the last column (its above-right replicated)."""
    for w, h in ((48, 48), (41, 35)):
        mbs = _mbs(w, h, mode, ymodes=lambda k: [mode] * 16)
        assert check(tmp_path, encode_webp([(b"VP8 ", encode_vp8(w, h, mbs))])) is not None


def test_hand_vp8_scale_bits_are_ignored(tmp_path):
    frame = encode_vp8(37, 21, _mbs(37, 21, 2))
    want = check(tmp_path, encode_webp([(b"VP8 ", frame)]))
    for xs, ys in ((1, 0), (0, 2), (3, 3)):
        scaled = frame[:6] + struct.pack("<HH", 37 | xs << 14, 21 | ys << 14) + frame[10:]
        np.testing.assert_array_equal(check(tmp_path, encode_webp([(b"VP8 ", scaled)])), want)


def test_hand_vp8_broken_frames(tmp_path):
    frame = encode_vp8(40, 40, _mbs(40, 40, 1), partitions=2)
    for bad in (frame[:3], frame[:9], bytes([frame[0] | 1]) + frame[1:],  # not a key frame
                bytes([frame[0] & ~0x10]) + frame[1:],  # not shown
                bytes([frame[0] | 0x0E]) + frame[1:],  # version 7
                frame[:3] + b"\x9d\x01\x2b" + frame[6:],  # start code
                frame[:6] + b"\x00\x00" + frame[8:],  # width 0
                frame[: len(frame) - 20], frame[:40]):
        assert check(tmp_path, encode_webp([(b"VP8 ", bad)])) is None


# -- hand-encoded VP8L -----------------------------------------------------------


def _argb(seed, h=13, w=21):
    rng = np.random.RandomState(seed)
    img = picture(h, w, seed).astype(np.uint32)
    img[3:6] = img[2]
    img[:, 10:] = img[:, 9:10]
    alpha = rng.randint(0, 256, (h, w)).astype(np.uint32)
    return (alpha << 24) | (img[..., 0] << 16) | (img[..., 1] << 8) | img[..., 2]


def _rgb(argb):
    return np.stack([(argb >> 16) & 255, (argb >> 8) & 255, argb & 255], 2).astype(np.uint8)


def _vp8l_check(tmp_path, argb, **kw):
    want = check(tmp_path, encode_webp([(b"VP8L", encode_vp8l(argb, **kw))]))
    np.testing.assert_array_equal(want, _rgb(argb))


@pytest.mark.parametrize("mode", range(16))
def test_hand_vp8l_predictor_modes(tmp_path, mode):
    """Each predictor (14 and 15 predict as 0) over every tile."""
    _vp8l_check(tmp_path, _argb(mode),
                transforms=[{"kind": "predictor", "bits": 2, "modes": np.full((4, 6), mode)}])


VP8L_FORMS = {
    "predictor_mixed": dict(transforms=[{"kind": "predictor", "bits": 3,
                                         "modes": np.arange(6).reshape(2, 3) * 3 % 16}]),
    "cross_colour": dict(transforms=[{"kind": "cross", "bits": 2,
                                      "multipliers": (np.arange(72).reshape(4, 6, 3) * 53) % 256
                                      - 128}]),
    "subtract_green": dict(transforms=[{"kind": "green"}]),
    "all_three": dict(transforms=[{"kind": "green"},
                                  {"kind": "cross", "bits": 2,
                                   "multipliers": (np.arange(72).reshape(4, 6, 3) * 29) % 256
                                   - 128},
                                  {"kind": "predictor", "bits": 2,
                                   "modes": np.arange(24).reshape(4, 6) % 14}]),
    "meta_codes": dict(meta=(2, np.arange(24).reshape(4, 6) % 3)),
    "meta_codes_unused_group": dict(meta=(3, np.array([[0, 2, 2], [2, 0, 0]]))),
    "meta_with_cache": dict(meta=(2, np.arange(24).reshape(4, 6) % 5), cache_bits=4,
                            distances=[1, 2, 21, 22]),
    "normal_codes": dict(simple=False),
    "no_repeat_codes": dict(repeats=False, trim=False),
    "short_distances": dict(distances=[1, 2, 3, 20, 21, 22, 43], plane=True),
    "long_distances": dict(distances=[1, 21, 2 * 21 + 5, 100, 250], plane=False),
    "overlapping_copies": dict(distances=[1, 2, 3], min_len=2),
    "sub_image_cache": dict(transforms=[{"kind": "predictor", "bits": 2,
                                         "modes": np.arange(24).reshape(4, 6) % 14}],
                            sub_cache=3),
}
VP8L_FORMS.update({f"cache_{b}": dict(cache_bits=b, distances=[1, 21]) for b in range(1, 12)})


@pytest.mark.parametrize("form", sorted(VP8L_FORMS))
def test_hand_vp8l_forms(tmp_path, form):
    _vp8l_check(tmp_path, _argb(len(form)), **VP8L_FORMS[form])


@pytest.mark.parametrize("colours", [2, 3, 4, 5, 16, 17, 256])
def test_hand_vp8l_palettes(tmp_path, colours):
    """Colour indexing, bundled 8, 4 and 2 to a pixel below 17 colours, alone
    and under a predictor on the narrowed image."""
    rng = np.random.RandomState(colours)
    pal = rng.randint(0, 1 << 32, colours, dtype=np.uint64).astype(np.uint32)
    argb = pal[rng.randint(0, colours, (13, 21))]
    palette = {"kind": "palette", "colours": pal}
    _vp8l_check(tmp_path, argb, transforms=[palette])
    _vp8l_check(tmp_path, argb, transforms=[palette, {"kind": "predictor", "bits": 2,
                                                      "modes": np.full((4, 6), 11)}])


def test_hand_vp8l_broken_streams(tmp_path):
    argb = _argb(3)
    stream = encode_vp8l(argb, cache_bits=3, distances=[1, 21])
    for bad in (stream[:4], stream[:10], stream[: len(stream) // 2], stream[:-1],
                bytes([0x2E]) + stream[1:],  # signature
                stream[:4] + bytes([stream[4] | 0x20]) + stream[5:]):  # version 1
        assert check(tmp_path, encode_webp([(b"VP8L", bad)])) is None


# -- ALPH ---------------------------------------------------------------------------


@pytest.mark.parametrize("filtering", range(4))
@pytest.mark.parametrize("lossless", [False, True])
def test_alph_filters_and_compressions(tmp_path, filtering, lossless):
    h, w = 19, 27
    img = picture(h, w, 5)
    lossy = chunks(cv2.imencode(".webp", img[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, 70])[1]
                   .tobytes())[0][1]
    alpha = (np.add.outer(np.arange(h) * 9, np.arange(w) * 5) % 256).astype(np.uint8)
    alpha[5:9, 3:20] = np.random.RandomState(filtering).randint(0, 256, (4, 17))
    kws = [{}] if not lossless else [{}, {"cache_bits": 3, "distances": [1, w]}]
    for kw in kws:
        data = encode_webp([(b"VP8X", vp8x(0x10, w, h)),
                            (b"ALPH", alph_chunk(alpha, filtering, lossless, **kw)),
                            (b"VP8 ", lossy)])
        assert check(tmp_path, data) is not None
        np.testing.assert_array_equal(read_webp(data)[1], alpha)
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        np.testing.assert_array_equal(pil[..., 3], alpha)


def test_alph_palette_stream_may_end_in_its_last_symbol(tmp_path):
    """An alpha plane of colour indexing alone is decoded a byte per pixel,
    and libwebp lets that stream end inside its last symbol."""
    h, w = 6, 9
    lossy = chunks(cv2.imencode(".webp", picture(h, w)[..., ::-1],
                                [cv2.IMWRITE_WEBP_QUALITY, 70])[1].tobytes())[0][1]
    alpha = np.random.RandomState(0).choice([0, 9, 255], (h, w)).astype(np.uint8)
    cols = (np.unique(alpha).astype(np.uint32) << 8) | 0xFF000000
    full = alph_chunk(alpha, 0, True, transforms=[{"kind": "palette", "colours": cols}])
    read = []
    for cut in range(len(full) - 5, len(full) + 1):
        data = encode_webp([(b"VP8X", vp8x(0x10, w, h)), (b"ALPH", full[:cut]), (b"VP8 ", lossy)])
        read.append(check(tmp_path, data) is not None)
    assert read == [False] * 4 + [True, True]


@pytest.mark.parametrize("flags", [0x10, 0])
def test_broken_alph_fails_the_image(tmp_path, flags):
    h, w = 8, 10
    lossy = chunks(cv2.imencode(".webp", picture(h, w)[..., ::-1],
                                [cv2.IMWRITE_WEBP_QUALITY, 70])[1].tobytes())[0][1]
    for body in (b"", b"\x00", b"\x02" + bytes(w * h), b"\x20" + bytes(w * h),
                 b"\x40" + bytes(w * h), b"\x00" + bytes(w * h - 1), b"\x01\xff\xff"):
        data = encode_webp([(b"VP8X", vp8x(flags, w, h)), (b"ALPH", body), (b"VP8 ", lossy)])
        assert check(tmp_path, data) is None
    ok = encode_webp([(b"VP8X", vp8x(flags, w, h)), (b"ALPH", b"\x10" + bytes(w * h)),
                      (b"VP8 ", lossy)])
    assert check(tmp_path, ok) is not None


# -- seeded fuzz --------------------------------------------------------------------


def _fuzz_seeds():
    img = picture(21, 35, 9)
    rgba = np.dstack([img, (np.arange(35) * 7 % 256)[None].repeat(21, 0).astype(np.uint8)])
    frames = [Image.fromarray(img), Image.fromarray(img[::-1].copy())]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], lossless=True)
    exif = Image.Exif()
    exif[0x0112] = 6
    return [pil_webp(img, quality=80), pil_webp(img, lossless=True),
            pil_webp(rgba, quality=60), buf.getvalue(),
            pil_webp(img, quality=50, exif=exif.tobytes()),
            encode_webp([(b"VP8 ", encode_vp8(35, 21, _mbs(35, 21, 4), partitions=4))]),
            encode_webp([(b"VP8L", encode_vp8l(_argb(5), cache_bits=5, distances=[1, 21],
                                               meta=(2, np.arange(24).reshape(4, 6) % 3)))])]


@pytest.mark.parametrize("part", range(4))
def test_fuzzed_files_read_as_none_exactly_where_cv2_does(tmp_path, part):
    """150 cases a part (600 in all): cut files, flipped bits, overwritten
    bytes, lying RIFF and chunk sizes, bytes inserted or dropped."""
    rng = np.random.RandomState(1000 + part)
    seeds = _fuzz_seeds()
    for k in range(150):
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
            found = [4] + [12 + 4 + off for off in _chunk_offsets(bytes(data))]
            pos = found[rng.randint(len(found))]
            size = struct.unpack("<I", data[pos : pos + 4])[0]
            size = max(0, size + rng.randint(-20, 21)) if rng.rand() < 0.8 \
                else rng.randint(0, 1 << 32)
            data[pos : pos + 4] = struct.pack("<I", size)
        else:
            cut = rng.randint(12, len(data))
            data = data[:cut] + bytes(rng.randint(0, 256, rng.randint(0, 20)).astype(np.uint8)) \
                + data[cut + rng.randint(0, 10) :]
        check(tmp_path, bytes(data))


def _chunk_offsets(data):
    out, pos = [], 0
    while 12 + pos + 8 <= len(data):
        out.append(pos)
        size = struct.unpack("<I", data[12 + pos + 4 : 12 + pos + 8])[0]
        pos += 8 + size + (size & 1)
    return out
