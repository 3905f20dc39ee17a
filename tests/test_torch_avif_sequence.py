"""The first frame of an AVIF image sequence (``avis``) against
``cv2.imread``, exactly.

Pillow's ``save_all`` writes an ``avis`` file: a ``meta`` box whose primary
item is the first frame, and a ``moov`` box with one track (``tkhd``,
``edts``, ``stbl`` with ``stsd``, ``stts``, ``stsc``, ``stsz``, ``stco``,
``stss``; an RGBA sequence adds an ``auxv`` alpha track with an ``auxl``
reference).  libavif's ``AVIF_DECODER_SOURCE_AUTO`` takes the track when
the major brand is ``avis``, the primary item when it is ``avif``, and
otherwise the track if there is one; probed with a primary item moved to
the second sample and a file without ``meta``; 64-bit chunk offsets
(``co64``) read as ``stco``'s.  cv2 reads the first
sample, whose sequence header is a full one: temporal delimiters, order
hints, decoder model info (``timing-info``), frame ids
(``error-resilient``), none of them.  A key frame hidden and shown by a
``show_existing_frame`` (``torch_image_writers.av1_hidden_key``) reads as
cv2 reads it, and so does a hidden key frame followed by an inter frame
(libaom's ``enable-keyframe-filtering`` 2; ``test_torch_avif_inter.py``
holds that form at every quality, depth and subsampling).
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image
from test_torch_avif import FORMS, check, cv2_rgb, first_headers, picture
from torch_image_writers import _av1_units, av1_hidden_key, avif_rebuild

from molnextr_tpu_torch.data import av1_obu, avif
from molnextr_tpu_torch.data.image import imread


def sequence(n, h, w, alpha=False, **kw):
    frames = []
    for k in range(n):
        img = picture("gradient", h, w, k)
        if alpha:
            img = np.dstack([img, np.full((h, w), 100 + k, np.uint8)])
        frames.append(Image.fromarray(img))
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:], **kw)
    return buf.getvalue()


def first_sample(data):
    f = avif._Avif(data)
    offset, size = f.tracks[0].samples[0]
    return f, data[offset : offset + size]


@pytest.mark.parametrize("n", [2, 3, 5])
@pytest.mark.parametrize("quality", [100, 90, 50, 10])
def test_pillow_sequences_read_exactly(tmp_path, quality, n):
    data = sequence(n, 37, 53, quality=quality)
    f, sample = first_sample(data)
    assert f.from_track and len(f.tracks[0].samples) == n
    assert not first_headers(sample)[0].reduced
    check(tmp_path, data)


OPTIONS = {
    "4:4:4": dict(subsampling="4:4:4", quality=60),
    "4:0:0": dict(subsampling="4:0:0", quality=60),
    "film grain": dict(quality=60, advanced={"film-grain-test": "3"}),
    "decoder model": dict(quality=60, advanced={"timing-info": "model"}),
    "equal picture interval": dict(quality=60, advanced={"timing-info": "constant"}),
    "frame ids": dict(quality=60, advanced={"error-resilient": "1"}),
    "no order hints": dict(quality=60, advanced={"enable-order-hint": "0"}),
    "150 x 170": dict(quality=70, size=(150, 170)),
    "alpha track": dict(quality=80, alpha=True),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_sequence_forms_read_exactly(tmp_path, name):
    options = dict(OPTIONS[name])
    h, w = options.pop("size", (64, 70))
    data = sequence(4, h, w, alpha=options.pop("alpha", False), **options)
    f, sample = first_sample(data)
    seq = first_headers(sample)[0]
    if name == "decoder model":
        assert seq.decoder_model and not seq.equal_picture_interval
    if name == "frame ids":
        assert seq.frame_id_bits
    if name == "no order hints":
        assert seq.order_hint_bits == 0
    if name == "alpha track":
        assert [t.auxl for t in f.tracks] == [False, True]
    check(tmp_path, data)


def test_source_is_chosen_as_libavif_chooses_it(tmp_path):
    """The track when the major brand is ``avis`` (a primary item moved to
    the second sample, an inter frame, is not read), the item when it is
    ``avif`` (that item fails, None), the track when neither and there is
    one; a file with no ``meta`` and no ``avif`` brand reads from its
    track, one with an ``avis`` brand and no ``moov`` is None."""
    data = sequence(3, 20, 30, quality=90)
    f, _ = first_sample(data)
    (o0, s0), (o1, s1) = f.tracks[0].samples[:2]
    first = check(tmp_path, data)
    moved = bytearray(data)
    k = moved.find(o0.to_bytes(4, "big") + s0.to_bytes(4, "big"), moved.find(b"iloc"))
    moved[k : k + 8] = o1.to_bytes(4, "big") + s1.to_bytes(4, "big")
    np.testing.assert_array_equal(check(tmp_path, bytes(moved)), first)
    path = tmp_path / "x.avif"
    for major, read in ((b"avif", False), (b"mif1", True)):
        moved[8:12] = major
        path.write_bytes(bytes(moved))
        if read:
            np.testing.assert_array_equal(check(tmp_path, bytes(moved)), first)
        else:
            assert cv2_rgb(path) is None and imread(str(path)) is None
    no_meta = bytearray(data)
    k = no_meta.find(b"meta")
    no_meta[k : k + 4] = b"free"
    path.write_bytes(bytes(no_meta))
    assert cv2_rgb(path) is None and imread(str(path)) is None  # the avif brand needs meta
    k = no_meta.find(b"avif", 12, 44)
    no_meta[k : k + 4] = b"mif1"
    np.testing.assert_array_equal(check(tmp_path, bytes(no_meta)), first)
    no_moov = bytearray(data)
    k = no_moov.find(b"moov")
    no_moov[k : k + 4] = b"free"
    path.write_bytes(bytes(no_moov))
    assert cv2_rgb(path) is None and imread(str(path)) is None


@pytest.mark.parametrize("slot", [0, 5])
def test_hidden_key_frame_shown_later_reads_exactly(tmp_path, slot):
    data = sequence(2, 40, 50, quality=60)
    _, sample = first_sample(data)
    hidden = av1_hidden_key(sample, slot)
    fr = first_headers(hidden)[1]  # shown later by a show_existing_frame of its slot
    assert fr.frame_type == av1_obu.KEY_FRAME and fr.showable and not fr.show
    check(tmp_path, avif_rebuild(data, payload=hidden))
    path = tmp_path / "none.avif"  # a key frame not showable: libaom shows nothing
    path.write_bytes(avif_rebuild(data, payload=av1_hidden_key(sample, slot, showable=False)))
    assert cv2_rgb(path) is None and imread(str(path)) is None


def test_64_bit_chunk_offsets_read_exactly(tmp_path):
    """A ``co64`` box in place of ``stco`` (Pillow writes one chunk): the
    ``stco`` and ``stss`` boxes, 40 bytes, become ``co64`` and a ``free``
    box of the same length, so no size or offset moves."""
    data = sequence(3, 30, 40, quality=70)
    k = data.find(b"stco") - 4
    assert data[k + 20 : k + 28] == b"\0\0\0\x14stss"
    (offset,) = struct.unpack_from(">I", data, k + 16)
    co64 = struct.pack(">I4sIIQ", 24, b"co64", 0, 1, offset) + struct.pack(">I4s8x", 16, b"free")
    moved = data[:k] + co64 + data[k + 40 :]
    assert len(moved) == len(data)
    np.testing.assert_array_equal(check(tmp_path, moved), check(tmp_path, data, "stco.avif"))


def test_inter_frame_after_a_hidden_key_frame_raises_naming_it(tmp_path):
    """A hidden key frame, then a shown inter frame (libaom's key frame
    filtering): decoded, it reads to cv2's array."""
    data = sequence(4, 40, 50, quality=60, advanced={"enable-keyframe-filtering": "2"})
    _, sample = first_sample(data)
    frames = [body[0] >> 4 for kind, _, body in _av1_units(sample) if kind == 6]
    assert frames == [0, 3]  # a hidden KEY_FRAME, a shown INTER_FRAME
    check(tmp_path, data)


def test_cut_sequences_read_as_cv2(tmp_path):
    data = sequence(3, 30, 40, quality=70)
    path = tmp_path / "x.avif"
    for cut in sorted({int(c) for c in np.linspace(40, len(data) - 1, 25)}):
        path.write_bytes(data[:cut])
        want = cv2_rgb(path)
        got = imread(str(path))
        if want is None:
            assert got is None, cut
        else:
            np.testing.assert_array_equal(got, want)


def test_new_demo_forms_predict_the_jax_packages_smiles():
    """The committed forms of the reader's new paths (cv2's 10-bit 4:2:0,
    film grain, a grid of lossless tiles, the first frame of a lossless
    sequence): the JAX package's ``predict_image_files`` (through
    ``cv2.imread``) and the port's, float32 on the CPU, give the same
    SMILES, demo_0.png's; the grid and the sequence read to its pixels."""
    from pathlib import Path

    from molnextr_tpu.api import MolNexTR as JaxMolNexTR

    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.chem import canonicalize_smiles

    paths = [str(FORMS / f"demo_0_{k}.avif") for k in ("10bit", "grain", "grid", "anim")]
    png = imread(str(FORMS.parent / "demo_0.png"))
    for path in paths[2:]:
        np.testing.assert_array_equal(imread(path), png)
    bundle = str(Path(__file__).resolve().parents[1] / "examples" / "demo_model")
    jax = JaxMolNexTR(model_path=bundle).predict_image_files(paths)
    port = MolNexTR(model_path=bundle, device="cpu", num_workers=1).predict_image_files(paths)
    got = [canonicalize_smiles(p["predicted_smiles"])[0] for p in port]
    want = [canonicalize_smiles(p["predicted_smiles"])[0] for p in jax]
    assert got == want == [canonicalize_smiles("CC(C)O")[0]] * len(paths)
