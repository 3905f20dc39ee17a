"""The first shown frame of a key-frame-filtered AVIF sequence against
``cv2.imread``, exactly.

Pillow's AVIF writer with libaom's ``enable-keyframe-filtering`` 2 puts a
hidden key frame (a temporally filtered copy of the first picture) and then
a shown inter frame (the overlay, predicted from it) into the first sample
of an ``avis`` track; libavif, under cv2, shows that inter frame.  The
reader decodes both through ``data/av1_refs.py`` (the reference slots),
``data/av1_mvpred.py`` and ``data/av1_inter.py``.  Pillow writes 8 bits at
every quality, subsampling and speed, with an alpha track that is inter
coded too; 10 and 12 bits come from libaom itself
(``torch_image_writers.aom_encode_frames``) around one item.  Files cut at
any length read as cv2 reads them (None where it gives None).
"""

import io

import numpy as np
import pytest
from PIL import Image
from test_torch_avif import check, cv2_rgb
from torch_image_writers import (_av1_units, aom_avif, aom_encode_frames, aom_yuv,
                                 moving_drawing)

from molnextr_tpu_torch.data import av1_recon, avif
from molnextr_tpu_torch.data.image import imread

FILTERING = {"enable-keyframe-filtering": "2"}


def filtered(frames, alpha=None, **kw):
    """A Pillow ``avis`` of ``frames`` (RGB, or RGBA with ``alpha``) with
    key frame filtering."""
    if alpha is not None:
        frames = [np.dstack([f, np.full(f.shape[:2], alpha + 9 * k, np.uint8)])
                  for k, f in enumerate(frames)]
    kw["advanced"] = {**FILTERING, **kw.get("advanced", {})}
    buf = io.BytesIO()
    Image.fromarray(frames[0]).save(buf, "AVIF", save_all=True,
                                    append_images=[Image.fromarray(f) for f in frames[1:]], **kw)
    return buf.getvalue()


def first_frames(data, track=0):
    """The frame OBUs of a track's first sample, as (header byte, size)."""
    f = avif._Avif(data)
    offset, size = f.tracks[track].samples[0]
    sample = data[offset : offset + size]
    return [(body[0], len(body)) for kind, _, body in _av1_units(sample) if kind == 6]


def assert_hidden_key_then_inter(data, track=0):
    frames = first_frames(data, track)
    assert frames[0][0] >> 4 == 0  # KEY_FRAME, show_frame 0
    assert frames[-1][0] >> 4 == 3  # INTER_FRAME, shown


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
@pytest.mark.parametrize("quality", [100, 90, 60, 30, 10])
def test_keyframe_filtered_sequences_read_exactly(tmp_path, quality, subsampling):
    data = filtered(moving_drawing(3, 48, 64, "shift", seed=quality), quality=quality,
                    subsampling=subsampling)
    assert_hidden_key_then_inter(data)
    av1_recon.REACHED.clear()
    check(tmp_path, data)
    assert "inter_translation" in av1_recon.REACHED or quality == 100


FORMS = {
    "alpha": dict(size=(40, 56), quality=70, alpha=100),
    "alpha lossless": dict(size=(40, 56), quality=100, alpha=30),
    "37 x 53": dict(size=(37, 53), quality=60),
    "150 x 170 rotated": dict(size=(150, 170), quality=50, motion="rotate"),
    "zoom": dict(size=(64, 64), quality=40, motion="zoom"),
    "4:2:2": dict(size=(48, 64), quality=60, subsampling="4:2:2"),
    "4:0:0": dict(size=(48, 64), quality=60, subsampling="4:0:0"),
    "speed 2": dict(size=(64, 64), quality=50, speed=2),
    "speed 4": dict(size=(64, 64), quality=50, speed=4),
    "speed 0": dict(size=(64, 64), quality=50, speed=0),
    "four frames": dict(size=(48, 64), quality=60, frames=4),
    "film grain": dict(size=(48, 64), quality=60, advanced={"film-grain-test": "4"}),
    "restoration": dict(size=(64, 80), quality=40, speed=3,
                        advanced={"enable-restoration": "1"}),
}


@pytest.mark.parametrize("name", sorted(FORMS))
def test_keyframe_filtered_forms_read_exactly(tmp_path, name):
    options = dict(FORMS[name])
    h, w = options.pop("size")
    frames = moving_drawing(options.pop("frames", 3), h, w, options.pop("motion", "shift"),
                            seed=len(name))
    data = filtered(frames, **options)
    assert_hidden_key_then_inter(data)
    if "alpha" in options:
        assert [t.auxl for t in avif._Avif(data).tracks] == [False, True]
        assert_hidden_key_then_inter(data, track=1)
    check(tmp_path, data)


@pytest.mark.parametrize("depth, subsampling", [(10, "4:2:0"), (10, "4:4:4"), (12, "4:2:0")])
def test_deep_keyframe_filtered_items_read_exactly(tmp_path, depth, subsampling):
    """libaom at 10 and 12 bits with key frame filtering, its first
    temporal unit (a hidden key frame, the shown overlay) as one item."""
    frames = moving_drawing(4, 48, 64, "rotate", seed=depth)
    units = aom_encode_frames([aom_yuv(f, subsampling, depth) for f in frames], depth,
                              subsampling, q=25, speed=4, lag=4,
                              options=[("enable-keyframe-filtering", "2")])
    obus = b"".join(u for u in [units[0]])
    kinds = [(kind, body[0] >> 4) for kind, _, body in _av1_units(obus) if kind == 6]
    assert kinds[0] == (6, 0) and kinds[-1] == (6, 3)
    check(tmp_path, aom_avif(obus))


def test_cut_keyframe_filtered_sequences_read_as_cv2(tmp_path):
    data = filtered(moving_drawing(3, 40, 48, "zoom", seed=3), quality=60)
    path = tmp_path / "x.avif"
    for cut in sorted({int(c) for c in np.linspace(40, len(data) - 1, 30)}):
        path.write_bytes(data[:cut])
        want = cv2_rgb(path)
        got = imread(str(path))
        if want is None:
            assert got is None, cut
        else:
            np.testing.assert_array_equal(got, want)


def test_inter_demo_forms_predict_the_jax_packages_smiles():
    """The committed key-frame-filtered forms: the JAX package's
    ``predict_image_files`` (through ``cv2.imread``) and the port's, float32
    on the CPU, give demo_0.png's SMILES; the lossless one reads to its
    pixels, the 1024 x 1024 one to cv2's array."""
    from pathlib import Path

    from molnextr_tpu.api import MolNexTR as JaxMolNexTR
    from test_torch_avif import FORMS

    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.chem import canonicalize_smiles

    paths = [str(FORMS / f"demo_0_{k}.avif") for k in ("inter", "inter_lossless")]
    assert_hidden_key_then_inter(open(paths[0], "rb").read())
    np.testing.assert_array_equal(imread(paths[1]), imread(str(FORMS.parent / "demo_0.png")))
    np.testing.assert_array_equal(imread(str(FORMS / "big_inter.avif")),
                                  cv2_rgb(FORMS / "big_inter.avif"))
    bundle = str(Path(__file__).resolve().parents[1] / "examples" / "demo_model")
    jax = JaxMolNexTR(model_path=bundle).predict_image_files(paths)
    port = MolNexTR(model_path=bundle, device="cpu", num_workers=1).predict_image_files(paths)
    got = [canonicalize_smiles(p["predicted_smiles"])[0] for p in port]
    want = [canonicalize_smiles(p["predicted_smiles"])[0] for p in jax]
    assert got == want == [canonicalize_smiles("CC(C)O")[0]] * len(paths)


def test_fuzzed_keyframe_filtered_files_read_as_cv2(tmp_path):
    """A byte of the first sample's AV1 data replaced (the hidden key
    frame's and the inter frame's headers and tiles): None exactly where
    cv2 gives None (libaom finds most such frames corrupt), its array
    otherwise."""
    rng = np.random.RandomState(31)
    data = filtered(moving_drawing(3, 48, 64, "rotate", seed=2), quality=30, speed=3)
    f = avif._Avif(data)
    offset, size = f.tracks[0].samples[0]
    path = tmp_path / "x.avif"
    read = 0
    for _ in range(150):
        d = bytearray(data)
        d[rng.randint(offset, offset + size)] = rng.randint(0, 256)
        path.write_bytes(bytes(d))
        want = cv2_rgb(path)
        got = imread(str(path))
        if want is None:
            assert got is None
        else:
            read += 1
            np.testing.assert_array_equal(got, want)
    assert read
