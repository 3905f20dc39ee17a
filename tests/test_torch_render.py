"""The port's renderer and synthetic data (``molnextr_tpu_torch.chem.raster``,
``chem.render``, ``data.synthetic``, ``data.corpus``, ``chem.match``)
against OpenCV and the JAX package, on the CPU.

What "matches" means, in three layers:

* everything before pixels is exact: the same ``random`` seed gives the
  same label SMILES, graph (symbols, edges, coordinates) and success flag
  as the JAX package, in the default style and in the jittered, augmented
  one;
* each primitive's geometry is exact, and so are its pixels: the bound
  stated for every primitive (AA line at thickness 1/2/3, hash line,
  filled polygon, filled rectangle, one label per font) is ink IoU 1.0
  (grey < 200), and the tests hold the stronger pixel equality;
  ``text_size`` equals ``cv2.getTextSize`` with no tolerance;
* whole renders: ink IoU after rerank's normalisation (CropWhite 8, resize
  to 256, one 3x3 dilation) must reach 0.90 on every image; the port's
  renders are pixel-equal to the JAX package's, so the worst case met is
  1.0.

Polygons are exact while they lie inside the image; one that crosses the
border may differ from OpenCV's in a few border pixels (the renderer's
30 px margin keeps every wedge inside).
"""

import random

import cv2
import numpy as np
import pytest

from molnextr_tpu.chem.match import find_substructures as jax_find
from molnextr_tpu.data import corpus as jax_corpus
from molnextr_tpu.data import synthetic as jax_synthetic
from molnextr_tpu.rerank import _normalize_for_match
from molnextr_tpu_torch.chem import raster
from molnextr_tpu_torch.chem.match import find_substructures
from molnextr_tpu_torch.data import corpus, synthetic

N_CORPUS = 100
WHOLE_RENDER_IOU = 0.90
FONTS = (cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_DUPLEX, cv2.FONT_HERSHEY_COMPLEX,
         cv2.FONT_HERSHEY_TRIPLEX, cv2.FONT_HERSHEY_PLAIN)
COLORS = ((0, 0, 0), (60, 60, 60), (0, 0, 128), (128, 0, 0))


def ink(img):
    return cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) < 200


def ink_iou(a, b):
    ia, ib = ink(a), ink(b)
    union = np.logical_or(ia, ib).sum()
    return np.logical_and(ia, ib).sum() / union if union else 1.0


def canvas(size=128):
    img = np.full((size, size, 3), 255, np.uint8)
    img[20:50, 30:90] = 190  # a grey patch so blending over non-white is held too
    return img


@pytest.fixture(scope="module")
def corpus_smiles():
    return jax_corpus.generate_corpus(N_CORPUS, seed=0)


def test_generate_corpus_equal_to_jax():
    assert corpus.generate_corpus(40, seed=3) == jax_corpus.generate_corpus(40, seed=3)


# -- primitives ----------------------------------------------------------------


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_aa_line_pixels_equal_cv2(thickness):
    rng = random.Random(thickness)
    worst = 1.0
    for _ in range(60):
        # integer endpoints, some beyond the image
        p1 = (rng.randint(-12, 140), rng.randint(-12, 140))
        p2 = (rng.randint(-12, 140), rng.randint(-12, 140))
        col = rng.choice(COLORS)
        want, got = canvas(), canvas()
        cv2.line(want, p1, p2, col, thickness, cv2.LINE_AA)
        raster.line(got, p1, p2, col, thickness)
        worst = min(worst, ink_iou(want, got))
        np.testing.assert_array_equal(got, want, err_msg=f"{p1} {p2}")
    assert worst == 1.0


def test_hash_lines_pixels_equal_cv2():
    """A dashed wedge's short thickness-1 strokes, drawn over each other."""
    rng = random.Random(7)
    want, got = canvas(), canvas()
    for _ in range(80):
        x, y = rng.randint(10, 118), rng.randint(10, 118)
        p1, p2 = (x, y), (x + rng.randint(-4, 4), y + rng.randint(-4, 4))
        cv2.line(want, p1, p2, (0, 0, 0), 1, cv2.LINE_AA)
        raster.line(got, p1, p2, (0, 0, 0), 1)
    np.testing.assert_array_equal(got, want)


def test_filled_polygon_pixels_equal_cv2():
    rng = random.Random(1)
    for _ in range(150):
        tri = np.array([(rng.randint(0, 127), rng.randint(0, 127)) for _ in range(3)], np.int32)
        col = rng.choice(COLORS)
        want, got = canvas(), canvas()
        cv2.fillPoly(want, [tri], col)
        raster.fill_poly(got, tri, col)
        np.testing.assert_array_equal(got, want, err_msg=str(tri.tolist()))


def test_filled_rectangle_pixels_equal_cv2():
    rng = random.Random(2)
    for _ in range(100):
        p1 = (rng.randint(-10, 137), rng.randint(-10, 137))
        p2 = (rng.randint(-10, 137), rng.randint(-10, 137))
        want, got = canvas(), canvas()
        cv2.rectangle(want, p1, p2, (255, 255, 255), -1)
        raster.fill_rect(got, p1, p2, (255, 255, 255))
        np.testing.assert_array_equal(got, want)


def test_fill_convex_poly_aa_pixels_equal_cv2():
    """The anti-aliased polygon under thick lines and their caps, at 16
    fractional bits."""
    rng = random.Random(4)
    for _ in range(100):
        pts = [(rng.randint(-5 << 16, 70 << 16), rng.randint(-5 << 16, 70 << 16)) for _ in range(4)]
        want, got = canvas(64), canvas(64)
        cv2.fillConvexPoly(want, np.array(pts, np.int32), (0, 0, 0), cv2.LINE_AA, 16)
        raster.fill_convex_poly(got, pts, (0, 0, 0))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("font", FONTS)
def test_label_pixels_equal_cv2(font):
    rng = random.Random(font)
    chars = [chr(c) for c in range(32, 127)]
    for k in range(40):
        text = "".join(rng.choice(chars) for _ in range(rng.randint(1, 7)))
        scale = 0.6 if k == 0 else rng.uniform(0.45, 0.8)
        org = (rng.randint(-20, 120), rng.randint(-5, 140))  # some clipped
        col = rng.choice(COLORS)
        want, got = canvas(), canvas()
        cv2.putText(want, text, org, font, scale, col, 1, cv2.LINE_AA)
        raster.put_text(got, text, org, font, scale, col)
        np.testing.assert_array_equal(got, want, err_msg=f"{text!r} {scale} {org}")


def test_text_size_equals_cv2_at_every_font_and_scale():
    rng = random.Random(9)
    labels = ["N", "NH2", "OH", "Cl", "Br", "CH3", "NH+", "O-", "Ac", "OMe", "R1", "R'",
              "CF3", "(C2H4OMe)12", "13CH", "Si", "Boc", "NHCOCH3", "H2N", "SO3H", "12"]
    for font in FONTS:
        for _ in range(150):
            scale = rng.uniform(0.45, 0.8)
            for label in labels:
                assert raster.text_size(label, font, scale, 1) == cv2.getTextSize(
                    label, font, scale, 1)[0], (label, font, scale)


# -- the generator against the JAX package --------------------------------------


def _same_pre_pixel(a, b):
    """Label SMILES, success flag and graph equal."""
    assert a[1] == b[1] and a[3] == b[3]
    ga, gb = a[2], b[2]
    assert set(ga) == set(gb)
    if ga:
        assert ga["symbols"] == gb["symbols"] and ga["coords"] == gb["coords"]
        assert ga["num_atoms"] == gb["num_atoms"]
        np.testing.assert_array_equal(ga["edges"], gb["edges"])


@pytest.mark.parametrize("mode", ["default", "augmented"])
def test_generate_synthetic_image_equal_to_jax(mode, corpus_smiles, monkeypatch):
    """Same seeds, same outputs; every label drawn is sized as OpenCV sizes
    it; the whole render is pixel-equal, so its normalised ink IoU is 1.0."""
    kw = (dict(mol_augment=False, default_option=True, size=256) if mode == "default"
          else dict(mol_augment=True, default_option=False, size=384))
    sized = []
    text_size = raster.text_size

    def recording(label, font, scale, thickness=1):
        sized.append((label, font, scale))
        return text_size(label, font, scale, thickness)

    monkeypatch.setattr(raster, "text_size", recording)
    worst = 1.0
    for i, smi in enumerate(corpus_smiles):
        random.seed(i)
        np.random.seed(i)
        want = jax_synthetic.generate_synthetic_image(smi, **kw)
        state = (random.getstate(), np.random.get_state()[1].tolist())
        random.seed(i)
        np.random.seed(i)
        got = synthetic.generate_synthetic_image(smi, **kw)
        # the same draws from both streams, in the same number
        assert (random.getstate(), np.random.get_state()[1].tolist()) == state
        _same_pre_pixel(got, want)
        np.testing.assert_array_equal(got[0], want[0], err_msg=smi)
        if want[3]:
            iou = _normalised_iou(got[0], want[0])
            worst = min(worst, iou)
    assert worst >= WHOLE_RENDER_IOU and worst == 1.0
    assert sized
    for label, font, scale in sized:
        assert text_size(label, font, scale) == cv2.getTextSize(label, font, scale, 1)[0]
    if mode == "default":
        assert {(f, s) for _, f, s in sized} == {(cv2.FONT_HERSHEY_SIMPLEX, 0.6)}


def _normalised_iou(a, b):
    """Ink IoU after rerank's normalisation (JAX's own, with OpenCV)."""
    kernel = np.ones((3, 3), np.uint8)
    ma, mb = (cv2.dilate(ink(_normalize_for_match(x, 256)).astype(np.uint8), kernel) > 0
              for x in (a, b))
    return np.logical_and(ma, mb).sum() / max(np.logical_or(ma, mb).sum(), 1)


def test_failed_generation_matches_jax():
    for smi in ("not a smiles", "C1CC(", ""):
        want = jax_synthetic.generate_synthetic_image(smi)
        got = synthetic.generate_synthetic_image(smi)
        _same_pre_pixel(got, want)
        np.testing.assert_array_equal(got[0], want[0])


def test_find_substructures_equal_to_jax(corpus_smiles):
    """Every abbreviation pattern against corpus molecules, aromatic and
    Kekulé: the same matches in the same order (the generator draws from
    ``random`` per match)."""
    from molnextr_tpu.chem.aromaticity import dearomatize as jdearomatize
    from molnextr_tpu.chem.aromaticity import sanitize as jsanitize
    from molnextr_tpu.chem.smiles_parser import parse_smiles as jparse
    from molnextr_tpu_torch.chem.aromaticity import dearomatize, sanitize
    from molnextr_tpu_torch.chem.smiles_parser import parse_smiles

    jpats, pats = jax_synthetic._patterns(), synthetic._patterns()
    assert len(jpats) == len(pats)
    found = 0
    for smi in corpus_smiles[:30]:
        for kekule in (False, True):
            jm, m = jparse(smi), parse_smiles(smi)
            jsanitize(jm)
            sanitize(m)
            if kekule:
                jdearomatize(jm, strict=False)
                dearomatize(m, strict=False)
            for (_, jpat, jaf), (_, pat, af) in zip(jpats, pats):
                want = jax_find(jm, jpat, jaf, max_matches=8)
                assert find_substructures(m, pat, af, max_matches=8) == want
                found += len(want)
    assert found > 100


def test_demo_renders_equal_fixture():
    """The six demo images ``chip_smoke.py`` draws on the card: the port's
    renders equal the JAX package's, committed in ``fixtures/demo.npz``."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "molnextr_tpu_torch", "fixtures",
                        "demo.npz")
    with np.load(path) as f:
        images, meta = f["images"], json.loads(str(f["meta"]))
    random.seed(5)
    for smi, want, gold in zip(meta["inputs"], images, meta["gold"]):
        img, label, _, ok = synthetic.generate_synthetic_image(
            smi, mol_augment=False, default_option=True, size=128)
        assert ok and label == gold
        np.testing.assert_array_equal(img, want)


def test_text_outside_the_glyph_table_raises():
    with pytest.raises(ValueError, match="no glyph table"):
        raster.text_size("N", cv2.FONT_HERSHEY_SIMPLEX, 1.5)
    # thickness 2 is OpenCV's heavier weight: SIMPLEX is in the table, DUPLEX not
    assert raster.text_size("N", cv2.FONT_HERSHEY_SIMPLEX, 0.6, 2) == \
        cv2.getTextSize("N", cv2.FONT_HERSHEY_SIMPLEX, 0.6, 2)[0]
    with pytest.raises(ValueError, match="no glyph table for font 2 at thickness 2"):
        raster.text_size("N", cv2.FONT_HERSHEY_DUPLEX, 0.6, 2)
    # a character outside printable ASCII is drawn as "?", as OpenCV draws it
    assert raster.text_size("é", cv2.FONT_HERSHEY_SIMPLEX, 0.6) == \
        cv2.getTextSize("?", cv2.FONT_HERSHEY_SIMPLEX, 0.6, 1)[0]


def test_molecule_index_equal_to_jax(corpus_smiles):
    """``chem/search.py``: similarity and substructure search over the
    corpus give the JAX package's records and scores."""
    from molnextr_tpu.chem.search import MoleculeIndex as JaxIndex
    from molnextr_tpu_torch.chem.search import MoleculeIndex

    jax_index, index = JaxIndex(), MoleculeIndex()
    jax_index.insert_many(corpus_smiles[:40])
    index.insert_many(corpus_smiles[:40])
    for query in ("c1ccccc1", "C(=O)O", "C1CCNCC1", corpus_smiles[3]):
        assert index.search_sub(query) == jax_index.search_sub(query)
        assert index.search_sim(query, min_sim=0.2) == jax_index.search_sim(query, min_sim=0.2)
    assert index.search_sub("c1ccccc1")
