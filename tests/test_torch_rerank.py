"""The port's round-trip rerank (``molnextr_tpu_torch.rerank``), its
evaluation helpers and the API's ``rerank="roundtrip"`` branch against
OpenCV and the JAX package, on the CPU.

``ink_mask`` and the 3x3 dilation are bit-exact against OpenCV; the
normalisation differs from the JAX package's by at most one grey level
(the port's resize, ``test_torch_io.py::test_resize_within_one_grey_level``);
on every case of ``fixtures/rerank.npz`` the port picks the JAX package's
winner, with scores within ``SCORE_TOL``.
"""

import json
import os
import random

import cv2
import numpy as np
import pytest
import torch

import molnextr_tpu.rerank as jax_rerank
from molnextr_tpu.data.synthetic import generate_synthetic_image as jax_generate
from molnextr_tpu.evaluation import SmilesEvaluator as JaxEvaluator
from molnextr_tpu.evaluation import convert_smiles_to_canonsmiles as jax_convert
from molnextr_tpu_torch import rerank
from molnextr_tpu_torch.evaluation import SmilesEvaluator, convert_smiles_to_canonsmiles

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(ROOT, "molnextr_tpu_torch", "fixtures")
# the largest score difference a one-grey-level resize difference may cause
SCORE_TOL = 1e-3
ASPIRIN = "CC(=O)Oc1ccccc1C(=O)O"
IBUPROFEN = "CC(C)Cc1ccc(cc1)C(C)C(=O)O"


@pytest.fixture(scope="module")
def cases():
    with np.load(os.path.join(FIXTURES, "rerank.npz")) as f:
        meta = json.loads(str(f["meta"]))
        return [(meta["seed"] + k, m, f[f"image_{k}"]) for k, m in enumerate(meta["cases"])]


def test_ink_mask_bit_exact_against_cv2():
    rng = np.random.RandomState(0)
    for shape in ((37, 53, 3), (64, 64, 3), (20, 31)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if img.ndim == 3 else img
        np.testing.assert_array_equal(rerank.ink_mask(img), gray < 200)
        np.testing.assert_array_equal(rerank.ink_mask(img), jax_rerank.ink_mask(img))


@pytest.mark.parametrize("density", [0.02, 0.2, 0.7])
def test_dilate3x3_bit_exact_against_cv2(density):
    rng = np.random.RandomState(int(density * 100))
    kernel = np.ones((3, 3), np.uint8)
    for shape in ((1, 1), (5, 9), (64, 64), (97, 33)):
        mask = (rng.rand(*shape) < density).astype(np.uint8)
        mask[0, :] = mask[:, -1] = 1  # ink on the border
        want = cv2.dilate(mask, kernel, iterations=1)
        np.testing.assert_array_equal(rerank.dilate3x3(mask), want)
        np.testing.assert_array_equal(rerank.dilate3x3(mask.astype(bool)), want.astype(bool))


def test_normalize_for_match_within_one_grey_level(cases):
    images = [image for _, _, image in cases]
    images.append(np.random.RandomState(1).randint(0, 256, (90, 140, 3)).astype(np.uint8))
    for image in images:
        for size in (256, 97):
            random.seed(3)
            want = jax_rerank._normalize_for_match(image, size)
            state = random.getstate()
            random.seed(3)
            got = rerank._normalize_for_match(image, size)
            assert random.getstate() == state  # the same draws as the JAX transforms
            assert got.shape == want.shape and got.dtype == np.uint8
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_rerank_fixture_same_winner_as_jax(cases):
    names = set()
    worst = 0.0
    for seed, meta, image in cases:
        random.seed(seed)  # the layout's draws for coinciding atoms
        winner, scores = rerank.roundtrip_rerank(image, meta["candidates"])
        assert winner == meta["winner"], meta["name"]
        assert len(scores) == len(meta["scores"]), meta["name"]
        if scores:
            worst = max(worst, float(np.abs(np.subtract(scores, meta["scores"])).max()))
        names.add(meta["name"])
    assert worst <= SCORE_TOL, worst
    assert any(-1.0 in meta["scores"] for _, meta, _ in cases)  # an undrawable candidate
    assert {"challenger_wins", "rank0_stands", "duplicates_collapse", "unrenderable",
            "clutter_inert"} <= names
    assert len(cases) >= 12


def test_select_scores_unrenderable_like_jax():
    image = jax_generate(ASPIRIN, mol_augment=False, default_option=True, size=160)[0]
    cands = [IBUPROFEN, "", "not-a-smiles", ASPIRIN]
    want = jax_rerank.roundtrip_select(image, cands)
    got = rerank.roundtrip_select(image, cands)
    assert got[0] == want[0] == 3
    assert got[1][1] == -1.0
    np.testing.assert_allclose(got[1], want[1], atol=SCORE_TOL)


def test_smiles_to_molblock_equal_to_jax():
    for smi in (ASPIRIN, IBUPROFEN, "C[C@H](N)C(=O)O", "]["):
        assert rerank.smiles_to_molblock(smi) == jax_rerank.smiles_to_molblock(smi)


def test_smiles_evaluator_equal_to_jax():
    gold = [ASPIRIN, "C[C@H](N)C(=O)O", "C/C=C/C", "", "c1ccccc1O", IBUPROFEN]
    pred = ["OC(=O)c1ccccc1OC(C)=O", "C[C@@H](N)C(=O)O", "C/C=C\\C", "CC", "Oc1ccccc1", "]["]
    want = JaxEvaluator(gold, num_workers=1, tanimoto=True).evaluate(pred, include_details=True)
    got = SmilesEvaluator(gold, num_workers=1, tanimoto=True).evaluate(pred, include_details=True)
    np.testing.assert_array_equal(got.pop("canon_smiles_details"),
                                  want.pop("canon_smiles_details"))
    assert got == want
    assert convert_smiles_to_canonsmiles(pred, num_workers=0) == \
        jax_convert(pred, num_workers=0)


@pytest.mark.parametrize("beam", [1, 4])
def test_api_rerank_equal_to_jax(beam):
    """``MolNexTR`` with ``rerank="roundtrip"`` in both packages on the tiny
    model's seeded weights: the same SMILES and molfiles."""
    from molnextr_tpu.api import MolNexTR as JMolNexTR
    from molnextr_tpu.config import tiny_test_config as jax_tiny_config
    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.weights import seeded_flax_params

    jcfg = jax_tiny_config()
    jcfg.decode.rerank = "roundtrip"
    jcfg.decode.beam_size = jcfg.decode.n_best = beam
    cfg = Config.from_dict(jcfg.to_dict())
    assert cfg.decode.rerank == "roundtrip" and cfg.decode.beam_size == beam
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    params = seeded_flax_params(cfg, vocab, 0)
    with np.load(os.path.join(FIXTURES, "demo.npz")) as f:
        images = list(f["images"][:3])
    images.append(jax_generate(ASPIRIN, mol_augment=False, default_option=True, size=96)[0])
    jax_model = JMolNexTR(cfg=jcfg, params=params, num_workers=1)
    model = MolNexTR(cfg=cfg, params=params, device="cpu", num_workers=1)
    random.seed(0)
    want = jax_model.predict_images(images)
    random.seed(0)
    got = model.predict_images(images)
    assert [o["predicted_smiles"] for o in got] == [o["predicted_smiles"] for o in want]
    assert [o["predicted_molfile"] for o in got] == [o["predicted_molfile"] for o in want]
