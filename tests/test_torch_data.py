"""The port's augmenting transforms and training dataset (CPU) against the
JAX package's, drawing the same random numbers.

The JAX transforms draw from the module-level ``random`` and ``np.random``;
the port's from the instances they are handed.  Seeding both the same way
makes them draw the same numbers in the same order, which each test checks
by comparing the generators' next draws afterwards.

Tolerances, measured against the installed OpenCV 5: the pads, crops, noise,
``Blur`` (box filter) and ``Downscale``'s ``INTER_AREA`` are exact;
``SafeRotate`` (``warpAffine``), ``Downscale``'s ``INTER_CUBIC`` and
``Resize`` (``INTER_LINEAR``) differ by at most one grey level, at a few
pixels (about 1e-4 of them); keypoints agree to 1e-4.  The whole augmenting
pipeline over 60 seeds stayed within one grey level with equal shapes.  A
rotated pixel one level off at the edge of the ink could move
``CropWhite``'s box by a pixel; the dataset test's seeds do not.
"""

import dataclasses
import random

import numpy as np
import pytest

from molnextr_tpu.config import tiny_test_config as jax_tiny_config
from molnextr_tpu.data import dataset as jds
from molnextr_tpu.data import transforms as jt
from molnextr_tpu.data.synthetic import generate_synthetic_image as jax_render
from molnextr_tpu.tokenization import get_tokenizer as jax_tokenizer
from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.data import dataset as pds
from molnextr_tpu_torch.data import transforms as pt
from molnextr_tpu_torch.tokenization import get_tokenizer

SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CCCCC1", "CCOC", "CN", "CO", "CCC", "CCCl"]
ASPIRIN = "CC(=O)Oc1ccccc1C(=O)O"

# name -> (constructor arguments, exact?)
TRANSFORMS = {
    "SafeRotate": ({"limit": 90, "p": 1.0}, False),
    "CropWhite": ({"pad": 50}, True),
    "PadToSquare": ({}, True),
    "CropAndPad": ({"percent": (-0.05, 0.0), "p": 1.0}, True),
    "PadWhite": ({"pad_ratio": 0.4, "p": 1.0}, True),
    "Downscale": ({"scale_min": 0.2, "scale_max": 0.5, "p": 1.0}, False),
    "Blur": ({"p": 1.0}, True),
    "GaussNoise": ({"p": 1.0}, True),
    "SaltAndPepperNoise": ({"num_dots": 20, "p": 1.0}, True),
    "ToGray": ({}, True),
}


@pytest.fixture(scope="module")
def render():
    random.seed(3)
    img, _, graph, ok = jax_render(ASPIRIN, size=256)
    assert ok
    return img, np.asarray(graph["coords"], np.float32)


def _check_same_draws(rng, np_rng):
    assert rng.random() == random.random()
    assert np_rng.random_sample() == np.random.random_sample()


def _compare(got, want, exact):
    assert got["image"].shape == want["image"].shape and got["image"].dtype == np.uint8
    diff = np.abs(got["image"].astype(int) - want["image"].astype(int))
    assert diff.max() <= (0 if exact else 1), diff.max()
    assert (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(got["keypoints"], want["keypoints"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_matches_jax(render, name, seed):
    img, kps = render
    kwargs, exact = TRANSFORMS[name]
    random.seed(seed)
    np.random.seed(seed)
    want = jt.Compose([getattr(jt, name)(**kwargs)])(image=img.copy(), keypoints=kps)
    rng, np_rng = random.Random(seed), np.random.RandomState(seed)
    got = pt.Compose([getattr(pt, name)(**kwargs)])(image=img.copy(), keypoints=kps, rng=rng,
                                                    np_rng=np_rng)
    _compare(got, want, exact)
    _check_same_draws(rng, np_rng)


@pytest.mark.parametrize("seed", range(6))
def test_augmenting_pipeline_matches_jax(render, seed):
    img, kps = render
    random.seed(seed)
    np.random.seed(seed)
    want = jt.get_transforms(128, augment=True, rotate=True, normalize=False)(
        image=img.copy(), keypoints=kps)
    rng, np_rng = random.Random(seed), np.random.RandomState(seed)
    got = pt.get_transforms(128, augment=True, rotate=True, normalize=False)(
        image=img.copy(), keypoints=kps, rng=rng, np_rng=np_rng)
    _compare(got, want, exact=False)
    _check_same_draws(rng, np_rng)


def test_normalize_and_clutter():
    img = np.random.RandomState(0).randint(0, 256, (40, 50, 3)).astype(np.uint8)
    want = jt.get_transforms(32, augment=False, rotate=False)(image=img)["image"]
    got = pt.get_transforms(32, augment=False, rotate=False)(image=img)["image"]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02)  # one grey level of the resize
    assert pt.dataset_pads_to_square("real/UOB.csv") and not pt.dataset_pads_to_square("uspto")
    # the clutter family is ported (tests/test_torch_clutter.py): equal to JAX's
    random.seed(4)
    np.random.seed(4)
    want = jt.get_transforms(32, augment=False, rotate=False, clutter=True)(image=img)["image"]
    rng, np_rng = random.Random(4), np.random.RandomState(4)
    got = pt.get_transforms(32, augment=False, rotate=False, clutter=True)(
        image=img, rng=rng, np_rng=np_rng)["image"]
    np.testing.assert_array_equal(got, want)
    _check_same_draws(rng, np_rng)


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------


def _cfgs(**data):
    jcfg = jax_tiny_config()
    jcfg.data = dataclasses.replace(jcfg.data, input_size=64, **data)
    return jcfg, Config.from_dict(jcfg.to_dict())


@pytest.mark.parametrize("seed", [0, 1])
def test_train_item_matches_jax(seed):
    """The same seed through the JAX item and the port's.  The port's
    dataset is handed the module-level generators' own instances, so the
    renderer and the transforms share one stream, as in the JAX package."""
    jcfg, cfg = _cfgs(max_atoms=32)
    samples = [ASPIRIN, "CN1C=NC2=C1C(=O)N(C)C(=O)N2C"]
    jd = jds.TrainDataset(jcfg, [jds.Sample(s) for s in samples], jax_tokenizer(jcfg.data))
    random.seed(seed)
    np.random.seed(seed)
    want = jd[seed]
    random.seed(seed)
    np.random.seed(seed)
    pd = pds.TrainDataset(cfg, [pds.Sample(s) for s in samples], get_tokenizer(cfg.data),
                          rng=random._inst, np_rng=np.random.mtrand._rand)
    got = pd[seed]
    assert set(got) == set(want)
    for key in ("chartok_coords", "chartok_coords_indices"):
        assert list(got[key]) == list(want[key])
    assert got["smiles"] == want["smiles"]
    np.testing.assert_array_equal(got["edges"], want["edges"])
    np.testing.assert_array_equal(got["atom_grid"], want["atom_grid"])
    diff = np.abs(got["image"].astype(int) - want["image"].astype(int))
    assert got["image"].shape == want["image"].shape and diff.max() <= 1


def test_pad_batch_matches_jax():
    jcfg, cfg = _cfgs(continuous_coords=True)
    rng = np.random.RandomState(5)
    items = []
    for n in (3, 5):
        items.append({
            "image": rng.randint(0, 256, (64, 64, 3)).astype(np.uint8),
            "smiles": "C" * n,
            "chartok_coords": list(rng.randint(3, 40, n + 4)),
            "chartok_coords_indices": list(range(1, n + 1)),
            "coords": rng.rand(n, 2).astype(np.float32),
            "atom_grid": rng.randint(-2, 12, (8, 8)).astype(np.int8),
            "edges": rng.randint(0, 7, (n, n)).astype(np.int8),
        })
    args = (cfg.data.formats, 24, cfg.data.max_atoms)
    want = jds.pad_batch(items + [None], *args)
    got = pds.pad_batch(items + [None], *args)
    assert got["smiles"] == want["smiles"] and set(got["refs"]) == set(want["refs"])
    np.testing.assert_array_equal(got["images"], want["images"])
    assert got["images"].shape == (2, 64, 64, 1)
    for key, value in want["refs"].items():
        assert got["refs"][key].dtype == value.dtype
        np.testing.assert_array_equal(got["refs"][key], value)


def test_pool_loader_count_matches_inline():
    _, cfg = _cfgs()
    random.seed(2)
    ds = pds.TrainDataset(cfg, [pds.Sample(s) for s in SMILES], get_tokenizer(cfg.data))
    inline = list(pds.DataLoader(ds, batch_size=2, num_workers=0, prefetch=0))
    threaded = list(pds.DataLoader(ds, batch_size=2, num_workers=0))
    pooled = list(pds.DataLoader(ds, batch_size=2, num_workers=2))
    assert len(inline) == len(threaded) == len(pooled) == 5
    assert all(b["images"].shape == (2, 64, 64, 1) for b in pooled)


def test_item_cache_round_trip(tmp_path):
    _, cfg = _cfgs(render_cache=True, augment=False, mol_augment=False, default_style=True)
    tok = get_tokenizer(cfg.data)
    smiles = ["CCO", "c1ccccc1", "CC(=O)O"]
    ds = pds.TrainDataset(cfg, [pds.Sample(s) for s in smiles], tok)
    assert ds._item_cacheable
    items = [ds[i] for i in range(len(ds))]
    assert ds.item_cache_complete()
    path = str(tmp_path / "item_cache.pkl")
    assert ds.save_item_cache(path)
    ds2 = pds.TrainDataset(cfg, [pds.Sample(s) for s in smiles], tok)
    assert ds2.load_item_cache(path)
    for i, it in enumerate(items):
        np.testing.assert_array_equal(ds2[i]["image"], it["image"])
        assert list(ds2[i]["chartok_coords"]) == list(it["chartok_coords"])
    assert not pds.TrainDataset(cfg, [pds.Sample(s) for s in smiles[:2]], tok).load_item_cache(path)


def test_file_samples_read_png_and_refuse_other_files(tmp_path, monkeypatch):
    from molnextr_tpu_torch.data.image import UnsupportedFormat
    from molnextr_tpu_torch.data.png import write_png

    _, cfg = _cfgs()
    img = np.full((64, 64, 3), 255, np.uint8)
    img[10:50, 30:33] = 0
    png = str(tmp_path / "mol.png")
    write_png(png, img)
    corrupt = tmp_path / "mol.jpg"
    corrupt.write_bytes(b"\xff\xd8\xff\xe0not a jpeg")
    other = tmp_path / "mol.j2k"  # HTJ2K code-blocks, 5/3 cleanup passes: the same pixels
    from torch_image_writers import J2K_HT, encode_j2k

    other.write_bytes(encode_j2k([img[..., k] for k in range(3)], style=J2K_HT, mct=1))
    samples = [pds.Sample("CC", image_path=png, coords=np.array([[0.4, 0.2], [0.5, 0.7]])),
               pds.Sample("CC", image_path=str(other)), pds.Sample("CC", image_path=str(corrupt))]
    ds = pds.TrainDataset(cfg, samples, get_tokenizer(cfg.data), split="valid")
    item = ds[0]
    assert item["image"].shape == (64, 64, 3)
    assert (item["atom_grid"] == -2).all()  # a file sample has no atom symbols: unlabeled
    np.testing.assert_array_equal(ds[1]["image"], item["image"])
    # a format the port does not decode is refused, never whitened
    def unported(path):
        raise UnsupportedFormat("a form the port does not decode")

    monkeypatch.setattr(pds, "imread", unported)
    ds = pds.TrainDataset(cfg, samples, get_tokenizer(cfg.data), split="valid")
    assert ds[1] is None
    with pytest.raises(ValueError, match="does not decode"):
        ds._build(samples[1])
    monkeypatch.undo()
    # a corrupt file reads as None, as cv2.imread's: the JAX package's white placeholder
    assert ds[2]["image"].shape == (64, 64, 3) and (ds[2]["image"] == 255).all()
