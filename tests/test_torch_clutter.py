"""The port's clutter transforms, ResizePad, ConditionalPadToSquare and
NormalizedGridDistortion against the JAX package's cv2-backed ones.

The JAX transforms draw from the module-level ``random`` and ``np.random``;
the port's from the instances they are handed.  Seeding both alike makes
them draw the same numbers; each test checks the generators' next draws
afterwards.  Every comparison is pixel for pixel (tolerance 0), over 30
seeds and images of several sizes: the clutter draws ``cv2.line``
(``LINE_8``), ``cv2.rectangle`` and ``cv2.putText`` through
``chem/raster.py``; ``cv2.remap`` in OpenCV 5 is float32 bilinear, which
``transforms.remap_linear`` repeats exactly; ``cv2.resize`` (``INTER_LINEAR``)
is exact.  Only the compositions with ``augment=True`` keep the default
set's bound (``SafeRotate``'s ``warpAffine`` and ``Downscale``'s
``INTER_CUBIC``, one grey level at a few pixels, ``tests/test_torch_data.py``).
"""

import random

import cv2
import numpy as np
import pytest

from molnextr_tpu.data import transforms as jt
from molnextr_tpu_torch.chem import raster
from molnextr_tpu_torch.data import transforms as pt

SEEDS = range(30)
CLUTTER = ["AddLineNoise", "AddEdgeElementSymbolNoise", "AddBondNoise",
           "AddIncompleteStructuralNoise", "DrawBorder"]


def _image(seed: int) -> np.ndarray:
    """A white page of a seeded size (30-420 px a side) with dark strokes
    and grey noise, so the clutter lands on ink and on paper."""
    rng = np.random.RandomState(1000 + seed)
    h, w = rng.randint(30, 421, 2)
    img = np.full((h, w, 3), 255, np.uint8)
    for _ in range(rng.randint(1, 6)):
        y, x = rng.randint(0, h), rng.randint(0, w)
        img[y:y + rng.randint(1, 20), x:x + rng.randint(1, 40)] = rng.randint(0, 200)
    noisy = rng.rand(h, w) < 0.02
    img[noisy] = rng.randint(0, 256, (int(noisy.sum()), 3))
    return img


def _keypoints(seed: int, img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    return (np.random.RandomState(seed).rand(5, 2) * [w, h]).astype(np.float32)


def _run_both(jax_t, port_t, img, kps, seed):
    random.seed(seed)
    np.random.seed(seed)
    want = jax_t(image=img.copy(), keypoints=kps)
    rng, np_rng = random.Random(seed), np.random.RandomState(seed)
    got = port_t(image=img.copy(), keypoints=kps, rng=rng, np_rng=np_rng)
    assert rng.random() == random.random()
    assert np_rng.random_sample() == np.random.random_sample()
    return got, want


def _equal(got, want, kps_atol=0.0):
    assert got["image"].shape == want["image"].shape
    assert got["image"].dtype == want["image"].dtype
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_allclose(got["keypoints"], want["keypoints"], rtol=0, atol=kps_atol)


@pytest.mark.parametrize("name", CLUTTER)
def test_clutter_transform_equals_jax(name):
    """p = 1: each of 30 seeds draws 1 to n marks of random size, thickness
    and place, some crossing the border."""
    for seed in SEEDS:
        img = _image(seed)
        kps = _keypoints(seed, img)
        got, want = _run_both(jt.Compose([getattr(jt, name)(p=1.0)]),
                              pt.Compose([getattr(pt, name)(p=1.0)]), img, kps, seed)
        _equal(got, want)


@pytest.mark.parametrize("scale", [0.4, 0.8, 0.037 * 11.5 - 1e-9, 0.037 * 11.5 + 1e-9,
                                   0.037 * 21.5 - 1e-9, 0.037 * 21.5 + 1e-9])
def test_symbol_sizes_at_the_ends_of_the_scale_range(scale):
    """``putText`` at the scales AddEdgeElementSymbolNoise draws (0.4-0.8,
    pixel size ``round(scale / 0.037)`` = 11-22) and either side of a
    rounding step: the glyph table's size and pixels equal cv2's."""
    assert 11 <= raster.font_size(0, scale)[1] <= 22
    img = np.full((60, 160, 3), 255, np.uint8)
    want = img.copy()
    for i, sym in enumerate(jt.AddEdgeElementSymbolNoise.SYMBOLS):
        org = (3 + 14 * i, 30 + (i % 3) * 12)
        cv2.putText(want, sym, org, cv2.FONT_HERSHEY_SIMPLEX, scale, (0, 0, 0), 1, cv2.LINE_AA)
        raster.put_text(img, sym, org, 0, scale, (0, 0, 0))
    np.testing.assert_array_equal(img, want)


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_line8_and_rectangle_equal_cv2(thickness):
    """``cv2.line``/``cv2.rectangle`` (``LINE_8``) on 200 seeded segments,
    half of them leaving the image."""
    rng = np.random.RandomState(thickness)
    for i in range(200):
        h, w = rng.randint(5, 80, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        p1 = (int(rng.randint(-20, w + 20)), int(rng.randint(-20, h + 20)))
        p2 = (int(rng.randint(0, w)), int(rng.randint(0, h)))
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        want, got = img.copy(), img.copy()
        if i % 2:
            cv2.line(want, p1, p2, color, thickness)
            raster.line8(got, p1, p2, color, thickness)
        else:
            cv2.rectangle(want, p1, p2, color, thickness)
            raster.rectangle(got, p1, p2, color, thickness)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("target", [(64, 64), (200, 120), (500, 500)])
def test_resize_pad_equals_jax(target):
    """Each side clamped on its own (downscale only), then centre-padded."""
    for seed in SEEDS:
        img = _image(seed)
        kps = _keypoints(seed, img)
        got, want = _run_both(jt.Compose([jt.ResizePad(*target)]),
                              pt.Compose([pt.ResizePad(*target)]), img, kps, seed)
        assert got["image"].shape[:2] == target
        _equal(got, want, kps_atol=1e-4)


@pytest.mark.parametrize("threshold", [1.0, 1.5, 3.0])
def test_conditional_pad_to_square_equals_jax(threshold):
    for seed in SEEDS:
        img = _image(seed)
        kps = _keypoints(seed, img)
        got, want = _run_both(jt.Compose([jt.ConditionalPadToSquare(ratio_threshold=threshold)]),
                              pt.Compose([pt.ConditionalPadToSquare(ratio_threshold=threshold)]),
                              img, kps, seed)
        _equal(got, want)


@pytest.mark.parametrize("num_steps,limit", [(10, 0.3), (5, 0.5), (3, 0.1)])
def test_grid_distortion_equals_jax(num_steps, limit):
    """Measured bound: 0 grey levels.  OpenCV 5 resamples in float32, and
    ``remap_linear`` repeats its arithmetic (not OpenCV 4's 5-bit fixed
    point)."""
    for seed in SEEDS:
        img = _image(seed)
        kps = _keypoints(seed, img)
        kw = {"num_steps": num_steps, "distort_limit": limit, "p": 1.0}
        got, want = _run_both(jt.Compose([jt.NormalizedGridDistortion(**kw)]),
                              pt.Compose([pt.NormalizedGridDistortion(**kw)]), img, kps, seed)
        _equal(got, want)


def test_remap_linear_equals_cv2_off_the_image():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    mx = (rng.rand(41, 29) * 61 - 4).astype(np.float32)
    my = (rng.rand(41, 29) * 45 - 4).astype(np.float32)
    want = cv2.remap(img, mx, my, interpolation=cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_CONSTANT, borderValue=(255, 255, 255))
    np.testing.assert_array_equal(pt.remap_linear(img, mx, my, (255, 255, 255)), want)


@pytest.mark.parametrize("size", [64, 384])
def test_perturbation_transforms_equal_jax(size):
    """The perturbed suite's pipeline, normalized float32 out: equal."""
    for seed in SEEDS:
        img = _image(seed)
        got, want = _run_both(jt.get_perturbation_transforms(size),
                              pt.get_perturbation_transforms(size), img, None, seed)
        assert got["image"].dtype == np.float32 and got["image"].shape == (size, size, 3)
        _equal(got, want)


@pytest.mark.parametrize("augment", [False, True])
def test_get_transforms_with_clutter_equals_jax(augment):
    """``clutter=True`` on the training wire (uint8), without and with the
    augmenting set; with it, SafeRotate and Downscale keep their bound."""
    for seed in SEEDS:
        img = _image(seed)
        kps = _keypoints(seed, img)
        kw = {"augment": augment, "rotate": augment, "normalize": False, "clutter": True}
        got, want = _run_both(jt.get_transforms(96, **kw), pt.get_transforms(96, **kw),
                              img, kps, seed)
        if not augment:
            _equal(got, want, kps_atol=1e-4)
            continue
        assert got["image"].shape == want["image"].shape
        diff = np.abs(got["image"].astype(int) - want["image"].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (seed, diff.max())
        np.testing.assert_allclose(got["keypoints"], want["keypoints"], rtol=0, atol=1e-4)
