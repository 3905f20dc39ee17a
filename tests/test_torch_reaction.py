"""The port's reaction drawing against ``molnextr_tpu.data.reaction``.

``generate_reaction_image`` draws each reaction pixel for pixel as the JAX
package does, with the same label and graph, under the same ``random`` and
``np.random`` seeds; a reaction it cannot draw gives the same failure
tuple.  Its two OpenCV calls are held to cv2 on their own:
``raster.arrowed_line`` to ``cv2.arrowedLine`` and ``raster.put_text`` at
thickness 2 to ``cv2.putText``.
"""

import random

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from molnextr_tpu.data.reaction import generate_reaction_image as jax_generate
from molnextr_tpu_torch.chem import raster
from molnextr_tpu_torch.data.reaction import generate_reaction_image

REACTIONS = [
    "CCO.CC(=O)O>[H+]>CCOC(C)=O",
    "c1ccccc1Br.OB(O)c1ccccc1>>c1ccc(cc1)-c1ccccc1",
    "CC(=O)Cl.NCC.CCN(CC)CC>>CC(=O)NCC",
    "C=CC=C.C=C>>C1=CCCCC1",
    "OC(=O)c1ccccc1O.CC(=O)OC(C)=O>>CC(=O)Oc1ccccc1C(=O)O",
    "CCN>O>",
]


def _both(reaction, seed, **kwargs):
    random.seed(seed)
    np.random.seed(seed)
    want = jax_generate(reaction, **kwargs)
    random.seed(seed)
    np.random.seed(seed)
    got = generate_reaction_image(reaction, **kwargs)
    return want, got


@pytest.mark.parametrize("reaction", REACTIONS)
@pytest.mark.parametrize("mol_augment", [False, True])
def test_reaction_image_label_and_graph_equal_jax(reaction, mol_augment):
    (wimg, wlabel, wgraph, wok), (img, label, graph, ok) = _both(
        reaction, len(reaction), mol_augment=mol_augment)
    assert ok and wok
    assert img.dtype == wimg.dtype == np.uint8
    np.testing.assert_array_equal(img, wimg)
    assert label == wlabel
    assert graph["symbols"] == wgraph["symbols"] and graph["num_atoms"] == wgraph["num_atoms"]
    np.testing.assert_array_equal(np.asarray(graph["coords"]), np.asarray(wgraph["coords"]))
    np.testing.assert_array_equal(graph["edges"], wgraph["edges"])


@pytest.mark.parametrize("reaction", ["not a reaction", "C1CC>>C", "C(>>C", "CC>>C>C", "CC>>Xx"])
def test_failure_tuple_equals_jax(reaction):
    (wimg, wlabel, wgraph, wok), (img, label, graph, ok) = _both(reaction, 0)
    assert not ok and not wok and label == wlabel == reaction and graph == wgraph == {}
    np.testing.assert_array_equal(img, wimg)
    assert img.shape == (10, 10, 3) and img.dtype == wimg.dtype == np.float32
    with pytest.raises(Exception):
        generate_reaction_image(reaction, debug=True)


@settings(max_examples=60, deadline=None)
@given(x1=st.integers(-20, 120), y1=st.integers(-20, 120), x2=st.integers(-20, 120),
       y2=st.integers(-20, 120), thickness=st.integers(1, 3),
       tip=st.sampled_from([0.1, 0.25, 0.5]))
def test_arrowed_line_equals_cv2(x1, y1, x2, y2, thickness, tip):
    want = np.full((100, 100, 3), 255, np.uint8)
    got = want.copy()
    cv2.arrowedLine(want, (x1, y1), (x2, y2), (0, 0, 0), thickness, tipLength=tip)
    raster.arrowed_line(got, (x1, y1), (x2, y2), (0, 0, 0), thickness, tip_length=tip)
    np.testing.assert_array_equal(got, want)


def test_reaction_arrows_equal_cv2():
    for y in (40, 131, 132):
        for x in (20, 264, 700):
            want = np.full((264, 900, 3), 255, np.uint8)
            got = want.copy()
            cv2.arrowedLine(want, (x + 8, y), (x + 82, y), (0, 0, 0), 2, tipLength=0.25)
            raster.arrowed_line(got, (x + 8, y), (x + 82, y), (0, 0, 0), 2, tip_length=0.25)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("text", ["+", "A+b", "x 9?"])
def test_put_text_at_thickness_2_equals_cv2(text):
    """SIMPLEX at thickness 2 draws weight 600, 27 px at scale 1.0."""
    assert raster.font_size(cv2.FONT_HERSHEY_SIMPLEX, 1.0, 2) == (600, 27)
    for org in ((10, 40), (0, 20), (95, 60)):
        want = np.full((64, 120, 3), 255, np.uint8)
        got = want.copy()
        cv2.putText(want, text, org, cv2.FONT_HERSHEY_SIMPLEX, 1.0, (0, 0, 0), 2, cv2.LINE_AA)
        raster.put_text(got, text, org, cv2.FONT_HERSHEY_SIMPLEX, 1.0, (0, 0, 0), 2)
        np.testing.assert_array_equal(got, want)
    assert raster.text_size(text, cv2.FONT_HERSHEY_SIMPLEX, 1.0, 2) == \
        cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 1.0, 2)[0]
