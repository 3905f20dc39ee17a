"""Frames decoded against the reference slots, in the forms a stream or an
AVIF item takes them, against ``cv2.imread`` and libaom's own decoder.

* A first shown frame after a hidden key frame and libaom's hidden frames
  (its ALTREF): the first two temporal units of a lagged stream as one
  item, the key frame hidden (``torch_image_writers.av1_hidden_before``),
  so the shown frame predicts from two references (compound prediction,
  skip mode).
* An intra-only frame (``frame_type`` 2) shown after a hidden key frame
  (``torch_image_writers.av1_intra_only``: a key frame's header rewritten).
* Whole streams in every form: subsamplings and depths, lossless, grain on
  every frame (``update_grain`` and ``film_grain_params_ref_idx``), switch
  frames, frame ids (error resilience), order hints off, screen content,
  deltas, 128 superblocks, tiles, loop restoration; ``show_existing_frame``
  of hidden frames ends every lagged stream.
"""

import numpy as np
import pytest
from test_torch_avif import check, first_headers
from test_torch_avif_inter_tools import assert_equal_to_libaom, decoded
from torch_image_writers import (_av1_join, _av1_units, aom_avif, aom_decode_frames,
                                 aom_encode_frames, aom_yuv, av1_hidden_before, av1_hidden_key,
                                 av1_intra_only, moving_drawing)

from molnextr_tpu_torch.data import av1_obu, av1_recon


@pytest.mark.parametrize("motion", ["shift", "rotate", "zoom"])
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
def test_first_shown_frame_after_hidden_key_and_altref(tmp_path, subsampling, motion):
    frames = moving_drawing(8, 64, 80, motion, seed=7)
    units = aom_encode_frames([aom_yuv(f, subsampling) for f in frames], 8, subsampling, q=30,
                              speed=3, lag=16)
    item = av1_hidden_before(units, 2)
    shows = [body[0] >> 4 & 1 for kind, _, body in _av1_units(item) if kind == 6]
    assert shows[0] == 0 and shows[-1] == 1 and len(shows) > 2
    av1_recon.REACHED.clear()
    want = aom_decode_frames(item)
    got = decoded(item)
    assert len(want) == len(got) == 1
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    assert "compound_average" in av1_recon.REACHED
    check(tmp_path, aom_avif(item))


def test_skip_mode_is_reached_after_hidden_frames():
    frames = moving_drawing(8, 64, 80, "shift", seed=7)
    units = aom_encode_frames([aom_yuv(f) for f in frames], q=30, speed=3, lag=16)
    av1_recon.REACHED.clear()
    assert_equal_to_libaom([av1_hidden_before(units, 2)])
    assert "skip_mode" in av1_recon.REACHED


@pytest.mark.parametrize("refresh", [0x01, 0x7E])
def test_intra_only_frame_after_hidden_key_frame(tmp_path, refresh):
    frames = moving_drawing(4, 48, 64, "shift", seed=refresh)
    keys = aom_encode_frames([aom_yuv(frames[0]), aom_yuv(frames[3])], q=30,
                             config=dict(kf_max_dist=0))
    hidden = [u for u in _av1_units(av1_hidden_key(keys[0])) if u[0] not in (2, 3)]
    intra = [u for u in _av1_units(av1_intra_only(keys[1], refresh)) if u[0] == 6]
    item = _av1_join(hidden + intra)
    fr = first_headers(_av1_join(hidden[:1] + intra))[1]
    assert fr.frame_type == av1_obu.INTRA_ONLY_FRAME and fr.refresh == refresh
    assert_equal_to_libaom([item])
    check(tmp_path, aom_avif(item))


FORMS = {
    "4:4:4": dict(subsampling="4:4:4"),
    "4:2:2 10-bit": dict(subsampling="4:2:2", depth=10),
    "4:2:0 12-bit": dict(depth=12),
    "4:2:0 10-bit": dict(depth=10),
    "monochrome": dict(subsampling="4:0:0"),
    "lossless": dict(q=0),
    "film grain": dict(options=[("film-grain-test", "5")]),
    "switch frames": dict(config=dict(sframe_dist=2, sframe_mode=1), lag=0),
    "error resilient": dict(options=[("error-resilient", "1")], lag=0),
    "no order hints": dict(options=[("enable-order-hint", "0")], lag=0),
    "screen content": dict(options=[("tune-content", "screen")]),
    "delta q and lf": dict(options=[("deltaq-mode", "1"), ("delta-lf-mode", "1")]),
    "128 superblocks": dict(options=[("sb-size", "128")], size=(144, 144)),
    "2 x 2 tiles": dict(options=[("tile-columns", "1"), ("tile-rows", "1")], size=(144, 288)),
    "restoration": dict(options=[("enable-restoration", "1")]),
}


@pytest.mark.parametrize("name", sorted(FORMS))
def test_stream_forms_equal_libaoms_decoder(name):
    """Every default tool on, in the forms a stream takes: subsamplings and
    depths, lossless, grain on every frame, switch frames, frame ids,
    order hints off, screen content, deltas, superblocks, tiles."""
    kw = dict(FORMS[name])
    h, w = kw.pop("size", (64, 80))
    sub, depth = kw.pop("subsampling", "4:2:0"), kw.pop("depth", 8)
    frames = moving_drawing(5, h, w, "rotate", seed=len(name))
    units = aom_encode_frames([aom_yuv(f, sub, depth) for f in frames], depth, sub,
                              q=kw.pop("q", 30), speed=4, lag=kw.pop("lag", 6), **kw)
    assert_equal_to_libaom(units)
