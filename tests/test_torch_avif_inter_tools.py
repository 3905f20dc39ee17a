"""Every inter tool libaom 3.14 writes, each switched on alone, held to
libaom's own decoder frame by frame.

The streams come from the libaom that cv2 ships, through ``ctypes``
(``torch_image_writers.aom_encode_frames``: good-quality usage, a lag for
hidden ALTREF frames), over seeded drawings moved by sub-pixel shifts,
rotation and zoom (``moving_drawing``).  Every shown frame the port's
``data/av1_refs.frames`` yields, film grain added, equals the frame
libaom's decoder (``aom_codec_av1_dx``, ``torch_image_writers.
aom_decode_frames``) outputs, in number and in every sample; each case
asserts that its tool was reached (``av1_recon.REACHED``).

libaom writes ``enable_dual_filter`` 0 in its sequence header whatever the
option asks, so the two filter directions are always read alike; the
reader reads both symbols where a stream asks for them.
"""

import pytest
from torch_image_writers import (aom_decode_frames, aom_encode_frames, aom_yuv,
                                 moving_drawing)

from molnextr_tpu_torch.data import av1_grain, av1_recon, av1_refs

# every inter tool off, so that a case turns on one
OFF = [("enable-obmc", "0"), ("enable-warped-motion", "0"), ("enable-global-motion", "0"),
       ("enable-dual-filter", "0"), ("enable-interintra-comp", "0"),
       ("enable-interintra-wedge", "0"), ("enable-masked-comp", "0"),
       ("enable-dist-wtd-comp", "0"), ("enable-ref-frame-mvs", "0"),
       ("enable-smooth-interintra", "0")]

# tool -> (options switched on, encoder settings, what the decoder must reach)
TOOLS = {
    "obmc": ([("enable-obmc", "1")], {}, "obmc"),
    "warped motion": ([("enable-warped-motion", "1")], {}, "inter_local_warp"),
    "global motion": ([("enable-global-motion", "1")], {}, "inter_global_warp"),
    "interintra smooth": ([("enable-interintra-comp", "1"), ("enable-smooth-interintra", "1")],
                          dict(speed=1, lag=8, size=(96, 96), q=20), "interintra_smooth"),
    "interintra wedge": ([("enable-interintra-comp", "1"), ("enable-interintra-wedge", "1")],
                         dict(speed=1, lag=8, size=(96, 96), q=20), "interintra_wedge"),
    "masked compound": ([("enable-masked-comp", "1")], dict(speed=1, lag=8),
                        "compound_wedge"),
    "difference weighted": ([("enable-masked-comp", "1"), ("enable-diff-wtd-comp", "1")],
                            dict(lag=8), "compound_diffwtd"),
    "distance weighted": ([("enable-dist-wtd-comp", "1")], dict(speed=0, lag=8),
                          "compound_distance"),
    "ref frame mvs": ([("enable-ref-frame-mvs", "1")], dict(lag=8), "temporal_mv"),
    "reduced tx set": ([("reduced-tx-type-set", "1")], {}, "reduced_tx_set"),
    "resize": ([], dict(config=dict(rc_resize_mode=1, rc_resize_denominator=12,
                                    rc_resize_kf_denominator=8)), "inter_scaled"),
    "superres": ([], dict(superres=12, lag=8), "inter_scaled"),
    "skip mode": ([], dict(lag=8), "skip_mode"),
}


def decoded(stream):
    """The port's shown frames of a stream, film grain added."""
    out = []
    for shown in av1_refs.frames(stream):
        planes, seq = shown.planes, shown.seq
        if shown.grain is not None:
            planes = av1_grain.apply_grain(planes, shown.grain, seq.bit_depth, seq.ss_x,
                                           seq.ss_y, seq.matrix == 0)
        out.append(planes)
    return out


def assert_equal_to_libaom(units):
    want = aom_decode_frames(None, units)
    got = decoded(b"".join(units))
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for p, (a, b) in enumerate(zip(g, w)):
            assert a.shape == b.shape and (a == b).all(), (k, p, int((a != b).sum()))


@pytest.mark.parametrize("motion", ["shift", "rotate", "zoom"])
@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_streams_equal_libaoms_decoder(tool, motion):
    options, settings, reached = TOOLS[tool]
    settings = dict(settings)
    h, w = settings.pop("size", (64, 80))
    frames = moving_drawing(settings.pop("frames", 5), h, w, motion, seed=len(tool))
    names = {name for name, _ in options}
    opts = [o for o in OFF if o[0] not in names] + list(options)
    units = aom_encode_frames([aom_yuv(f) for f in frames], q=settings.pop("q", 30),
                              speed=settings.pop("speed", 3), options=opts, **settings)
    av1_recon.REACHED.clear()
    assert_equal_to_libaom(units)
    TOOL_REACHED.setdefault(tool, set()).update(av1_recon.REACHED)


TOOL_REACHED = {}


def test_every_inter_tool_is_reached():
    """Each tool's streams (over the three motions) reached it; a tool
    whose cases did not run here is run on the shift alone."""
    for tool in TOOLS:
        if tool not in TOOL_REACHED:
            test_tool_streams_equal_libaoms_decoder(tool, "shift")
    missing = [tool for tool, (_, _, name) in TOOLS.items() if name not in TOOL_REACHED[tool]]
    assert not missing

