"""The port's HTJ2K code-blocks (``data/j2k_ht.py``, JPEG 2000 Part 15,
ITU-T T.814) against ``cv2.imread`` (OpenJPEG 2.5.3 in cv2 5.0), exactly.

Files come from the HT block encoder of ``torch_image_writers``
(``encode_j2k(style=J2K_HT)``: MEL, VLC, MagSgn, SigProp and MagRef
streams, the codes the decoder's tables turned round) and from
single-block codestreams written here with chosen segment lengths, pass
counts and zero bit-planes for what OpenJPEG refuses.  The 5/3 files coded
by the cleanup pass alone (and with refinement passes, where the writer
keeps them lossless) also read to their source planes, which shows the
writer right.

Behaviours found by test (cv2 5.0 on OpenJPEG 2.5.3): the second of the two
tables in the library's data serves the first line pair; the cleanup's
segment holds one pass and the next segment every other pass of the
packet, with no segment limit of HT's own, so refinement passes in a later
layer than their cleanup pass are read as part of the cleanup segment (as
None, or other pixels); a code-block whose band has no bit-planes reads as
zeros; a cleanup of no bytes is refused; the MEL check looks only at the
bytes OpenJPEG reads singly, which depends on where the segment lies.
"""

import os
import struct

import cv2
import numpy as np
import pytest
from torch_image_writers import (J2K_HT, J2K_TERMALL, J2K_VSC, HTBackward, HTForward, HTMel, _HeaderBits,
                                 _passes_code, _uvlc, encode_j2k, encode_jp2, ht_codewords,
                                 ht_encode, ht_tables, j2k_segment)

from molnextr_tpu_torch.data import j2k_ht
from molnextr_tpu_torch.data.image import decode

GREY = b"\x01\x00\x00" + struct.pack(">I", 17)


def check(tmp_path, data, name="x.j2k"):
    """The port reads ``data`` as cv2 does (None included); returns cv2's
    array (RGB)."""
    path = tmp_path / name
    path.write_bytes(data)
    img = cv2.imread(str(path))
    want = None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    got = decode(data)
    if want is None:
        assert got is None
    else:
        assert got is not None and got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    return want


def picture(h, w, seed=0, channels=3, scale=1):
    rng = np.random.RandomState(seed)
    yy, xx = np.indices((h, w))
    base = (5 * yy + 3 * xx)[..., None] + rng.randint(0, 60, (h, w, channels)) * scale
    return np.clip(base, 0, 255).astype(np.uint8)


def rgb_j2k(img, **kw):
    return encode_j2k([img[..., k] for k in range(img.shape[2])], style=kw.pop("style", J2K_HT),
                      **kw)


# -- units: the streams and codes round trip through the encoder -----------------------

def test_mel_events_round_trip():
    rng = np.random.RandomState(0)
    for n, rate in ((1, 0.5), (40, 0.05), (600, 0.3), (900, 0.9)):
        events = (rng.rand(n) < rate).astype(int).tolist()
        mel = HTMel()
        for e in events:
            mel.encode(e)
        if mel.run:
            mel._bit(1)
        if mel.rem < 8:
            mel.out.append((mel.tmp << mel.rem) & 0xFF)
        data = bytes(mel.out) + b"\x00\x00"
        got = j2k_ht._mel_events(data, 0, len(data) - 1)
        assert [next(got) for _ in events] == events


@pytest.mark.parametrize("kind", ["forward", "backward"])
def test_raw_streams_round_trip(kind):
    """MagSgn/SigProp (0xFF stuffing) and VLC/MagRef (0x7F after >0x8F)."""
    rng = np.random.RandomState(1)
    for n in (1, 7, 100, 3000):
        bits = (rng.rand(n) < rng.choice([0.5, 0.97])).astype(int).tolist()
        if kind == "forward":
            w = HTForward()
            for b in bits:
                w.put(b, 1)
            data = w.flush(False)
            got = j2k_ht._forward(data, 0, len(data), 0, 8)
        else:
            w = HTBackward(False)
            for b in bits:
                w.put(b, 1)
            data = w.flush()
            vals = np.frombuffer(data, np.uint8)[::-1]
            got = j2k_ht._pack(vals, j2k_ht._backward_counts(vals, True), 0, 8)
        assert got[:n].tolist() == bits


def test_uvlc_round_trip():
    """T.814 table 3: every u_q up to the 5-bit suffix's last, one bit at a
    time through the VLC stream's byte order."""
    assert j2k_ht.UVLC == [(3, 5, 5), (1, 0, 1), (2, 0, 2), (1, 0, 1), (3, 1, 3), (1, 0, 1),
                           (2, 0, 2), (1, 0, 1)]
    for u in range(1, 33):
        prefix, plen, suffix, slen = _uvlc(u)
        v = prefix | suffix << plen
        got_plen, got_slen, pfx = j2k_ht.UVLC[v & 7]
        assert (got_plen, got_slen) == (plen, slen)
        assert pfx + ((v >> plen) & ((1 << slen) - 1)) == u


@pytest.mark.parametrize("initial", [True, False])
def test_vlc_codes_round_trip(initial):
    """Every code the writer picks reads back, through the decoder's table,
    as its context's rho, u_off, e_k and e_1, for any bits after it."""
    table = j2k_ht.VLC_INITIAL if initial else j2k_ht.VLC_LATER
    choices = ht_tables()[0 if initial else 1]
    assert len(choices) > 200
    rng = np.random.RandomState(2)
    for (c, rho, u_off, emb), (cwd, length, e_k) in choices.items():
        for tail in rng.randint(0, 128, 3):
            entry = table[(c << 7) | ((cwd | int(tail) << length) & 0x7F)]
            assert entry & 7 == length
            assert (entry >> 4) & 15 == rho and (entry >> 3) & 1 == u_off
            assert entry >> 12 == e_k and (emb & e_k) == (entry >> 8) & 15
    assert set(ht_codewords(initial)) >= {(c, r, 0, 0, 0) for c in range(1, 8) for r in (0, 1)}


def test_tables_are_the_ones_in_cv2():
    """``data/j2k_ht.npz`` is what ``build_ht_tables`` reads out of the
    installed ``cv2.abi3.so`` (OpenJPEG 2.5.3)."""
    from test_torch_fixtures import build_ht_tables

    with np.load(os.path.join(os.path.dirname(j2k_ht.__file__), "j2k_ht.npz")) as z:
        committed = {k: z[k] for k in z.files}
    built = build_ht_tables()
    assert sorted(committed) == sorted(built) == ["vlc_initial", "vlc_later"]
    for key in built:
        assert committed[key].dtype == np.uint16 and committed[key].shape == (1024,)
        np.testing.assert_array_equal(committed[key], built[key])


def test_swapped_tables_disagree_with_cv2(tmp_path, monkeypatch):
    """The assignment of the two tables is cv2's: swapped, the decoder
    reads this file otherwise than cv2 does."""
    data = rgb_j2k(picture(24, 24, 3), numres=2, cblk=(3, 3))
    want = check(tmp_path, data)
    monkeypatch.setattr(j2k_ht, "VLC_INITIAL", j2k_ht.VLC_LATER)
    monkeypatch.setattr(j2k_ht, "VLC_LATER", list(j2k_ht.VLC_INITIAL))
    got = decode(data)
    assert got is None or not np.array_equal(got, want)


# -- files: the writer's codestreams ---------------------------------------------------

@pytest.mark.parametrize("cblk", [(2, 2), (3, 3), (4, 4), (5, 5), (6, 6), (10, 2), (2, 10),
                                  (6, 3)])
def test_lossless_cleanup_reads_the_source(tmp_path, cblk):
    """5/3 with RCT, cleanup passes alone, code-blocks 4 x 4 up to 64 x 64
    and 1024 x 4: cv2 reads the source planes, and so does the port."""
    img = picture(37, 70, 4)
    data = rgb_j2k(img, numres=3, cblk=cblk, mct=1)
    np.testing.assert_array_equal(check(tmp_path, data), img)


def test_grey_jp2_and_jph(tmp_path):
    """A grey JP2 and an RGB JPH (brand ``jph ``) around HT codestreams."""
    grey = picture(30, 41, 5, channels=1)[..., 0]
    code = encode_j2k([grey], style=J2K_HT, numres=4, cblk=(4, 4))
    want = check(tmp_path, encode_jp2(code, 41, 30, 1, colr=GREY), "g.jp2")
    np.testing.assert_array_equal(want, np.repeat(grey[..., None], 3, axis=2))
    img = picture(33, 28, 6)
    code = rgb_j2k(img, numres=3, cblk=(4, 4), mct=1)
    want = check(tmp_path, encode_jp2(code, 28, 33, 3, brand=b"jph "), "c.jph")
    np.testing.assert_array_equal(want, img)


@pytest.mark.parametrize("passes", [2, 3])
@pytest.mark.parametrize("drop", [0, 1, 2])
def test_irreversible_with_refinement_passes(tmp_path, passes, drop):
    """9/7 with the SigProp and MagRef passes, bit-planes dropped below."""
    img = picture(40, 45, 7, scale=3)
    check(tmp_path, rgb_j2k(img, numres=3, cblk=(4, 4), reversible=False, mct=1,
                            ht_passes=passes, ht_drop=drop))


@pytest.mark.parametrize("style", [J2K_HT, J2K_HT | J2K_VSC])
@pytest.mark.parametrize("size", [(1, 9), (7, 1), (5, 3), (6, 17), (13, 11), (9, 30), (36, 20)])
def test_refinement_stripes_and_vsc(tmp_path, style, size):
    """Refinement passes over every stripe height and odd widths, with and
    without vertically causal contexts; 5/3 stays lossless."""
    h, w = size
    img = picture(h, w, 8, scale=2)
    for passes in (2, 3):
        data = rgb_j2k(img, numres=2, cblk=(3, 3), mct=1, style=style, ht_passes=passes)
        want = check(tmp_path, data)
        if passes == 3:
            np.testing.assert_array_equal(want, img)
        check(tmp_path, rgb_j2k(img, numres=1, cblk=(3, 3), mct=1, style=style,
                                ht_passes=passes, reversible=False, ht_drop=1))


WRITER_CASES = {
    "tiles": dict(tile=(24, 20), numres=3, cblk=(3, 3)),
    "precincts": dict(numres=3, cblk=(4, 4), precincts=[(3, 3), (3, 3), (4, 3)]),
    "precincts_rlcp": dict(numres=3, cblk=(4, 4), precincts=[(2, 2), (3, 2), (3, 3)],
                           progression=1),
    "tiles_precincts": dict(tile=(32, 24), numres=4, cblk=(2, 3),
                            precincts=[(2, 2), (3, 3), (3, 3), (4, 4)]),
    "resolutions_6": dict(numres=6, cblk=(4, 4)),
    "no_cap": dict(numres=3, cblk=(4, 4), cap=False),
    "sop_eph": dict(numres=2, cblk=(3, 3), sop=True, eph=True),
    "ppt": dict(numres=2, cblk=(3, 3), headers="ppt", parts=2),
    "rpcl": dict(numres=3, cblk=(3, 3), progression=2),
    "part1_component": dict(numres=3, cblk=(4, 4), coc={1: {"style": 0}}),
}


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_writer_cases(tmp_path, case):
    img = picture(50, 61, 9)
    want = check(tmp_path, rgb_j2k(img, mct=1, **WRITER_CASES[case]))
    np.testing.assert_array_equal(want, img)


@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("layers", [2, 3])
def test_layers_read_as_openjpeg_reads_them(tmp_path, passes, layers):
    """Passes spread over layers: OpenJPEG puts the first pass of a later
    packet into the cleanup segment (it has no HT segment limit), so files
    whose refinement follows its cleanup in a later layer read as None or
    as other pixels, in cv2 as in the port; with ``TERMALL`` too (Part 1's
    one pass a segment)."""
    img = picture(20, 26, 10, scale=2)
    for reversible in (True, False):
        for style in (J2K_HT, J2K_HT | J2K_TERMALL):
            check(tmp_path, rgb_j2k(img, numres=2, cblk=(3, 3), mct=1, layers=layers,
                                    ht_passes=passes, reversible=reversible, style=style))


# -- what OpenJPEG refuses, and where it warns and goes on --------------------------------

def one_block(pieces, zbp, w=8, h=8, expn=8, guard=2, roi=0, layers=None):
    """A 3-component 5/3 codestream of one resolution and one code-block, of
    which component 0's alone is coded: ``pieces`` (passes, bytes) of its
    first packet, or ``layers`` (one such list a packet), its zero
    bit-planes ``zbp`` and band bit-planes ``expn + guard - 1``."""
    layers = layers or [pieces]
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, 3) + bytes([7, 1, 1]) * 3
    cod = bytes([0, 0]) + struct.pack(">H", len(layers)) + bytes([0, 0, 4, 4, J2K_HT, 1])
    main = (b"\xff\x4f" + j2k_segment(0xFF51, siz) + j2k_segment(0xFF52, cod)
            + j2k_segment(0xFF5C, bytes([guard << 5, expn << 3])))
    if roi:
        main += j2k_segment(0xFF5E, bytes([0, 0, roi]))
    body, lblock = b"", 3
    for layer, pcs in enumerate(layers):
        if pcs:
            bits = _HeaderBits()
            bits.put(1)
            bits.put(1)  # included
            if layer == 0:
                bits.put(1, zbp + 1)  # the one-leaf tag tree: zbp zeros, a one
            _passes_code(bits, sum(n for n, _ in pcs))
            inc = max([0] + [len(d).bit_length() - (n.bit_length() - 1) - lblock
                             for n, d in pcs])
            bits.put((1 << (inc + 1)) - 2, inc + 1)
            lblock += inc
            for n, d in pcs:
                bits.put(len(d), lblock + n.bit_length() - 1)
            body += bits.flush() + b"".join(d for _, d in pcs)
        else:
            body += b"\x00"
        body += b"\x00\x00"  # components 1 and 2: empty packets
    sot = j2k_segment(0xFF90, struct.pack(">HIBB", 0, 14 + len(body), 0, 1))
    return main + sot + b"\xff\x93" + body + b"\xff\xd9"


def block(h=8, w=8, seed=0, big=5):
    rng = np.random.RandomState(seed)
    return rng.randint(-big, big + 1, (h, w)) * (rng.rand(h, w) < 0.5)


def test_single_block_reads_its_coefficients(tmp_path):
    """The helper's codestream: zero bit-planes Mb - 1 put the cleanup's
    bits at plane 0 (the samples, 128 apart), Mb - 2 at plane 1 (twice
    them, and the half of plane 0)."""
    q = block()
    cleanup = ht_encode(q, 1)[0]
    want = check(tmp_path, one_block([(1, cleanup)], 8))
    np.testing.assert_array_equal(want[..., 0].astype(int) - 128, q)
    want = check(tmp_path, one_block([(1, cleanup)], 7))
    np.testing.assert_array_equal(want[..., 0].astype(int) - 128,
                                  np.clip(np.sign(q) * (2 * np.abs(q) + 1), -128, 127)
                                  * (q != 0))


def test_refusals_and_warnings(tmp_path):
    """Each HT refusal of OpenJPEG 2.5.3, and its two warnings, as cv2 reads
    them: None for a refusal, the cleanup alone for a warning."""
    q = block(seed=1)
    cleanup, sp, mr, _ = ht_encode(q, 2, 3)
    refine = sp + mr
    ok = check(tmp_path, one_block([(1, cleanup), (2, refine)], 7))
    assert ok is not None
    cases = {
        # "We do not support ROI in decoding HT codeblocks"
        "roi": (one_block([(1, cleanup)], 8, roi=3), None),
        # "... more than one coding pass, but zero length for 2nd ..." (a warning)
        "second_pass_empty": (one_block([(1, cleanup), (2, b"")], 7), "cleanup"),
        # "32 bits are not enough ... the number of bitplane, %d, is larger than 30"
        "bitplanes_31": (one_block([(1, cleanup)], 29, expn=30), None),
        # "We do not support more than 3 coding passes in an HT codeblock"
        "passes_4": (one_block([(1, cleanup), (3, refine)], 7), None),
        "passes_4_empty": (one_block([(1, cleanup), (3, b"")], 7), "cleanup"),
        # "Malformed HT codeblock ... There are %d zero bitplanes in %d bitplanes."
        "zero_bitplanes": (one_block([(1, cleanup)], 9), None),
        # "... only the cleanup pass makes sense ..." (a warning)
        "all_zero_bitplanes": (one_block([(1, ht_encode(q, 1)[0]), (2, refine)], 8), "cleanup"),
        # "Malformed HT codeblock. Invalid codeblock length values."
        "length_0": (one_block([(1, b"")], 8), None),
        "length_1": (one_block([(1, cleanup[-1:])], 8), None),
        # "... One of the following condition is not met: 2 <= Scup <= min(Lcup, 4079)"
        "scup_past_lcup": (one_block([(1, cleanup[:-1] + b"\xff")], 7), None),
        "scup_1": (one_block([(1, cleanup[:-2] + b"\x01\x00")], 7), None),
    }
    for name, (data, outcome) in cases.items():
        got = check(tmp_path, data)
        if outcome is None:
            assert got is None, name
        else:
            assert got is not None, name
    # no bit-planes in the band (expn 0, one guard bit): the block reads as zeros
    zeros = check(tmp_path, one_block([(1, cleanup)], 0, expn=0, guard=1))
    assert (zeros == 128).all()


def test_u_q_past_the_zero_bitplanes(tmp_path):
    """"U_q is larger than zero bitplanes + 1" in the first line pair, and
    its twin "U_q islarger than bitplanes + 1" in later ones: magnitudes
    coded past what the zero bit-planes allow."""
    small = np.zeros((8, 8), int)
    small[0, 0], small[5, 3] = 2, -1
    for row, want_none in ((0, True), (4, True), (7, True)):
        q = small.copy()
        q[row, 6] = 100
        cleanup = ht_encode(q, 1)[0]
        # band bit-planes 3: zero bit-planes 2 let U_q be 3 at most
        got = check(tmp_path, one_block([(1, cleanup)], 2, expn=2))
        assert (got is None) == want_none
    fits = check(tmp_path, one_block([(1, ht_encode(small, 1)[0])], 2, expn=2))
    np.testing.assert_array_equal(fits[..., 0].astype(int) - 128, small)


def test_significance_outside_the_block(tmp_path):
    """"VLC code produces significant samples outside the codeblock area":
    a cleanup written for a wider or taller block."""
    for shape, size in (((8, 4), (3, 8)), ((4, 8), (8, 3)), ((2, 2), (1, 1))):
        q = np.zeros(shape, int)
        q[shape[0] - 1, shape[1] - 1] = 3
        cleanup = ht_encode(q, 1)[0]
        assert check(tmp_path, one_block([(1, cleanup)], 8, w=size[0], h=size[1])) is None
        q[shape[0] - 1, shape[1] - 1] = 0
        q[0, 0] = 3
        assert check(tmp_path, one_block([(1, ht_encode(q, 1)[0])], 8, w=size[0],
                                         h=size[1])) is not None


def test_incorrect_mel_sequence_depends_on_where_the_segment_lies(tmp_path):
    """"Incorrect MEL segment sequence": an ``0xFF`` followed by a byte above
    ``0x8F`` among the MEL bytes OpenJPEG reads one at a time, up to an
    address that is a multiple of four.  The same MEL after 0-7 bytes of
    MagSgn (which no sample reads) is refused or read as zeros as the
    segment's address falls."""
    outcomes = []
    for k in range(8):
        segment = bytes([0x55] * k) + bytes([0xFF, 0x90, 0x04, 0x00])
        outcomes.append(check(tmp_path, one_block([(1, segment)], 8)) is None)
    assert any(outcomes) and not all(outcomes)


def test_placeholder_passes(tmp_path):
    """More passes than three in a first packet (Part 15's placeholder
    passes): OpenJPEG gives the cleanup segment one pass and the next all
    the others, and refuses the block unless that one is empty."""
    q = block(seed=2)
    cleanup = ht_encode(q, 1)[0]
    for extra, empty in ((3, True), (3, False), (6, True), (36, True)):
        tail = b"" if empty else b"\x00\x11"
        got = check(tmp_path, one_block([(1, cleanup), (extra, tail)], 8))
        assert (got is None) == (not empty)


def _segments(data):
    """(start, end) in ``data`` of every code-block segment the writer's
    single-tile codestream holds, from the port's packet reader."""
    from molnextr_tpu_torch.data import j2k_t2

    spans = []
    original = j2k_t2._read_data

    def spy(res, precno, tile_data, pos, end, keep):
        out = original(res, precno, tile_data, pos, end, keep)
        if out > pos:
            spans.append((pos, out))
        return out

    j2k_t2._read_data = spy
    try:
        decode(data)
    finally:
        j2k_t2._read_data = original
    base = data.index(b"\xff\x93") + 2
    return [(base + a, base + b) for a, b in spans]


def _fuzz_cases():
    rng = np.random.RandomState(22)
    cases = []
    for i in range(96):
        h, w = (int(v) for v in rng.randint(4, 33, 2))
        kw = dict(numres=int(rng.randint(1, 4)), cblk=(int(rng.randint(2, 5)),
                                                        int(rng.randint(2, 5))),
                  style=J2K_HT | (J2K_VSC if rng.rand() < 0.3 else 0), mct=1,
                  ht_passes=int(rng.randint(1, 4)), ht_drop=int(rng.randint(0, 2)),
                  reversible=bool(rng.rand() < 0.5))
        edits = [(float(rng.rand()), int(rng.randint(1 << 30)), int(rng.randint(256)))
                 for _ in range(int(rng.randint(1, 4)))]
        cases.append((i, h, w, kw, edits))
    return cases


@pytest.mark.parametrize("part", range(4))
def test_damaged_segments_read_as_cv2_reads_them(tmp_path, part):
    """A seeded corpus of HT segments with bytes flipped, set to 0xFF,
    0x7F or 0x8F/0x90, or cut: None exactly where cv2 gives None, its
    array elsewhere."""
    for i, h, w, kw, edits in _fuzz_cases()[part::4]:
        data = bytearray(rgb_j2k(picture(h, w, i, scale=2), **kw))
        spans = _segments(bytes(data))
        for r, where, value in edits:
            a, b = spans[where % len(spans)]
            pos = a + where % (b - a)
            if r < 0.4:
                data[pos] ^= 1 << (value & 7)
            elif r < 0.6:
                data[pos] = 0xFF
            elif r < 0.8:
                data[pos] = (0x7F, 0x8F, 0x90, 0x00)[value & 3]
            else:
                data[pos] = value
        check(tmp_path, bytes(data))
