"""AV1 decoding across frames: the eight reference slots and the frames of
a temporal unit decoded in order (the AV1 specification, sections 7.20
and 7.21, and the load processes of 7.8 and 6.8.2).

:func:`frames` walks every OBU of an AV1 payload and yields each shown
frame: a frame with ``show_frame``, or a ``show_existing_frame`` of a
slot (a key frame shown that way refreshes every slot with it).  Each
frame is decoded against the slots: its CDFs are the defaults, or those
its primary reference frame saved (``load_cdfs``, with ``load_previous``:
loop filter deltas, segmentation features, global motion parameters; the
previous segment map when the sizes agree), its motion field is projected
from the references' saved vectors (``data/av1_mvpred.py``), and after
the in-loop filters and superres (before film grain) it is saved into
the slots ``refresh_frame_flags`` names with the CDFs of tile
``context_update_tile_id`` (``disable_frame_end_update_cdf`` keeps the
loaded ones), every counter cleared, and its vectors towards past
references (``MfRefFrames``/``MfMvs``).  :func:`first_shown` is what an
image reader wants: the first shown frame, which fills no slot, since
nothing decoded after it reads one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional

import numpy as np

from molnextr_tpu_torch.data import av1_cdfs
from molnextr_tpu_torch.data.av1_obu import (KEY_FRAME, PRIMARY_REF_NONE, AV1Error, BitReader,
                                             FilmGrain, Frame, Sequence, _tile_count,
                                             _tile_group, frame_header, obus, relative_dist,
                                             sequence_header)

REFMVS_LIMIT = (1 << 12) - 1


@dataclass
class Slot:
    """What a reference slot holds of a decoded frame."""

    frame_type: int = KEY_FRAME
    order_hint: int = 0
    saved_order_hints: List[int] = field(default_factory=lambda: [0] * 8)
    upscaled_width: int = 0
    height: int = 0
    render: tuple = (0, 0)
    mi_rows: int = 0
    mi_cols: int = 0
    bit_depth: int = 8
    showable: bool = False
    grain: Optional[FilmGrain] = None
    gm_params: List[List[int]] = field(default_factory=list)
    lf_ref_deltas: List[int] = field(default_factory=list)
    lf_mode_deltas: List[int] = field(default_factory=list)
    seg_features: List[List[Optional[int]]] = field(default_factory=list)
    seg_ids: Optional[np.ndarray] = None
    cdfs: Optional[dict] = None
    planes: Optional[List[np.ndarray]] = None  # cut to the frame, after the in-loop filters
    mf_ref: Optional[np.ndarray] = None
    mf_mvs: Optional[np.ndarray] = None


@dataclass
class Shown:
    """A shown frame: its planes (cut to its size, before film grain), the
    grain to add, the sequence header and its size."""

    seq: Sequence
    planes: List[np.ndarray]
    grain: Optional[FilmGrain]
    width: int
    height: int


def frames(data: bytes, before: Optional[Callable[[int, int], None]] = None,
           first: bool = False) -> Iterator[Shown]:
    """Every shown frame of ``data``, in order, or with ``first`` only the
    first, which then fills no slot; ``before`` is called with the (width,
    height) of a frame that will be shown, before it is decoded."""
    seq: Optional[Sequence] = None
    slots: List[Optional[Slot]] = [None] * 8
    fr: Optional[Frame] = None
    tiles: list = []
    for obu_type, temporal_id, spatial_id, pos, end in obus(data):
        if obu_type == 1:
            r = BitReader(data, pos, end)
            seq = sequence_header(r)
            r.trailing()
        elif obu_type in (3, 6):
            if fr is not None:
                raise AV1Error("AV1: a frame header before the last frame's tiles")
            if seq is None:
                raise AV1Error("AV1: frame before a sequence header")
            r = BitReader(data, pos, end)
            fr = frame_header(r, seq, temporal_id, spatial_id, slots)
            if fr.show_existing:
                r.trailing()
                slot = slots[fr.existing_slot]
                if before is not None:
                    before(slot.upscaled_width, slot.height)
                if slot.frame_type == KEY_FRAME:
                    slot.showable = False
                    slots = [slot] * 8
                yield Shown(seq, slot.planes, slot.grain, slot.upscaled_width, slot.height)
                fr = None
                continue
            for i, hint in fr.lost_slots.items():
                slots[i] = Slot(order_hint=hint)
            if fr.show and before is not None:
                before(fr.upscaled_width, fr.height)
            if obu_type == 6:
                r.align()
                tiles = _tile_group(data, r, end, fr)
            else:
                r.trailing()
                tiles = []
        elif obu_type == 4 and fr is not None:
            tiles += _tile_group(data, BitReader(data, pos, end), end, fr)
        if fr is not None and len(tiles) >= _tile_count(fr):
            if len(tiles) > _tile_count(fr):
                raise AV1Error("AV1: more tiles than the frame has")
            dec, cdfs, prev_seg, planes = _decode_frame(seq, fr, data, tiles, slots)
            if fr.show and first:
                yield Shown(seq, planes, fr.grain, fr.upscaled_width, fr.height)
                return
            slot = save_state(seq, fr, dec, cdfs, prev_seg, planes)
            for i in range(8):
                if (fr.refresh >> i) & 1:
                    slots[i] = slot
            if fr.show:
                yield Shown(seq, slot.planes, fr.grain, fr.upscaled_width, fr.height)
            fr = None
    if seq is None:
        raise AV1Error("AV1: no sequence header")
    if fr is not None:
        raise AV1Error("AV1: tiles missing")


def first_shown(data: bytes, before: Optional[Callable[[int, int], None]] = None) -> Shown:
    for shown in frames(data, before, first=True):
        return shown
    raise AV1Error("AV1: no frame shown")


def _decode_frame(seq: Sequence, fr: Frame, data: bytes, tiles, slots):
    """Decode one frame against the slots: its decoder, the CDFs and
    segment map it loaded and its planes, cut to its size."""
    from molnextr_tpu_torch.data import av1_block
    from molnextr_tpu_torch.data.avif import filtered_planes

    cdfs, prev_seg, motion = load_state(seq, fr, slots)
    dec = av1_block.FrameDecoder(seq, fr, cdfs, slots, prev_seg, motion)
    dec.decode(data, tiles)
    planes = []
    for p, full in enumerate(filtered_planes(dec)):
        sx, sy = dec.ss[p]
        planes.append(full[: (fr.height + sy) >> sy, : (fr.upscaled_width + sx) >> sx])
    return dec, cdfs, prev_seg, planes


def load_state(seq: Sequence, fr: Frame, slots):
    """What a frame loads from the slots before its tiles: its CDFs (the
    defaults, or those its primary reference frame saved), the previous
    segment map (None where there is none of its size) and the projected
    motion field (``data/av1_mvpred.py``)."""
    from molnextr_tpu_torch.data import av1_mvpred

    prev = None
    if fr.primary_ref_frame != PRIMARY_REF_NONE:
        prev = slots[fr.ref_frame_idx[fr.primary_ref_frame]]
    if not fr.is_intra:
        for i in fr.ref_frame_idx:
            if slots[i] is None or slots[i].planes is None:
                raise AV1Error("AV1: an inter frame refers to a slot with no picture")
            if slots[i].bit_depth != seq.bit_depth:
                raise AV1Error("AV1: a reference frame of another bit depth")
    if prev is None or prev.cdfs is None:
        cdfs = av1_cdfs.fresh(av1_cdfs.q_context(fr.base_q_idx))
    else:
        cdfs = prev.cdfs  # each tile works on a copy; saved CDFs are never changed
    prev_seg = None
    if fr.seg_enabled and prev is not None and prev.seg_ids is not None and \
            prev.seg_ids.shape == (fr.mi_rows, fr.mi_cols):
        prev_seg = prev.seg_ids
    return cdfs, prev_seg, av1_mvpred.motion_field(seq, fr, slots)


def save_state(seq: Sequence, fr: Frame, dec, cdfs, prev_seg, planes) -> Slot:
    """The slot a decoded frame fills: its header's state, its planes, the
    CDFs of tile ``context_update_tile_id`` (``cdfs``, as loaded, under
    ``disable_frame_end_update_cdf``) with their counters cleared, its
    segment map and its motion field."""
    slot = Slot(frame_type=fr.frame_type, order_hint=fr.order_hint,
                saved_order_hints=list(fr.order_hints), upscaled_width=fr.upscaled_width,
                height=fr.height, render=fr.render, mi_rows=fr.mi_rows,
                mi_cols=fr.mi_cols, bit_depth=seq.bit_depth, showable=fr.showable,
                grain=fr.grain, gm_params=[list(g) for g in fr.gm_params],
                lf_ref_deltas=list(fr.lf_ref_deltas), lf_mode_deltas=list(fr.lf_mode_deltas),
                seg_features=[list(f) for f in fr.seg_features], planes=planes)
    if fr.disable_frame_end_update_cdf or dec.end_cdfs is None:
        slot.cdfs = cdfs  # the frame's CDFs as loaded, their counters 0
    else:
        slot.cdfs = dec.end_cdfs
        av1_cdfs.clear_counters(slot.cdfs)
    shape = (fr.mi_rows, fr.mi_cols)
    if not fr.seg_enabled:
        slot.seg_ids = np.zeros(shape, np.int64)
    elif fr.seg_update_map:
        slot.seg_ids = np.asarray(dec.seg, np.int64).reshape(shape)
    else:
        slot.seg_ids = prev_seg if prev_seg is not None else np.zeros(shape, np.int64)
    slot.mf_ref, slot.mf_mvs = _saved_motion(seq, fr, dec)
    return slot


def _saved_motion(seq: Sequence, fr: Frame, dec):
    """The motion field motion vector storage process: per MI the last of
    its vectors that points to a past reference, within ``REFMVS_LIMIT``."""
    shape = (fr.mi_rows, fr.mi_cols)
    mf_ref = np.zeros(shape, np.int64)
    mf_mvs = np.zeros(shape + (2,), np.int64)
    if fr.is_intra:
        return mf_ref, mf_mvs
    past = np.array([False] + [relative_dist(seq, fr.order_hints[r], fr.order_hint) < 0
                               for r in range(1, 8)])
    for refs, mvs in ((dec.ref0, dec.mv), (dec.ref1, dec.mv1)):
        ref = np.asarray(refs, np.int64).reshape(shape)
        mv = np.asarray(mvs, np.int64).reshape(shape + (2,))
        keep = (ref > 0) & past[np.maximum(ref, 0)] & (np.abs(mv) <= REFMVS_LIMIT).all(-1)
        mf_ref[keep] = ref[keep]
        mf_mvs[keep] = mv[keep]
    return mf_ref, mf_mvs
