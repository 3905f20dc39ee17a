"""AV1 OBUs and frame headers (the AV1 specification, sections 5.3-5.9),
as an AVIF item or sample carries them.

:func:`obus` walks the OBUs of a payload (``obu_has_size_field``, or one
last OBU that runs to the end); :func:`sequence_header` reads
``reduced_still_picture_header`` or not, the inter tools' flags, order
hints, ``color_config`` at 8, 10 and 12 bits, monochrome, the
subsampling; :func:`frame_header` reads any frame's
``uncompressed_header`` against the reference slots
(``data/av1_refs.py``): ``show_existing_frame``, KEY, INTER, INTRA_ONLY
and SWITCH frames, the size and render size (``frame_size_with_refs``),
superres (``superres_params``: the frame coded at a reduced width,
upscaled by ``data/av1_superres.py``), ``frame_refs_short_signaling``
with ``set_frame_refs``, ``ref_frame_idx``, ``OrderHints`` and
``RefFrameSignBias``, ``primary_ref_frame`` (whose loop filter deltas,
segmentation features and global motion parameters it loads),
``allow_high_precision_mv``, the interpolation filter,
``is_motion_mode_switchable``, ``use_ref_frame_mvs``,
``allow_screen_content_tools``, ``allow_intrabc``, ``tile_info`` (uniform
or not, ``context_update_tile_id``), quantisation with ``qm``,
segmentation (``update_map``, ``temporal_update``), ``delta_q``/``delta_lf``,
the loop filter, CDEF, loop restoration, ``tx_mode``, ``reference_select``,
``skip_mode_params``, ``allow_warped_motion``, ``reduced_tx_set``,
``global_motion_params`` and film grain (``update_grain``,
``film_grain_params_ref_idx``), and tile groups as byte ranges of the
payload; ``data/av1_refs.py`` walks the frames.

Every field the decoding process reads is kept on :class:`Frame`: the
quantiser deltas and matrix levels, the per-segment ``qindex`` and lossless
flag, ``delta_q``/``delta_lf``, the loop filter levels, sharpness and
deltas, the CDEF damping and strengths, the restoration types and unit
sizes, ``TxMode``, ``reduced_tx_set`` and the film grain parameters
(:class:`FilmGrain`, applied by ``data/av1_grain.py``).  A header libaom
would refuse is an ``AV1Error``, None.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from molnextr_tpu_torch.data.av1_superres import SUPERRES_DENOM_MIN, downscaled_width

TX_MODE_ONLY_4X4, TX_MODE_LARGEST, TX_MODE_SELECT = range(3)
RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = range(4)
_REMAP_LR_TYPE = (RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ)
_SEG_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
_SEG_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
_SEG_MAX = (255, 63, 63, 63, 63, 7, 0, 0)
KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME = range(4)
PRIMARY_REF_NONE = 7
SWITCHABLE = 4
IDENTITY, TRANSLATION, ROTZOOM, AFFINE = range(4)
GM_DEFAULT = (0, 0, 1 << 16, 0, 0, 1 << 16)
LF_REF_DELTAS = (1, 0, 0, 0, -1, 0, -1, -1)


class AV1Error(ValueError):
    """An AV1 bitstream libaom refuses."""


class BitReader:
    """MSB-first bits of ``data[start:end]``; reading past the end fails."""

    def __init__(self, data: bytes, start: int = 0, end: Optional[int] = None):
        self.data, self.bit, self.limit = data, start * 8, (len(data) if end is None else end) * 8

    def f(self, n: int) -> int:
        if self.bit + n > self.limit:
            raise AV1Error("AV1: header runs past its OBU")
        x = 0
        for _ in range(n):
            x = (x << 1) | ((self.data[self.bit >> 3] >> (7 - (self.bit & 7))) & 1)
            self.bit += 1
        return x

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        return v if v < m else (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        zeros = 0
        while not self.f(1):
            zeros += 1
            if zeros >= 32:
                return (1 << 32) - 1
        return self.f(zeros) + (1 << zeros) - 1

    def le(self, n: int) -> int:
        return sum(self.f(8) << (8 * i) for i in range(n))

    def align(self) -> None:
        """``byte_alignment``: zero bits up to the next byte (libaom fails a
        frame whose alignment bits are not zero)."""
        while self.bit & 7:
            if self.f(1):
                raise AV1Error("AV1: nonzero alignment bits")

    def trailing(self) -> None:
        """``trailing_bits`` after a header: a one bit, zeros to the byte's
        end (libaom's ``check_trailing_bits``)."""
        n = 8 - self.bit % 8
        if self.f(n) != 1 << (n - 1):
            raise AV1Error("AV1: header without its trailing bits")


def leb128(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    for i in range(8):
        if pos >= len(data):
            raise AV1Error("AV1: OBU size runs past the data")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return value, pos
    return value, pos


@dataclass
class Sequence:
    profile: int = 0
    reduced: bool = False
    use_128: bool = False
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = False
    enable_interintra: bool = False
    enable_masked: bool = False
    enable_warped: bool = False
    enable_dual_filter: bool = False
    enable_order_hint: bool = False
    enable_jnt_comp: bool = False
    enable_ref_frame_mvs: bool = False
    screen_tools: int = 2  # seq_force_screen_content_tools
    integer_mv: int = 2  # seq_force_integer_mv
    order_hint_bits: int = 0
    enable_superres: bool = False
    enable_cdef: bool = False
    enable_restoration: bool = False
    bit_depth: int = 8
    mono: bool = False
    ss_x: int = 1
    ss_y: int = 1
    primaries: int = 2
    transfer: int = 2
    matrix: int = 2
    full_range: bool = False
    separate_uv_delta_q: bool = False
    film_grain: bool = False
    width_bits: int = 0
    height_bits: int = 0
    max_width: int = 0
    max_height: int = 0
    frame_id_bits: int = 0  # 0 without frame ids
    delta_frame_id_bits: int = 0
    decoder_model: bool = False
    equal_picture_interval: bool = False
    buffer_removal_bits: int = 0
    presentation_bits: int = 0
    op_idc: List[int] = field(default_factory=list)
    op_model: List[bool] = field(default_factory=list)

    @property
    def planes(self) -> int:
        return 1 if self.mono else 3


def sequence_header(r: BitReader) -> Sequence:
    s = Sequence()
    s.profile = r.f(3)
    if s.profile > 2:
        raise AV1Error(f"AV1: profile {s.profile}")
    r.f(1)  # still_picture
    s.reduced = bool(r.f(1))
    if s.reduced:
        _level(r.f(5))
        s.op_idc, s.op_model = [0], [False]
    else:
        if r.f(1):  # timing_info_present_flag
            r.f(32)
            r.f(32)
            s.equal_picture_interval = bool(r.f(1))
            if s.equal_picture_interval:
                r.uvlc()
            s.decoder_model = bool(r.f(1))
            if s.decoder_model:
                delay_bits = r.f(5) + 1
                r.f(32)
                s.buffer_removal_bits = r.f(5) + 1
                s.presentation_bits = r.f(5) + 1
        else:
            s.decoder_model = False
        initial_delay = r.f(1)
        for _ in range(r.f(5) + 1):
            s.op_idc.append(r.f(12))
            if _level(r.f(5)) > 7:
                r.f(1)  # seq_tier
            model = False
            if s.decoder_model:
                model = bool(r.f(1))
                if model:
                    r.f(delay_bits)
                    r.f(delay_bits)
                    r.f(1)
            s.op_model.append(model)
            if initial_delay and r.f(1):
                r.f(4)
    s.width_bits, s.height_bits = r.f(4) + 1, r.f(4) + 1
    s.max_width, s.max_height = r.f(s.width_bits) + 1, r.f(s.height_bits) + 1
    if not s.reduced and r.f(1):  # frame_id_numbers_present_flag
        s.delta_frame_id_bits = delta = r.f(4) + 2
        s.frame_id_bits = r.f(3) + delta + 1
    s.use_128 = bool(r.f(1))
    s.enable_filter_intra = bool(r.f(1))
    s.enable_intra_edge_filter = bool(r.f(1))
    if not s.reduced:
        s.enable_interintra, s.enable_masked = bool(r.f(1)), bool(r.f(1))
        s.enable_warped, s.enable_dual_filter = bool(r.f(1)), bool(r.f(1))
        order_hint = s.enable_order_hint = bool(r.f(1))
        if order_hint:
            s.enable_jnt_comp, s.enable_ref_frame_mvs = bool(r.f(1)), bool(r.f(1))
        s.screen_tools = 2 if r.f(1) else r.f(1)
        if s.screen_tools > 0:
            s.integer_mv = 2 if r.f(1) else r.f(1)
        if order_hint:
            s.order_hint_bits = r.f(3) + 1
    s.enable_superres = bool(r.f(1))
    s.enable_cdef = bool(r.f(1))
    s.enable_restoration = bool(r.f(1))
    _color_config(r, s)
    s.film_grain = bool(r.f(1))
    return s


def _level(idx: int) -> int:
    """A ``seq_level_idx`` libaom 3.14 defines (or 31, no level)."""
    if idx != 31 and (idx >= 20 or idx in (2, 3, 6, 7, 10, 11)):
        raise AV1Error(f"AV1: seq_level_idx {idx} is not defined")
    return idx


def _color_config(r: BitReader, s: Sequence) -> None:
    high = r.f(1)
    if s.profile == 2 and high:
        s.bit_depth = 12 if r.f(1) else 10
    else:
        s.bit_depth = 10 if high else 8
    s.mono = bool(r.f(1)) if s.profile != 1 else False
    if r.f(1):  # color_description_present_flag
        s.primaries, s.transfer, s.matrix = r.f(8), r.f(8), r.f(8)
    if s.mono:
        s.full_range = bool(r.f(1))
        s.ss_x = s.ss_y = 1
        return
    if s.primaries == 1 and s.transfer == 13 and s.matrix == 0:
        s.full_range = True
        s.ss_x = s.ss_y = 0
    else:
        s.full_range = bool(r.f(1))
        if s.profile == 0:
            s.ss_x = s.ss_y = 1
        elif s.profile == 1:
            s.ss_x = s.ss_y = 0
        elif s.bit_depth == 12:
            s.ss_x = r.f(1)
            s.ss_y = r.f(1) if s.ss_x else 0
        else:
            s.ss_x, s.ss_y = 1, 0
        if s.ss_x and s.ss_y:
            r.f(2)  # chroma_sample_position
    s.separate_uv_delta_q = bool(r.f(1))


@dataclass
class FilmGrain:
    """``film_grain_params`` of a frame that applies grain, as read (the
    ``*_plus_128`` coefficients less 128; scaling points as (value,
    scaling) pairs)."""

    grain_seed: int = 0
    point_y: List[Tuple[int, int]] = field(default_factory=list)
    chroma_scaling_from_luma: bool = False
    point_cb: List[Tuple[int, int]] = field(default_factory=list)
    point_cr: List[Tuple[int, int]] = field(default_factory=list)
    grain_scaling_minus_8: int = 0
    ar_coeff_lag: int = 0
    ar_coeffs_y: List[int] = field(default_factory=list)
    ar_coeffs_cb: List[int] = field(default_factory=list)
    ar_coeffs_cr: List[int] = field(default_factory=list)
    ar_coeff_shift_minus_6: int = 0
    grain_scale_shift: int = 0
    cb_mult: int = 0
    cb_luma_mult: int = 0
    cb_offset: int = 0
    cr_mult: int = 0
    cr_luma_mult: int = 0
    cr_offset: int = 0
    overlap_flag: bool = False
    clip_to_restricted_range: bool = False


@dataclass
class Frame:
    """What decoding a frame needs of its header (``width`` is the coded
    ``FrameWidth``, below ``upscaled_width`` under superres).  Reference
    frames are indexed as the specification's ``LAST_FRAME`` (1) ..
    ``ALTREF_FRAME`` (7); ``ref_frame_idx`` holds the slot of each."""

    width: int = 0
    upscaled_width: int = 0
    superres_denom: int = 8  # SuperresDenom; SUPERRES_NUM without superres
    height: int = 0
    render: Tuple[int, int] = (0, 0)
    mi_cols: int = 0
    mi_rows: int = 0
    frame_type: int = KEY_FRAME
    show_existing: bool = False
    existing_slot: int = 0
    error_resilient: bool = True
    disable_cdf_update: bool = False
    disable_frame_end_update_cdf: bool = True
    context_update_tile_id: int = 0
    screen_tools: bool = False
    force_integer_mv: bool = True
    allow_intrabc: bool = False
    order_hint: int = 0
    primary_ref_frame: int = PRIMARY_REF_NONE
    ref_frame_idx: List[int] = field(default_factory=lambda: [0] * 7)
    order_hints: List[int] = field(default_factory=lambda: [0] * 8)  # OrderHints[ref]
    sign_bias: List[int] = field(default_factory=lambda: [0] * 8)  # RefFrameSignBias[ref]
    allow_hp: bool = False
    interp_filter: int = 0  # 0-3, or SWITCHABLE
    motion_switchable: bool = False
    use_ref_frame_mvs: bool = False
    reference_select: bool = False
    skip_mode_present: bool = False
    skip_mode_frames: Tuple[int, int] = (0, 0)
    allow_warped: bool = False
    gm_type: List[int] = field(default_factory=lambda: [IDENTITY] * 8)
    gm_params: List[List[int]] = field(default_factory=lambda: [list(GM_DEFAULT) for _ in range(8)])
    base_q_idx: int = 0
    seg_enabled: bool = False
    seg_update_map: bool = True
    seg_temporal_update: bool = False
    seg_features: List[List[Optional[int]]] = field(default_factory=lambda: [[None] * 8] * 8)
    seg_id_pre_skip: bool = False
    last_active_seg_id: int = 0
    col_starts: List[int] = field(default_factory=list)
    row_starts: List[int] = field(default_factory=list)
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    tile_size_bytes: int = 4
    # quantisation: DC/AC deltas per plane as (dc, ac), matrix levels per plane
    delta_q: List[Tuple[int, int]] = field(default_factory=lambda: [(0, 0)] * 3)
    using_qmatrix: bool = False
    qm: List[int] = field(default_factory=lambda: [15, 15, 15])
    qindex: List[int] = field(default_factory=lambda: [0] * 8)  # per segment, no delta_q
    lossless: List[bool] = field(default_factory=lambda: [True] * 8)
    coded_lossless: bool = True
    delta_q_present: bool = False
    delta_q_res: int = 0
    delta_lf_present: bool = False
    delta_lf_res: int = 0
    delta_lf_multi: bool = False
    # loop filter: levels (luma vertical, luma horizontal, U, V)
    lf_level: List[int] = field(default_factory=lambda: [0, 0, 0, 0])
    lf_sharpness: int = 0
    lf_delta_enabled: bool = False
    lf_ref_deltas: List[int] = field(default_factory=lambda: list(LF_REF_DELTAS))
    lf_mode_deltas: List[int] = field(default_factory=lambda: [0, 0])
    # CDEF: damping, bits and the strengths as (primary, secondary) per index
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_y: List[Tuple[int, int]] = field(default_factory=lambda: [(0, 0)])
    cdef_uv: List[Tuple[int, int]] = field(default_factory=lambda: [(0, 0)])
    # loop restoration: type and unit size per plane
    lr_type: List[int] = field(default_factory=lambda: [RESTORE_NONE] * 3)
    lr_size: List[int] = field(default_factory=lambda: [64] * 3)
    tx_mode: int = TX_MODE_ONLY_4X4
    reduced_tx_set: bool = False
    grain: Optional[FilmGrain] = None  # film grain to apply when the frame is shown
    show: bool = True
    showable: bool = False
    refresh: int = 0xFF  # refresh_frame_flags
    lost_slots: Dict[int, int] = field(default_factory=dict)  # slot -> ref_order_hint

    @property
    def uses_lr(self) -> bool:
        return any(t != RESTORE_NONE for t in self.lr_type)

    @property
    def use_superres(self) -> bool:
        return self.upscaled_width != self.width

    @property
    def is_intra(self) -> bool:
        return self.frame_type in (KEY_FRAME, INTRA_ONLY_FRAME)


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def relative_dist(s: Sequence, a: int, b: int) -> int:
    """``get_relative_dist`` of two order hints."""
    if not s.enable_order_hint:
        return 0
    diff = a - b
    m = 1 << (s.order_hint_bits - 1)
    return (diff & (m - 1)) - (diff & m)


def _slot(refs, i: int):
    ref = refs[i] if refs is not None else None
    if ref is None:
        raise AV1Error(f"AV1: a frame refers to reference slot {i}, which holds no frame")
    return ref


def frame_header(r: BitReader, s: Sequence, temporal_id: int, spatial_id: int,
                 refs=None) -> Frame:
    """``uncompressed_header`` of any frame: key, inter, intra-only or
    switch, or a ``show_existing_frame``.  ``refs`` holds the eight
    reference slots (objects with the saved header state of
    ``data/av1_refs.py``, None where a slot is empty); without it every
    slot is empty."""
    fr = Frame()
    slot_hint = [ref.order_hint if ref is not None else 0 for ref in (refs or [None] * 8)]
    if s.reduced:
        frame_type, show_frame = KEY_FRAME, True
    else:
        if r.f(1):  # show_existing_frame
            fr.show_existing = True
            fr.existing_slot = r.f(3)
            if s.decoder_model and not s.equal_picture_interval:
                r.f(s.presentation_bits)  # temporal_point_info
            if s.frame_id_bits:
                r.f(s.frame_id_bits)  # display_frame_id
            ref = _slot(refs, fr.existing_slot)
            if not ref.showable:
                raise AV1Error("AV1: show_existing_frame of a slot with no showable frame")
            fr.frame_type = ref.frame_type
            fr.refresh = 0xFF if ref.frame_type == KEY_FRAME else 0
            fr.grain = ref.grain
            return fr
        frame_type = r.f(2)
        show_frame = bool(r.f(1))
        if show_frame and s.decoder_model and not s.equal_picture_interval:
            r.f(s.presentation_bits)  # temporal_point_info
        fr.showable = frame_type != KEY_FRAME if show_frame else bool(r.f(1))
        if frame_type == SWITCH_FRAME or (frame_type == KEY_FRAME and show_frame):
            fr.error_resilient = True
        else:
            fr.error_resilient = bool(r.f(1))
    fr.frame_type = frame_type
    fr.show = show_frame
    if frame_type == KEY_FRAME and show_frame:
        refs = None
        slot_hint = [0] * 8
    fr.disable_cdf_update = bool(r.f(1))
    fr.screen_tools = bool(r.f(1) if s.screen_tools == 2 else s.screen_tools)
    if fr.screen_tools:
        fr.force_integer_mv = bool(r.f(1) if s.integer_mv == 2 else s.integer_mv)
    else:
        fr.force_integer_mv = False
    if fr.is_intra:
        fr.force_integer_mv = True
    if s.frame_id_bits:
        r.f(s.frame_id_bits)  # current_frame_id
    if frame_type == SWITCH_FRAME:
        size_override = 1
    else:
        size_override = 0 if s.reduced else r.f(1)
    fr.order_hint = r.f(s.order_hint_bits)
    if fr.is_intra or fr.error_resilient:
        fr.primary_ref_frame = PRIMARY_REF_NONE
    else:
        fr.primary_ref_frame = r.f(3)
    if s.decoder_model and r.f(1):  # buffer_removal_time_present_flag
        for idc, model in zip(s.op_idc, s.op_model):
            if model:
                in_t = (idc >> temporal_id) & 1
                in_s = (idc >> (spatial_id + 8)) & 1
                if idc == 0 or (in_t and in_s):
                    r.f(s.buffer_removal_bits)
    if frame_type == SWITCH_FRAME or (frame_type == KEY_FRAME and show_frame):
        fr.refresh = 0xFF
    else:
        fr.refresh = r.f(8)
    if frame_type == INTRA_ONLY_FRAME and fr.refresh == 0xFF:
        raise AV1Error("AV1: an intra-only frame refreshing every reference")
    if (not fr.is_intra or fr.refresh != 0xFF) and fr.error_resilient and s.enable_order_hint:
        for i in range(8):
            hint = r.f(s.order_hint_bits)  # ref_order_hint[]
            if hint != slot_hint[i] or (refs is None or refs[i] is None):
                # libaom puts a frame of that order hint, and no picture, there
                fr.lost_slots[i] = hint
                slot_hint[i] = hint
    if fr.is_intra:
        _frame_size(r, s, fr, size_override)
        if fr.screen_tools and not fr.use_superres:
            fr.allow_intrabc = bool(r.f(1))
    else:
        short = bool(r.f(1)) if s.enable_order_hint else False
        if short:
            last, gold = r.f(3), r.f(3)
            fr.ref_frame_idx = _set_frame_refs(s, slot_hint, fr.order_hint, last, gold)
        for i in range(7):
            if not short:
                fr.ref_frame_idx[i] = r.f(3)
            if s.frame_id_bits:
                r.f(s.delta_frame_id_bits)  # delta_frame_id_minus_1
        for i in fr.ref_frame_idx:
            _slot(refs, i)
        found = False
        if size_override and not fr.error_resilient:
            for i in range(7):
                if r.f(1):  # found_ref
                    ref = refs[fr.ref_frame_idx[i]]
                    fr.upscaled_width = fr.width = ref.upscaled_width
                    fr.height, fr.render = ref.height, ref.render
                    found = True
                    break
        if found:
            _superres(r, s, fr)
        else:
            _frame_size(r, s, fr, size_override)
        fr.allow_hp = False if fr.force_integer_mv else bool(r.f(1))
        fr.interp_filter = SWITCHABLE if r.f(1) else r.f(2)
        fr.motion_switchable = bool(r.f(1))
        if not fr.error_resilient and s.enable_ref_frame_mvs:
            fr.use_ref_frame_mvs = bool(r.f(1))
        for i in range(7):
            hint = slot_hint[fr.ref_frame_idx[i]]
            fr.order_hints[1 + i] = hint
            fr.sign_bias[1 + i] = int(relative_dist(s, hint, fr.order_hint) > 0)
    if s.reduced or fr.disable_cdf_update:
        fr.disable_frame_end_update_cdf = True
    else:
        fr.disable_frame_end_update_cdf = bool(r.f(1))
    prev = None
    if fr.primary_ref_frame != PRIMARY_REF_NONE:
        prev = _slot(refs, fr.ref_frame_idx[fr.primary_ref_frame])  # load_previous
        fr.lf_ref_deltas, fr.lf_mode_deltas = list(prev.lf_ref_deltas), list(prev.lf_mode_deltas)
    _tile_info(r, s, fr)
    # quantization_params
    fr.base_q_idx = r.f(8)
    y_dc = _delta_q(r)
    u = v = (0, 0)
    if s.planes > 1:
        diff_uv = r.f(1) if s.separate_uv_delta_q else 0
        u = (_delta_q(r), _delta_q(r))
        v = (_delta_q(r), _delta_q(r)) if diff_uv else u
    fr.delta_q = [(y_dc, 0), u, v]
    fr.using_qmatrix = bool(r.f(1))
    if fr.using_qmatrix:
        qm_y, qm_u = r.f(4), r.f(4)
        qm_v = r.f(4) if s.separate_uv_delta_q else qm_u
        fr.qm = [qm_y, qm_u, qm_v]
    _segmentation_params(r, fr, prev)
    # delta_q_params, delta_lf_params
    if fr.base_q_idx > 0:
        fr.delta_q_present = bool(r.f(1))
    if fr.delta_q_present:
        fr.delta_q_res = r.f(2)
        if not fr.allow_intrabc:
            fr.delta_lf_present = bool(r.f(1))
        if fr.delta_lf_present:
            fr.delta_lf_res = r.f(2)
            fr.delta_lf_multi = bool(r.f(1))
    no_deltas = not any(d for pair in fr.delta_q for d in pair)
    fr.qindex = [_qindex(fr, seg) for seg in range(8)]
    fr.lossless = [q == 0 and no_deltas for q in fr.qindex]
    fr.coded_lossless = all(fr.lossless)
    _loop_filter_params(r, s, fr)
    _cdef_params(r, s, fr)
    _lr_params(r, s, fr)
    if not fr.coded_lossless:
        fr.tx_mode = TX_MODE_SELECT if r.f(1) else TX_MODE_LARGEST
    if not fr.is_intra:
        fr.reference_select = bool(r.f(1))
    if _skip_mode_allowed(s, fr, slot_hint):
        fr.skip_mode_present = bool(r.f(1))
    if not (fr.is_intra or fr.error_resilient) and s.enable_warped:
        fr.allow_warped = bool(r.f(1))
    fr.reduced_tx_set = bool(r.f(1))
    if not fr.is_intra:
        _global_motion_params(r, fr, prev)
    if s.film_grain and (fr.show or fr.showable) and r.f(1):  # apply_grain
        fr.grain = _film_grain(r, s, fr, refs)
    return fr


def _frame_size(r: BitReader, s: Sequence, fr: Frame, size_override: int) -> None:
    """``frame_size``, ``superres_params`` and ``render_size``."""
    if size_override:
        fr.width, fr.height = r.f(s.width_bits) + 1, r.f(s.height_bits) + 1
    else:
        fr.width, fr.height = s.max_width, s.max_height
    fr.upscaled_width = fr.width
    _superres(r, s, fr)
    if r.f(1):  # render_and_frame_size_different
        fr.render = (r.f(16) + 1, r.f(16) + 1)
    else:
        fr.render = (fr.upscaled_width, fr.height)


def _superres(r: BitReader, s: Sequence, fr: Frame) -> None:
    fr.width = fr.upscaled_width
    fr.superres_denom = 8
    if s.enable_superres and r.f(1):  # use_superres, then coded_denom
        fr.superres_denom = r.f(3) + SUPERRES_DENOM_MIN
        fr.width = downscaled_width(fr.upscaled_width, fr.superres_denom)
    fr.mi_cols, fr.mi_rows = 2 * ((fr.width + 7) >> 3), 2 * ((fr.height + 7) >> 3)


def _set_frame_refs(s: Sequence, slot_hint: List[int], order_hint: int, last: int,
                    gold: int) -> List[int]:
    """The ``set_frame_refs`` process of ``frame_refs_short_signaling``."""
    idx = [-1] * 7
    idx[0], idx[3] = last, gold
    used = [False] * 8
    used[last] = used[gold] = True
    cur = 1 << (s.order_hint_bits - 1)
    shifted = [cur + relative_dist(s, slot_hint[i], order_hint) for i in range(8)]
    if shifted[last] >= cur or shifted[gold] >= cur:
        raise AV1Error("AV1: short-signalled LAST or GOLDEN frame not in the past")

    def pick(backward: bool, latest: bool) -> int:
        ref, best = -1, 0
        for i in range(8):
            hint = shifted[i]
            if used[i] or (hint >= cur) != backward:
                continue
            if ref < 0 or (hint >= best if latest else hint < best):
                ref, best = i, hint
        return ref

    for target, backward, latest in ((6, True, True), (4, True, False), (5, True, False)):
        ref = pick(backward, latest)
        if ref >= 0:
            idx[target] = ref
            used[ref] = True
    for target in (1, 2, 4, 5, 6):  # LAST2, LAST3, BWDREF, ALTREF2, ALTREF
        if idx[target] < 0:
            ref = pick(False, True)
            if ref >= 0:
                idx[target] = ref
                used[ref] = True
    ref, earliest = -1, 0
    for i in range(8):
        if ref < 0 or shifted[i] < earliest:
            ref, earliest = i, shifted[i]
    return [ref if i < 0 else i for i in idx]


def _skip_mode_allowed(s: Sequence, fr: Frame, slot_hint: List[int]) -> bool:
    """``skip_mode_params``: whether ``skip_mode_present`` is read, and
    ``SkipModeFrame``."""
    if fr.is_intra or not fr.reference_select or not s.enable_order_hint:
        return False
    fwd = bwd = -1
    fwd_hint = bwd_hint = 0
    for i in range(7):
        hint = slot_hint[fr.ref_frame_idx[i]]
        d = relative_dist(s, hint, fr.order_hint)
        if d < 0:
            if fwd < 0 or relative_dist(s, hint, fwd_hint) > 0:
                fwd, fwd_hint = i, hint
        elif d > 0:
            if bwd < 0 or relative_dist(s, hint, bwd_hint) < 0:
                bwd, bwd_hint = i, hint
    if fwd < 0:
        return False
    if bwd < 0:
        fwd2, fwd2_hint = -1, 0
        for i in range(7):
            hint = slot_hint[fr.ref_frame_idx[i]]
            if relative_dist(s, hint, fwd_hint) < 0:
                if fwd2 < 0 or relative_dist(s, hint, fwd2_hint) > 0:
                    fwd2, fwd2_hint = i, hint
        if fwd2 < 0:
            return False
        bwd = fwd2
    fr.skip_mode_frames = (1 + min(fwd, bwd), 1 + max(fwd, bwd))
    return True


def _segmentation_params(r: BitReader, fr: Frame, prev) -> None:
    """``segmentation_params``: features read, or kept from the primary
    reference frame (``load_previous``) when not updated."""
    fr.seg_enabled = bool(r.f(1))
    features = [[None] * 8 for _ in range(8)]
    if fr.seg_enabled:
        if prev is None:
            fr.seg_update_map, fr.seg_temporal_update, update_data = True, False, 1
        else:
            fr.seg_update_map = bool(r.f(1))
            fr.seg_temporal_update = bool(r.f(1)) if fr.seg_update_map else False
            update_data = r.f(1)
        if update_data:
            for i in range(8):
                for j in range(8):
                    if r.f(1):
                        if _SEG_SIGNED[j]:
                            v_ = max(-_SEG_MAX[j], min(_SEG_MAX[j], r.su(1 + _SEG_BITS[j])))
                        else:
                            v_ = min(_SEG_MAX[j], r.f(_SEG_BITS[j]))
                        features[i][j] = v_
        else:
            features = [list(row) for row in prev.seg_features]
    fr.seg_features = features
    for i in range(8):
        for j in range(8):
            if features[i][j] is not None:
                fr.last_active_seg_id = i
                if j >= 5:
                    fr.seg_id_pre_skip = True


def _global_motion_params(r: BitReader, fr: Frame, prev) -> None:
    """``global_motion_params`` against the primary reference frame's
    (``PrevGmParams``; the defaults without one)."""
    for ref in range(1, 8):
        prev_params = prev.gm_params[ref] if prev is not None else GM_DEFAULT
        if not r.f(1):  # is_global
            continue
        if r.f(1):
            kind = ROTZOOM
        else:
            kind = TRANSLATION if r.f(1) else AFFINE
        fr.gm_type[ref] = kind
        params = fr.gm_params[ref]
        if kind >= ROTZOOM:
            for i in (2, 3):
                params[i] = _global_param(r, fr, kind, i, prev_params)
            if kind == AFFINE:
                for i in (4, 5):
                    params[i] = _global_param(r, fr, kind, i, prev_params)
            else:
                params[4], params[5] = -params[3], params[2]
        for i in (0, 1):
            params[i] = _global_param(r, fr, kind, i, prev_params)


def _global_param(r: BitReader, fr: Frame, kind: int, idx: int, prev_params) -> int:
    abs_bits, prec_bits = 12, 15
    if idx < 2:
        if kind == TRANSLATION:
            abs_bits, prec_bits = 9 - (not fr.allow_hp), 3 - (not fr.allow_hp)
        else:
            abs_bits, prec_bits = 12, 6
    prec_diff = 16 - prec_bits
    rnd = 1 << 16 if idx % 3 == 2 else 0
    sub = 1 << prec_bits if idx % 3 == 2 else 0
    mx = 1 << abs_bits
    ref = (prev_params[idx] >> prec_diff) - sub
    # decode_signed_subexp_with_ref(-mx, mx + 1, ref)
    low, high = -mx, mx + 1
    num, rr = high - low, ref - low
    i, mk, k = 0, 0, 3
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num <= mk + 3 * a:
            v = r.ns(num - mk) + mk
            break
        if not r.f(1):
            v = r.f(b2) + mk
            break
        i += 1
        mk += a
    if (rr << 1) <= num:
        x = _inverse_recenter(rr, v)
    else:
        x = num - 1 - _inverse_recenter(num - 1 - rr, v)
    return ((x + low) << prec_diff) + rnd


def _inverse_recenter(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    return r - ((v + 1) >> 1) if v & 1 else r + (v >> 1)


def _loop_filter_params(r: BitReader, s: Sequence, fr: Frame) -> None:
    if fr.coded_lossless or fr.allow_intrabc:
        fr.lf_ref_deltas, fr.lf_mode_deltas = list(LF_REF_DELTAS), [0, 0]
        return
    fr.lf_level[0], fr.lf_level[1] = r.f(6), r.f(6)
    if s.planes > 1 and (fr.lf_level[0] or fr.lf_level[1]):
        fr.lf_level[2], fr.lf_level[3] = r.f(6), r.f(6)
    fr.lf_sharpness = r.f(3)
    fr.lf_delta_enabled = bool(r.f(1))
    if fr.lf_delta_enabled and r.f(1):  # loop_filter_delta_update
        for i in range(8):
            if r.f(1):
                fr.lf_ref_deltas[i] = r.su(7)
        for i in range(2):
            if r.f(1):
                fr.lf_mode_deltas[i] = r.su(7)


def _cdef_params(r: BitReader, s: Sequence, fr: Frame) -> None:
    if fr.coded_lossless or fr.allow_intrabc or not s.enable_cdef:
        return
    fr.cdef_damping = r.f(2) + 3
    fr.cdef_bits = r.f(2)
    fr.cdef_y, fr.cdef_uv = [], []
    for _ in range(1 << fr.cdef_bits):
        pri, sec = r.f(4), r.f(2)
        fr.cdef_y.append((pri, 4 if sec == 3 else sec))
        if s.planes > 1:
            pri, sec = r.f(4), r.f(2)
            fr.cdef_uv.append((pri, 4 if sec == 3 else sec))
        else:
            fr.cdef_uv.append((0, 0))


def _lr_params(r: BitReader, s: Sequence, fr: Frame) -> None:
    """``lr_params``: none when ``AllLossless`` (coded lossless and not
    superres)."""
    all_lossless = fr.coded_lossless and not fr.use_superres
    if all_lossless or fr.allow_intrabc or not s.enable_restoration:
        return
    fr.lr_type = [_REMAP_LR_TYPE[r.f(2)] for _ in range(s.planes)] + \
        [RESTORE_NONE] * (3 - s.planes)
    if not fr.uses_lr:
        return
    if s.use_128:
        shift = r.f(1) + 1
    else:
        shift = r.f(1)
        if shift:
            shift += r.f(1)
    uv_shift = 0
    if s.ss_x and s.ss_y and any(t != RESTORE_NONE for t in fr.lr_type[1:]):
        uv_shift = r.f(1)
    size = 256 >> (2 - shift)
    fr.lr_size = [size, size >> uv_shift, size >> uv_shift]


def _film_grain(r: BitReader, s: Sequence, fr: Frame, refs) -> FilmGrain:
    """``film_grain_params`` of a frame with ``apply_grain``, with libaom's
    checks (``read_film_grain_params``); an inter frame without
    ``update_grain`` takes a reference frame's (``load_grain_params``)
    with its own seed."""
    seed = r.f(16)
    if fr.frame_type == INTER_FRAME and not r.f(1):  # update_grain
        idx = r.f(3)  # film_grain_params_ref_idx
        if idx not in fr.ref_frame_idx:
            raise AV1Error("AV1: film grain parameters of a slot the frame does not refer to")
        ref = _slot(refs, idx).grain
        if ref is None:
            raise AV1Error("AV1: film grain parameters of a frame without grain")
        return replace(ref, grain_seed=seed)
    g = FilmGrain(grain_seed=seed)
    g.point_y = _scaling_points(r, 14, "luma")
    g.chroma_scaling_from_luma = bool(0 if s.mono else r.f(1))
    if not (s.mono or g.chroma_scaling_from_luma
            or (s.ss_x == 1 and s.ss_y == 1 and not g.point_y)):
        g.point_cb = _scaling_points(r, 10, "cb")
        g.point_cr = _scaling_points(r, 10, "cr")
        if s.ss_x == 1 and s.ss_y == 1 and bool(g.point_cb) != bool(g.point_cr):
            raise AV1Error("AV1: 4:2:0 film grain on one chroma plane only")
    g.grain_scaling_minus_8 = r.f(2)
    g.ar_coeff_lag = r.f(2)
    pos_luma = 2 * g.ar_coeff_lag * (g.ar_coeff_lag + 1)
    pos_chroma = pos_luma + 1 if g.point_y else pos_luma
    if g.point_y:
        g.ar_coeffs_y = [r.f(8) - 128 for _ in range(pos_luma)]
    if g.chroma_scaling_from_luma or g.point_cb:
        g.ar_coeffs_cb = [r.f(8) - 128 for _ in range(pos_chroma)]
    if g.chroma_scaling_from_luma or g.point_cr:
        g.ar_coeffs_cr = [r.f(8) - 128 for _ in range(pos_chroma)]
    g.ar_coeff_shift_minus_6 = r.f(2)
    g.grain_scale_shift = r.f(2)
    if g.point_cb:
        g.cb_mult, g.cb_luma_mult, g.cb_offset = r.f(8), r.f(8), r.f(9)
    if g.point_cr:
        g.cr_mult, g.cr_luma_mult, g.cr_offset = r.f(8), r.f(8), r.f(9)
    g.overlap_flag = bool(r.f(1))
    g.clip_to_restricted_range = bool(r.f(1))
    return g


def _scaling_points(r: BitReader, most: int, plane: str) -> List[Tuple[int, int]]:
    n = r.f(4)
    if n > most:
        raise AV1Error(f"AV1: {n} film grain {plane} scaling points")
    points: List[Tuple[int, int]] = []
    for _ in range(n):
        x = r.f(8)
        if points and points[-1][0] >= x:
            raise AV1Error("AV1: film grain scaling points not increasing")
        points.append((x, r.f(8)))
    return points


def _delta_q(r: BitReader) -> int:
    return r.su(7) if r.f(1) else 0


def _qindex(fr: Frame, seg: int) -> int:
    alt = fr.seg_features[seg][0] if fr.seg_enabled else None
    return fr.base_q_idx if alt is None else max(0, min(255, fr.base_q_idx + alt))


def _tile_info(r: BitReader, s: Sequence, fr: Frame) -> None:
    sb_shift = 5 if s.use_128 else 4
    sb_cols = (fr.mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (fr.mi_rows + (1 << sb_shift) - 1) >> sb_shift
    sb_size = sb_shift + 2
    max_width_sb = 4096 >> sb_size
    max_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_cols = _tile_log2(max_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols, _tile_log2(max_area_sb, sb_rows * sb_cols))
    if r.f(1):  # uniform_tile_spacing_flag
        cols_log2 = min_log2_cols
        while cols_log2 < max_log2_cols and r.f(1):
            cols_log2 += 1
        width_sb = (sb_cols + (1 << cols_log2) - 1) >> cols_log2
        fr.col_starts = [c << sb_shift for c in range(0, sb_cols, width_sb)]
        rows_log2 = max(min_log2_tiles - cols_log2, 0)
        while rows_log2 < max_log2_rows and r.f(1):
            rows_log2 += 1
        height_sb = (sb_rows + (1 << rows_log2) - 1) >> rows_log2
        fr.row_starts = [c << sb_shift for c in range(0, sb_rows, height_sb)]
    else:
        widest, start = 0, 0
        fr.col_starts = []
        while start < sb_cols:
            fr.col_starts.append(start << sb_shift)
            size = r.ns(min(sb_cols - start, max_width_sb)) + 1
            widest = max(size, widest)
            start += size
        cols_log2 = _tile_log2(1, len(fr.col_starts))
        area = (sb_rows * sb_cols) >> (min_log2_tiles + 1) if min_log2_tiles else \
            sb_rows * sb_cols
        max_height_sb = max(area // widest, 1)
        start = 0
        fr.row_starts = []
        while start < sb_rows:
            fr.row_starts.append(start << sb_shift)
            start += r.ns(min(sb_rows - start, max_height_sb)) + 1
        rows_log2 = _tile_log2(1, len(fr.row_starts))
    fr.col_starts.append(fr.mi_cols)
    fr.row_starts.append(fr.mi_rows)
    inner = [b - a for a, b in zip(fr.col_starts[:-2], fr.col_starts[1:-1])]
    if inner and min(inner) * 4 < 64 << fr.use_superres:  # av1_is_min_tile_width_satisfied
        raise AV1Error("AV1: a tile column narrower than libaom's minimum")
    fr.tile_cols_log2, fr.tile_rows_log2 = cols_log2, rows_log2
    if cols_log2 or rows_log2:
        fr.context_update_tile_id = r.f(cols_log2 + rows_log2)
        fr.tile_size_bytes = r.f(2) + 1


def obus(data: bytes):
    """The OBUs of ``data`` (``obu_has_size_field``, or one last OBU that
    runs to the end) as (type, temporal id, spatial id, start, end)."""
    pos = 0
    while pos < len(data):
        head = data[pos]
        if head & 0x80:
            raise AV1Error("AV1: forbidden bit set")
        obu_type, ext, has_size = (head >> 3) & 15, (head >> 2) & 1, (head >> 1) & 1
        pos += 1
        temporal_id = spatial_id = 0
        if ext:
            if pos >= len(data):
                raise AV1Error("AV1: OBU extension past the data")
            temporal_id, spatial_id = data[pos] >> 5, (data[pos] >> 3) & 3
            pos += 1
        if has_size:
            size, pos = leb128(data, pos)
        else:
            size = len(data) - pos
        end = pos + size
        if end > len(data):
            raise AV1Error("AV1: OBU runs past the data")
        yield obu_type, temporal_id, spatial_id, pos, end
        pos = end


def _tile_count(fr: Frame) -> int:
    return (len(fr.col_starts) - 1) * (len(fr.row_starts) - 1)


def _tile_group(data: bytes, r: BitReader, end: int, fr: Frame) -> List[Tuple[int, int, int]]:
    n = _tile_count(fr)
    start, last = 0, n - 1
    if n > 1 and r.f(1):  # tile_start_and_end_present_flag
        bits = fr.tile_cols_log2 + fr.tile_rows_log2
        start, last = r.f(bits), r.f(bits)
    r.align()
    pos = r.bit >> 3
    out = []
    for num in range(start, last + 1):
        if num == last:
            size = end - pos
        else:
            size = int.from_bytes(data[pos : pos + fr.tile_size_bytes], "little") + 1
            pos += fr.tile_size_bytes
        if size < 1 or pos + size > end:
            raise AV1Error("AV1: tile size past the tile group")
        out.append((num, pos, size))
        pos += size
    return out
