"""The block syntax of an AV1 frame, intra or inter (the AV1 specification,
sections 5.11 and 6.10, with the context derivations of 8.3.2), read tile
by tile into planes of flat Python lists.

Per tile: the CDFs of the frame's start (the defaults of its q-context,
``data/av1_cdfs.py``, or those its primary reference frame saved), those
of tile ``context_update_tile_id`` kept at its end, the above contexts
cleared, superblocks of 64 or 128
in raster order, each opening with its CDEF indices cleared and its loop
restoration units read (``read_lr``: Wiener taps and self-guided sets with
their reference-based subexponential coding), then split by
``decode_partition`` (every partition type, and ``split_or_horz`` /
``split_or_vert`` at the frame's right and bottom edges).  Per block: the
segment id (spatially predicted, ``neg_deinterleave``), ``skip``, the CDEF
index of its 64 x 64, ``delta_qindex`` and ``delta_lf`` at a superblock's
first block, ``use_intrabc`` with its vector (the intra block copy
reference stack of ``find_mv_stack``, its fallback, joints and classes),
the y mode from the above and left modes, angle deltas, the uv mode with
the CfL signs and alphas, palette sizes, the colour cache and colours, the
colour index map in its wavefront order with its context hash, filter
intra, and the transform size: 4 x 4 in a lossless segment, the largest,
a ``tx_depth`` under ``TX_MODE_SELECT``, or for an intra block copy the
transform tree of ``txfm_split``.  Each transform block is predicted, its
type read (the intra sets by mode, the inter sets of an intra block copy,
``reduced_tx_set``; chroma from the uv mode), its coefficients read in the
default, row or column scan of its size (``all_zero``, ``eob_pt`` and
``eob_extra``, ``coeff_base_eob``, ``coeff_base`` and ``coeff_br`` with
their 2-D, horizontal and vertical contexts, Golomb, ``dc_sign``),
dequantised (``data/av1_quant.py``) and inverse transformed
(``data/av1_transform.py``, or the 4 x 4 Walsh-Hadamard of a lossless
segment); prediction comes from ``data/av1_recon.py``.  The transform
sizes, skips, segments and ``delta_lf`` values stay for the in-loop
filters.

An inter frame's blocks (``inter_frame_mode_info``): the segment id
predicted from the previous map (``seg_id_predicted``), ``skip_mode``,
``is_inter``; intra blocks with the size-group y mode CDFs; inter blocks
with their reference frames (single, unidirectional and bidirectional
compound, each with the neighbour counts' contexts), the mode from the
motion vector stack's contexts (``data/av1_mvpred.py``), ``drl_mode``, the
vectors (classes, fractions, ``allow_high_precision_mv``,
``force_integer_mv``), inter-intra, the motion mode (OBMC, local warp), the
compound type (average, distance, wedge, difference) and the
interpolation filters; the variable transform split, the inter transform
sets (chroma types from luma's at the co-located 4 x 4).  Prediction is
``data/av1_inter.py``'s; per MI the references, vectors, modes and
filters stay for later blocks, the loop filter and the motion field.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

import numpy as np

from molnextr_tpu_torch.data import av1_cdfs, av1_inter, av1_recon
from molnextr_tpu_torch.data.av1_obu import (RESTORE_NONE, RESTORE_SGRPROJ, RESTORE_WIENER,
                                             SWITCHABLE, TX_MODE_SELECT, AV1Error, Frame,
                                             Sequence, relative_dist)
from molnextr_tpu_torch.data.av1_quant import ac_q, dc_q, dq_denom, iqmatrix, qindex
from molnextr_tpu_torch.data.av1_recon import (D157, DC, PAETH, SMOOTH, SMOOTH_H, SMOOTH_V, H,
                                               V)
from molnextr_tpu_torch.data.av1_superres import SUPERRES_NUM
from molnextr_tpu_torch.data.av1_symbol import SymbolDecoder
from molnextr_tpu_torch.data.av1_transform import inverse_transform

# block sizes in the specification's order, as (width, height)
SIZES = ((4, 4), (4, 8), (8, 4), (8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16),
         (32, 32), (32, 64), (64, 32), (64, 64), (64, 128), (128, 64), (128, 128), (4, 16),
         (16, 4), (8, 32), (32, 8), (16, 64), (64, 16))
INDEX = {wh: i for i, wh in enumerate(SIZES)}
B8X8 = 3
NONE, HORZ, VERT, SPLIT, HORZ_A, HORZ_B, VERT_A, VERT_B, HORZ_4, VERT_4 = range(10)
UV_CFL = 13
MODE_CONTEXT = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)
SIZE_GROUP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 0, 0, 1, 1, 2, 2)
NEARESTMV, NEARMV, GLOBALMV, NEWMV = 13, 14, 15, 16
NEAREST_NEARESTMV, NEAR_NEARMV, NEAR_NEWMV, NEW_NEARMV, GLOBAL_GLOBALMV, NEW_NEWMV = \
    17, 18, 21, 22, 23, 24
# the single modes of each inter mode's two vectors (compound modes 17-24)
_COMPONENT_MODE = {13: (13, 13), 14: (14, 14), 15: (15, 15), 16: (16, 16), 17: (13, 13),
                   18: (14, 14), 19: (13, 16), 20: (16, 13), 21: (14, 16), 22: (16, 14),
                   23: (15, 15), 24: (16, 16)}
COMPOUND_MODE_CTX = ((0, 1, 1, 1, 1), (1, 2, 3, 4, 4), (4, 4, 5, 6, 7))
COMPOUND_WEDGE, COMPOUND_DIFFWTD, COMPOUND_AVERAGE, COMPOUND_INTRA, COMPOUND_DISTANCE = range(5)
WEDGE_BITS = {(8, 8): 4, (8, 16): 4, (16, 8): 4, (16, 16): 4, (16, 32): 4, (32, 16): 4,
              (32, 32): 4, (8, 32): 4, (32, 8): 4}
_NO_FEATURES = (None,) * 8
SKIP_CTX = ((1, 2, 2, 2, 3), (2, 4, 4, 4, 5), (2, 4, 4, 4, 5), (2, 4, 4, 4, 5),
            (3, 5, 5, 5, 6))
PALETTE_HASH_CTX = {2: 0, 5: 4, 6: 3, 7: 2, 8: 1}
DCT_DCT, IDTX = 0, 9
CLIP3 = (0, 1, 2) + (3,) * 13
FILTER_TO_DIR = (DC, V, H, D157, DC)
MODE_TO_TXFM = (0, 1, 2, 0, 3, 1, 2, 2, 1, 3, 1, 2, 3)  # intra mode -> chroma tx type
# av1_ext_tx_inv: each transform set's symbols as transform types (set 0 is DCT only,
# 1 DCT/identity, 2 and 3 the intra sets, 4 and 5 the inter sets of 12 and 16)
TX_INV = ((0,), (9, 0), (9, 0, 3, 1, 2), (9, 0, 10, 11, 3, 1, 2),
          (9, 10, 11, 0, 1, 2, 4, 5, 3, 6, 7, 8),
          (9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 4, 5, 3, 6, 7, 8))
_INTRA_ESET = {2: 2, 3: 1}
_INTER_ESET = {1: 3, 4: 2, 5: 1}
_EOB_PT = ("EOB_PT_16", "EOB_PT_32", "EOB_PT_64", "EOB_PT_128", "EOB_PT_256", "EOB_PT_512",
           "EOB_PT_1024")
WIENER_MIN, WIENER_MAX, WIENER_K = (-5, -23, -17), (10, 8, 46), (1, 2, 3)
WIENER_MID = (3, -7, 15)
SGR_XQD_MIN, SGR_XQD_MAX, SGR_XQD_MID = (-96, -32), (31, 95), (-32, 31)
# Sgr_Params: (r0, s0, r1, s1) of the 16 self-guided sets
SGR_PARAMS = ((2, 140, 1, 3236), (2, 112, 1, 2158), (2, 93, 1, 1618), (2, 80, 1, 1438),
              (2, 70, 1, 1295), (2, 58, 1, 1177), (2, 47, 1, 1079), (2, 37, 1, 996),
              (2, 30, 1, 925), (2, 25, 1, 863), (0, -1, 1, 2589), (0, -1, 1, 1618),
              (0, -1, 1, 1177), (0, -1, 1, 925), (2, 56, 0, -1), (2, 22, 0, -1))


def _log2(n: int) -> int:
    return n.bit_length() - 1


def _ceil_log2(n: int) -> int:
    return 0 if n < 2 else (n - 1).bit_length()


def _sqr_index(n: int) -> int:
    """4, 8, 16, 32, 64 -> 0..4 (``TX_4X4`` .. ``TX_64X64``)."""
    return n.bit_length() - 3


def split_tx(tx):
    """``Split_Tx_Size`` of a (w, h) transform size."""
    w, h = tx
    if w == h:
        return (max(4, w >> 1), max(4, h >> 1))
    return (w >> 1, h) if w > h else (w, h >> 1)


def _tx_depth_to_4x4(tx) -> int:
    depth = 0
    while tx != (4, 4):
        tx = split_tx(tx)
        depth += 1
    return depth


def tx_set(tx, inter: bool, reduced: bool) -> int:
    """``av1_get_ext_tx_set_type``: the set of transform types a size
    allows (an index of ``TX_INV``)."""
    up, sq = max(tx), min(tx)
    if up > 32:
        return 0
    if up == 32:
        return 1 if inter else 0
    if reduced:
        return 1 if inter else 2
    if inter:
        return 4 if sq == 16 else 5
    return 2 if sq == 16 else 3


class _ScanInfo:
    """A transform size and type's scan (positions row-major in the size,
    64s cut to 32), the positions' indices in a padded level buffer, the
    context class (0 2-D, 1 horizontal, 2 vertical) and context offsets."""

    __slots__ = ("scan", "pad", "stride", "aw", "ah", "area", "cls", "offs", "br_offs")


@lru_cache(maxsize=None)
def _scan_info(tw: int, th: int, tx_type: int) -> _ScanInfo:
    info = _ScanInfo()
    aw, ah = min(tw, 32), min(th, 32)
    kind = "default"
    if max(tw, th) < 64 and tx_type != IDTX:
        if tx_type in (10, 12, 14):
            kind = "mrow"
        elif tx_type in (11, 13, 15):
            kind = "mcol"
    if kind == "mrow":
        cells = [(r, c) for r in range(ah) for c in range(aw)]
    elif kind == "mcol":
        cells = [(r, c) for c in range(aw) for r in range(ah)]
    else:  # diagonals: zig-zag when square, else all one way
        cells = []
        for d in range(aw + ah - 1):
            diag = [(r, d - r) for r in range(ah) if 0 <= d - r < aw]
            if (aw < ah) or (aw == ah and d & 1):
                cells += diag
            else:
                cells += diag[::-1]
    info.scan = tuple(r * aw + c for r, c in cells)
    info.stride = stride = aw + 4
    info.pad = [(pos // aw) * stride + pos % aw for pos in range(aw * ah)]
    info.aw, info.ah, info.area = aw, ah, aw * ah
    info.cls = 0 if tx_type <= IDTX else 2 if tx_type in (10, 12, 14) else 1
    offs, br = [], []
    for pos in range(aw * ah):
        r, c = divmod(pos, aw)
        if info.cls == 0:
            if tw < th and r < 2:
                o = 11
            elif tw > th and c < 2:
                o = 16
            else:
                o = 1 if r + c < 2 else 6 if r + c < 4 else 21
            near = r < 2 and c < 2
        else:
            o = 26 + 5 * min(c if info.cls == 1 else r, 2)
            near = (c if info.cls == 1 else r) == 0
        offs.append(o)
        br.append(0 if pos == 0 else 7 if near else 14)
    info.offs, info.br_offs = offs, br
    return info


class FrameDecoder:
    """Decodes every tile of a frame, intra or inter, into ``planes`` (flat
    lists of ``stride`` samples, MI-aligned, with a margin), before the
    in-loop filters; an inter frame reads its references' planes from the
    slots of ``refs``."""

    def __init__(self, seq: Sequence, fr: Frame, cdfs, refs, prev_seg, motion_field):
        self.seq, self.fr = seq, fr
        # the frame's CDFs at its start (the defaults of its q-context, or
        # those loaded from its primary reference frame), the reference
        # slots, the previous segment map and the projected motion field
        self.init_cdfs = cdfs
        self.end_cdfs = None
        self.refs = refs
        self.prev_seg = prev_seg
        self.mf = motion_field
        self.bd = seq.bit_depth
        self.nplanes = seq.planes
        self.ss = [(0, 0)] + [(seq.ss_x, seq.ss_y)] * (self.nplanes - 1)
        self.sb4 = 32 if seq.use_128 else 16
        rows, cols = fr.mi_rows, fr.mi_cols
        self.mi_stride = cols
        n = rows * cols
        self.mi_size = [0] * n
        self.y_mode = [0] * n
        self.uv_mode = [0] * n
        self.is_bc = [False] * n
        self.is_inter = [False] * n
        self.ref0 = [0] * n  # RefFrames[][][0]: 0 intra, 1-7 LAST..ALTREF
        self.ref1 = [-1] * n  # RefFrames[][][1]: -1 none, 0 inter-intra
        self.mv = [(0, 0)] * n
        self.mv1 = [(0, 0)] * n
        self.interp = [(0, 0)] * n  # (vertical, horizontal) interpolation filters
        self.skip_mode = [0] * n
        self.comp_group = [0] * n
        self.comp_idx = [0] * n
        self.seg_pred = [0] * n
        self.seg_map = None  # the segment map this frame saves, when it differs from seg
        self.skip = [0] * n
        self.seg = [0] * n
        self.pal_size = [[0] * n, [0] * n]
        self.pal_colors = [[()] * n, [()] * n]
        self.written = [False] * n
        self.planes, self.strides = [], []
        for p in range(self.nplanes):
            sx, sy = self.ss[p]
            w = ((cols * 4) >> sx) + 160
            h = ((rows * 4) >> sy) + 160
            self.planes.append([0] * (w * h))
            self.strides.append(w)
        self.max_x = [((cols * 4) >> sx) - 1 for sx, _ in self.ss]
        self.max_y = [((rows * 4) >> sy) - 1 for _, sy in self.ss]
        self.above_level = [[0] * (cols + 64) for _ in range(self.nplanes)]
        self.above_dc = [[0] * (cols + 64) for _ in range(self.nplanes)]
        self.left_level = [[0] * (rows + 64) for _ in range(self.nplanes)]
        self.left_dc = [[0] * (rows + 64) for _ in range(self.nplanes)]
        self.above_txfm = [64] * (cols + 64)
        self.left_txfm = [64] * (rows + 64)
        self.delta_lf = [(0, 0, 0, 0)] * n
        # each plane's transform width and height per 4 x 4 (the loop filter's)
        self.lf_tw = [np.zeros(((rows * 4 >> sy) + 3 >> 2, (cols * 4 >> sx) + 3 >> 2), np.int32)
                      for sx, sy in self.ss]
        self.lf_th = [a.copy() for a in self.lf_tw]
        self.cdef_idx = {}  # per 64 x 64, as (row, col) in 64s; -1 when never read
        # loop restoration units per plane: (unit row, unit col) -> (type, params)
        self.lr_units = [dict() for _ in range(self.nplanes)]

    # -- tiles ---------------------------------------------------------------
    def decode(self, data: bytes, tiles) -> None:
        fr = self.fr
        ncols = len(fr.col_starts) - 1
        for num, start, size in tiles:
            tr, tc = divmod(num, ncols)
            self.r0, self.r1 = fr.row_starts[tr], fr.row_starts[tr + 1]
            self.c0, self.c1 = fr.col_starts[tc], fr.col_starts[tc + 1]
            self.cdf = av1_cdfs.copied(self.init_cdfs)
            self.sd = SymbolDecoder(data, start, size, not fr.disable_cdf_update)
            for p in range(self.nplanes):
                self.above_level[p] = [0] * len(self.above_level[p])
                self.above_dc[p] = [0] * len(self.above_dc[p])
            self.above_txfm = [64] * len(self.above_txfm)
            self.cur_q = fr.base_q_idx
            self.cur_lf = [0, 0, 0, 0]
            self.ref_wiener = [[list(WIENER_MID), list(WIENER_MID)] for _ in range(self.nplanes)]
            self.ref_sgr = [list(SGR_XQD_MID) for _ in range(self.nplanes)]
            sb = self.sb4
            bsize = INDEX[(sb * 4, sb * 4)]
            for r in range(self.r0, self.r1, sb):
                for p in range(self.nplanes):
                    self.left_level[p] = [0] * len(self.left_level[p])
                    self.left_dc[p] = [0] * len(self.left_dc[p])
                self.left_txfm = [64] * len(self.left_txfm)
                for c in range(self.c0, self.c1, sb):
                    self.read_deltas = fr.delta_q_present
                    for y in range(r >> 4, (r + sb) >> 4):
                        for x in range(c >> 4, (c + sb) >> 4):
                            self.cdef_idx[(y, x)] = -1
                    self._clear_decoded(r, c)
                    self._read_lr(r, c, sb)
                    self._partition(r, c, bsize)
                    if self.sd.overflowed():
                        raise AV1Error("AV1: tile data overrun (a corrupt frame)")
            if not self.sd.trailing_ok():
                raise AV1Error("AV1: tile without its trailing bits (a corrupt frame)")
            if num == fr.context_update_tile_id:
                self.end_cdfs = self.cdf  # this tile's CDFs, which no later tile touches

    def frame_planes(self) -> List[np.ndarray]:
        """The decoded planes over the MI-aligned frame, as int32 arrays."""
        out = []
        for p in range(self.nplanes):
            sx, sy = self.ss[p]
            h, w = (self.fr.mi_rows * 4) >> sy, (self.fr.mi_cols * 4) >> sx
            full = np.asarray(self.planes[p], np.int32).reshape(-1, self.strides[p])
            out.append(full[:h, :w].copy())
        return out

    def _clear_decoded(self, r: int, c: int) -> None:
        """``clear_block_decoded_flags``: per plane, rows and columns -1 to
        the superblock's size, as dicts keyed (row, col)."""
        self.decoded = []
        sb = self.sb4
        for p in range(self.nplanes):
            sx, sy = self.ss[p]
            w4, h4 = (self.c1 - c) >> sx, (self.r1 - r) >> sy
            flags = {}
            for y in range(-1, (sb >> sy) + 1):
                for x in range(-1, (sb >> sx) + 1):
                    flags[(y, x)] = (y < 0 and x < w4) or (x < 0 and y < h4)
            flags[(sb >> sy, -1)] = False
            self.decoded.append(flags)

    def _inside(self, r: int, c: int) -> bool:
        return self.r0 <= r < self.r1 and self.c0 <= c < self.c1

    # -- partitions ------------------------------------------------------------
    def _partition(self, r: int, c: int, bsize: int) -> None:
        fr = self.fr
        if r >= fr.mi_rows or c >= fr.mi_cols:
            return
        w, h = SIZES[bsize]
        n4 = w >> 2
        half = n4 >> 1
        quarter = half >> 1
        has_rows = r + half < fr.mi_rows
        has_cols = c + half < fr.mi_cols
        if bsize < B8X8:
            part = NONE
        else:
            bsl = _log2(n4)
            st = self.mi_stride
            above = self._inside(r - 1, c) and \
                _log2(SIZES[self.mi_size[(r - 1) * st + c]][0] >> 2) < bsl
            left = self._inside(r, c - 1) and \
                _log2(SIZES[self.mi_size[r * st + c - 1]][1] >> 2) < bsl
            cdf = self.cdf["PARTITION"][bsl - 1][left * 2 + above]
            if has_rows and has_cols:
                part = self.sd.symbol(cdf)
            elif has_cols:  # split_or_horz
                part = SPLIT if self._gather(cdf, (VERT, SPLIT, HORZ_A, VERT_A, VERT_B, VERT_4),
                                             bsl) else HORZ
            elif has_rows:  # split_or_vert
                part = SPLIT if self._gather(cdf, (HORZ, SPLIT, HORZ_A, HORZ_B, VERT_A, HORZ_4),
                                             bsl) else VERT
            else:
                part = SPLIT
        sub = _sub_size(part, w, h)
        if self.nplanes > 1 and self.ss[1] == (1, 0) and SIZES[sub][1] > SIZES[sub][0]:
            raise AV1Error("AV1: a block size 4:2:2 chroma cannot take")
        split = INDEX[(w >> 1, h >> 1)] if bsize >= B8X8 else bsize
        blk = self._block
        if part == NONE:
            blk(r, c, sub)
        elif part == HORZ:
            blk(r, c, sub)
            if has_rows:
                blk(r + half, c, sub)
        elif part == VERT:
            blk(r, c, sub)
            if has_cols:
                blk(r, c + half, sub)
        elif part == SPLIT:
            for dr, dc in ((0, 0), (0, half), (half, 0), (half, half)):
                self._partition(r + dr, c + dc, sub)
        elif part == HORZ_A:
            blk(r, c, split)
            blk(r, c + half, split)
            blk(r + half, c, sub)
        elif part == HORZ_B:
            blk(r, c, sub)
            blk(r + half, c, split)
            blk(r + half, c + half, split)
        elif part == VERT_A:
            blk(r, c, split)
            blk(r + half, c, split)
            blk(r, c + half, sub)
        elif part == VERT_B:
            blk(r, c, sub)
            blk(r, c + half, split)
            blk(r + half, c + half, split)
        elif part == HORZ_4:
            for k in range(4):
                if k < 3 or r + quarter * 3 < fr.mi_rows:
                    blk(r + quarter * k, c, sub)
        else:
            for k in range(4):
                if k < 3 or c + quarter * 3 < fr.mi_cols:
                    blk(r, c + quarter * k, sub)

    def _gather(self, cdf: List[int], parts, bsl: int) -> int:
        """A bool read from the partition CDF's probabilities of ``parts``
        (the last left out at 128 x 128, which has no 4-way split), without
        adaptation."""
        psum = 0
        for p in parts:
            if p >= len(cdf) - 1:
                continue
            psum += cdf[p] - (cdf[p - 1] if p else 0)
        fixed = [32768 - psum, 32768, 0]
        adapt, self.sd.adapt = self.sd.adapt, False
        bit = self.sd.symbol(fixed)
        self.sd.adapt = adapt
        return bit

    # -- blocks ------------------------------------------------------------------
    def _block(self, r: int, c: int, bsize: int) -> None:
        seq, fr = self.seq, self.fr
        w, h = SIZES[bsize]
        bw4, bh4 = w >> 2, h >> 2
        ssx, ssy = seq.ss_x, seq.ss_y
        if self.nplanes == 1:
            has_chroma = False
        elif bh4 == 1 and ssy and not r & 1 or bw4 == 1 and ssx and not c & 1:
            has_chroma = False
        else:
            has_chroma = True
        au, al = self._inside(r - 1, c), self._inside(r, c - 1)
        auc = alc = False
        if has_chroma:
            auc = self._inside(r - 2, c) if ssy and bh4 == 1 else au
            alc = self._inside(r, c - 2) if ssx and bw4 == 1 else al
        st = self.mi_stride
        b = _Block(r, c, bsize, w, h, has_chroma, au, al, auc, alc)
        if fr.is_intra:
            self._intra_frame_mode_info(b)
        else:
            self._inter_frame_mode_info(b)
        self._read_tx_size(b)
        lf = tuple(self.cur_lf)
        # store the block's mode info
        for y in range(r, min(r + bh4, fr.mi_rows)):
            for x in range(c, min(c + bw4, fr.mi_cols)):
                i = y * st + x
                self.mi_size[i] = bsize
                self.y_mode[i] = b.y_mode
                self.uv_mode[i] = b.uv_mode if has_chroma else DC
                self.is_bc[i] = b.bc
                self.is_inter[i] = b.inter
                self.ref0[i], self.ref1[i] = b.ref
                self.mv[i], self.mv1[i] = b.mv, b.mv1
                self.interp[i] = b.interp
                self.skip_mode[i] = b.skip_mode
                self.comp_group[i], self.comp_idx[i] = b.comp_group, b.comp_idx
                self.seg_pred[i] = b.seg_pred
                self.skip[i] = b.skip
                self.seg[i] = b.seg
                self.delta_lf[i] = lf
                self.pal_size[0][i], self.pal_size[1][i] = b.pal
                self.pal_colors[0][i] = b.colors[0]
                self.pal_colors[1][i] = b.colors[1]
                self.written[i] = True
        if b.skip:
            for p in range(1 + 2 * has_chroma):
                sx, sy = self.ss[p]
                for i in range(c >> sx, (c + bw4) >> sx):
                    self.above_level[p][i] = self.above_dc[p][i] = 0
                for i in range(r >> sy, (r + bh4) >> sy):
                    self.left_level[p][i] = self.left_dc[p][i] = 0
        if b.bc:
            self._predict_bc(b)
        elif b.inter:
            av1_inter.predict_block(self, b)
        self._residual(b)

    def _intra_frame_mode_info(self, b) -> None:
        fr, sd, cdf, st = self.fr, self.sd, self.cdf, self.mi_stride
        up = (b.r - 1) * st + b.c
        if fr.seg_id_pre_skip:
            b.seg = self._segment_id(b, 0)
        if fr.seg_id_pre_skip and fr.seg_features[b.seg][6] is not None:
            b.skip = 1
        else:
            b.skip = sd.symbol(cdf["SKIP"][(self.skip[up] if b.au else 0)
                                           + (self.skip[b.r * st + b.c - 1] if b.al else 0)])
        if not fr.seg_id_pre_skip:
            b.seg = self._segment_id(b, b.skip)
        self._block_deltas(b)
        if fr.allow_intrabc and sd.symbol(cdf["INTRABC"]):
            b.bc = b.inter = True
            self._intrabc_mv(b)
        else:
            ya = MODE_CONTEXT[self.y_mode[up]] if b.au else 0
            yl = MODE_CONTEXT[self.y_mode[b.r * st + b.c - 1]] if b.al else 0
            self._intra_modes(b, cdf["KF_Y_MODE"][ya][yl])

    def _block_deltas(self, b) -> None:
        """The lossless flag, the CDEF index and the superblock's deltas."""
        b.lossless = self.fr.lossless[b.seg]
        self._read_cdef(b)
        if self.read_deltas:
            if not ((b.w, b.h) == (self.sb4 * 4, self.sb4 * 4) and b.skip):
                self._read_delta_q()
                if self.fr.delta_lf_present:
                    self._read_delta_lf()
            self.read_deltas = False

    def _intra_modes(self, b, y_cdf) -> None:
        """``intra_frame_mode_info``'s and ``intra_block_mode_info``'s modes:
        y (from ``y_cdf``), angle deltas, uv and CfL, palette, filter intra."""
        seq, fr, sd, cdf = self.seq, self.fr, self.sd, self.cdf
        w, h, bsize = b.w, b.h, b.bsize
        b.y_mode = sd.symbol(y_cdf)
        if bsize >= B8X8 and 1 <= b.y_mode <= 8:
            b.y_delta = sd.symbol(cdf["ANGLE_DELTA"][b.y_mode - 1]) - 3
        if b.has_chroma:
            cw, ch = max(4, w >> seq.ss_x), max(4, h >> seq.ss_y)
            cfl_ok = (cw, ch) == (4, 4) if b.lossless else max(w, h) <= 32
            table = cdf["UV_MODE_CFL_ALLOWED" if cfl_ok else "UV_MODE_CFL_NOT_ALLOWED"]
            b.uv_mode = sd.symbol(table[b.y_mode])
            if b.uv_mode == UV_CFL:
                self._cfl_alphas(b)
            if bsize >= B8X8 and 1 <= b.uv_mode <= 8:
                b.uv_delta = sd.symbol(cdf["ANGLE_DELTA"][b.uv_mode - 1]) - 3
        if bsize >= B8X8 and w <= 64 and h <= 64 and fr.screen_tools:
            self._palette_mode_info(b)
        if seq.enable_filter_intra and b.y_mode == DC and not b.pal[0] and max(w, h) <= 32:
            if sd.symbol(cdf["FILTER_INTRA"][bsize]):
                b.filter_mode = sd.symbol(cdf["FILTER_INTRA_MODE"])
        if b.pal[0] or b.pal[1]:
            self._palette_tokens(b)

    # -- inter frames ----------------------------------------------------------
    def _inter_frame_mode_info(self, b) -> None:
        """``inter_frame_mode_info``."""
        fr, sd, cdf, st = self.fr, self.sd, self.cdf, self.mi_stride
        up, lf = (b.r - 1) * st + b.c, b.r * st + b.c - 1
        b.nb = ((self.ref0[up], self.ref1[up]) if b.au else None,
                (self.ref0[lf], self.ref1[lf]) if b.al else None)
        self._inter_segment_id(b, True)
        feat = fr.seg_features[b.seg] if fr.seg_enabled else _NO_FEATURES
        if fr.skip_mode_present and min(b.w, b.h) >= 8 and feat[5] is None and \
                feat[6] is None and feat[7] is None:
            ctx = (self.skip_mode[up] if b.au else 0) + (self.skip_mode[lf] if b.al else 0)
            b.skip_mode = sd.symbol(cdf["SKIP_MODE"][ctx])
        if b.skip_mode:
            b.skip = 1
        elif fr.seg_id_pre_skip and feat[6] is not None:
            b.skip = 1
        else:
            b.skip = sd.symbol(cdf["SKIP"][(self.skip[up] if b.au else 0)
                                           + (self.skip[lf] if b.al else 0)])
        if not fr.seg_id_pre_skip:
            self._inter_segment_id(b, False)
        feat = fr.seg_features[b.seg] if fr.seg_enabled else _NO_FEATURES
        self._block_deltas(b)
        if b.skip_mode:
            b.inter = True
        elif feat[5] is not None:
            b.inter = feat[5] != 0
        elif feat[7] is not None:
            b.inter = True
        else:
            a_intra = b.nb[0] is not None and b.nb[0][0] <= 0
            l_intra = b.nb[1] is not None and b.nb[1][0] <= 0
            if b.au and b.al:
                ctx = 3 if a_intra and l_intra else int(a_intra or l_intra)
            elif b.au or b.al:
                ctx = 2 * (a_intra if b.au else l_intra)
            else:
                ctx = 0
            b.inter = bool(sd.symbol(cdf["IS_INTER"][ctx]))
        if b.inter:
            self._inter_block_mode_info(b, feat)
        else:
            av1_recon._hit("intra_in_inter_frame")
            self._intra_modes(b, cdf["Y_MODE"][SIZE_GROUP[b.bsize]])

    def _inter_segment_id(self, b, pre_skip: bool) -> None:
        fr = self.fr
        if not fr.seg_enabled:
            return
        if not fr.seg_update_map:
            b.seg = self._predicted_segment(b)
            return
        if pre_skip and not fr.seg_id_pre_skip:
            b.seg = 0
            return
        if not pre_skip and b.skip:
            b.seg_pred = 0
            b.seg = self._segment_id(b, 1)
            return
        if fr.seg_temporal_update:
            st = self.mi_stride
            ctx = (self.seg_pred[(b.r - 1) * st + b.c] if b.au else 0) + \
                (self.seg_pred[b.r * st + b.c - 1] if b.al else 0)
            b.seg_pred = self.sd.symbol(self.cdf["SEGMENT_ID_PREDICTED"][ctx])
            if b.seg_pred:
                b.seg = self._predicted_segment(b)
                return
        b.seg = self._segment_id(b, 0)

    def _predicted_segment(self, b) -> int:
        """``get_segment_id``: the least previous segment under the block."""
        if self.prev_seg is None:
            return 0
        fr = self.fr
        return int(self.prev_seg[b.r : min(fr.mi_rows, b.r + (b.h >> 2)),
                                 b.c : min(fr.mi_cols, b.c + (b.w >> 2))].min())

    def _ref_counts(self, b) -> List[int]:
        counts = [0] * 8
        for nb in b.nb:
            if nb is not None and nb[0] > 0:
                counts[nb[0]] += 1
                if nb[1] > 0:
                    counts[nb[1]] += 1
        return counts

    def _read_ref_frames(self, b, feat) -> None:
        fr, sd, cdf = self.fr, self.sd, self.cdf
        if b.skip_mode:
            b.ref = fr.skip_mode_frames
            return
        if feat[5] is not None:
            b.ref = (feat[5], -1)
            return
        if feat[6] is not None or feat[7] is not None:
            b.ref = (1, -1)
            return
        n = self._ref_counts(b)

        def cmp(a: int, c: int) -> int:
            return 1 if a == c else 0 if a < c else 2

        fwd, bwd = n[1] + n[2] + n[3] + n[4], n[5] + n[6] + n[7]
        compound = False
        if fr.reference_select and min(b.w, b.h) >= 8:
            compound = bool(sd.symbol(cdf["COMP_MODE"][self._comp_mode_ctx(b)]))
        if compound:
            if sd.symbol(cdf["COMP_REF_TYPE"][self._comp_ref_type_ctx(b)]):  # bidirectional
                if sd.symbol(cdf["COMP_REF"][cmp(n[1] + n[2], n[3] + n[4])][0]):
                    r0 = 4 if sd.symbol(cdf["COMP_REF"][cmp(n[3], n[4])][2]) else 3
                else:
                    r0 = 2 if sd.symbol(cdf["COMP_REF"][cmp(n[1], n[2])][1]) else 1
                if sd.symbol(cdf["COMP_BWDREF"][cmp(n[5] + n[6], n[7])][0]):
                    r1 = 7
                else:
                    r1 = 6 if sd.symbol(cdf["COMP_BWDREF"][cmp(n[5], n[6])][1]) else 5
                b.ref = (r0, r1)
            elif sd.symbol(cdf["UNI_COMP_REF"][cmp(fwd, bwd)][0]):
                b.ref = (5, 7)
            elif sd.symbol(cdf["UNI_COMP_REF"][cmp(n[2], n[3] + n[4])][1]):
                b.ref = (1, 4) if sd.symbol(cdf["UNI_COMP_REF"][cmp(n[3], n[4])][2]) else (1, 3)
            else:
                b.ref = (1, 2)
            return
        single = cdf["SINGLE_REF"]
        if sd.symbol(single[cmp(fwd, bwd)][0]):
            if sd.symbol(single[cmp(n[5] + n[6], n[7])][1]):
                r0 = 7
            else:
                r0 = 6 if sd.symbol(single[cmp(n[5], n[6])][5]) else 5
        elif sd.symbol(single[cmp(n[1] + n[2], n[3] + n[4])][2]):
            r0 = 4 if sd.symbol(single[cmp(n[3], n[4])][4]) else 3
        else:
            r0 = 2 if sd.symbol(single[cmp(n[1], n[2])][3]) else 1
        b.ref = (r0, -1)

    def _comp_mode_ctx(self, b) -> int:
        a, l_ = b.nb
        if a is not None and l_ is not None:
            if a[1] <= 0 and l_[1] <= 0:
                return int(a[0] >= 5) ^ int(l_[0] >= 5)
            if a[1] <= 0:
                return 2 + int(a[0] >= 5 or a[0] <= 0)
            if l_[1] <= 0:
                return 2 + int(l_[0] >= 5 or l_[0] <= 0)
            return 4
        if a is not None or l_ is not None:
            e = a if a is not None else l_
            return int(e[0] >= 5) if e[1] <= 0 else 3
        return 1

    def _comp_ref_type_ctx(self, b) -> int:
        a, l_ = b.nb

        def uni(e) -> bool:
            return e[1] > 0 and (e[0] >= 5) == (e[1] >= 5)

        if a is not None and l_ is not None:
            ai, li = a[0] <= 0, l_[0] <= 0
            if ai and li:
                return 2
            if ai or li:
                e = l_ if ai else a
                return 2 if e[1] <= 0 else 1 + 2 * uni(e)
            a_sg, l_sg = a[1] <= 0, l_[1] <= 0
            same = (a[0] >= 5) == (l_[0] >= 5)
            if a_sg and l_sg:
                return 1 + 2 * same
            if a_sg or l_sg:
                e = l_ if a_sg else a
                return 1 if not uni(e) else 3 + same
            ua, ul = uni(a), uni(l_)
            if not ua and not ul:
                return 0
            if not ua or not ul:
                return 2
            return 3 + int((a[0] == 5) == (l_[0] == 5))
        if a is not None or l_ is not None:
            e = a if a is not None else l_
            if e[0] <= 0 or e[1] <= 0:
                return 2
            return 4 * uni(e)
        return 2

    def _inter_block_mode_info(self, b, feat) -> None:
        """``inter_block_mode_info``: references, the mode, the vectors,
        inter-intra, the motion mode, the compound type and the filters."""
        fr, sd, cdf, seq = self.fr, self.sd, self.cdf, self.seq
        self._read_ref_frames(b, feat)
        compound = b.ref[1] > 0
        stack = av1_mvpred.find_mv_stack(self, b, b.ref)
        if b.skip_mode:
            b.y_mode = NEAREST_NEARESTMV
        elif feat[6] is not None or feat[7] is not None:
            b.y_mode = GLOBALMV
        elif compound:
            ctx = COMPOUND_MODE_CTX[stack.ref_ctx >> 1][min(stack.new_ctx, 4)]
            b.y_mode = NEAREST_NEARESTMV + sd.symbol(cdf["COMPOUND_MODE"][ctx])
        elif sd.symbol(cdf["NEW_MV"][stack.new_ctx]) == 0:
            b.y_mode = NEWMV
        elif sd.symbol(cdf["ZERO_MV"][stack.zero_ctx]) == 0:
            b.y_mode = GLOBALMV
        else:
            b.y_mode = NEARMV if sd.symbol(cdf["REF_MV"][stack.ref_ctx]) else NEARESTMV
        idx = 0
        if b.y_mode in (NEWMV, NEW_NEWMV):
            for k in range(2):
                if stack.num > k + 1:
                    idx = k + sd.symbol(cdf["DRL_MODE"][stack.drl_ctx[k]])
                    if idx == k:
                        break
        elif b.y_mode in (NEARMV, NEAR_NEARMV, NEAR_NEWMV, NEW_NEARMV):
            idx = 1
            for k in range(1, 3):
                if stack.num > k + 1:
                    idx = k + sd.symbol(cdf["DRL_MODE"][stack.drl_ctx[k]])
                    if idx == k:
                        break
        mvs = []
        for k in range(1 + compound):
            mode = _COMPONENT_MODE[b.y_mode][k]
            if mode == GLOBALMV:
                pred = stack.gm[k]
            else:
                pos = 0 if mode == NEARESTMV else idx
                if mode == NEWMV and stack.num <= 1:
                    pos = 0
                pred = stack.mvs[pos][k]
            if mode == NEWMV:
                mvc = cdf["MV"][0]
                joint = sd.symbol(mvc["joint"])
                dr = self._mv_component(mvc["comp"][0]) if joint in (2, 3) else 0
                dc = self._mv_component(mvc["comp"][1]) if joint in (1, 3) else 0
                pred = (pred[0] + dr, pred[1] + dc)
                if not (abs(pred[0]) < 1 << 14 and abs(pred[1]) < 1 << 14):
                    raise AV1Error("AV1: a motion vector out of range (a corrupt frame)")
            mvs.append(pred)
        b.mv = mvs[0]
        b.mv1 = mvs[1] if compound else (0, 0)
        # inter-intra
        if seq.enable_interintra and not b.skip_mode and not compound and \
                B8X8 <= b.bsize <= INDEX[(32, 32)]:
            group = SIZE_GROUP[b.bsize]
            if sd.symbol(cdf["INTERINTRA"][group]):
                b.interintra = sd.symbol(cdf["INTERINTRA_MODE"][group]) + 1
                b.ref = (b.ref[0], 0)
                if sd.symbol(cdf["WEDGE_INTERINTRA"][b.bsize]):
                    b.wedge = (sd.symbol(cdf["WEDGE_INDEX"][b.bsize]), 0)
        # motion mode
        samples = []
        if fr.motion_switchable and not b.skip_mode and min(b.w, b.h) >= 8 and \
                not (not fr.force_integer_mv and b.y_mode == GLOBALMV
                     and fr.gm_type[b.ref[0]] > 1) and \
                b.ref[1] == -1 and av1_mvpred.has_overlappable_candidates(self, b):
            samples = av1_mvpred.find_warp_samples(self, b, b.mv)
            slot = self.refs[fr.ref_frame_idx[b.ref[0] - 1]]
            if fr.force_integer_mv or not samples or not fr.allow_warped or \
                    av1_inter.is_scaled(slot, fr):
                b.motion_mode = sd.symbol(cdf["USE_OBMC"][b.bsize])
            else:
                b.motion_mode = sd.symbol(cdf["MOTION_MODE"][b.bsize])
        if b.motion_mode == 2:
            params = av1_inter.warp_estimation(samples, b.w, b.h, b.mv, b.r, b.c)
            shear = av1_inter.setup_shear(params) if params is not None else None
            b.local_warp = (params, shear) if shear is not None else None
        # compound type
        if compound and not b.skip_mode:
            if seq.enable_masked:
                st = self.mi_stride
                ctx = 0
                for nb, i in ((b.nb[0], (b.r - 1) * st + b.c), (b.nb[1], b.r * st + b.c - 1)):
                    if nb is not None:
                        ctx += self.comp_group[i] if nb[1] > 0 else 3 * (nb[0] == 7)
                b.comp_group = sd.symbol(cdf["COMP_GROUP_IDX"][min(5, ctx)])
            if b.comp_group == 0:
                if seq.enable_jnt_comp:
                    b.comp_idx = sd.symbol(cdf["COMPOUND_IDX"][self._compound_idx_ctx(b)])
                    b.compound = COMPOUND_AVERAGE if b.comp_idx else COMPOUND_DISTANCE
            else:
                if WEDGE_BITS.get((b.w, b.h), 0):
                    b.compound = sd.symbol(cdf["COMPOUND_TYPE"][b.bsize])  # wedge 0, diff 1
                else:
                    b.compound = COMPOUND_DIFFWTD
                if b.compound == COMPOUND_WEDGE:
                    b.wedge = (sd.symbol(cdf["WEDGE_INDEX"][b.bsize]), sd.literal(1))
                else:
                    b.mask_type = sd.literal(1)
        elif b.interintra:
            b.compound = COMPOUND_WEDGE if b.wedge is not None else COMPOUND_INTRA
        # interpolation filters
        if fr.interp_filter != SWITCHABLE:
            b.interp = (fr.interp_filter, fr.interp_filter)
        elif self._needs_interp_filter(b):
            filters = []
            for direction in range(2 if seq.enable_dual_filter else 1):
                filters.append(sd.symbol(cdf["INTERP_FILTER"][self._interp_ctx(b, direction)]))
            b.interp = (filters[0], filters[-1])

    def _compound_idx_ctx(self, b) -> int:
        fr, st = self.fr, self.mi_stride
        fwd = abs(relative_dist(self.seq, fr.order_hints[b.ref[0]], fr.order_hint))
        bck = abs(relative_dist(self.seq, fr.order_hints[b.ref[1]], fr.order_hint))
        ctx = 3 if fwd == bck else 0
        for nb, i in ((b.nb[0], (b.r - 1) * st + b.c), (b.nb[1], b.r * st + b.c - 1)):
            if nb is not None:
                ctx += self.comp_idx[i] if nb[1] > 0 else int(nb[0] == 7)
        return ctx

    def _needs_interp_filter(self, b) -> bool:
        fr = self.fr
        large = min(b.w, b.h) >= 8
        if b.skip_mode or b.motion_mode == 2:
            return False
        if large and b.y_mode == GLOBALMV:
            return fr.gm_type[b.ref[0]] == 1
        if large and b.y_mode == GLOBAL_GLOBALMV:
            return fr.gm_type[b.ref[0]] == 1 or fr.gm_type[b.ref[1]] == 1
        return True

    def _interp_ctx(self, b, direction: int) -> int:
        st = self.mi_stride
        ctx = ((direction & 1) * 2 + (b.ref[1] > 0)) * 4
        types = []
        for nb, i in ((b.nb[1], b.r * st + b.c - 1), (b.nb[0], (b.r - 1) * st + b.c)):
            if nb is not None and b.ref[0] in nb:
                types.append(self.interp[i][direction])
            else:
                types.append(3)
        left, above = types
        if left == above:
            return ctx + left
        if left == 3:
            return ctx + above
        if above == 3:
            return ctx + left
        return ctx + 3

    def _segment_id(self, b, skip: int) -> int:
        fr = self.fr
        if not fr.seg_enabled:
            return 0
        st = self.mi_stride
        r, c = b.r, b.c
        ul = self.seg[(r - 1) * st + c - 1] if b.au and b.al else -1
        u = self.seg[(r - 1) * st + c] if b.au else -1
        lf = self.seg[r * st + c - 1] if b.al else -1
        if u == -1:
            pred = 0 if lf == -1 else lf
        elif lf == -1:
            pred = u
        else:
            pred = u if ul == u else lf
        if skip:
            return pred
        if ul < 0:
            ctx = 0
        elif ul == u and ul == lf:
            ctx = 2
        elif ul == u or ul == lf or u == lf:
            ctx = 1
        else:
            ctx = 0
        diff = self.sd.symbol(self.cdf["SEGMENT_ID"][ctx])
        seg = _neg_deinterleave(diff, pred, fr.last_active_seg_id + 1)
        if not 0 <= seg <= fr.last_active_seg_id:
            raise AV1Error("AV1: corrupted segment id")
        return seg

    def _cfl_alphas(self, b) -> None:
        sd, cdf = self.sd, self.cdf
        signs = sd.symbol(cdf["CFL_SIGN"])
        su, sv = (signs + 1) // 3, (signs + 1) % 3
        if su:
            a = sd.symbol(cdf["CFL_ALPHA"][(su - 1) * 3 + sv]) + 1
            b.alpha_u = -a if su == 1 else a
        if sv:
            a = sd.symbol(cdf["CFL_ALPHA"][(sv - 1) * 3 + su]) + 1
            b.alpha_v = -a if sv == 1 else a

    # -- superblock-level syntax: CDEF index, delta q and lf, restoration ----
    def _read_cdef(self, b) -> None:
        fr = self.fr
        if b.skip or fr.coded_lossless or not self.seq.enable_cdef or fr.allow_intrabc:
            return
        r64, c64 = b.r >> 4, b.c >> 4
        if self.cdef_idx[(r64, c64)] == -1:
            v = self.sd.literal(fr.cdef_bits)
            for y in range(r64, r64 + max(1, b.h >> 6)):
                for x in range(c64, c64 + max(1, b.w >> 6)):
                    self.cdef_idx[(y, x)] = v

    def _signed_delta(self, cdf) -> int:
        """``delta_q_abs`` / ``delta_lf_abs``, their remainder bits past 3,
        and the sign."""
        sd = self.sd
        a = sd.symbol(cdf)
        if a == 3:
            bits = sd.literal(3) + 1
            a = sd.literal(bits) + (1 << bits) + 1
        return -a if a and sd.literal(1) else a

    def _read_delta_q(self) -> None:
        d = self._signed_delta(self.cdf["DELTA_Q"])
        if d:
            av1_recon._hit("delta_q")
            self.cur_q = min(max(self.cur_q + (d << self.fr.delta_q_res), 1), 255)

    def _read_delta_lf(self) -> None:
        fr = self.fr
        count = (4 if self.nplanes > 1 else 2) if fr.delta_lf_multi else 1
        for i in range(count):
            d = self._signed_delta(self.cdf["DELTA_LF_MULTI"][i] if fr.delta_lf_multi
                                   else self.cdf["DELTA_LF"])
            if d:
                av1_recon._hit("delta_lf")
                self.cur_lf[i] = min(max(self.cur_lf[i] + (d << fr.delta_lf_res), -63), 63)

    def _read_lr(self, r: int, c: int, sb4: int) -> None:
        """``read_lr``: the restoration units whose top-left lies in the
        superblock at (r, c), on the upscaled frame under superres."""
        fr = self.fr
        if fr.allow_intrabc:
            return
        for p in range(self.nplanes):
            if fr.lr_type[p] == RESTORE_NONE:
                continue
            sx, sy = self.ss[p]
            size = fr.lr_size[p]
            rows = lr_unit_count(size, (fr.height + sy) >> sy)
            cols = lr_unit_count(size, (fr.upscaled_width + sx) >> sx)
            r0 = (r * (4 >> sy) + size - 1) // size
            r1 = min(rows, ((r + sb4) * (4 >> sy) + size - 1) // size)
            # units lie on the upscaled frame: a superblock's columns scaled
            denom = fr.superres_denom if fr.use_superres else SUPERRES_NUM
            num, den = (4 >> sx) * denom, size * SUPERRES_NUM
            c0 = (c * num + den - 1) // den
            c1 = min(cols, ((c + sb4) * num + den - 1) // den)
            for ur in range(r0, r1):
                for uc in range(c0, c1):
                    self.lr_units[p][(ur, uc)] = self._lr_unit(p)

    def _lr_unit(self, p: int):
        fr, sd, cdf = self.fr, self.sd, self.cdf
        kind = fr.lr_type[p]
        if kind == RESTORE_WIENER:
            t = RESTORE_WIENER if sd.symbol(cdf["WIENER_RESTORE"]) else RESTORE_NONE
        elif kind == RESTORE_SGRPROJ:
            t = RESTORE_SGRPROJ if sd.symbol(cdf["SGRPROJ_RESTORE"]) else RESTORE_NONE
        else:
            av1_recon._hit("lr_switchable")
            t = (RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ)[
                sd.symbol(cdf["SWITCHABLE_RESTORE"])]
        if t == RESTORE_WIENER:
            av1_recon._hit("lr_wiener")
            coefs = []
            for pas in range(2):
                ref = self.ref_wiener[p][pas]
                taps = [0, 0, 0]
                for j in range(1 if p else 0, 3):
                    v = self._subexp_ref(WIENER_MIN[j], WIENER_MAX[j] + 1, WIENER_K[j], ref[j])
                    taps[j] = ref[j] = v
                coefs.append(tuple(taps))
            return t, tuple(coefs)
        if t == RESTORE_SGRPROJ:
            av1_recon._hit("lr_sgrproj")
            s = sd.literal(4)
            ref = self.ref_sgr[p]
            xqd = [0, 0]
            for i in range(2):
                if SGR_PARAMS[s][2 * i]:
                    v = self._subexp_ref(SGR_XQD_MIN[i], SGR_XQD_MAX[i] + 1, 4, ref[i])
                elif i == 1:
                    v = min(max((1 << 7) - ref[0], SGR_XQD_MIN[1]), SGR_XQD_MAX[1])
                else:
                    v = 0
                xqd[i] = ref[i] = v
            return t, (s, tuple(xqd))
        return RESTORE_NONE, None

    def _subexp_ref(self, low: int, high: int, k: int, ref: int) -> int:
        """``decode_signed_subexp_with_ref_bool``."""
        mx, r = high - low, ref - low
        v = self._subexp(mx, k)
        if (r << 1) <= mx:
            x = _inverse_recenter(r, v)
        else:
            x = mx - 1 - _inverse_recenter(mx - 1 - r, v)
        return x + low

    def _subexp(self, num: int, k: int) -> int:
        sd = self.sd
        i, mk = 0, 0
        while True:
            b2 = k + i - 1 if i else k
            a = 1 << b2
            if num <= mk + 3 * a:
                return sd.ns(num - mk) + mk
            if not sd.literal(1):
                return sd.literal(b2) + mk
            i += 1
            mk += a

    # -- palettes --------------------------------------------------------------
    def _palette_mode_info(self, b) -> None:
        sd, cdf, bd = self.sd, self.cdf, self.bd
        w, h = SIZES[b.bsize]
        bctx = _log2(w >> 2) + _log2(h >> 2) - 2
        st = self.mi_stride
        up, lf = (b.r - 1) * st + b.c, b.r * st + b.c - 1
        if b.y_mode == DC:
            ctx = (b.au and self.pal_size[0][up] > 0) + (b.al and self.pal_size[0][lf] > 0)
            if sd.symbol(cdf["PALETTE_Y_MODE"][bctx][ctx]):
                n = sd.symbol(cdf["PALETTE_Y_SIZE"][bctx]) + 2
                b.colors[0] = self._colors(b, 0, n, bd - 3, 1)
                b.pal[0] = n
        if b.has_chroma and b.uv_mode == DC:
            if sd.symbol(cdf["PALETTE_UV_MODE"][1 if b.pal[0] else 0]):
                n = sd.symbol(cdf["PALETTE_UV_SIZE"][bctx]) + 2
                u = self._colors(b, 1, n, bd - 3, 0)
                if sd.literal(1):  # delta_encode_palette_colors_v
                    bits = bd - 4 + sd.literal(2)
                    v = [sd.literal(bd)]
                    top = 1 << bd
                    for _ in range(1, n):
                        d = sd.literal(bits)
                        if d and sd.literal(1):
                            d = -d
                        val = v[-1] + d
                        val = val + top if val < 0 else val - top if val >= top else val
                        v.append(min(max(val, 0), top - 1))
                else:
                    v = [sd.literal(bd) for _ in range(n)]
                b.colors[1] = (tuple(u), tuple(v))
                b.pal[1] = n

    def _colors(self, b, plane: int, n: int, min_bits: int, plus: int) -> List[int]:
        """``palette_colors_y`` / ``_u``: from the cache, then a literal and
        ascending deltas (``plus`` 1 for luma, whose deltas are at least 1)."""
        sd, bd = self.sd, self.bd
        cache = self._palette_cache(b, plane)
        cached: List[int] = []
        for col in cache:
            if len(cached) >= n:
                break
            if sd.literal(1):
                cached.append(col)
        lit = []
        if len(cached) < n:
            lit.append(sd.literal(bd))
            if len(cached) + 1 < n:
                bits = min_bits + sd.literal(2)
                top = (1 << bd) - 1
                for _ in range(n - len(cached) - 1):
                    d = sd.literal(bits) + plus
                    col = min(lit[-1] + d, top)
                    lit.append(col)
                    bits = min(bits, _ceil_log2(top + 1 - col - plus))
        return sorted(cached + lit)

    def _palette_cache(self, b, plane: int) -> List[int]:
        st = self.mi_stride
        up, lf = (b.r - 1) * st + b.c, b.r * st + b.c - 1
        above = self.pal_colors[plane][up] if b.au and (b.r * 4) % 64 else ()
        left = self.pal_colors[plane][lf] if b.al else ()
        if plane == 1:
            above = above[0] if above else ()
            left = left[0] if left else ()
        out: List[int] = []
        i = j = 0
        while i < len(above) and j < len(left):
            a, l_ = above[i], left[j]
            if l_ < a:
                if not out or l_ != out[-1]:
                    out.append(l_)
                j += 1
            else:
                if not out or a != out[-1]:
                    out.append(a)
                i += 1
                if l_ == a:
                    j += 1
        for v in list(above[i:]) + list(left[j:]):
            if not out or v != out[-1]:
                out.append(v)
        return out

    def _palette_tokens(self, b) -> None:
        fr = self.fr
        w, h = SIZES[b.bsize]
        on_h = min(h, (fr.mi_rows - b.r) * 4)
        on_w = min(w, (fr.mi_cols - b.c) * 4)
        if b.pal[0]:
            b.maps[0] = self._color_map(b.pal[0], w, h, on_w, on_h, self.cdf["PALETTE_Y_COLOR"])
        if b.pal[1]:
            sx, sy = self.seq.ss_x, self.seq.ss_y
            bw, bh, ow, oh = w >> sx, h >> sy, on_w >> sx, on_h >> sy
            if bw < 4:
                bw, ow = bw + 2, ow + 2
            if bh < 4:
                bh, oh = bh + 2, oh + 2
            b.maps[1] = self._color_map(b.pal[1], bw, bh, ow, oh, self.cdf["PALETTE_UV_COLOR"])

    def _color_map(self, n: int, w: int, h: int, on_w: int, on_h: int, cdfs) -> List[List[int]]:
        av1_recon._hit("palette")
        sd = self.sd
        m = [[0] * w for _ in range(h)]
        m[0][0] = sd.ns(n)
        table = cdfs[n - 2]
        for i in range(1, on_h + on_w - 1):
            for j in range(min(i, on_w - 1), max(0, i - on_h + 1) - 1, -1):
                r, c = i - j, j
                scores = [0] * 8
                if c > 0:
                    scores[m[r][c - 1]] += 2
                if r > 0 and c > 0:
                    scores[m[r - 1][c - 1]] += 1
                if r > 0:
                    scores[m[r - 1][c]] += 2
                order = list(range(8))
                for k in range(3):
                    best, bi = scores[k], k
                    for t in range(k + 1, n):
                        if scores[t] > best:
                            best, bi = scores[t], t
                    if bi != k:
                        s, o = scores[bi], order[bi]
                        for t in range(bi, k, -1):
                            scores[t], order[t] = scores[t - 1], order[t - 1]
                        scores[k], order[k] = s, o
                ctx = PALETTE_HASH_CTX[scores[0] + 2 * scores[1] + 2 * scores[2]]
                m[r][c] = order[sd.symbol(table[ctx])]
        for i in range(on_h):
            m[i][on_w:] = [m[i][on_w - 1]] * (w - on_w)
        for i in range(on_h, h):
            m[i] = list(m[on_h - 1])
        return m

    # -- intra block copy ----------------------------------------------------
    def _intrabc_mv(self, b) -> None:
        b.y_mode = DC
        b.uv_mode = DC
        stack = self._ref_mv_stack(b)
        pred = stack[0] if len(stack) > 0 else (0, 0)
        if pred == (0, 0):
            pred = stack[1] if len(stack) > 1 else (0, 0)
        if pred == (0, 0):
            sb4 = self.sb4
            if b.r - sb4 < self.r0:
                pred = (0, -(sb4 * 4 + 256) * 8)
            else:
                pred = (-(sb4 * 4 * 8), 0)
        sd = self.sd
        mvc = self.cdf["MV"][1]
        joint = sd.symbol(mvc["joint"])
        dr = self._mv_component(mvc["comp"][0]) if joint in (2, 3) else 0
        dc = self._mv_component(mvc["comp"][1]) if joint in (1, 3) else 0
        b.mv = (pred[0] + dr, pred[1] + dc)
        if not self._dv_valid(b):
            raise AV1Error("AV1: an intra block copy vector outside the decoded area")

    def _dv_valid(self, b) -> bool:
        """libaom's ``av1_is_dv_valid``: whole pixels, inside the tile (4
        pixels in for sub-8 chroma), and in a superblock at least
        ``INTRABC_DELAY_SB64`` 64-wide superblocks back on the wavefront."""
        dvr, dvc = b.mv
        if dvr & 7 or dvc & 7 or not (-(1 << 14) < dvr < 1 << 14 and -(1 << 14) < dvc < 1 << 14):
            return False
        top = b.r * 32 + dvr
        left = b.c * 32 + dvc
        bottom = (b.r * 4 + b.h) * 8 + dvr
        right = (b.c * 4 + b.w) * 8 + dvc
        if top < self.r0 * 32 or left < self.c0 * 32 or bottom > self.r1 * 32 \
                or right > self.c1 * 32:
            return False
        if b.has_chroma:
            if b.w < 8 and self.seq.ss_x and left < self.c0 * 32 + 32:
                return False
            if b.h < 8 and self.seq.ss_y and top < self.r0 * 32 + 32:
                return False
        sb_log2 = 5 if self.seq.use_128 else 4
        sb_px = 4 << sb_log2
        active_row = b.r >> sb_log2
        active_col64 = (b.c * 4) >> 6
        src_row = ((bottom >> 3) - 1) // sb_px
        src_col64 = ((right >> 3) - 1) >> 6
        per_row = ((self.c1 - self.c0 - 1) >> 4) + 1
        if src_row * per_row + src_col64 >= active_row * per_row + active_col64 - 4:
            return False
        wf = (1 + 4 + (sb_px > 64)) * (active_row - src_row)
        return not (src_row > active_row or src_col64 >= active_col64 - 4 + wf)

    def _mv_component(self, comp) -> int:
        """``read_mv_component``: the fraction 3 and the eighth 1 where
        ``force_integer_mv`` and ``allow_high_precision_mv`` leave them
        unread."""
        sd, fr = self.sd, self.fr
        sign = sd.symbol(comp["MV_SIGN"])
        cls = sd.symbol(comp["MV_CLASS"])
        if cls == 0:
            d = sd.symbol(comp["MV_CLASS0_BIT"])
            frac = 3 if fr.force_integer_mv else sd.symbol(comp["MV_CLASS0_FR"][d])
            hp = sd.symbol(comp["MV_CLASS0_HP"]) if fr.allow_hp else 1
            mag = ((d << 3) | (frac << 1) | hp) + 1
        else:
            d = 0
            for i in range(cls):
                d |= sd.symbol(comp["MV_BIT"][i]) << i
            frac = 3 if fr.force_integer_mv else sd.symbol(comp["MV_FR"])
            hp = sd.symbol(comp["MV_HP"]) if fr.allow_hp else 1
            mag = (2 << (cls + 2)) + ((d << 3) | (frac << 1) | hp) + 1
        return -mag if sign else mag

    def _ref_mv_stack(self, b) -> List[tuple]:
        """``find_mv_stack`` for an intra block copy: candidates from the
        rows and columns around the block that were themselves copies,
        weighted, sorted, then clamped."""
        fr = self.fr
        bw4, bh4 = b.w >> 2, b.h >> 2
        mvs: List[list] = []  # [mv, weight]

        def add(r: int, c: int, weight: int) -> None:
            i = r * self.mi_stride + c
            if not self.is_bc[i]:
                return
            mv = self.mv[i]
            for e in mvs:
                if e[0] == mv:
                    e[1] += weight
                    return
            if len(mvs) < 8:
                mvs.append([mv, weight])

        def scan_row(dr: int) -> None:
            end4 = min(bw4, fr.mi_cols - b.c, 16)
            dc = 0
            step16 = bw4 >= 16
            if abs(dr) > 1:
                dr += b.r & 1
                dc = 1 - (b.c & 1)
            i = 0
            while i < end4:
                r, c = b.r + dr, b.c + dc + i
                if not self._inside(r, c):
                    break
                ln = min(bw4, SIZES[self.mi_size[r * self.mi_stride + c]][0] >> 2)
                if abs(dr) > 1:
                    ln = max(2, ln)
                if step16:
                    ln = max(4, ln)
                add(r, c, 2 * ln)
                i += ln

        def scan_col(dc: int) -> None:
            end4 = min(bh4, fr.mi_rows - b.r, 16)
            dr = 0
            step16 = bh4 >= 16
            if abs(dc) > 1:
                dr = 1 - (b.r & 1)
                dc += b.c & 1
            i = 0
            while i < end4:
                r, c = b.r + dr + i, b.c + dc
                if not self._inside(r, c):
                    break
                ln = min(bh4, SIZES[self.mi_size[r * self.mi_stride + c]][1] >> 2)
                if abs(dc) > 1:
                    ln = max(2, ln)
                if step16:
                    ln = max(4, ln)
                add(r, c, 2 * ln)
                i += ln

        def scan_point(dr: int, dc: int) -> None:
            r, c = b.r + dr, b.c + dc
            if self._inside(r, c) and self.written[r * self.mi_stride + c]:
                add(r, c, 4)

        scan_row(-1)
        scan_col(-1)
        if max(bw4, bh4) <= 16:
            scan_point(-1, bw4)
        nearest = len(mvs)
        for e in mvs:
            e[1] += 640
        scan_point(-1, -1)
        scan_row(-3)
        scan_col(-3)
        if bh4 > 1:
            scan_row(-5)
        if bw4 > 1:
            scan_col(-5)
        for lo, hi in ((0, nearest), (nearest, len(mvs))):
            end = hi
            while end > lo:
                new_end = lo
                for k in range(lo + 1, end):
                    if mvs[k - 1][1] < mvs[k][1]:
                        mvs[k - 1], mvs[k] = mvs[k], mvs[k - 1]
                        new_end = k
                end = new_end
        out = []
        top, bottom = -(b.r * 32), (fr.mi_rows - bh4 - b.r) * 32
        lft, rgt = -(b.c * 32), (fr.mi_cols - bw4 - b.c) * 32
        for (mr, mc), _w in mvs:
            br, bc = 128 + bh4 * 32, 128 + bw4 * 32
            out.append((min(max(mr, top - br), bottom + br), min(max(mc, lft - bc), rgt + bc)))
        return out

    def _predict_bc(self, b) -> None:
        for p in range(1 + 2 * b.has_chroma):
            sx, sy = self.ss[p]
            pw, ph = max(4, b.w >> sx), max(4, b.h >> sy)
            bx, by = (b.c >> sx) * 4, (b.r >> sy) * 4
            # libaom copies from its frame buffer without extending the
            # frame's edge: the MI-aligned samples past it are read as decoded
            last_x, last_y = self.max_x[p], self.max_y[p]
            av1_recon.predict_intrabc(self.planes[p], self.strides[p], bx, by, pw, ph,
                                      b.mv[0], b.mv[1], sx, sy, last_x, last_y, self.bd)

    # -- transform size and type ---------------------------------------------
    def _read_tx_size(self, b) -> None:
        """``read_block_tx_size``: the block's transform size (``b.tx``), or
        for an intra block copy with ``TX_MODE_SELECT`` the transform tree
        (``b.inter_tx``), and the above/left transform contexts."""
        fr, bw4, bh4 = self.fr, b.w >> 2, b.h >> 2
        max_tx = (min(b.w, 64), min(b.h, 64))
        if b.lossless:
            b.tx = (4, 4)
        elif fr.tx_mode == TX_MODE_SELECT and b.bsize and b.inter and not b.skip:
            b.inter_tx = {}
            for r4 in range(0, bh4, max_tx[1] >> 2):
                for c4 in range(0, bw4, max_tx[0] >> 2):
                    self._var_tx(b, r4, c4, max_tx, 0)
            return
        else:
            b.tx = max_tx
            if b.bsize and fr.tx_mode == TX_MODE_SELECT and not (b.inter and b.skip):
                depth = self.sd.symbol(self.cdf["TX_SIZE"][_tx_depth_to_4x4(max_tx) - 1]
                                       [self._tx_size_ctx(b, max_tx)])
                av1_recon._hit("tx_mode_select")
                for _ in range(depth):
                    b.tx = split_tx(b.tx)
        tw, th = (b.w, b.h) if b.skip and b.inter else b.tx
        self.above_txfm[b.c : b.c + bw4] = [tw] * bw4
        self.left_txfm[b.r : b.r + bh4] = [th] * bh4

    def _tx_size_ctx(self, b, max_tx) -> int:
        st = self.mi_stride
        above = self.above_txfm[b.c] >= max_tx[0]
        left = self.left_txfm[b.r] >= max_tx[1]
        if b.au:
            i = (b.r - 1) * st + b.c
            if self.is_inter[i]:
                above = SIZES[self.mi_size[i]][0] >= max_tx[0]
        if b.al:
            i = b.r * st + b.c - 1
            if self.is_inter[i]:
                left = SIZES[self.mi_size[i]][1] >= max_tx[1]
        if b.au and b.al:
            return above + left
        return above if b.au else left if b.al else 0

    def _var_tx(self, b, r4: int, c4: int, tx, depth: int) -> None:
        """``read_var_tx_size`` as libaom's ``read_tx_size_vartx`` runs it."""
        if b.r + r4 >= self.fr.mi_rows or b.c + c4 >= self.fr.mi_cols:
            return
        tw4, th4 = tx[0] >> 2, tx[1] >> 2
        col, row = b.c + c4, b.r + r4
        if depth < 2 and tx != (4, 4):
            above = self.above_txfm[col] < tx[0]
            left = self.left_txfm[row] < tx[1]
            top = _sqr_index(min(max(b.w, b.h), 64))
            cat = (_sqr_index(max(tx)) != top and top > 1) + (4 - top) * 2
            ctx = cat * 3 + above + left
            if self.sd.symbol(self.cdf["TXFM_SPLIT"][ctx]):
                av1_recon._hit("txfm_split")
                sub = split_tx(tx)
                if sub == (4, 4):
                    for i in range(th4):
                        for j in range(tw4):
                            b.inter_tx[(r4 + i, c4 + j)] = sub
                    self.above_txfm[col : col + tw4] = [4] * tw4
                    self.left_txfm[row : row + th4] = [4] * th4
                    return
                for i in range(0, th4, sub[1] >> 2):
                    for j in range(0, tw4, sub[0] >> 2):
                        self._var_tx(b, r4 + i, c4 + j, sub, depth + 1)
                return
        b.inter_tx[(r4, c4)] = tx
        self.above_txfm[col : col + tw4] = [tx[0]] * tw4
        self.left_txfm[row : row + th4] = [tx[1]] * th4

    def _read_tx_type(self, b, tx) -> int:
        """``transform_type`` of a luma transform block."""
        fr = self.fr
        kind = tx_set(tx, b.inter, fr.reduced_tx_set)
        if kind == 0 or fr.qindex[b.seg] == 0:
            return DCT_DCT
        sqr = _sqr_index(min(tx))
        if b.inter:
            eset = _INTER_ESET[kind]
            cdf = self.cdf[f"INTER_TX_SET{eset}"][sqr]
        else:
            eset = _INTRA_ESET[kind]
            mode = FILTER_TO_DIR[b.filter_mode] if b.filter_mode >= 0 else b.y_mode
            cdf = self.cdf[f"INTRA_TX_SET{eset}"][sqr][mode]
        av1_recon._hit(f"tx_set_{'inter' if b.inter else 'intra'}_{eset}")
        if fr.reduced_tx_set and b.inter:
            av1_recon._hit("reduced_tx_set")
        return TX_INV[kind][self.sd.symbol(cdf)]

    @staticmethod
    def _luma_tx_type(b, x4: int, y4: int, w4: int, h4: int, t: int) -> None:
        """``TxTypes`` of a luma transform block over its 4 x 4s, which the
        chroma of an inter block reads at the co-located position."""
        for i in range(h4):
            for j in range(w4):
                b.tx_types[(y4 - b.r + i, x4 - b.c + j)] = t

    def _plane_tx_type(self, b, p: int, tx, x4: int, y4: int) -> int:
        """``compute_tx_type`` of a chroma transform block."""
        if b.lossless or max(tx) > 32:
            return DCT_DCT
        kind = tx_set(tx, b.inter, self.fr.reduced_tx_set)
        if b.inter:
            sx, sy = self.ss[p]
            t = b.tx_types.get((max(b.r, y4 << sy) - b.r, max(b.c, x4 << sx) - b.c), DCT_DCT)
        else:
            t = MODE_TO_TXFM[DC if b.uv_mode == UV_CFL else b.uv_mode]
        return t if t in TX_INV[kind] else DCT_DCT

    # -- residual ------------------------------------------------------------
    def _residual(self, b) -> None:
        bw4, bh4 = b.w >> 2, b.h >> 2
        cw, ch = min(b.w, 64), min(b.h, 64)
        b.qidx = qindex(self.cur_q if self.fr.delta_q_present else self.fr.base_q_idx,
                        self.fr.seg_features[b.seg][0] if self.fr.seg_enabled else None)
        for cy in range(max(1, bh4 >> 4)):
            for cx in range(max(1, bw4 >> 4)):
                for p in range(1 + 2 * b.has_chroma):
                    sx, sy = self.ss[p]
                    tx = (4, 4) if b.lossless else b.tx if p == 0 else self._uv_tx(b, p)
                    pw, ph = max(4, cw >> sx), max(4, ch >> sy)
                    if b.inter and not b.lossless and p == 0:
                        self._tree(b, b.c * 4 + cx * 64, b.r * 4 + cy * 64, pw, ph)
                        continue
                    bx, by = (b.c >> sx) * 4, (b.r >> sy) * 4
                    for y in range(0, ph >> 2, tx[1] >> 2):
                        for x in range(0, pw >> 2, tx[0] >> 2):
                            self._tx_block(b, p, bx, by, tx, x + ((cx << 4) >> sx),
                                           y + ((cy << 4) >> sy))

    def _uv_tx(self, b, p: int):
        sx, sy = self.ss[p]
        w, h = min(max(4, b.w >> sx), 64), min(max(4, b.h >> sy), 64)
        if w == 64 or h == 64:
            return (16, 32) if w == 16 else (32, 16) if h == 16 else (32, 32)
        return (w, h)

    def _tree(self, b, x: int, y: int, w: int, h: int) -> None:
        """``transform_tree`` of an intra block copy's luma."""
        if x >= self.fr.mi_cols * 4 or y >= self.fr.mi_rows * 4:
            return
        tx = b.tx if b.inter_tx is None else b.inter_tx.get(((y >> 2) - b.r, (x >> 2) - b.c))
        if tx is None or w < tx[0] or h < tx[1]:
            raise AV1Error("AV1: a transform tree without its transform (a corrupt frame)")
        if tx == (w, h):
            self._tx_block(b, 0, x, y, tx, 0, 0)
        elif w > h:
            self._tree(b, x, y, w // 2, h)
            self._tree(b, x + w // 2, y, w // 2, h)
        elif w < h:
            self._tree(b, x, y, w, h // 2)
            self._tree(b, x, y + h // 2, w, h // 2)
        else:
            for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                self._tree(b, x + dx * w // 2, y + dy * h // 2, w // 2, h // 2)

    def _tx_block(self, b, p: int, bx: int, by: int, tx, x: int, y: int) -> None:
        sx, sy = self.ss[p]
        tw, th = tx
        sx_ = bx + 4 * x
        sy_ = by + 4 * y
        if sx_ > self.max_x[p] or sy_ > self.max_y[p]:
            return
        sb_mask = self.sb4 - 1
        row = (((sy_ << sy) >> 2) & sb_mask) >> sy
        col = (((sx_ << sx) >> 2) & sb_mask) >> sx
        step_x, step_y = tw >> 2, th >> 2
        flags = self.decoded[p]
        px, stride = self.planes[p], self.strides[p]
        if not b.inter:
            if b.pal[1 if p else 0]:
                pal = b.colors[0] if p == 0 else b.colors[1][p - 1]
                cmap = b.maps[1 if p else 0]
                for i in range(th):
                    mrow = cmap[y * 4 + i]
                    at = (sy_ + i) * stride + sx_
                    px[at : at + tw] = [pal[k] for k in mrow[x * 4 : x * 4 + tw]]
            else:
                cfl = p > 0 and b.uv_mode == UV_CFL
                mode = b.y_mode if p == 0 else (DC if cfl else b.uv_mode)
                have_left = (b.al if p == 0 else b.alc) or x > 0
                have_above = (b.au if p == 0 else b.auc) or y > 0
                have_ar = flags.get((row - 1, col + step_x), False)
                have_bl = flags.get((row + step_y, col - 1), False)
                # get_filter_type matters only to the directional modes' edges
                smooth = self.seq.enable_intra_edge_filter and 1 <= mode <= 8 and \
                    self._smooth_neighbour(b, p)
                av1_recon.predict_intra(
                    px, stride, sx_, sy_, tw, th, have_left, have_above, have_ar, have_bl,
                    self.max_x[p], self.max_y[p], self.bd, mode,
                    b.y_delta if p == 0 else b.uv_delta,
                    b.filter_mode if p == 0 else -1, self.seq.enable_intra_edge_filter, smooth)
                if cfl:
                    av1_recon.predict_cfl(px, stride, self.planes[0], self.strides[0], sx_, sy_,
                                          tw, th, sx, sy, b.max_luma_w, b.max_luma_h,
                                          b.alpha_u if p == 1 else b.alpha_v, self.bd)
        if p == 0:
            b.max_luma_w, b.max_luma_h = sx_ + tw, sy_ + th
        if not b.skip:
            coefs = self._coeffs(b, p, sx_ >> 2, sy_ >> 2, tx)
            if coefs is not None:
                if b.lossless:
                    av1_recon.reconstruct_wht(px, stride, sx_, sy_, coefs, self.bd)
                else:
                    av1_recon.add_residual(px, stride, sx_, sy_, inverse_transform(
                        coefs, b.plane_tx_type, self.bd), self.bd)
        for i in range(step_y):
            for j in range(step_x):
                flags[(row + i, col + j)] = True
        self.lf_tw[p][sy_ >> 2 : (sy_ >> 2) + step_y, sx_ >> 2 : (sx_ >> 2) + step_x] = tw
        self.lf_th[p][sy_ >> 2 : (sy_ >> 2) + step_y, sx_ >> 2 : (sx_ >> 2) + step_x] = th

    def _smooth_neighbour(self, b, p: int) -> bool:
        """``get_filter_type``: is the above or left block (of the plane's
        own blocks, for chroma) smooth?"""
        st = self.mi_stride
        sx, sy = self.ss[p]
        out = False
        if b.au if p == 0 else b.auc:
            r, c = b.r - 1, b.c
            if p:
                if sx and not b.c & 1:
                    c += 1
                if sy and b.r & 1:
                    r -= 1
            out = self._is_smooth(r * st + c, p)
        if not out and (b.al if p == 0 else b.alc):
            r, c = b.r, b.c - 1
            if p:
                if sx and b.c & 1:
                    c -= 1
                if sy and not b.r & 1:
                    r += 1
            out = self._is_smooth(r * st + c, p)
        return out

    def _is_smooth(self, i: int, p: int) -> bool:
        mode = self.y_mode[i] if p == 0 else (DC if self.is_inter[i] else self.uv_mode[i])
        return mode in (SMOOTH, SMOOTH_V, SMOOTH_H)

    def _coeffs(self, b, p: int, x4: int, y4: int, tx):
        """``coeffs`` of one transform block: the dequantised coefficients,
        a list in row-major order for a lossless 4 x 4 block, else an (h, w)
        array (the top-left 32 x 32 of a 64-point size), or None when
        ``all_zero``.  Sets ``b.plane_tx_type``."""
        sd, cdf = self.sd, self.cdf
        tw, th = tx
        w4, h4 = tw >> 2, th >> 2
        sx, sy = self.ss[p]
        max_x4, max_y4 = self.fr.mi_cols >> sx, self.fr.mi_rows >> sy
        al, ad = self.above_level[p], self.above_dc[p]
        ll, ld = self.left_level[p], self.left_dc[p]
        nx, ny = max(0, min(w4, max_x4 - x4)), max(0, min(h4, max_y4 - y4))
        szctx = (_sqr_index(min(tw, th)) + _sqr_index(max(tw, th)) + 1) >> 1
        if p == 0:
            if (b.w, b.h) == tx:
                ctx = 0
            else:
                top = max(al[x4 : x4 + nx], default=0)
                left = max(ll[y4 : y4 + ny], default=0)
                ctx = SKIP_CTX[min(top, 4)][min(left, 4)]
        else:
            above = any(al[x4 : x4 + nx]) or any(ad[x4 : x4 + nx])
            left = any(ll[y4 : y4 + ny]) or any(ld[y4 : y4 + ny])
            pw, ph = max(4, b.w >> sx), max(4, b.h >> sy)
            ctx = above + left + (10 if pw * ph > tw * th else 7)
        if sd.symbol(cdf["TXB_SKIP"][szctx][ctx]):
            if p == 0 and b.inter:
                self._luma_tx_type(b, x4, y4, w4, h4, DCT_DCT)
            al[x4 : x4 + w4] = ad[x4 : x4 + w4] = [0] * w4
            ll[y4 : y4 + h4] = ld[y4 : y4 + h4] = [0] * h4
            return None
        if p == 0:
            t = self._read_tx_type(b, tx)
            if b.inter:
                self._luma_tx_type(b, x4, y4, w4, h4, t)
            b.luma_tx_type = t
            if b.lossless or max(tx) > 32:
                t = DCT_DCT
        else:
            t = self._plane_tx_type(b, p, tx, x4, y4)
        b.plane_tx_type = t
        av1_recon._hit(f"tx_{tw}x{th}")
        info = _scan_info(tw, th, t)
        scan, pad, stride, aw, tx_class = info.scan, info.pad, info.stride, info.aw, info.cls
        ptype = 1 if p else 0
        multi = min(tw.bit_length() - 1, 5) + min(th.bit_length() - 1, 5) - 4
        eob_pt = sd.symbol(cdf[_EOB_PT[multi]][ptype][0 if tx_class == 0 else 1]) + 1
        eob = eob_pt if eob_pt < 2 else (1 << (eob_pt - 2)) + 1
        if eob_pt >= 3:
            if sd.symbol(cdf["EOB_EXTRA"][szctx][ptype][eob_pt - 3]):
                eob += 1 << (eob_pt - 3)
            for i in range(1, eob_pt - 2):
                if sd.literal(1):
                    eob += 1 << (eob_pt - 3 - i)
        if eob > len(scan):
            raise AV1Error("AV1: end of block past the transform (a corrupt frame)")
        levels = [0] * (stride * (info.ah + 4))
        quant = {}
        base_cdfs = cdf["COEFF_BASE"][szctx][ptype]
        br_cdfs = cdf["COEFF_BR"][min(szctx, 3)][ptype]
        offs = info.offs
        lim = info.area
        for k in range(eob - 1, -1, -1):
            pos = scan[k]
            pi = pad[pos]
            if k == eob - 1:
                ctx = 0 if k == 0 else 1 if k <= lim >> 3 else 2 if k <= lim >> 2 else 3
                level = sd.symbol(cdf["COEFF_BASE_EOB"][szctx][ptype][ctx]) + 1
            else:
                if tx_class == 0:
                    if pos == 0:
                        ctx = 0
                    else:
                        mag = (CLIP3[levels[pi + 1]] + CLIP3[levels[pi + stride]]
                               + CLIP3[levels[pi + stride + 1]] + CLIP3[levels[pi + 2]]
                               + CLIP3[levels[pi + 2 * stride]])
                        ctx = min((mag + 1) >> 1, 4) + offs[pos]
                elif tx_class == 1:  # horizontal: along the row
                    mag = (CLIP3[levels[pi + 1]] + CLIP3[levels[pi + stride]]
                           + CLIP3[levels[pi + 2]] + CLIP3[levels[pi + 3]] + CLIP3[levels[pi + 4]])
                    ctx = min((mag + 1) >> 1, 4) + offs[pos]
                else:  # vertical: down the column
                    mag = (CLIP3[levels[pi + 1]] + CLIP3[levels[pi + stride]]
                           + CLIP3[levels[pi + 2 * stride]] + CLIP3[levels[pi + 3 * stride]]
                           + CLIP3[levels[pi + 4 * stride]])
                    ctx = min((mag + 1) >> 1, 4) + offs[pos]
                level = sd.symbol(base_cdfs[ctx])
            if level > 2:
                if tx_class == 0:
                    mag = levels[pi + 1] + levels[pi + stride] + levels[pi + stride + 1]
                elif tx_class == 1:
                    mag = levels[pi + 1] + levels[pi + stride] + levels[pi + 2]
                else:
                    mag = levels[pi + 1] + levels[pi + stride] + levels[pi + 2 * stride]
                mag = min((mag + 1) >> 1, 6)
                ctx = mag + info.br_offs[pos]
                for _ in range(4):
                    br = sd.symbol(br_cdfs[ctx])
                    level += br
                    if br < 3:
                        break
            levels[pi] = level
            quant[pos] = level
        # signs, Golomb remainders, dequantisation
        bd = self.bd
        qidx = b.qidx
        dq_dc, dq_ac = self.fr.delta_q[p]
        dcq = dc_q(bd, qidx, dq_dc)
        acq = ac_q(bd, qidx, dq_ac)
        qm = None
        level_qm = self.fr.qm[p]
        if self.fr.using_qmatrix and not b.lossless and level_qm < 15 and t < IDTX:
            qm = iqmatrix(level_qm, p > 0, tw, th).reshape(-1)
            av1_recon._hit("qm")
        shift = dq_denom(tw, th)
        lo, hi = -(1 << (7 + bd)), (1 << (7 + bd)) - 1
        cul, dc_cat = 0, 0
        out = {}
        for k in range(eob):
            pos = scan[k]
            level = quant[pos]
            if not level:
                continue
            if k == 0:
                s = 0
                for v in ad[x4 : x4 + nx]:
                    s += -1 if v == 1 else 1 if v == 2 else 0
                for v in ld[y4 : y4 + ny]:
                    s += -1 if v == 1 else 1 if v == 2 else 0
                sign = sd.symbol(cdf["DC_SIGN"][ptype][1 if s < 0 else 2 if s > 0 else 0])
            else:
                sign = sd.literal(1)
            if level > 14:
                length = 0
                while True:
                    length += 1
                    bit = sd.literal(1)
                    if length > 20:
                        raise AV1Error("AV1: Golomb code too long")
                    if bit:
                        break
                x = 1
                for _ in range(length - 1):
                    x = (x << 1) | sd.literal(1)
                level = x + 14
            if pos == 0:
                dc_cat = 1 if sign else 2
            level &= 0xFFFFF
            cul += level
            q = dcq if pos == 0 else acq
            if qm is not None:
                q = (int(qm[pos]) * q + 16) >> 5
            dq = ((level * q) & 0xFFFFFF) >> shift
            out[pos] = max(-dq, lo) if sign else min(dq, hi)
        cul = min(63, cul)
        al[x4 : x4 + w4] = [cul] * w4
        ll[y4 : y4 + h4] = [cul] * h4
        ad[x4 : x4 + w4] = [dc_cat] * w4
        ld[y4 : y4 + h4] = [dc_cat] * h4
        if b.lossless:
            coefs = [0] * 16
            for pos, v in out.items():
                coefs[pos] = v
            return coefs
        coefs = np.zeros((th, tw), np.int64)
        flat = coefs[: info.ah, : aw]
        for pos, v in out.items():
            flat[pos // aw, pos % aw] = v
        return coefs

class _Block:
    __slots__ = ("r", "c", "bsize", "w", "h", "has_chroma", "au", "al", "auc", "alc", "seg",
                 "skip", "bc", "mv", "y_mode", "uv_mode", "y_delta", "uv_delta", "alpha_u",
                 "alpha_v", "pal", "colors", "maps", "filter_mode", "max_luma_w",
                 "max_luma_h", "lossless", "tx", "inter_tx", "tx_types", "qidx",
                 "plane_tx_type", "luma_tx_type", "inter", "ref", "mv1", "interp", "skip_mode",
                 "comp_group", "comp_idx", "seg_pred", "nb", "interintra", "wedge",
                 "motion_mode", "local_warp", "compound", "mask_type", "mask")

    def __init__(self, r, c, bsize, w, h, has_chroma, au, al, auc, alc):
        self.r, self.c, self.bsize, self.w, self.h = r, c, bsize, w, h
        self.has_chroma, self.au, self.al, self.auc, self.alc = has_chroma, au, al, auc, alc
        self.seg = self.skip = 0
        self.bc = False
        self.mv = (0, 0)
        self.y_mode = self.uv_mode = DC
        self.y_delta = self.uv_delta = 0
        self.alpha_u = self.alpha_v = 0
        self.pal = [0, 0]
        self.colors = [(), ()]
        self.maps = [None, None]
        self.filter_mode = -1
        self.max_luma_w = self.max_luma_h = 0
        self.lossless = True
        self.tx = (4, 4)
        self.inter_tx = None
        self.tx_types = {}
        self.qidx = 0
        self.plane_tx_type = self.luma_tx_type = DCT_DCT
        self.inter = False
        self.ref = (0, -1)
        self.mv1 = (0, 0)
        self.interp = (0, 0)
        self.skip_mode = self.comp_group = self.seg_pred = self.interintra = 0
        self.comp_idx = 1
        self.nb = (None, None)
        self.wedge = self.local_warp = self.mask = None
        self.motion_mode = self.mask_type = 0
        self.compound = COMPOUND_AVERAGE


def lr_unit_count(size: int, extent: int) -> int:
    """``count_units_in_frame``."""
    return max((extent + (size >> 1)) // size, 1)


def _inverse_recenter(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    return r - ((v + 1) >> 1) if v & 1 else r + (v >> 1)


def _sub_size(part: int, w: int, h: int) -> int:
    if part == NONE:
        return INDEX[(w, h)]
    if part in (HORZ, HORZ_A, HORZ_B):
        return INDEX[(w, h >> 1)]
    if part in (VERT, VERT_A, VERT_B):
        return INDEX[(w >> 1, h)]
    if part == SPLIT:
        return INDEX[(w >> 1, h >> 1)]
    if part == HORZ_4:
        return INDEX[(w, h >> 2)]
    return INDEX[(w >> 2, h)]


def _neg_deinterleave(diff: int, ref: int, top: int) -> int:
    if not ref:
        return diff
    if ref >= top - 1:
        return top - diff - 1
    if 2 * ref < top:
        if diff <= 2 * ref:
            return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
        return diff
    if diff <= 2 * (top - ref - 1):
        return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
    return top - (diff + 1)


from molnextr_tpu_torch.data import av1_mvpred  # noqa: E402  (it reads SIZES from here)
