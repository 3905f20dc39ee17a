"""AV1 motion vector prediction (the AV1 specification, sections 7.9 and
7.10.2-7.10.4, as libaom 3.14's ``mvref_common.c`` runs it).

* :func:`motion_field`: the motion field estimation of a frame that uses
  its references' motion vectors: each reference's saved vectors projected
  onto the current frame (``motion_field_projection``: LAST unless it is
  an overlay, BWDREF, ALTREF2, ALTREF, LAST2 while stamps last), kept as
  one vector and its reference distance per 8 x 8.  A key or intra-only
  frame saves none.
* :func:`find_mv_stack`: the reference motion vector stack of a block: the
  rows and columns above and left (nearest first, weighted), the top
  right, the temporal candidates, the outer rows and columns, sorting,
  the extra search (with sign inversion, and the compound combinations),
  clamping, and the ``NewMvContext``/``RefMvContext``/``ZeroMvContext``
  and ``DrlCtxStack`` contexts.
* :func:`has_overlappable_candidates` and :func:`find_warp_samples` for
  the motion modes.

The decoder's per-MI state is read from flat lists of the frame decoder
(``ref0``/``ref1``, ``mv0``/``mv1``, ``y_mode``, ``mi_size``, ``written``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from molnextr_tpu_torch.data.av1_block import SIZES
from molnextr_tpu_torch.data.av1_inter import round2signed
from molnextr_tpu_torch.data.av1_recon import _hit
from molnextr_tpu_torch.data.av1_obu import (IDENTITY, INTRA_ONLY_FRAME, KEY_FRAME,
                                             TRANSLATION, relative_dist)

NEARESTMV, NEARMV, GLOBALMV, NEWMV = 13, 14, 15, 16
NEAREST_NEARESTMV, NEAR_NEARMV, NEAREST_NEWMV, NEW_NEARESTMV = 17, 18, 19, 20
NEAR_NEWMV, NEW_NEARMV, GLOBAL_GLOBALMV, NEW_NEWMV = 21, 22, 23, 24
NEW_MODES = (NEWMV, NEW_NEWMV, NEAR_NEWMV, NEW_NEARMV, NEAREST_NEWMV, NEW_NEARESTMV)
DIV_MULT = (0, 16384, 8192, 5461, 4096, 3276, 2730, 2340, 2048, 1820, 1638, 1489, 1365, 1260,
            1170, 1092, 1024, 963, 910, 862, 819, 780, 744, 712, 682, 655, 630, 606, 585, 564,
            546, 528)
REF_CAT_LEVEL = 640
BWDREF, ALTREF2, ALTREF, LAST, LAST2, GOLDEN = 5, 6, 7, 1, 2, 4


def lower_precision(fr, mv: Tuple[int, int]) -> Tuple[int, int]:
    """``lower_mv_precision``."""
    if fr.allow_hp:
        return mv
    out = []
    for v in mv:
        if fr.force_integer_mv:
            a = (abs(v) + 3) >> 3
            v = a << 3 if v > 0 else -(a << 3)
        elif v & 1:
            v += -1 if v > 0 else 1
        out.append(v)
    return out[0], out[1]


def global_mv(fr, ref: int, bw: int, bh: int, mi_row: int, mi_col: int) -> Tuple[int, int]:
    """``setup_global_mv`` (libaom's ``gm_get_motion_vector``)."""
    kind = fr.gm_type[ref] if ref > 0 else IDENTITY
    if ref <= 0 or kind == IDENTITY:
        mv = (0, 0)
    else:
        p = fr.gm_params[ref]
        if kind == TRANSLATION:
            mv = (p[0] >> 13, p[1] >> 13)  # libaom's (and the specification's) order
        else:
            x = mi_col * 4 + bw // 2 - 1
            y = mi_row * 4 + bh // 2 - 1
            xc = (p[2] - (1 << 16)) * x + p[3] * y + p[0]
            yc = p[4] * x + (p[5] - (1 << 16)) * y + p[1]
            if fr.allow_hp:
                mv = (round2signed(yc, 13), round2signed(xc, 13))
            else:
                mv = (round2signed(yc, 14) * 2, round2signed(xc, 14) * 2)
    return lower_precision(fr, mv)


def _projection(mv, num: int, den: int) -> Tuple[int, int]:
    """``get_mv_projection``."""
    den = min(den, 31)
    num = min(num, 31) if num > 0 else max(num, -31)
    out = []
    for v in mv:
        p = round2signed(v * num * DIV_MULT[den], 14)
        out.append(max(-(1 << 14) + 1, min((1 << 14) - 1, p)))
    return out[0], out[1]


def motion_field(seq, fr, refs) -> Optional[tuple]:
    """``av1_setup_motion_field``: per 8 x 8 of the frame, the projected
    vector (an (h8, w8, 2) array), its reference distance and whether one
    landed there; None without ``use_ref_frame_mvs``."""
    if not fr.use_ref_frame_mvs:
        return None
    h8, w8 = fr.mi_rows >> 1, fr.mi_cols >> 1
    mvs = np.zeros((h8, w8, 2), np.int64)
    offs = np.zeros((h8, w8), np.int64)
    valid = np.zeros((h8, w8), bool)
    hint = {r: refs[fr.ref_frame_idx[r - 1]].order_hint for r in range(1, 8)}

    def project(src: int, direction: int) -> bool:
        ref = refs[fr.ref_frame_idx[src - 1]]
        if ref.frame_type in (KEY_FRAME, INTRA_ONLY_FRAME) or ref.mf_ref is None:
            return False
        if (ref.mi_rows, ref.mi_cols) != (fr.mi_rows, fr.mi_cols):
            return False
        to_cur = relative_dist(seq, ref.order_hint, fr.order_hint)
        ref_off = [0] + [relative_dist(seq, ref.order_hint, ref.saved_order_hints[r])
                         for r in range(1, 8)]
        if direction == 2:
            to_cur = -to_cur
        sign = direction >> 1
        src_ref = ref.mf_ref[1::2, 1::2]
        src_mv = ref.mf_mvs[1::2, 1::2]
        targets, sources = [], []
        for r8, c8 in zip(*np.nonzero(src_ref > 0)):
            off = ref_off[src_ref[r8, c8]]
            if not (0 < off <= 31 and abs(to_cur) <= 31):
                continue
            mv = (int(src_mv[r8, c8, 0]), int(src_mv[r8, c8, 1]))
            pr, pc = _projection(mv, to_cur, off)
            row_off = pr >> 6 if pr >= 0 else -((-pr) >> 6)
            col_off = pc >> 6 if pc >= 0 else -((-pc) >> 6)
            row = r8 - row_off if sign else r8 + row_off
            col = c8 - col_off if sign else c8 + col_off
            base_r, base_c = (r8 >> 3) << 3, (c8 >> 3) << 3
            if not (0 <= row < h8 and 0 <= col < w8):
                continue
            if not (base_r <= row < base_r + 8 and base_c - 8 <= col < base_c + 16):
                continue
            targets.append((row, col))
            sources.append((mv, off))
        for (row, col), (mv, off) in zip(targets, sources):
            mvs[row, col] = mv
            offs[row, col] = off
            valid[row, col] = True
        return True

    stamp = 2
    last = refs[fr.ref_frame_idx[0]]
    if last.saved_order_hints[ALTREF] != hint[GOLDEN]:
        project(LAST, 2)
    stamp -= 1
    if relative_dist(seq, hint[BWDREF], fr.order_hint) > 0 and project(BWDREF, 0):
        stamp -= 1
    if relative_dist(seq, hint[ALTREF2], fr.order_hint) > 0 and project(ALTREF2, 0):
        stamp -= 1
    if relative_dist(seq, hint[ALTREF], fr.order_hint) > 0 and stamp >= 0 and \
            project(ALTREF, 0):
        stamp -= 1
    if stamp >= 0:
        project(LAST2, 2)
    return mvs, offs, valid


class Stack:
    """The result of ``find_mv_stack``."""

    __slots__ = ("mvs", "num", "new_ctx", "ref_ctx", "zero_ctx", "drl_ctx", "gm")


def find_mv_stack(d, b, refs: Tuple[int, int]) -> Stack:
    """``find_mv_stack`` for a block's reference frame(s) ``refs``
    (``refs[1]`` > 0 when compound)."""
    fr, st = d.fr, d.mi_stride
    compound = refs[1] > 0
    bw4, bh4 = b.w >> 2, b.h >> 2
    gm = [global_mv(fr, refs[0], b.w, b.h, b.r, b.c),
          global_mv(fr, refs[1], b.w, b.h, b.r, b.c) if compound else (0, 0)]
    stack: List[list] = []  # [mv0, mv1, weight]
    state = {"found": 0, "new": 0}

    def cand_mv(i: int, lst: int, k: int):
        mode = d.y_mode[i]
        size = d.mi_size[i]
        w, h = SIZES[size]
        ref = refs[k]
        if mode in (GLOBALMV, GLOBAL_GLOBALMV) and fr.gm_type[ref] > TRANSLATION and \
                min(w, h) >= 8:
            return gm[k]
        return lower_precision(fr, d.mv[i] if lst == 0 else d.mv1[i])

    def add(r: int, c: int, weight: int) -> None:
        i = r * st + c
        if d.ref0[i] <= 0:
            return
        if not compound:
            for lst in (0, 1):
                if (d.ref0[i], d.ref1[i])[lst] == refs[0]:
                    mv = cand_mv(i, lst, 0)
                    if d.y_mode[i] in NEW_MODES:
                        state["new"] += 1
                    state["found"] = 1
                    for e in stack:
                        if e[0] == mv:
                            e[2] += weight
                            break
                    else:
                        if len(stack) < 8:
                            stack.append([mv, None, weight])
        elif (d.ref0[i], d.ref1[i]) == refs:
            mv0, mv1 = cand_mv(i, 0, 0), cand_mv(i, 1, 1)
            state["found"] = 1
            for e in stack:
                if e[0] == mv0 and e[1] == mv1:
                    e[2] += weight
                    break
            else:
                if len(stack) < 8:
                    stack.append([mv0, mv1, weight])
            if d.y_mode[i] in NEW_MODES:
                state["new"] += 1

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
            if not d._inside(r, c):
                break
            ln = min(bw4, SIZES[d.mi_size[r * st + c]][0] >> 2)
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
            if not d._inside(r, c):
                break
            ln = min(bh4, SIZES[d.mi_size[r * st + c]][1] >> 2)
            if abs(dc) > 1:
                ln = max(2, ln)
            if step16:
                ln = max(4, ln)
            add(r, c, 2 * ln)
            i += ln

    def scan_point(dr: int, dc: int) -> None:
        r, c = b.r + dr, b.c + dc
        if d._inside(r, c) and d.written[r * st + c]:
            add(r, c, 4)

    scan_row(-1)
    above = state["found"]
    state["found"] = 0
    scan_col(-1)
    left = state["found"]
    state["found"] = 0
    if max(bw4, bh4) <= 16:
        scan_point(-1, bw4)
    if state["found"]:
        above = 1
    close = above + left
    nearest, num_new = len(stack), state["new"]
    for e in stack:
        e[2] += REF_CAT_LEVEL
    zero_ctx = 0
    if d.mf is not None:
        zero_ctx = _temporal(d, b, refs, gm, stack)
    scan_point(-1, -1)
    if state["found"]:
        above = 1
    state["found"] = 0
    scan_row(-3)
    if state["found"]:
        above = 1
    state["found"] = 0
    scan_col(-3)
    if state["found"]:
        left = 1
    state["found"] = 0
    if bh4 > 1:
        scan_row(-5)
    if state["found"]:
        above = 1
    state["found"] = 0
    if bw4 > 1:
        scan_col(-5)
    if state["found"]:
        left = 1
    total = above + left
    _sort(stack, 0, nearest)
    _sort(stack, nearest, len(stack))
    if len(stack) < 2:
        _extra_search(d, b, refs, gm, stack)
    out = Stack()
    out.num = len(stack)
    out.drl_ctx = []
    for k in range(len(stack)):
        z = 0
        if k + 1 < len(stack):
            w0, w1 = stack[k][2] >= REF_CAT_LEVEL, stack[k + 1][2] >= REF_CAT_LEVEL
            z = 1 if w0 and not w1 else 2 if not w0 and not w1 else 0
        out.drl_ctx.append(z)
    top, bottom = -(b.r * 32) - 128 - bh4 * 32, (fr.mi_rows - bh4 - b.r) * 32 + 128 + bh4 * 32
    lft, rgt = -(b.c * 32) - 128 - bw4 * 32, (fr.mi_cols - bw4 - b.c) * 32 + 128 + bw4 * 32

    def clamp(mv):
        return (min(max(mv[0], top), bottom), min(max(mv[1], lft), rgt))

    out.mvs = [(clamp(e[0]), clamp(e[1]) if compound else None) for e in stack]
    while len(out.mvs) < 2:  # single reference: the global vector, not clamped
        out.mvs.append((gm[0], None))
    if close == 0:
        out.new_ctx, out.ref_ctx = min(total, 1), total
    elif close == 1:
        out.new_ctx, out.ref_ctx = 3 - min(num_new, 1), 2 + total
    else:
        out.new_ctx, out.ref_ctx = 5 - min(num_new, 1), 5
    out.zero_ctx = zero_ctx
    out.gm = gm
    return out


def _sort(stack: List[list], lo: int, hi: int) -> None:
    end = hi
    while end > lo:
        new_end = lo
        for k in range(lo + 1, end):
            if stack[k - 1][2] < stack[k][2]:
                stack[k - 1], stack[k] = stack[k], stack[k - 1]
                new_end = k
        end = new_end


def _temporal(d, b, refs, gm, stack) -> int:
    """The temporal candidates (``add_tpl_ref_mv`` over the block's 8 x 8s
    and three positions past it); returns ``ZeroMvContext``."""
    fr = d.fr
    mvs, offs, valid = d.mf
    bw4, bh4 = b.w >> 2, b.h >> 2
    step_w = 4 if bw4 >= 16 else 2
    step_h = 4 if bh4 >= 16 else 2
    cur_off = [relative_dist(d.seq, fr.order_hint, fr.order_hints[r]) if r > 0 else 0
               for r in refs]
    zero_ctx = 0
    positions = [(dr, dc) for dr in range(0, min(bh4, 16), step_h)
                 for dc in range(0, min(bw4, 16), step_w)]
    if 2 <= bh4 < 16 and 2 <= bw4 < 16:
        for dr, dc in ((bh4, -2), (bh4, bw4), (bh4 - 2, bw4)):
            r, c = (b.r & 15) + dr, (b.c & 15) + dc
            if 0 <= r < 16 and 0 <= c < 16:
                positions.append((dr, dc))
    for dr, dc in positions:
        row, col = (b.r + dr) | 1, (b.c + dc) | 1
        if not (0 <= row < fr.mi_rows and d.c0 <= col < d.c1):
            continue
        first = dr == 0 and dc == 0
        if first:
            zero_ctx = 1
        y8, x8 = row >> 1, col >> 1
        if not valid[y8, x8]:
            continue
        _hit("temporal_mv")
        src = (int(mvs[y8, x8, 0]), int(mvs[y8, x8, 1]))
        off = int(offs[y8, x8])
        mv0 = lower_precision(fr, _projection(src, cur_off[0], off))
        if refs[1] <= 0:
            if first:
                zero_ctx = int(abs(mv0[0] - gm[0][0]) >= 16 or abs(mv0[1] - gm[0][1]) >= 16)
            for e in stack:
                if e[0] == mv0:
                    e[2] += 2
                    break
            else:
                if len(stack) < 8:
                    stack.append([mv0, None, 2])
        else:
            mv1 = lower_precision(fr, _projection(src, cur_off[1], off))
            if first:
                zero_ctx = int(abs(mv0[0] - gm[0][0]) >= 16 or abs(mv0[1] - gm[0][1]) >= 16
                               or abs(mv1[0] - gm[1][0]) >= 16 or abs(mv1[1] - gm[1][1]) >= 16)
            for e in stack:
                if e[0] == mv0 and e[1] == mv1:
                    e[2] += 2
                    break
            else:
                if len(stack) < 8:
                    stack.append([mv0, mv1, 2])
    return zero_ctx


def _extra_search(d, b, refs, gm, stack) -> None:
    fr, st = d.fr, d.mi_stride
    compound = refs[1] > 0
    w4 = min(16, b.w >> 2, fr.mi_cols - b.c)
    h4 = min(16, b.h >> 2, fr.mi_rows - b.r)
    num4 = min(w4, h4)
    id_mvs: List[List[tuple]] = [[], []]
    diff_mvs: List[List[tuple]] = [[], []]
    bias = fr.sign_bias
    for pas in range(2):
        if len(stack) >= 2:
            break
        idx = 0
        while idx < num4 and len(stack) < 2:
            r, c = (b.r - 1, b.c + idx) if pas == 0 else (b.r + idx, b.c - 1)
            if not d._inside(r, c):
                break
            i = r * st + c
            for lst in (0, 1):
                cref = (d.ref0[i], d.ref1[i])[lst]
                if cref <= 0:
                    continue
                cmv = d.mv[i] if lst == 0 else d.mv1[i]
                if compound:
                    for k in (0, 1):
                        if cref == refs[k] and len(id_mvs[k]) < 2:
                            id_mvs[k].append(cmv)
                        elif len(diff_mvs[k]) < 2:
                            mv = cmv
                            if bias[cref] != bias[refs[k]]:
                                mv = (-mv[0], -mv[1])
                            diff_mvs[k].append(mv)
                else:
                    mv = cmv
                    if bias[cref] != bias[refs[0]]:
                        mv = (-mv[0], -mv[1])
                    if all(e[0] != mv for e in stack):
                        stack.append([mv, None, 2])
            size = SIZES[d.mi_size[i]]
            idx += (size[0] if pas == 0 else size[1]) >> 2
    if compound:
        combined = [[None, None], [None, None]]
        for k in (0, 1):
            cands = (id_mvs[k] + diff_mvs[k] + [gm[k], gm[k]])[:2]
            combined[0][k], combined[1][k] = cands[0], cands[1]
        if len(stack) == 1:
            pick = combined[1] if (combined[0][0], combined[0][1]) == (stack[0][0], stack[0][1]) \
                else combined[0]
            stack.append([pick[0], pick[1], 2])
        else:
            for k in (0, 1):
                stack.append([combined[k][0], combined[k][1], 2])


def has_overlappable_candidates(d, b) -> bool:
    fr, st = d.fr, d.mi_stride
    if b.au:
        for x4 in range(b.c, min(fr.mi_cols, b.c + (b.w >> 2)), 2):
            x5 = min(x4 | 1, fr.mi_cols - 1)
            if d.ref0[(b.r - 1) * st + x5] > 0:
                return True
    if b.al:
        for y4 in range(b.r, min(fr.mi_rows, b.r + (b.h >> 2)), 2):
            y5 = min(y4 | 1, fr.mi_rows - 1)
            if d.ref0[y5 * st + b.c - 1] > 0:
                return True
    return False


def find_warp_samples(d, b, mv: Tuple[int, int]) -> list:
    """``av1_findSamples`` then ``av1_selectSamples``: the neighbours of the
    same single reference, each as ((x, y), (x, y) in the reference) in 1/8
    samples relative to the block, those whose vector is far from ``mv``
    dropped (one kept at least)."""
    fr, st = d.fr, d.mi_stride
    ref = b.ref[0]
    samples = []
    top_left = top_right = True
    bw4, bh4 = b.w >> 2, b.h >> 2

    def record(r: int, c: int, row_off: int, sign_r: int, col_off: int, sign_c: int) -> None:
        i = r * st + c
        if d.ref0[i] != ref or d.ref1[i] != -1:
            return
        w, h = SIZES[d.mi_size[i]]
        x = col_off * 4 + sign_c * w // 2 - 1
        y = row_off * 4 + sign_r * h // 2 - 1
        cmv = d.mv[i]
        samples.append(((x * 8, y * 8), (x * 8 + cmv[1], y * 8 + cmv[0])))

    if b.au:
        sw = SIZES[d.mi_size[(b.r - 1) * st + b.c]][0] >> 2
        if bw4 <= sw:
            col_off = -(b.c % sw)
            if col_off < 0:
                top_left = False
            if col_off + sw > bw4:
                top_right = False
            record(b.r - 1, b.c, 0, -1, col_off, 1)
        else:
            i = 0
            while i < min(bw4, fr.mi_cols - b.c):
                sw = SIZES[d.mi_size[(b.r - 1) * st + b.c + i]][0] >> 2
                record(b.r - 1, b.c + i, 0, -1, i, 1)
                i += sw
    if b.al:
        sh = SIZES[d.mi_size[b.r * st + b.c - 1]][1] >> 2
        if bh4 <= sh:
            row_off = -(b.r % sh)
            if row_off < 0:
                top_left = False
            record(b.r, b.c - 1, row_off, 1, 0, -1)
        else:
            i = 0
            while i < min(bh4, fr.mi_rows - b.r):
                sh = SIZES[d.mi_size[(b.r + i) * st + b.c - 1]][1] >> 2
                record(b.r + i, b.c - 1, i, 1, 0, -1)
                i += sh
    if top_left and b.au and b.al:
        record(b.r - 1, b.c - 1, 0, -1, 0, -1)
    if top_right and max(bw4, bh4) <= 16:
        r, c = b.r - 1, b.c + bw4
        if d._inside(r, c) and d.written[r * st + c]:
            record(r, c, 0, -1, bw4, 1)
    samples = samples[:8]
    if len(samples) > 1:
        thresh = min(max(max(b.w, b.h), 16), 112)
        kept = [s for s in samples
                if abs(s[1][0] - s[0][0] - mv[1]) + abs(s[1][1] - s[0][1] - mv[0]) <= thresh]
        samples = kept or samples[:1]
    return samples

