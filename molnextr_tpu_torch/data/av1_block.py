"""The block syntax of a coded-lossless AV1 intra frame (the AV1
specification, sections 5.11 and 6.10, with the context derivations of
8.3.2), read tile by tile into planes of flat Python lists.

Per tile: the CDFs reset to their defaults (``data/av1_cdfs.py``), the above
contexts cleared, superblocks of 64 or 128 in raster order, each split by
``decode_partition`` (every partition type, and ``split_or_horz`` /
``split_or_vert`` at the frame's right and bottom edges).  Per block: the
segment id (spatially predicted, ``neg_deinterleave``), ``skip``,
``use_intrabc`` with its vector (the intra block copy reference stack of
``find_mv_stack``, its fallback, joints and classes), the y mode from the
above and left modes, angle deltas, the uv mode with the CfL signs and
alphas, palette sizes, the colour cache and colours, the colour index map
in its wavefront order with its context hash, and filter intra.  Every
transform is 4 x 4 Walsh-Hadamard (``Lossless``); coefficients are read
with their contexts (``all_zero``, ``eob_pt_16``, ``eob_extra``,
``coeff_base_eob``, ``coeff_base``, ``coeff_br``, Golomb, ``dc_sign``),
and prediction and reconstruction come from ``data/av1_recon.py``.
"""

from __future__ import annotations

from typing import List

from molnextr_tpu_torch.data import av1_cdfs, av1_recon
from molnextr_tpu_torch.data.av1_obu import AV1Error, Frame, Sequence
from molnextr_tpu_torch.data.av1_recon import DC, PAETH, SMOOTH, SMOOTH_H, SMOOTH_V
from molnextr_tpu_torch.data.av1_symbol import SymbolDecoder

# block sizes in the specification's order, as (width, height)
SIZES = ((4, 4), (4, 8), (8, 4), (8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16),
         (32, 32), (32, 64), (64, 32), (64, 64), (64, 128), (128, 64), (128, 128), (4, 16),
         (16, 4), (8, 32), (32, 8), (16, 64), (64, 16))
INDEX = {wh: i for i, wh in enumerate(SIZES)}
B8X8 = 3
NONE, HORZ, VERT, SPLIT, HORZ_A, HORZ_B, VERT_A, VERT_B, HORZ_4, VERT_4 = range(10)
UV_CFL = 13
MODE_CONTEXT = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)
SCAN_4X4 = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BASE_CTX_OFFSET = ((0, 1, 6, 6), (1, 6, 6, 21), (6, 6, 21, 21), (6, 21, 21, 21))
SKIP_CTX = ((1, 2, 2, 2, 3), (2, 4, 4, 4, 5), (2, 4, 4, 4, 5), (2, 4, 4, 4, 5),
            (3, 5, 5, 5, 6))
PALETTE_HASH_CTX = {2: 0, 5: 4, 6: 3, 7: 2, 8: 1}


def _log2(n: int) -> int:
    return n.bit_length() - 1


def _ceil_log2(n: int) -> int:
    return 0 if n < 2 else (n - 1).bit_length()


def _neighbours_4x4(q: List[int]):
    """For each position of a 4 x 4 block (row-major), the positions that
    ``coeff_base`` (5) and ``coeff_br`` (3) look at, inside the block."""
    base, br = [], []
    for pos in range(16):
        r, c = pos >> 2, pos & 3
        base.append([(r + dr) * 4 + c + dc for dr, dc in ((0, 1), (1, 0), (1, 1), (0, 2), (2, 0))
                     if r + dr < 4 and c + dc < 4])
        br.append([(r + dr) * 4 + c + dc for dr, dc in ((0, 1), (1, 0), (1, 1))
                   if r + dr < 4 and c + dc < 4])
    return base, br


BASE_NB, BR_NB = _neighbours_4x4([])


class FrameDecoder:
    """Decodes every tile of a coded-lossless intra frame into ``planes``
    (flat lists of ``stride`` samples, MI-aligned, with a margin)."""

    def __init__(self, seq: Sequence, fr: Frame):
        self.seq, self.fr = seq, fr
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
        self.mv = [(0, 0)] * n
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

    # -- tiles ---------------------------------------------------------------
    def decode(self, data: bytes, tiles) -> None:
        fr = self.fr
        ncols = len(fr.col_starts) - 1
        for num, start, size in tiles:
            tr, tc = divmod(num, ncols)
            self.r0, self.r1 = fr.row_starts[tr], fr.row_starts[tr + 1]
            self.c0, self.c1 = fr.col_starts[tc], fr.col_starts[tc + 1]
            self.cdf = av1_cdfs.fresh()
            self.sd = SymbolDecoder(data, start, size, not fr.disable_cdf_update)
            for p in range(self.nplanes):
                self.above_level[p] = [0] * len(self.above_level[p])
                self.above_dc[p] = [0] * len(self.above_dc[p])
            sb = self.sb4
            bsize = INDEX[(sb * 4, sb * 4)]
            for r in range(self.r0, self.r1, sb):
                for p in range(self.nplanes):
                    self.left_level[p] = [0] * len(self.left_level[p])
                    self.left_dc[p] = [0] * len(self.left_dc[p])
                for c in range(self.c0, self.c1, sb):
                    self._clear_decoded(r, c)
                    self._partition(r, c, bsize)
                    if self.sd.overflowed():
                        raise AV1Error("AV1: tile data overrun (a corrupt frame)")
            if not self.sd.trailing_ok():
                raise AV1Error("AV1: tile without its trailing bits (a corrupt frame)")

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
        seq, fr, sd, cdf = self.seq, self.fr, self.sd, self.cdf
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
        up, lf = (r - 1) * st + c, r * st + c - 1
        b = _Block(r, c, bsize, w, h, has_chroma, au, al, auc, alc)
        # intra_frame_mode_info
        if fr.seg_id_pre_skip:
            b.seg = self._segment_id(b, 0)
        if fr.seg_id_pre_skip and fr.seg_features[b.seg][6] is not None:
            b.skip = 1
        else:
            b.skip = sd.symbol(cdf["SKIP"][(self.skip[up] if au else 0)
                                           + (self.skip[lf] if al else 0)])
        if not fr.seg_id_pre_skip:
            b.seg = self._segment_id(b, b.skip)
        if fr.allow_intrabc and sd.symbol(cdf["INTRABC"]):
            b.bc = True
            self._intrabc_mv(b)
        else:
            ya = MODE_CONTEXT[self.y_mode[up]] if au else 0
            yl = MODE_CONTEXT[self.y_mode[lf]] if al else 0
            b.y_mode = sd.symbol(cdf["KF_Y_MODE"][ya][yl])
            if bsize >= B8X8 and 1 <= b.y_mode <= 8:
                b.y_delta = sd.symbol(cdf["ANGLE_DELTA"][b.y_mode - 1]) - 3
            if has_chroma:
                cw, ch = max(4, w >> ssx), max(4, h >> ssy)
                cfl_ok = (cw, ch) == (4, 4)
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
        # store the block's mode info
        for y in range(r, min(r + bh4, fr.mi_rows)):
            for x in range(c, min(c + bw4, fr.mi_cols)):
                i = y * st + x
                self.mi_size[i] = bsize
                self.y_mode[i] = b.y_mode
                self.uv_mode[i] = b.uv_mode if has_chroma else DC
                self.is_bc[i] = b.bc
                self.mv[i] = b.mv
                self.skip[i] = b.skip
                self.seg[i] = b.seg
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
        self._residual(b)

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
        sd = self.sd
        sign = sd.symbol(comp["MV_SIGN"])
        cls = sd.symbol(comp["MV_CLASS"])
        if cls == 0:
            mag = ((sd.symbol(comp["MV_CLASS0_BIT"]) << 3) | 7) + 1
        else:
            d = 0
            for i in range(cls):
                d |= sd.symbol(comp["MV_BIT"][i]) << i
            mag = (2 << (cls + 2)) + ((d << 3) | 7) + 1
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
            last_x = ((self.fr.width + sx) >> sx) - 1
            last_y = ((self.fr.height + sy) >> sy) - 1
            av1_recon.predict_intrabc(self.planes[p], self.strides[p], bx, by, pw, ph,
                                      b.mv[0], b.mv[1], sx, sy, last_x, last_y, self.bd)

    # -- residual ------------------------------------------------------------
    def _residual(self, b) -> None:
        bw4, bh4 = b.w >> 2, b.h >> 2
        sb_mask = self.sb4 - 1
        for cy in range(max(1, bh4 >> 4)):
            for cx in range(max(1, bw4 >> 4)):
                for p in range(1 + 2 * b.has_chroma):
                    sx, sy = self.ss[p]
                    n4w = max(4, b.w >> sx) >> 2
                    n4h = max(4, b.h >> sy) >> 2
                    bx, by = (b.c >> sx) * 4, (b.r >> sy) * 4
                    for y in range(0, min(n4h, 16 >> sy)):
                        for x in range(0, min(n4w, 16 >> sx)):
                            self._tx_block(b, p, bx, by, x + ((cx << 4) >> sx),
                                           y + ((cy << 4) >> sy), sb_mask)

    def _tx_block(self, b, p: int, bx: int, by: int, x: int, y: int, sb_mask: int) -> None:
        sx, sy = self.ss[p]
        sx_ = (bx + 4 * x)
        sy_ = (by + 4 * y)
        if sx_ > self.max_x[p] or sy_ > self.max_y[p]:
            return
        row = ((sy_ << sy) >> 2) & sb_mask
        col = ((sx_ << sx) >> 2) & sb_mask
        flags = self.decoded[p]
        px, stride = self.planes[p], self.strides[p]
        if not b.bc:
            if b.pal[1 if p else 0]:
                pal = b.colors[0] if p == 0 else b.colors[1][p - 1]
                cmap = b.maps[1 if p else 0]
                for i in range(4):
                    mrow = cmap[y * 4 + i]
                    at = (sy_ + i) * stride + sx_
                    px[at : at + 4] = [pal[k] for k in mrow[x * 4 : x * 4 + 4]]
            else:
                cfl = p > 0 and b.uv_mode == UV_CFL
                mode = b.y_mode if p == 0 else (DC if cfl else b.uv_mode)
                have_left = (b.al if p == 0 else b.alc) or x > 0
                have_above = (b.au if p == 0 else b.auc) or y > 0
                have_ar = flags.get(((row >> sy) - 1, (col >> sx) + 1), False)
                have_bl = flags.get(((row >> sy) + 1, (col >> sx) - 1), False)
                # get_filter_type matters only to the directional modes' edges
                smooth = self.seq.enable_intra_edge_filter and 1 <= mode <= 8 and \
                    self._smooth_neighbour(b, p)
                av1_recon.predict_intra(
                    px, stride, sx_, sy_, 4, 4, have_left, have_above, have_ar, have_bl,
                    self.max_x[p], self.max_y[p], self.bd, mode,
                    b.y_delta if p == 0 else b.uv_delta,
                    b.filter_mode if p == 0 else -1, self.seq.enable_intra_edge_filter, smooth)
                if cfl:
                    av1_recon.predict_cfl(px, stride, self.planes[0], self.strides[0], sx_, sy_,
                                          4, 4, sx, sy, b.max_luma_w, b.max_luma_h,
                                          b.alpha_u if p == 1 else b.alpha_v, self.bd)
        if p == 0:
            b.max_luma_w, b.max_luma_h = sx_ + 4, sy_ + 4
        if not b.skip:
            coefs = self._coeffs(b, p, sx_ >> 2, sy_ >> 2)
            if coefs is not None:
                av1_recon.reconstruct_wht(px, stride, sx_, sy_, coefs, self.bd)
        flags[(row >> sy, col >> sx)] = True

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
        mode = self.y_mode[i] if p == 0 else (DC if self.is_bc[i] else self.uv_mode[i])
        return mode in (SMOOTH, SMOOTH_V, SMOOTH_H)

    def _coeffs(self, b, p: int, x4: int, y4: int):
        """``coeffs`` of one 4 x 4 block: the dequantised coefficients in
        row-major order, or None when ``all_zero``."""
        sd, cdf = self.sd, self.cdf
        al, ad = self.above_level[p], self.above_dc[p]
        ll, ld = self.left_level[p], self.left_dc[p]
        a_lvl, l_lvl = al[x4], ll[y4]
        if p == 0:
            ctx = 0 if b.bsize == 0 else SKIP_CTX[min(a_lvl, 4)][min(l_lvl, 4)]
        else:
            sx, sy = self.ss[p]
            pw, ph = max(4, b.w >> sx), max(4, b.h >> sy)
            ctx = (1 if (a_lvl or ad[x4]) else 0) + (1 if (l_lvl or ld[y4]) else 0) \
                + (10 if pw * ph > 16 else 7)
        if sd.symbol(cdf["TXB_SKIP"][ctx]):
            al[x4] = ad[x4] = ll[y4] = ld[y4] = 0
            return None
        ptype = 1 if p else 0
        eob_pt = sd.symbol(cdf["EOB_PT_16"][ptype][0]) + 1
        eob = eob_pt if eob_pt < 2 else (1 << (eob_pt - 2)) + 1
        shift = eob_pt - 3
        if shift >= 0:
            if sd.symbol(cdf["EOB_EXTRA"][ptype][eob_pt - 3]):
                eob += 1 << shift
            for i in range(1, max(0, eob_pt - 2)):
                if sd.literal(1):
                    eob += 1 << (max(0, eob_pt - 2) - 1 - i)
        q = [0] * 16
        base_cdfs, br_cdfs = cdf["COEFF_BASE"][ptype], cdf["COEFF_BR"][ptype]
        for k in range(eob - 1, -1, -1):
            pos = SCAN_4X4[k]
            if k == eob - 1:
                ctx = 0 if k == 0 else 1 if k <= 2 else 2 if k <= 4 else 3
                level = sd.symbol(cdf["COEFF_BASE_EOB"][ptype][ctx]) + 1
            else:
                if pos == 0:
                    ctx = 0
                else:
                    mag = 0
                    for n in BASE_NB[pos]:
                        v = q[n]
                        mag += v if v < 3 else 3
                    ctx = min((mag + 1) >> 1, 4) + BASE_CTX_OFFSET[pos >> 2][pos & 3]
                level = sd.symbol(base_cdfs[ctx])
            if level > 2:
                mag = 0
                for n in BR_NB[pos]:
                    v = q[n]
                    mag += v if v < 15 else 15
                mag = min((mag + 1) >> 1, 6)
                ctx = mag if pos == 0 else (mag + 7 if (pos >> 2) < 2 and (pos & 3) < 2
                                            else mag + 14)
                for _ in range(4):
                    br = sd.symbol(br_cdfs[ctx])
                    level += br
                    if br < 3:
                        break
            q[pos] = level
        cul, dc_cat = 0, 0
        out = [0] * 16
        for k in range(eob):
            pos = SCAN_4X4[k]
            level = q[pos]
            if not level:
                continue
            if k == 0:
                s = 0
                for v in (ad[x4], ld[y4]):
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
            dq = (level * 4) & 0xFFFFFF
            out[pos] = -dq if sign else dq
        lim = 1 << (7 + self.bd)
        out = [min(max(v, -lim), lim - 1) for v in out]
        cul = min(63, cul)
        al[x4] = ll[y4] = cul
        ad[x4] = ld[y4] = dc_cat
        return out


class _Block:
    __slots__ = ("r", "c", "bsize", "w", "h", "has_chroma", "au", "al", "auc", "alc", "seg",
                 "skip", "bc", "mv", "y_mode", "uv_mode", "y_delta", "uv_delta", "alpha_u",
                 "alpha_v", "pal", "colors", "maps", "filter_mode", "max_luma_w",
                 "max_luma_h")

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
