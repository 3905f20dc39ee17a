"""AV1 inter prediction (the AV1 specification, section 7.11.3, as libaom
3.14 decodes it), in numpy.

* :func:`rounding`: ``InterRound0``/``InterRound1``/``InterPostRound`` by
  bit depth and compound.
* :func:`scale_mv`: the motion vector scaling process, references of
  another size than the frame included (``xStep``/``yStep``).
* :func:`block_prediction`: the 8-tap sub-pixel filters (regular, smooth,
  sharp, bilinear) in two passes, with their 4-tap forms for blocks 4 or
  fewer samples wide (high); the reference is read through clamped indices,
  which is the frame's edge extended without end.
* :func:`setup_shear`, :func:`warp_estimation`, :func:`warp_prediction`:
  the warp filter's shear parameters, the local warp model's least squares
  fit (``find_affine_int``), and warped prediction in 8 x 8 blocks as
  ``av1_warp_affine_c`` runs it.
* Masks: :func:`wedge_mask` (the codebooks and the master templates,
  libaom's sign flips), :func:`diff_mask`, :func:`distance_weights`,
  :func:`ii_mask` (the inter-intra smooth masks), :data:`OBMC_MASKS`.

The filter tables, the warped filter, ``div_lut``, the inter-intra weights
and the wedge templates and codebooks (``av1_inter.npz``) were read out of
libaom 3.14's read-only data.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from molnextr_tpu_torch.data.av1_obu import relative_dist
from molnextr_tpu_torch.data.av1_recon import _hit

with np.load(Path(__file__).with_name("av1_inter.npz")) as _z:
    SUBPEL = _z["subpel"].astype(np.int64)  # [filter][phase][tap]
    WARPED = _z["warped"].astype(np.int64)  # [193][8]
    DIV_LUT = _z["div_lut"].astype(np.int64)
    II_WEIGHTS = _z["ii_weights"].astype(np.int64)
    _WEDGE_MASTER = _z["wedge_master"].astype(np.int64)  # oblique odd, even, vertical
    _WEDGE_CODEBOOK = _z["wedge_codebook"].astype(np.int64)  # heqw, hgtw, hltw

OBMC_MASKS = {1: (64,), 2: (45, 64), 4: (39, 50, 59, 64), 8: (36, 42, 48, 53, 57, 61, 64, 64),
              16: (34, 37, 40, 43, 46, 49, 52, 54, 56, 58, 60, 61, 64, 64, 64, 64),
              32: (33, 35, 36, 38, 40, 41, 43, 44, 45, 47, 48, 50, 51, 52, 53, 55, 56, 57, 58,
                   59, 60, 60, 61, 62, 64, 64, 64, 64, 64, 64, 64, 64)}
QUANT_DIST_WEIGHT = ((2, 3), (2, 5), (2, 7), (1, 31))
QUANT_DIST_LOOKUP = ((9, 7), (11, 5), (12, 4), (13, 3))


def round2(x, n: int):
    return x if n == 0 else (x + (1 << (n - 1))) >> n


def round2signed(x: int, n: int) -> int:
    return round2(x, n) if x >= 0 else -round2(-x, n)


def rounding(bd: int, compound: bool) -> Tuple[int, int, int]:
    """(InterRound0, InterRound1, InterPostRound)."""
    r0 = 5 if bd == 12 else 3
    r1 = 7 if compound else 14 - r0
    return r0, r1, 14 - r0 - r1


def scale_mv(x: int, y: int, mv: Tuple[int, int], sx: int, sy: int, ref_w: int, ref_h: int,
             cur_w: int, cur_h: int) -> Tuple[int, int, int, int]:
    """The motion vector scaling process: (startX, startY, xStep, yStep)
    in 1/1024 samples of the reference plane, for a block at (x, y) of the
    current plane; ``ref_w``/``cur_w`` are luma widths (the reference's
    upscaled, the frame's coded)."""
    x_scale = ((ref_w << 14) + (cur_w // 2)) // cur_w
    y_scale = ((ref_h << 14) + (cur_h // 2)) // cur_h
    orig_x = (x << 4) + ((2 * mv[1]) >> sx) + 8
    orig_y = (y << 4) + ((2 * mv[0]) >> sy) + 8
    base_x = orig_x * x_scale - (8 << 14)
    base_y = orig_y * y_scale - (8 << 14)
    start_x = round2signed(base_x, 8) + 32
    start_y = round2signed(base_y, 8) + 32
    return start_x, start_y, round2signed(x_scale, 4), round2signed(y_scale, 4)


def filter_index(kind: int, size: int) -> int:
    """The filter of an interpolation type for a block ``size`` samples
    along the filter: the 4-tap regular (4) or smooth (5) form at 4 or
    fewer (sharp takes the regular one), bilinear as it is."""
    if size <= 4 and kind in (0, 2):
        return 4
    if size <= 4 and kind == 1:
        return 5
    return kind


def block_prediction(ref: np.ndarray, start_x: int, start_y: int, x_step: int, y_step: int,
                     w: int, h: int, filters: Tuple[int, int], r0: int, r1: int) -> np.ndarray:
    """The block inter prediction process: (h, w) int64 predictions of a
    reference plane (cut to its size) from position (startX, startY) in
    1/1024 samples; ``filters`` the (vertical, horizontal) interpolation
    types."""
    last_y, last_x = ref.shape[0] - 1, ref.shape[1] - 1
    inter_h = (((h - 1) * y_step + (1 << 10) - 1) >> 10) + 8
    rows = np.clip((start_y >> 10) + np.arange(inter_h) - 3, 0, last_y)
    p = start_x + x_step * np.arange(w)
    cols = np.clip((p >> 10)[:, None] + np.arange(8)[None, :] - 3, 0, last_x)
    fx = SUBPEL[filter_index(filters[1], w)][(p >> 6) & 15]  # (w, 8)
    block = ref[rows][:, cols].astype(np.int64)  # (inter_h, w, 8)
    inter = round2((block * fx[None]).sum(-1), r0)
    q = (start_y & 1023) + y_step * np.arange(h)
    fy = SUBPEL[filter_index(filters[0], h)][(q >> 6) & 15]  # (h, 8)
    taps = inter[(q >> 10)[:, None] + np.arange(8)[None, :]]  # (h, 8, w)
    return round2((taps * fy[:, :, None]).sum(1), r1)


def _resolve_divisor(d: int) -> Tuple[int, int]:
    """``resolve_divisor_32``/``_64``: (multiplier, shift) of 1 / d."""
    n = d.bit_length() - 1
    e = d - (1 << n)
    f = round2(e, n - 8) if n > 8 else e << (8 - n)
    return int(DIV_LUT[f]), n + 14


def _clamp16(v: int) -> int:
    return max(-32768, min(32767, v))


def setup_shear(params) -> Optional[Tuple[int, int, int, int]]:
    """``av1_get_shear_params``: (alpha, beta, gamma, delta), or None when
    the model cannot be warped."""
    m = params
    if m[2] <= 0:
        return None
    alpha = _clamp16(m[2] - (1 << 16))
    beta = _clamp16(m[3])
    div, shift = _resolve_divisor(abs(m[2]))
    v = (m[4] << 16) * div
    gamma = _clamp16(round2signed(v, shift))
    v = m[3] * m[4] * div
    delta = _clamp16(m[5] - round2signed(v, shift) - (1 << 16))
    alpha, beta, gamma, delta = (round2signed(a, 6) << 6 for a in (alpha, beta, gamma, delta))
    if 4 * abs(alpha) + 7 * abs(beta) >= 1 << 16 or 4 * abs(gamma) + 4 * abs(delta) >= 1 << 16:
        return None
    return alpha, beta, gamma, delta


def _ls_square(a: int) -> int:
    return (a * a * 4 + a * 4 * 8 + 8 * 8 * 2) >> 4


def _ls_product1(a: int, b: int) -> int:
    return (a * b * 4 + (a + b) * 2 * 8 + 8 * 8) >> 4


def _ls_product2(a: int, b: int) -> int:
    return (a * b * 4 + (a + b) * 2 * 8 + 8 * 8 * 2) >> 4


def warp_estimation(samples, bw: int, bh: int, mv: Tuple[int, int], mi_row: int,
                    mi_col: int) -> Optional[List[int]]:
    """``find_affine_int``: the local warp model of a block from its
    samples ((x, y) and their (x, y) in the reference, in 1/8 samples
    relative to the block), or None when it cannot be solved."""
    a00 = a01 = a11 = bx0 = bx1 = by0 = by1 = 0
    rsuy, rsux = bh // 2 - 1, bw // 2 - 1
    suy, sux = rsuy * 8, rsux * 8
    duy, dux = suy + mv[0], sux + mv[1]
    for (px, py), (qx, qy) in samples:
        dx, dy = qx - dux, qy - duy
        sx, sy = px - sux, py - suy
        if abs(sx - dx) < 256 and abs(sy - dy) < 256:
            a00 += _ls_square(sx)
            a01 += _ls_product1(sx, sy)
            a11 += _ls_square(sy)
            bx0 += _ls_product2(sx, dx)
            bx1 += _ls_product1(sy, dx)
            by0 += _ls_product1(sx, dy)
            by1 += _ls_product2(sy, dy)
    det = a00 * a11 - a01 * a01
    if det == 0:
        return None
    idet, shift = _resolve_divisor(abs(det))
    idet = -idet if det < 0 else idet
    shift -= 16
    if shift < 0:
        idet = ((idet << -shift) + 32768) % 65536 - 32768  # libaom's int16_t
        shift = 0
    px0 = a11 * bx0 - a01 * bx1
    px1 = -a01 * bx0 + a00 * bx1
    py0 = a11 * by0 - a01 * by1
    py1 = -a01 * by0 + a00 * by1
    lim = 1 << 13

    def diag(p: int) -> int:
        return max((1 << 16) - lim + 1, min((1 << 16) + lim - 1, round2signed(p * idet, shift)))

    def ndiag(p: int) -> int:
        return max(-lim + 1, min(lim - 1, round2signed(p * idet, shift)))

    m = [0, 0, diag(px0), ndiag(px1), ndiag(py0), diag(py1)]
    isuy, isux = mi_row * 4 + rsuy, mi_col * 4 + rsux
    vx = mv[1] * (1 << 13) - (isux * (m[2] - (1 << 16)) + isuy * m[3])
    vy = mv[0] * (1 << 13) - (isux * m[4] + isuy * (m[5] - (1 << 16)))
    m[0] = max(-(1 << 23), min((1 << 23) - 1, vx))
    m[1] = max(-(1 << 23), min((1 << 23) - 1, vy))
    return m


def warp_prediction(ref: np.ndarray, params, shear, x: int, y: int, w: int, h: int, sx: int,
                    sy: int, r0: int, r1: int) -> np.ndarray:
    """Warped prediction of a w x h block at (x, y) of a plane subsampled
    by (sx, sy), in 8 x 8 blocks, as ``av1_warp_affine_c`` computes it."""
    alpha, beta, gamma, delta = shear
    last_y, last_x = ref.shape[0] - 1, ref.shape[1] - 1
    out = np.zeros((h, w), np.int64)
    k15 = np.arange(-7, 8)
    l8 = np.arange(-4, 4)
    m8 = np.arange(8)
    for i in range(0, h, 8):
        for j in range(0, w, 8):
            src_x = (x + j + 4) << sx
            src_y = (y + i + 4) << sy
            dst_x = params[2] * src_x + params[3] * src_y + params[0]
            dst_y = params[4] * src_x + params[5] * src_y + params[1]
            x4, y4 = dst_x >> sx, dst_y >> sy
            ix4, iy4 = x4 >> 16, y4 >> 16
            sx4 = ((x4 & 0xFFFF) - 4 * alpha - 4 * beta) & ~63
            sy4 = ((y4 & 0xFFFF) - 4 * gamma - 4 * delta) & ~63
            rows = np.clip(iy4 + k15, 0, last_y)
            sxs = sx4 + beta * (k15 + 4)[:, None] + alpha * (l8 + 4)[None, :]  # (15, 8)
            offs = ((sxs + 512) >> 10) + 64
            cols = np.clip(ix4 + l8[:, None] - 3 + m8[None, :], 0, last_x)  # (8, 8)
            samples = ref[rows][:, cols].astype(np.int64)  # (15, 8, 8)
            tmp = round2((samples * WARPED[offs]).sum(-1), r0)  # (15, 8)
            sys_ = sy4 + delta * (l8 + 4)[:, None] + gamma * (l8 + 4)[None, :]  # (k, l)
            offs = ((sys_ + 512) >> 10) + 64
            coef = WARPED[offs]  # (8, 8, 8): k, l, m
            taps = tmp[(l8 + 4)[:, None] + m8[None, :]]  # (k, m, l)
            pred = round2((coef * taps.transpose(0, 2, 1)).sum(-1), r1)
            hh, ww = min(8, h - i), min(8, w - j)
            out[i : i + hh, j : j + ww] = pred[:hh, :ww]
    return out


@lru_cache(maxsize=None)
def _wedge_masters() -> np.ndarray:
    """``init_wedge_master_masks``: [sign][direction] 64 x 64 templates
    (directions horizontal, vertical, oblique 27, 63, 117, 153)."""
    odd, even, vertical = _WEDGE_MASTER
    masks = np.zeros((2, 6, 64, 64), np.int64)
    shift = 16
    for i in range(0, 64, 2):
        masks[0, 3, i] = _shift_copy(even, shift)
        shift -= 1
        masks[0, 3, i + 1] = _shift_copy(odd, shift)
        masks[0, 1, i] = masks[0, 1, i + 1] = vertical
    obl = masks[0, 3]
    masks[0, 2] = obl.T
    masks[0, 4] = 64 - obl[:, ::-1]
    masks[0, 5] = (64 - obl).T[::-1]
    masks[1, 3] = 64 - obl
    masks[1, 2] = (64 - obl).T
    masks[1, 4] = obl[:, ::-1]
    masks[1, 5] = obl.T[::-1]
    masks[0, 0] = masks[0, 1].T
    masks[1, 1] = 64 - masks[0, 1]
    masks[1, 0] = (64 - masks[0, 1]).T
    return masks


def _shift_copy(src: np.ndarray, shift: int) -> np.ndarray:
    if shift >= 0:
        return np.concatenate([np.full(shift, src[0]), src[: 64 - shift]])
    return np.concatenate([src[-shift:], np.full(-shift, src[-1])])


def _codebook(w: int, h: int) -> np.ndarray:
    return _WEDGE_CODEBOOK[0 if w == h else 1 if h > w else 2]


def _wedge_in_place(index: int, neg: int, w: int, h: int) -> np.ndarray:
    direction, xo, yo = _codebook(w, h)[index]
    woff, hoff = (xo * w) >> 3, (yo * h) >> 3
    return _wedge_masters()[neg, direction, 32 - hoff : 32 - hoff + h, 32 - woff : 32 - woff + w]


@lru_cache(maxsize=None)
def wedge_mask(w: int, h: int, sign: int, index: int) -> np.ndarray:
    """The (h, w) wedge mask of a block size, sign and index, with
    libaom's sign flip (a wedge whose template averages under 32 on its
    top row and left column is flipped)."""
    m = _wedge_in_place(index, 0, w, h)
    avg = int(m[0, :].sum() + m[1:, 0].sum())
    avg = (avg + (w + h - 1) // 2) // (w + h - 1)
    flip = int(avg < 32)
    return _wedge_in_place(index, sign ^ flip, w, h).copy()


@lru_cache(maxsize=None)
def ii_mask(mode: int, w: int, h: int) -> np.ndarray:
    """The inter-intra smooth mask (``II_DC``, ``II_V``, ``II_H``,
    ``II_SMOOTH``) of a w x h plane block: the intra prediction's weight."""
    scale = 128 // max(w, h)
    i = np.arange(h)[:, None]
    j = np.arange(w)[None, :]
    if mode == 1:
        return np.broadcast_to(II_WEIGHTS[i * scale], (h, w)).copy()
    if mode == 2:
        return np.broadcast_to(II_WEIGHTS[j * scale], (h, w)).copy()
    if mode == 3:
        return II_WEIGHTS[np.minimum(i, j) * scale]
    return np.full((h, w), 32, np.int64)


def diff_mask(p0: np.ndarray, p1: np.ndarray, bd: int, post: int, inverse: int) -> np.ndarray:
    """The difference-weighted mask of two compound predictions."""
    diff = round2(np.abs(p0 - p1), bd - 8 + post)
    m = np.clip(38 + diff // 16, 0, 64)
    return 64 - m if inverse else m


def distance_weights(d0: int, d1: int) -> Tuple[int, int]:
    """(FwdWeight, BckWeight) of the distances of the two references."""
    order = int(d0 <= d1)
    if d0 == 0 or d1 == 0:
        return QUANT_DIST_LOOKUP[3][order], QUANT_DIST_LOOKUP[3][1 - order]
    i = 0
    while i < 3:
        c0, c1 = QUANT_DIST_WEIGHT[i][order], QUANT_DIST_WEIGHT[i][1 - order]
        if order and d0 * c0 > d1 * c1 or not order and d0 * c0 < d1 * c1:
            break
        i += 1
    return QUANT_DIST_LOOKUP[i][order], QUANT_DIST_LOOKUP[i][1 - order]


def subsample_mask(mask: np.ndarray, sx: int, sy: int) -> np.ndarray:
    """A luma mask averaged over the chroma sample's 2 x 2 (2 x 1, 1 x 2)."""
    m = mask
    if sx and sy:
        return round2(m[0::2, 0::2] + m[0::2, 1::2] + m[1::2, 0::2] + m[1::2, 1::2], 2)
    if sx:
        return round2(m[:, 0::2] + m[:, 1::2], 1)
    if sy:
        return round2(m[0::2] + m[1::2], 1)
    return m


# -- a block's prediction (compute_prediction) ---------------------------------------

_GLOBAL_MODES = (15, 23)  # GLOBALMV, GLOBAL_GLOBALMV
_II_TO_INTRA = (0, 1, 2, 9)  # II_DC, II_V, II_H, II_SMOOTH -> DC, V, H, SMOOTH
WEDGE, DIFFWTD, AVERAGE, INTRA, DISTANCE = range(5)


def is_scaled(slot, fr) -> bool:
    """Whether a reference frame is of another size than the coded frame."""
    x_scale = ((slot.upscaled_width << 14) + (fr.width // 2)) // fr.width
    y_scale = ((slot.height << 14) + (fr.height // 2)) // fr.height
    return x_scale != 1 << 14 or y_scale != 1 << 14


def _read(d, p: int, x: int, y: int, w: int, h: int) -> np.ndarray:
    px, stride = d.planes[p], d.strides[p]
    return np.array([px[(y + i) * stride + x : (y + i) * stride + x + w] for i in range(h)],
                    np.int64)


def _write(d, p: int, x: int, y: int, block: np.ndarray) -> None:
    px, stride = d.planes[p], d.strides[p]
    w = block.shape[1]
    for i, row in enumerate(block.tolist()):
        at = (y + i) * stride + x
        px[at : at + w] = row


def _single(d, p: int, x: int, y: int, w: int, h: int, ref: int, mv, filters, r0: int,
            r1: int, warp=None) -> np.ndarray:
    """One reference's prediction of a w x h block at (x, y) of plane p."""
    fr = d.fr
    slot = d.refs[fr.ref_frame_idx[ref - 1]]
    plane = slot.planes[p]
    sx, sy = d.ss[p]
    if warp is not None:
        return warp_prediction(plane, warp[0], warp[1], x, y, w, h, sx, sy, r0, r1)
    start_x, start_y, x_step, y_step = scale_mv(x, y, mv, sx, sy, slot.upscaled_width,
                                                slot.height, fr.width, fr.height)
    return block_prediction(plane, start_x, start_y, x_step, y_step, w, h, filters, r0, r1)


def _piece(d, b, p: int, x: int, y: int, w: int, h: int, ci: int) -> None:
    """``predict_inter`` of one block (or, for the chroma of a block under
    8 x 8, of one luma block's part) with the motion of MI ``ci``."""
    fr = d.fr
    bd = d.bd
    top = (1 << bd) - 1
    refs = (d.ref0[ci], d.ref1[ci])
    compound = refs[1] > 0
    r0, r1, post = rounding(bd, compound)
    preds = []
    for k in range(1 + compound):
        ref = refs[k]
        slot = d.refs[fr.ref_frame_idx[ref - 1]]
        warp = None
        if w >= 8 and h >= 8 and not fr.force_integer_mv:
            if b.motion_mode == 2 and b.local_warp is not None:
                warp = b.local_warp
            elif b.y_mode in _GLOBAL_MODES and fr.gm_type[ref] > 1 and not is_scaled(slot, fr):
                shear = setup_shear(fr.gm_params[ref])
                if shear is not None:
                    warp = (fr.gm_params[ref], shear)
        mv = d.mv[ci] if k == 0 else d.mv1[ci]
        _hit("inter_local_warp" if warp is b.local_warp and warp is not None else
             "inter_global_warp" if warp is not None else
             "inter_scaled" if is_scaled(slot, fr) else "inter_translation")
        if d.interp[ci][0] != d.interp[ci][1]:
            _hit("inter_dual_filter")
        _hit(f"inter_filter_{d.interp[ci][1]}")
        preds.append(_single(d, p, x, y, w, h, ref, mv, d.interp[ci], r0, r1, warp))
    sx, sy = d.ss[p]
    if compound:
        _hit(f"compound_{('wedge', 'diffwtd', 'average', 'intra', 'distance')[b.compound]}")
    if b.interintra:
        _hit("interintra_wedge" if b.wedge is not None else "interintra_smooth")
    if not compound and not b.interintra:
        out = np.clip(preds[0], 0, top)
    elif b.compound == AVERAGE:
        out = np.clip(round2(preds[0] + preds[1], 1 + post), 0, top)
    elif b.compound == DISTANCE:
        dist = [min(31, abs(relative_dist(d.seq, fr.order_hints[r], fr.order_hint)))
                for r in refs]
        fwd, bck = distance_weights(dist[1], dist[0])
        out = np.clip(round2(fwd * preds[0] + bck * preds[1], 4 + post), 0, top)
    elif b.interintra:
        inter = np.clip(round2(preds[0], post), 0, top)
        intra = _read(d, p, x, y, w, h)
        if b.wedge is not None:
            mask = subsample_mask(wedge_mask(b.w, b.h, 0, b.wedge[0]), sx, sy)
        else:
            mask = ii_mask(b.interintra - 1, w, h)
        out = round2(mask * intra + (64 - mask) * inter, 6)
    else:
        if p == 0:
            if b.compound == WEDGE:
                b.mask = wedge_mask(b.w, b.h, b.wedge[1], b.wedge[0])
            else:
                b.mask = diff_mask(preds[0], preds[1], bd, post, b.mask_type)
        mask = subsample_mask(b.mask, sx, sy)
        out = np.clip(round2(mask * preds[0] + (64 - mask) * preds[1], 6 + post), 0, top)
    _write(d, p, x, y, out)


def predict_block(d, b) -> None:
    """``compute_prediction`` of an inter block: per plane the inter-intra
    block's intra prediction, then the inter prediction (the chroma of a
    block under 8 x 8 from each luma block's motion unless one of them is
    intra), then overlapped block motion compensation."""
    from molnextr_tpu_torch.data import av1_recon

    if b.skip_mode:
        _hit("skip_mode")
    st = d.mi_stride
    for p in range(1 + 2 * b.has_chroma):
        sx, sy = d.ss[p]
        pw, ph = max(4, b.w >> sx), max(4, b.h >> sy)
        base_x, base_y = (b.c >> sx) * 4, (b.r >> sy) * 4
        if b.interintra:
            av1_recon.predict_intra(
                d.planes[p], d.strides[p], base_x, base_y, pw, ph, b.al if p == 0 else b.alc,
                b.au if p == 0 else b.auc, False, False, d.max_x[p], d.max_y[p], d.bd,
                _II_TO_INTRA[b.interintra - 1], 0, -1, False, False)
        cand_r, cand_c = (b.r >> sy) << sy, (b.c >> sx) << sx
        pred_w, pred_h = b.w >> sx, b.h >> sy
        if pred_w < pw or pred_h < ph:
            cells = [(cand_r + i) * st + cand_c + j for i in range(ph >> 2 << sy)
                     for j in range(pw >> 2 << sx)]
            _hit("inter_sub8x8_chroma")
            if any(d.ref0[i] <= 0 for i in cells):
                pred_w, pred_h = pw, ph
                cand_r, cand_c = b.r, b.c
        for i, y in enumerate(range(0, ph, pred_h)):
            for j, x in enumerate(range(0, pw, pred_w)):
                _piece(d, b, p, base_x + x, base_y + y, pred_w, pred_h,
                       (cand_r + i) * st + cand_c + j)
        if b.motion_mode == 1:
            _hit("obmc")
            _obmc(d, b, p, base_x, base_y, pw, ph)


def _obmc(d, b, p: int, base_x: int, base_y: int, pw: int, ph: int) -> None:
    """Overlapped block motion compensation of one plane: the above
    neighbours' predictions blended over the top half (at most 32 luma
    rows), then the left neighbours' over the left half, as libaom's
    ``av1_build_obmc_inter_prediction`` does (it skips the above pass of a
    chroma block under 8 x 8, not the left one)."""
    from molnextr_tpu_torch.data.av1_block import SIZES

    fr, st = d.fr, d.mi_stride
    sx, sy = d.ss[p]
    top = (1 << d.bd) - 1
    r0, r1, _ = rounding(d.bd, False)
    bw4, bh4 = b.w >> 2, b.h >> 2
    cur = _read(d, p, base_x, base_y, pw, ph)
    if b.au and not (p and (pw, ph) in ((4, 4), (8, 4), (4, 8))):
        limit = min(4, bw4.bit_length() - 1)
        count, x4 = 0, b.c
        pred_h = (min(b.h, 64) >> 1) >> sy
        mask = np.array(OBMC_MASKS[pred_h], np.int64)[:, None]
        while count < limit and x4 < min(fr.mi_cols, b.c + bw4):
            ci = (b.r - 1) * st + (x4 | 1 if SIZES[d.mi_size[(b.r - 1) * st + x4]][0] == 4 else x4)
            step = min(max(SIZES[d.mi_size[ci]][0] >> 2, 2), 16)
            if d.ref0[ci] > 0:
                count += 1
                pred_w = min(pw, (step * 4) >> sx)
                x = (x4 * 4) >> sx
                pred = np.clip(_single(d, p, x, base_y, pred_w, pred_h, d.ref0[ci], d.mv[ci],
                                       d.interp[ci], r0, r1), 0, top)
                area = cur[:pred_h, x - base_x : x - base_x + pred_w]
                area[:] = round2(mask * area + (64 - mask) * pred, 6)
            x4 += step
    if b.al:
        limit = min(4, bh4.bit_length() - 1)
        count, y4 = 0, b.r
        pred_w = (min(b.w, 64) >> 1) >> sx
        mask = np.array(OBMC_MASKS[pred_w], np.int64)[None, :]
        while count < limit and y4 < min(fr.mi_rows, b.r + bh4):
            row = y4 | 1 if SIZES[d.mi_size[y4 * st + b.c - 1]][1] == 4 else y4
            ci = row * st + b.c - 1
            step = min(max(SIZES[d.mi_size[ci]][1] >> 2, 2), 16)
            if d.ref0[ci] > 0:
                count += 1
                pred_h = min(ph, (step * 4) >> sy)
                y = (y4 * 4) >> sy
                pred = np.clip(_single(d, p, base_x, y, pred_w, pred_h, d.ref0[ci], d.mv[ci],
                                       d.interp[ci], r0, r1), 0, top)
                area = cur[y - base_y : y - base_y + pred_h, :pred_w]
                area[:] = round2(mask * area + (64 - mask) * pred, 6)
            y4 += step
    _write(d, p, base_x, base_y, cur)
