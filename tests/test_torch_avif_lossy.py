"""The port's lossy AVIF reader against ``cv2.imread``, exactly, and its
inverse transforms against a scalar transcription.

* **Transforms**: ``data/av1_transform.py`` (libaom's flow graphs run one
  stage at a time over every row or column of a block) against the scalar
  code below, written line by line from the same butterflies (a
  ``half_btf`` per rotation, a clamp per add/subtract stage) and the 2-D
  process (64-point zeroing, the ``1/sqrt(2)`` of ratio-2 sizes, the row
  clamp and shift, the column clamp and shift by 4, flips), for all 19
  sizes and every type each allows, at 8, 10 and 12 bits, on seeded
  coefficients that include the clamp extremes; and the 1-D DCT and ADST
  against their real-valued definitions.
* **A seeded survey**: files written at test time by ``cv2.imwrite`` at
  qualities 0-99 and speeds 0, 3, 6, 9 and 10, and by Pillow (4:4:4,
  4:2:2, 4:2:0, 4:0:0, loop restoration, quantiser matrices, ``deltaq``
  and ``aq`` modes, sharpness, tiles, 128 superblocks, screen content),
  sized 1 x 1 to past 128, 10- and 12-bit grey: each reads to cv2's array,
  0 pixels differing.  The committed ``fixtures/forms/*_lossy.avif`` files
  are ``test_torch_avif.py``'s ``test_committed_forms_read_exactly``.
* **Every tool**: across a set of files, every transform size, both intra
  and all three inter transform sets, ``TX_MODE_SELECT`` and the transform
  tree of an intra block copy, ``delta_q``, the 4-, 6-, 8- and 14-tap
  deblocking filters, CDEF's primary and secondary taps, Wiener,
  self-guided and switchable restoration, quantiser matrices, ``delta_lf``
  (libaom's ``delta-lf-mode`` under ``deltaq-mode`` 3, through
  ``torch_image_writers.aom_encode``), CDEF at 4:2:2 and superres are
  reached (``av1_recon.REACHED``).
* Cut and byte-flipped lossy files read as None exactly where cv2 reads
  None, and otherwise to its pixels; film grain and superres read to
  cv2's pixels (``test_torch_avif_superres.py`` holds the superres
  survey).
* On the committed lossy demo forms the port's ``predict_image_files``
  gives the JAX package's SMILES in float32 on the CPU, and so on a cv2
  form at quality 95 where the demo bundle reads another molecule.
"""

import io
import math
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image
from test_torch_avif import FORMS, SIZES, check, cv2_rgb, picture
from torch_image_writers import (aom_avif, aom_encode, aom_yuv, av1_superres_obus, avif_rebuild,
                                 film_grain_avif)

from molnextr_tpu_torch.data import av1_recon, av1_transform
from molnextr_tpu_torch.data.av1_transform import ADST, DCT, FLIPADST, IDTX, TX_TYPE_1D
from molnextr_tpu_torch.data.image import UnsupportedFormat, imread

COS = [round(4096 * math.cos(k * math.pi / 128)) for k in range(65)]
TX_SIZES = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4), (8, 16), (16, 8),
            (16, 32), (32, 16), (32, 64), (64, 32), (4, 16), (16, 4), (8, 32), (32, 8),
            (16, 64), (64, 16)]


def cv2_lossy(img, quality, speed=None, depth=8):
    params = [cv2.IMWRITE_AVIF_QUALITY, quality, cv2.IMWRITE_AVIF_DEPTH, depth]
    if speed is not None:
        params += [cv2.IMWRITE_AVIF_SPEED, speed]
    ok, buf = cv2.imencode(".avif", img[..., ::-1].copy() if img.ndim == 3 else img, params)
    assert ok
    return buf.tobytes()


def pil_lossy(img, quality=40, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "AVIF", quality=quality, **kw)
    return buf.getvalue()


# -- the scalar transforms -------------------------------------------------------
def _btf(w0, x0, w1, x1):
    return (w0 * x0 + w1 * x1 + 2048) >> 12


def _clamp(v, bits):
    return min(max(v, -(1 << (bits - 1))), (1 << (bits - 1)) - 1)


def _brev(bits, x):
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def scalar_dct(x, bits):
    """libaom's ``av1_idctN``: the input bit-reversed, then the DCT of half
    the size on the even half and the odd half's rotations and stages."""
    n = len(x)
    t = [x[_brev(n.bit_length() - 1, i)] for i in range(n)]
    _scalar_dct_body(t, 0, n, bits)
    return t


def _scalar_dct_body(t, base, n, bits):
    if n == 2:
        a, b = t[base], t[base + 1]
        t[base], t[base + 1] = _btf(COS[32], a, COS[32], b), _btf(COS[32], a, -COS[32], b)
        return
    _scalar_dct_body(t, base, n // 2, bits)
    o, half = base + n // 2, n // 2
    lg = n.bit_length() - 1
    for i in range(half // 2):  # the odd half's first rotations
        k = (64 // n) * (1 + 4 * _brev(lg - 2, i))
        a, b = t[o + i], t[o + half - 1 - i]
        t[o + i] = _btf(COS[64 - k], a, -COS[k], b)
        t[o + half - 1 - i] = _btf(COS[k], a, COS[64 - k], b)
    levels = half.bit_length() - 1
    for m in range(1, levels):
        grp = 1 << m
        for q in range(half // grp):  # add/subtract within groups, every other one turned
            for j in range(grp // 2):
                i, k = o + q * grp + j, o + q * grp + grp - 1 - j
                a, b = t[i], t[k]
                if q % 2:
                    t[i], t[k] = _clamp(b - a, bits), _clamp(a + b, bits)
                else:
                    t[i], t[k] = _clamp(a + b, bits), _clamp(a - b, bits)
        if m <= levels - 2:
            sub = n >> (m + 1)
            for q in range(half >> (m + 2)):
                k = (64 // sub) * (1 + 4 * _brev(sub.bit_length() - 3, q))
                for s in range(1 << m):
                    off = (q << (m + 1)) + (1 << (m - 1)) + s
                    i, j = o + off, o + half - 1 - off
                    a, b = t[i], t[j]
                    if s < (1 << (m - 1)):
                        t[i], t[j] = _btf(-COS[k], a, COS[64 - k], b), _btf(COS[64 - k], a, COS[k], b)
                    else:
                        t[i], t[j] = (_btf(-COS[64 - k], a, -COS[k], b),
                                      _btf(-COS[k], a, COS[64 - k], b))
    for s in range(half // 4):
        i, j = o + half // 4 + s, o + half - 1 - half // 4 - s
        a, b = t[i], t[j]
        t[i], t[j] = _btf(-COS[32], a, COS[32], b), _btf(COS[32], a, COS[32], b)
    for i in range(n // 2):
        a, b = t[base + i], t[base + n - 1 - i]
        t[base + i], t[base + n - 1 - i] = _clamp(a + b, bits), _clamp(a - b, bits)


def scalar_adst4(x):
    s0, s1, s2, s3 = 1321 * x[0], 2482 * x[0], 3344 * x[1], 3803 * x[2]
    s4, s5, s6 = 1321 * x[2], 2482 * x[3], 3803 * x[3]
    s7 = (x[0] - x[2]) + x[3]
    s0, s1 = s0 + s3, s1 - s4
    s3, s2 = s2, 3344 * s7
    s0, s1 = s0 + s5, s1 - s6
    return [(v + 2048) >> 12 for v in (s0 + s3, s1 + s3, s2, s0 + s1 - s3)]


def scalar_adst(x, bits):
    """libaom's ``av1_iadst8`` and ``av1_iadst16``, stage by stage."""
    n = len(x)
    c = COS
    t = [x[n - 1 - i] if i % 2 == 0 else x[i - 1] for i in range(n)]
    step = 32 // n
    for i in range(n // 2):
        k = step + 4 * step * i
        a, b = t[2 * i], t[2 * i + 1]
        t[2 * i], t[2 * i + 1] = _btf(c[k], a, c[64 - k], b), _btf(c[64 - k], a, -c[k], b)
    half = n // 2
    t = [_clamp(t[i] + t[i + half], bits) for i in range(half)] + \
        [_clamp(t[i] - t[i + half], bits) for i in range(half)]
    if n == 16:
        for a_, b_, (w0, w1, w2, w3) in ((8, 9, (c[8], c[56], c[56], -c[8])),
                                         (10, 11, (c[40], c[24], c[24], -c[40])),
                                         (12, 13, (-c[56], c[8], c[8], c[56])),
                                         (14, 15, (-c[24], c[40], c[40], c[24]))):
            a, b = t[a_], t[b_]
            t[a_], t[b_] = _btf(w0, a, w1, b), _btf(w2, a, w3, b)
        u = list(t)
        for base in (0, 8):
            for i in range(4):
                u[base + i] = _clamp(t[base + i] + t[base + 4 + i], bits)
                u[base + 4 + i] = _clamp(t[base + i] - t[base + 4 + i], bits)
        t = u
    for base in range(4, n, 8):
        a, b = t[base], t[base + 1]
        t[base], t[base + 1] = _btf(c[16], a, c[48], b), _btf(c[48], a, -c[16], b)
        a, b = t[base + 2], t[base + 3]
        t[base + 2], t[base + 3] = _btf(-c[48], a, c[16], b), _btf(c[16], a, c[48], b)
    for base in range(0, n, 4):
        a0, a1, a2, a3 = t[base : base + 4]
        t[base : base + 4] = [_clamp(a0 + a2, bits), _clamp(a1 + a3, bits),
                              _clamp(a0 - a2, bits), _clamp(a1 - a3, bits)]
    for base in range(0, n, 4):
        a, b = t[base + 2], t[base + 3]
        t[base + 2], t[base + 3] = _btf(c[32], a, c[32], b), _btf(c[32], a, -c[32], b)
    order = (0, 4, 6, 2, 3, 7, 5, 1) if n == 8 else (0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7,
                                                      5, 13, 9, 1)
    return [t[k] if i % 2 == 0 else -t[k] for i, k in enumerate(order)]


def scalar_identity(x):
    n = len(x)
    if n == 4:
        return [(v * 5793 + 2048) >> 12 for v in x]
    if n == 16:
        return [(v * 11586 + 2048) >> 12 for v in x]
    return [v * (2 if n == 8 else 4) for v in x]


def scalar_1d(x, kind, bits):
    if kind == IDTX:
        return scalar_identity(x)
    if kind == DCT:
        return scalar_dct(x, bits)
    return scalar_adst4(x) if len(x) == 4 else scalar_adst(x, bits)


ROW_SHIFT = {(4, 4): 0, (8, 8): 1, (16, 16): 2, (32, 32): 2, (64, 64): 2, (4, 8): 0, (8, 4): 0,
             (8, 16): 1, (16, 8): 1, (16, 32): 1, (32, 16): 1, (32, 64): 1, (64, 32): 1,
             (4, 16): 1, (16, 4): 1, (8, 32): 2, (32, 8): 2, (16, 64): 2, (64, 16): 2}


def scalar_2d(coefs, tx_type, bd):
    """The specification's 2-D inverse transform process, one row and one
    column at a time."""
    h, w = len(coefs), len(coefs[0])
    vert, horz = TX_TYPE_1D[tx_type]
    rect = abs(w.bit_length() - h.bit_length()) == 1
    res = [[0] * w for _ in range(h)]
    for i in range(min(h, 32)):
        row = [coefs[i][j] if j < 32 else 0 for j in range(w)]
        if rect:
            row = [(v * 2896 + 2048) >> 12 for v in row]
        row = [_clamp(v, bd + 8) for v in row]
        row = scalar_1d(row, horz, bd + 8)
        shift = ROW_SHIFT[(w, h)]
        res[i] = [(v + ((1 << shift) >> 1)) >> shift for v in row]
        if horz == FLIPADST:
            res[i] = res[i][::-1]
    col_bits = max(bd + 6, 16)
    out = [[0] * w for _ in range(h)]
    for j in range(w):
        col = [_clamp(res[i][j], col_bits) for i in range(h)]
        col = scalar_1d(col, vert, col_bits)
        col = [(v + 8) >> 4 for v in col]
        if vert == FLIPADST:
            col = col[::-1]
        for i in range(h):
            out[i][j] = col[i]
    return out


def _types_for(w, h):
    up = max(w, h)
    return range(16) if up <= 16 else (0, 9) if up == 32 else (0,)  # 9: IDTX


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("w,h", TX_SIZES, ids=lambda v: str(v))
def test_transforms_match_the_scalar_transcription(w, h, bd):
    rng = np.random.RandomState(w * 131 + h * 7 + bd)
    top = 1 << (bd + 7)
    for tx_type in _types_for(w, h):
        for case in range(3):
            coefs = np.zeros((h, w), np.int64)
            ah, aw = min(h, 32), min(w, 32)
            if case == 0:  # sparse, moderate
                coefs[:ah, :aw] = rng.randint(-300, 301, (ah, aw)) * (rng.rand(ah, aw) < 0.3)
            elif case == 1:  # the clamp extremes, and past them
                coefs[:ah, :aw] = rng.choice([-top - 5, -top, top - 1, top + 7, 0], (ah, aw))
            else:  # DC only
                coefs[0, 0] = rng.randint(-top, top)
            want = scalar_2d(coefs.tolist(), tx_type, bd)
            got = av1_transform.inverse_transform(coefs, tx_type, bd)
            np.testing.assert_array_equal(got, np.array(want), err_msg=f"type {tx_type} case {case}")


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_1d_transforms_follow_their_real_definitions(n):
    """The integer DCT and ADST stay within rounding of the real transforms
    they approximate: a rounding per stage, at most n / 4 + 2 for the DCT
    and 6 for the ADST on inputs of +-2000 (a wrong rotation or sign would
    miss by hundreds)."""
    rng = np.random.RandomState(n)
    x = rng.randint(-2000, 2001, (n, 40)).astype(np.int64)
    j, k = np.arange(n)[:, None], np.arange(n)
    dct = np.cos(np.pi * (2 * j + 1) * k / (2 * n))
    dct[:, 0] = 1 / math.sqrt(2)
    got = av1_transform.transform_1d(x.copy(), DCT, 30)
    assert np.abs(got - dct @ x).max() < n / 4 + 2
    if n == 4:
        adst = np.sin(np.pi * (j + 1) * (2 * k + 1) / 9) * 2 * math.sqrt(2) / 3
    elif n <= 16:
        adst = np.sin(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * n))
    else:
        return
    got = av1_transform.transform_1d(x.copy(), ADST, 30)
    assert np.abs(got - adst @ x).max() < 6


# -- the survey against cv2 ---------------------------------------------------------
@pytest.mark.parametrize("speed", [0, 3, 6, 9, 10])
@pytest.mark.parametrize("quality", [0, 15, 30, 50, 70, 90, 99])
def test_cv2_qualities_and_speeds_read_exactly(tmp_path, quality, speed):
    check(tmp_path, cv2_lossy(picture("gradient", 70, 90, quality), quality, speed))


@pytest.mark.parametrize("h,w", [(1, 1)] + SIZES[1:] + [(67, 129), (150, 70)])
@pytest.mark.parametrize("kind", ["gradient", "flat", "motif"])
def test_sizes_read_exactly(tmp_path, kind, h, w):
    img = picture(kind, h, w)
    check(tmp_path, cv2_lossy(img, 40), "cv2.avif")
    check(tmp_path, pil_lossy(img, 50, subsampling="4:4:4"), "pil.avif")


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0", "4:0:0"])
@pytest.mark.parametrize("kind", ["gradient", "flat", "motif"])
def test_pillow_subsamplings_read_exactly(tmp_path, subsampling, kind):
    img = picture(kind, 100, 120)
    for quality in (20, 60):
        check(tmp_path, pil_lossy(img, quality, subsampling=subsampling), f"{quality}.avif")


PIL_OPTIONS = {
    "restoration speed 2": dict(speed=2, advanced={"enable-restoration": "1"}),
    "restoration speed 0, 4:4:4": dict(speed=0, subsampling="4:4:4",
                                       advanced={"enable-restoration": "1"}),
    "qm": dict(advanced={"enable-qm": "1", "qm-min": "2", "qm-max": "10"}),
    "qm 4:4:4": dict(subsampling="4:4:4", advanced={"enable-qm": "1"}),
    "deltaq-mode 2": dict(advanced={"deltaq-mode": "2"}),
    "aq-mode 1": dict(advanced={"aq-mode": "1"}),
    "sharpness 3": dict(advanced={"sharpness": "3"}),
    "sharpness 7": dict(advanced={"sharpness": "7"}, subsampling="4:2:2"),
    "tiles": dict(tile_rows=1, tile_cols=2),
    "128 superblocks": dict(advanced={"sb-size": "128"}),
    "128 superblocks, speed 0": dict(speed=0, advanced={"sb-size": "128"}),
    "screen": dict(speed=4, advanced={"tune-content": "screen"}),
    "limited range": dict(range="limited"),
}


@pytest.mark.parametrize("name", sorted(PIL_OPTIONS))
def test_pillow_options_read_exactly(tmp_path, name):
    for quality, kind in ((30, "gradient"), (70, "motif")):
        check(tmp_path, pil_lossy(picture(kind, 150, 170, quality), quality, **PIL_OPTIONS[name]),
              f"{quality}.avif")


@pytest.mark.parametrize("depth", [10, 12])
def test_high_depth_grey_reads_exactly(tmp_path, depth):
    """Monochrome at 10 and 12 bits takes libaom's high-bit-depth paths
    (12-bit rounding in the Wiener filter; rounded half to even to 8 bits)."""
    rng = np.random.RandomState(depth)
    grey = picture("gradient", 80, 100)[..., 1].astype(np.int64) * ((1 << depth) - 1) // 255
    grey[30:50] = rng.randint(0, 1 << depth, (20, 100))
    for quality in (20, 60, 90):
        check(tmp_path, cv2_lossy(grey.astype(np.uint16), quality, 6, depth), f"{quality}.avif")
    check(tmp_path, cv2_lossy(grey.astype(np.uint16), 40, 0, depth), "s0.avif")


def _dots(h, w, seed):
    """The motif with small random squares: intra block copies that leave a
    residual (their transform trees and inter transform sets)."""
    rng = np.random.RandomState(seed)
    img = picture("motif", h, w).copy()
    for _ in range(60):
        y, x = rng.randint(0, h - 5), rng.randint(0, w - 5)
        img[y : y + 3, x : x + 3] = rng.randint(0, 256, 3)
    return img


def _stripes(period, vertical, seed):
    """Stripes that bring out the 4:1 transforms."""
    img = np.zeros((256, 256, 3), np.uint8)
    on = np.arange(256) // period % 2 == 1
    if vertical:
        img[:, on] = (200, 180, 40)
    else:
        img[on] = (200, 180, 40)
    noise = np.random.RandomState(seed).randint(-3, 4, img.shape)
    return np.clip(img.astype(np.int64) + noise, 0, 255).astype(np.uint8)


def _halves():
    """Two flat halves and a grey band: the 64-point transforms."""
    img = np.zeros((256, 256, 3), np.uint8)
    img[:, 128:] = 255
    img[100:110] = 90
    return img


def _mixed(seed):
    rng = np.random.RandomState(seed)
    noise = cv2.GaussianBlur(rng.randint(0, 256, (100, 230, 3)).astype(np.uint8), (3, 3), 1)
    return np.concatenate([picture("gradient", 100, 230), noise])


def tool_files():
    """Files that between them reach every tool of the lossy reader."""
    return [
        cv2_lossy(_dots(200, 230, 2), 30, 0),  # intra block copy reaching past the frame's edge
        cv2_lossy(_dots(200, 230, 2), 60, 3),
        cv2_lossy(_stripes(16, False, 16), 50, 9), cv2_lossy(_stripes(16, True, 16), 50, 9),
        cv2_lossy(_stripes(4, False, 4), 60, 0),
        cv2_lossy(_stripes(32, True, 1), 80, 0), cv2_lossy(_halves(), 20, 0),
        cv2_lossy(picture("gradient", 130, 150), 30, 0),
        cv2_lossy(picture("gradient", 130, 150), 95, 0),
        cv2_lossy(picture("gradient", 130, 150), 50, 6),
        pil_lossy(_mixed(5), 80, speed=1, subsampling="4:4:4",
                  advanced={"enable-restoration": "1"}),
        pil_lossy(picture("gradient", 130, 150), 50, speed=2,
                  advanced={"enable-restoration": "1"}),
        # libaom through ctypes: CDEF at 4:2:2, delta_lf, superres
        aom_avif(aom_encode(aom_yuv(picture("gradient", 100, 130), "4:2:2"), subsampling="4:2:2",
                            q=40, speed=2, options=[("enable-cdef", "1")])),
        aom_avif(aom_encode(aom_yuv(picture("gradient", 160, 200)), q=40,
                            options=[("deltaq-mode", "3"), ("delta-lf-mode", "1")])),
        aom_avif(aom_encode(aom_yuv(picture("gradient", 64, 90)), q=40, superres=12)),
    ]


def test_every_tool_is_reached(tmp_path):
    av1_recon.REACHED.clear()
    for k, data in enumerate(tool_files()):
        check(tmp_path, data, f"{k}.avif")
    tools = {f"tx_{w}x{h}" for w, h in TX_SIZES} | {
        "tx_set_intra_1", "tx_set_intra_2", "tx_set_inter_1", "tx_set_inter_2",
        "tx_set_inter_3", "tx_mode_select", "txfm_split", "delta_q", "qm", "deblock_4",
        "deblock_6", "deblock_8", "deblock_14", "cdef_primary", "cdef_secondary", "lr_wiener",
        "lr_sgrproj", "lr_switchable", "intrabc", "delta_lf", "cdef_422", "superres"}
    reached = set(av1_recon.REACHED)
    assert tools <= reached, sorted(tools - reached)


def test_intra_block_copy_reads_past_the_frame_edge(tmp_path):
    """An intra block copy whose source reaches the MI-aligned columns past
    the frame's width (230 of 232) reads them as decoded: libaom copies
    from its frame buffer without extending the frame's edge."""
    check(tmp_path, cv2_lossy(_dots(200, 230, 2), 30, 0))


# -- corrupt and refused files ------------------------------------------------------
def test_cut_and_flipped_lossy_files_read_as_cv2(tmp_path):
    rng = np.random.RandomState(11)
    sources = [cv2_lossy(picture("gradient", 70, 90), 50, 6),
               cv2_lossy(picture("motif", 90, 100), 60, 6),
               pil_lossy(picture("gradient", 60, 80), 40, speed=2,
                         advanced={"enable-restoration": "1"})]
    path = tmp_path / "f.avif"
    read = 0
    for data in sources:
        variants = [data[:c] for c in sorted(set(rng.randint(1, len(data), 10)))]
        for _ in range(50):
            d = bytearray(data)
            for _ in range(rng.randint(1, 3)):
                d[rng.randint(len(d) // 2, len(d))] = rng.randint(0, 256)  # mostly AV1 data
            variants.append(bytes(d))
        for v in variants:
            path.write_bytes(v)
            want = cv2_rgb(path)
            try:
                got = imread(str(path))
            except UnsupportedFormat:
                continue
            if want is None:
                assert got is None
            else:
                read += 1
                np.testing.assert_array_equal(got, want)
    assert read  # some flips land where libaom decodes on


def test_film_grain_and_superres_raise_naming_them(tmp_path):
    """Film grain and superres raised naming themselves until the port read
    them: the grain file and a libaom superres file now read to cv2's
    arrays (``test_torch_avif_grain*.py`` and
    ``test_torch_avif_superres.py`` hold the surveys), and the hand-built
    superres header, cut short after its denominator, reads as None, as
    libaom refuses it."""
    grain = film_grain_avif()
    assert check(tmp_path, grain, "grain.avif").std() > 1  # the grain is there
    superres = aom_avif(aom_encode(aom_yuv(picture("gradient", 40, 70)), q=30, superres=14))
    assert check(tmp_path, superres, "superres.avif").shape == (40, 70, 3)
    cut = tmp_path / "cut.avif"
    cut.write_bytes(avif_rebuild(cv2_lossy(picture("flat", 16, 16), 50),
                                 payload=av1_superres_obus()))
    assert cv2_rgb(cut) is None and imread(str(cut)) is None


# -- end to end ---------------------------------------------------------------------
def test_lossy_demo_forms_predict_the_jax_packages_smiles(tmp_path):
    """The committed lossy demo forms (cv2 at 90, Pillow at 40 in 4:2:0 and
    4:4:4, loop restoration, screen content) give demo_0.png's SMILES in
    the JAX package (through ``cv2.imread``) and in the port, float32 on
    the CPU; a cv2 form at quality 95, on which the demo bundle reads
    another molecule, gives the JAX package's SMILES in the port too."""
    from molnextr_tpu.api import MolNexTR as JaxMolNexTR

    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.chem import canonicalize_smiles

    bundle = str(Path(__file__).resolve().parents[1] / "examples" / "demo_model")
    paths = [str(p) for p in sorted(FORMS.glob("demo_0_*_lossy.avif"))] + \
        [str(p) for p in sorted(FORMS.glob("demo_0_lossy.avif"))]
    assert len(paths) == 5
    q95 = tmp_path / "demo_0_q95.avif"
    q95.write_bytes(cv2_lossy(cv2_rgb(FORMS.parent / "demo_0.png"), 95))
    paths.append(str(q95))
    jax = JaxMolNexTR(model_path=bundle).predict_image_files(paths)
    port = MolNexTR(model_path=bundle, device="cpu", num_workers=1).predict_image_files(paths)
    got = [canonicalize_smiles(p["predicted_smiles"])[0] for p in port]
    want = [canonicalize_smiles(p["predicted_smiles"])[0] for p in jax]
    assert got == want
    assert got[:5] == [canonicalize_smiles("CC(C)O")[0]] * 5 and got[5] != got[0]
