"""AV1 film grain synthesis (the AV1 specification, section 7.18.3), as
libaom's ``av1_add_film_grain`` applies it to every shown frame that
libavif hands OpenCV.

:func:`apply_grain` takes a frame's planes after the in-loop filters (Y,
then U and V unless monochrome, each cut to its size) and the frame
header's :class:`~molnextr_tpu_torch.data.av1_obu.FilmGrain`, and returns
the planes with grain, at 8, 10 or 12 bits:

* the 16-bit random register and the 2048-entry Gaussian sequence
  (``_GAUSSIAN``, libaom's ``gaussian_sequence``);
* the grain templates, luma 73 x 82 and chroma 38 x 44 at 4:2:0 (73 x 44
  at 4:2:2, 73 x 82 at 4:4:4), drawn from the sequence and run through the
  auto-regressive filter of lag ``ar_coeff_lag``, sample after sample
  (chroma with the average of the luma grain under it as its last input);
* the scaling lookups, piecewise linear between the points, interpolated
  between entries above 8 bits;
* the noise: a seed for each 32-row luma stripe, a random offset into the
  templates for each 32 x 32 block, and with ``overlap_flag`` the
  neighbouring blocks' and stripes' grain blended over 2 samples (1 in a
  subsampled direction);
* the noise scaled by the lookup of the sample (for chroma, of the luma
  and chroma mixed by the ``cb_*``/``cr_*`` multipliers and offsets, or of
  the luma alone with ``chroma_scaling_from_luma``), added and clipped to
  the full or, with ``clip_to_restricted_range``, the restricted range.

Chroma reads the luma before its grain.  At an odd width the 4:2:0 and
4:2:2 luma average repeats the last column, as libaom's copy padded to an
even size does.
"""

from __future__ import annotations

from typing import List

import numpy as np

from molnextr_tpu_torch.data.av1_obu import FilmGrain

# libaom's gaussian_sequence (aom_dsp/grain_synthesis.c), the specification's
# Gaussian_Sequence
_GAUSSIAN = np.array([
    56, 568, -180, 172, 124, -84, 172, -64, -900, 24, 820, 224, 1248, 996, 272, -8, -916, -388,
    -732, -104, -188, 800, 112, -652, -320, -376, 140, -252, 492, -168, 44, -788, 588, -584,
    500, -228, 12, 680, 272, -476, 972, -100, 652, 368, 432, -196, -720, -192, 1000, -332, 652,
    -136, -552, -604, -4, 192, -220, -136, 1000, -52, 372, -96, -624, 124, -24, 396, 540, -12,
    -104, 640, 464, 244, -208, -84, 368, -528, -740, 248, -968, -848, 608, 376, -60, -292, -40,
    -156, 252, -292, 248, 224, -280, 400, -244, 244, -60, 76, -80, 212, 532, 340, 128, -36,
    824, -352, -60, -264, -96, -612, 416, -704, 220, -204, 640, -160, 1220, -408, 900, 336, 20,
    -336, -96, -792, 304, 48, -28, -1232, -1172, -448, 104, -292, -520, 244, 60, -948, 0, -708,
    268, 108, 356, -548, 488, -344, -136, 488, -196, -224, 656, -236, -1128, 60, 4, 140, 276,
    -676, -376, 168, -108, 464, 8, 564, 64, 240, 308, -300, -400, -456, -136, 56, 120, -408,
    -116, 436, 504, -232, 328, 844, -164, -84, 784, -168, 232, -224, 348, -376, 128, 568, 96,
    -1244, -288, 276, 848, 832, -360, 656, 464, -384, -332, -356, 728, -388, 160, -192, 468,
    296, 224, 140, -776, -100, 280, 4, 196, 44, -36, -648, 932, 16, 1428, 28, 528, 808, 772,
    20, 268, 88, -332, -284, 124, -384, -448, 208, -228, -1044, -328, 660, 380, -148, -300,
    588, 240, 540, 28, 136, -88, -436, 256, 296, -1000, 1400, 0, -48, 1056, -136, 264, -528,
    -1108, 632, -484, -592, -344, 796, 124, -668, -768, 388, 1296, -232, -188, -200, -288, -4,
    308, 100, -168, 256, -500, 204, -508, 648, -136, 372, -272, -120, -1004, -552, -548, -384,
    548, -296, 428, -108, -8, -912, -324, -224, -88, -112, -220, -100, 996, -796, 548, 360,
    -216, 180, 428, -200, -212, 148, 96, 148, 284, 216, -412, -320, 120, -300, -384, -604,
    -572, -332, -8, -180, -176, 696, 116, -88, 628, 76, 44, -516, 240, -208, -40, 100, -592,
    344, -308, -452, -228, 20, 916, -1752, -136, -340, -804, 140, 40, 512, 340, 248, 184, -492,
    896, -156, 932, -628, 328, -688, -448, -616, -752, -100, 560, -1020, 180, -800, -64, 76,
    576, 1068, 396, 660, 552, -108, -28, 320, -628, 312, -92, -92, -472, 268, 16, 560, 516,
    -672, -52, 492, -100, 260, 384, 284, 292, 304, -148, 88, -152, 1012, 1064, -228, 164, -376,
    -684, 592, -392, 156, 196, -524, -64, -884, 160, -176, 636, 648, 404, -396, -436, 864, 424,
    -728, 988, -604, 904, -592, 296, -224, 536, -176, -920, 436, -48, 1176, -884, 416, -776,
    -824, -884, 524, -548, -564, -68, -164, -96, 692, 364, -692, -1012, -68, 260, -480, 876,
    -1116, 452, -332, -352, 892, -1088, 1220, -676, 12, -292, 244, 496, 372, -32, 280, 200,
    112, -440, -96, 24, -644, -184, 56, -432, 224, -980, 272, -260, 144, -436, 420, 356, 364,
    -528, 76, 172, -744, -368, 404, -752, -416, 684, -688, 72, 540, 416, 92, 444, 480, -72,
    -1416, 164, -1172, -68, 24, 424, 264, 1040, 128, -912, -524, -356, 64, 876, -12, 4, -88,
    532, 272, -524, 320, 276, -508, 940, 24, -400, -120, 756, 60, 236, -412, 100, 376, -484,
    400, -100, -740, -108, -260, 328, -268, 224, -200, -416, 184, -604, -564, -20, 296, 60,
    892, -888, 60, 164, 68, -760, 216, -296, 904, -336, -28, 404, -356, -568, -208, -1480,
    -512, 296, 328, -360, -164, -1560, -776, 1156, -428, 164, -504, -112, 120, -216, -148,
    -264, 308, 32, 64, -72, 72, 116, 176, -64, -272, 460, -536, -784, -280, 348, 108, -752,
    -132, 524, -540, -776, 116, -296, -1196, -288, -560, 1040, -472, 116, -848, -1116, 116,
    636, 696, 284, -176, 1016, 204, -864, -648, -248, 356, 972, -584, -204, 264, 880, 528, -24,
    -184, 116, 448, -144, 828, 524, 212, -212, 52, 12, 200, 268, -488, -404, -880, 824, -672,
    -40, 908, -248, 500, 716, -576, 492, -576, 16, 720, -108, 384, 124, 344, 280, 576, -500,
    252, 104, -308, 196, -188, -8, 1268, 296, 1032, -1196, 436, 316, 372, -432, -200, -660,
    704, -224, 596, -132, 268, 32, -452, 884, 104, -1008, 424, -1348, -280, 4, -1168, 368, 476,
    696, 300, -8, 24, 180, -592, -196, 388, 304, 500, 724, -160, 244, -84, 272, -256, -420,
    320, 208, -144, -156, 156, 364, 452, 28, 540, 316, 220, -644, -248, 464, 72, 360, 32, -388,
    496, -680, -48, 208, -116, -408, 60, -604, -392, 548, -840, 784, -460, 656, -544, -388,
    -264, 908, -800, -628, -612, -568, 572, -220, 164, 288, -16, -308, 308, -112, -636, -760,
    280, -668, 432, 364, 240, -196, 604, 340, 384, 196, 592, -44, -500, 432, -580, -132, 636,
    -76, 392, 4, -412, 540, 508, 328, -356, -36, 16, -220, -64, -248, -60, 24, -192, 368, 1040,
    92, -24, -1044, -32, 40, 104, 148, 192, -136, -520, 56, -816, -224, 732, 392, 356, 212,
    -80, -424, -1008, -324, 588, -1496, 576, 460, -816, -848, 56, -580, -92, -1372, -112, -496,
    200, 364, 52, -140, 48, -48, -60, 84, 72, 40, 132, -356, -268, -104, -284, -404, 732, -520,
    164, -304, -540, 120, 328, -76, -460, 756, 388, 588, 236, -436, -72, -176, -404, -316,
    -148, 716, -604, 404, -72, -88, -888, -68, 944, 88, -220, -344, 960, 472, 460, -232, 704,
    120, 832, -228, 692, -508, 132, -476, 844, -748, -364, -44, 1116, -1104, -1056, 76, 428,
    552, -692, 60, 356, 96, -384, -188, -612, -576, 736, 508, 892, 352, -1132, 504, -24, -352,
    324, 332, -600, -312, 292, 508, -144, -8, 484, 48, 284, -260, -240, 256, -100, -292, -204,
    -44, 472, -204, 908, -188, -1000, -256, 92, 1164, -392, 564, 356, 652, -28, -884, 256, 484,
    -192, 760, -176, 376, -524, -452, -436, 860, -736, 212, 124, 504, -476, 468, 76, -472, 552,
    -692, -944, -620, 740, -240, 400, 132, 20, 192, -196, 264, -668, -1012, -60, 296, -316,
    -828, 76, -156, 284, -768, -448, -832, 148, 248, 652, 616, 1236, 288, -328, -400, -124,
    588, 220, 520, -696, 1032, 768, -740, -92, -272, 296, 448, -464, 412, -200, 392, 440, -200,
    264, -152, -260, 320, 1032, 216, 320, -8, -64, 156, -1016, 1084, 1172, 536, 484, -432, 132,
    372, -52, -256, 84, 116, -352, 48, 116, 304, -384, 412, 924, -300, 528, 628, 180, 648, 44,
    -980, -220, 1320, 48, 332, 748, 524, -268, -720, 540, -276, 564, -344, -208, -196, 436,
    896, 88, -392, 132, 80, -964, -288, 568, 56, -48, -456, 888, 8, 552, -156, -292, 948, 288,
    128, -716, -292, 1192, -152, 876, 352, -600, -260, -812, -468, -28, -120, -32, -44, 1284,
    496, 192, 464, 312, -76, -516, -380, -456, -1012, -48, 308, -156, 36, 492, -156, -808, 188,
    1652, 68, -120, -116, 316, 160, -140, 352, 808, -416, 592, 316, -480, 56, 528, -204, -568,
    372, -232, 752, -344, 744, -4, 324, -416, -600, 768, 268, -248, -88, -132, -420, -432, 80,
    -288, 404, -316, -1216, -588, 520, -108, 92, -320, 368, -480, -216, -92, 1688, -300, 180,
    1020, -176, 820, -68, -228, -260, 436, -904, 20, 40, -508, 440, -736, 312, 332, 204, 760,
    -372, 728, 96, -20, -632, -520, -560, 336, 1076, -64, -532, 776, 584, 192, 396, -728, -520,
    276, -188, 80, -52, -612, -252, -48, 648, 212, -688, 228, -52, -260, 428, -412, -272, -404,
    180, 816, -796, 48, 152, 484, -88, -216, 988, 696, 188, -528, 648, -116, -180, 316, 476,
    12, -564, 96, 476, -252, -364, -376, -392, 556, -256, -576, 260, -352, 120, -16, -136,
    -260, -492, 72, 556, 660, 580, 616, 772, 436, 424, -32, -324, -1268, 416, -324, -80, 920,
    160, 228, 724, 32, -516, 64, 384, 68, -128, 136, 240, 248, -204, -68, 252, -932, -120,
    -480, -628, -84, 192, 852, -404, -288, -132, 204, 100, 168, -68, -196, -868, 460, 1080,
    380, -80, 244, 0, 484, -888, 64, 184, 352, 600, 460, 164, 604, -196, 320, -64, 588, -184,
    228, 12, 372, 48, -848, -344, 224, 208, -200, 484, 128, -20, 272, -468, -840, 384, 256,
    -720, -520, -464, -580, 112, -120, 644, -356, -208, -608, -528, 704, 560, -424, 392, 828,
    40, 84, 200, -152, 0, -144, 584, 280, -120, 80, -556, -972, -196, -472, 724, 80, 168, -32,
    88, 160, -688, 0, 160, 356, 372, -776, 740, -128, 676, -248, -480, 4, -364, 96, 544, 232,
    -1032, 956, 236, 356, 20, -40, 300, 24, -676, -596, 132, 1120, -104, 532, -1096, 568, 648,
    444, 508, 380, 188, -376, -604, 1488, 424, 24, 756, -220, -192, 716, 120, 920, 688, 168,
    44, -460, 568, 284, 1144, 1160, 600, 424, 888, 656, -356, -320, 220, 316, -176, -724, -188,
    -816, -628, -348, -228, -380, 1012, -452, -660, 736, 928, 404, -696, -72, -268, -892, 128,
    184, -344, -780, 360, 336, 400, 344, 428, 548, -112, 136, -228, -216, -820, -516, 340, 92,
    -136, 116, -300, 376, -244, 100, -316, -520, -284, -12, 824, 164, -548, -180, -128, 116,
    -924, -828, 268, -368, -580, 620, 192, 160, 0, -1676, 1068, 424, -56, -360, 468, -156, 720,
    288, -528, 556, -364, 548, -148, 504, 316, 152, -648, -620, -684, -24, -376, -384, -108,
    -920, -1032, 768, 180, -264, -508, -1268, -260, -60, 300, -240, 988, 724, -376, -576, -212,
    -736, 556, 192, 1092, -620, -880, 376, -56, -4, -216, -32, 836, 268, 396, 1332, 864, -600,
    100, 56, -412, -92, 356, 180, 884, -468, -436, 292, -388, -804, -704, -840, 368, -348, 140,
    -724, 1536, 940, 372, 112, -372, 436, -480, 1136, 296, -32, -228, 132, -48, -220, 868,
    -1016, -60, -1044, -464, 328, 916, 244, 12, -736, -296, 360, 468, -376, -108, -92, 788,
    368, -56, 544, 400, -672, -420, 728, 16, 320, 44, -284, -380, -796, 488, 132, 204, -596,
    -372, 88, -152, -908, -636, -572, -624, -116, -692, -200, -56, 276, -88, 484, -324, 948,
    864, 1000, -456, -184, -276, 292, -296, 156, 676, 320, 160, 908, -84, -1236, -288, -116,
    260, -372, -644, 732, -756, -96, 84, 344, -520, 348, -688, 240, -84, 216, -1044, -136,
    -676, -396, -1500, 960, -40, 176, 168, 1516, 420, -504, -344, -364, -360, 1216, -940, -380,
    -212, 252, -660, -708, 484, -444, -152, 928, -120, 1112, 476, -260, 560, -148, -344, 108,
    -196, 228, -288, 504, 560, -328, -88, 288, -1008, 460, -228, 468, -836, -196, 76, 388, 232,
    412, -1168, -716, -644, 756, -172, -356, -504, 116, 432, 528, 48, 476, -168, -608, 448,
    160, -532, -272, 28, -676, -12, 828, 980, 456, 520, 104, -104, 256, -344, -4, -28, -368,
    -52, -524, -572, -556, -200, 768, 1124, -208, -512, 176, 232, 248, -148, -888, 604, -600,
    -304, 804, -156, -212, 488, -192, -804, -256, 368, -360, -916, -328, 228, -240, -448, -472,
    856, -556, -364, 572, -12, -156, -368, -340, 432, 252, -752, -152, 288, 268, -580, -848,
    -592, 108, -76, 244, 312, -716, 592, -80, 436, 360, 4, -248, 160, 516, 584, 732, 44, -468,
    -280, -292, -156, -588, 28, 308, 912, 24, 124, 156, 180, -252, 944, -924, -772, -520, -428,
    -624, 300, -212, -1144, 32, -724, 800, -1128, -212, -1288, -848, 180, -416, 440, 192, -576,
    -792, -76, -1080, 80, -532, -352, -132, 380, -820, 148, 1112, 128, 164, 456, 700, -924,
    144, -668, -384, 648, -832, 508, 552, -52, -100, -656, 208, -568, 748, -88, 680, 232, 300,
    192, -408, -1012, -152, -252, -268, 272, -876, -664, -648, -332, -136, 16, 12, 1152, -28,
    332, -536, 320, -672, -460, -316, 532, -260, 228, -40, 1052, -816, 180, 88, -496, -556,
    -672, -368, 428, 92, 356, 404, -408, 252, 196, -176, -556, 792, 268, 32, 372, 40, 96, -332,
    328, 120, 372, -900, -40, 472, -264, -592, 952, 128, 656, 112, 664, -232, 420, 4, -344,
    -464, 556, 244, -416, -32, 252, 0, -412, 188, -696, 508, -476, 324, -1096, 656, -312, 560,
    264, -136, 304, 160, -64, -580, 248, 336, -720, 560, -348, -288, -276, -196, -500, 852,
    -544, -236, -1128, -992, -776, 116, 56, 52, 860, 884, 212, -12, 168, 1020, 512, -552, 924,
    -148, 716, 188, 164, -340, -520, -184, 880, -152, -680, -208, -1156, -300, -528, -472, 364,
    100, -744, -1056, -32, 540, 280, 144, -676, -32, -232, -280, -224, 96, 568, -76, 172, 148,
    148, 104, 32, -296, -32, 788, -80, 32, -16, 280, 288, 944, 428, -484,
], np.int64)
_LUMA_H, _LUMA_W = 73, 82


class _Random:
    """The specification's 16-bit ``RandomRegister`` and
    ``get_random_number``."""

    def __init__(self, seed: int):
        self.r = seed

    def take(self, bits: int) -> int:
        r = self.r
        r = (r >> 1) | (((r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1) << 15)
        self.r = r
        return (r >> (16 - bits)) & ((1 << bits) - 1)

    def gaussian(self, h: int, w: int, shift: int) -> np.ndarray:
        g = _GAUSSIAN[[self.take(11) for _ in range(h * w)]].reshape(h, w)
        return (g + ((1 << shift) >> 1)) >> shift


def _stripe_seed(seed: int, num: int) -> int:
    return seed ^ (((num * 37 + 178) & 255) << 8) ^ ((num * 173 + 105) & 255)


def _auto_regress(grain: np.ndarray, coeffs: List[int], lag: int, shift: int, lo: int,
                  hi: int, luma: np.ndarray = None) -> None:
    """The auto-regressive filter, in place, in raster order over rows 3
    on and columns 3 to the fourth last: the previous ``lag`` rows and the
    ``lag`` samples to the left, weighted by ``coeffs`` (then ``luma``, the
    luma grain's average at each sample, by the last coefficient)."""
    h, w = grain.shape
    taps = [(dy, dx) for dy in range(-lag, 1) for dx in range(-lag, lag + 1) if (dy, dx) < (0, 0)]
    above = [(c, dy, dx) for c, (dy, dx) in zip(coeffs, taps) if dy < 0]
    left = [(c, dx) for c, (dy, dx) in zip(coeffs, taps) if dy == 0]
    rnd = 1 << (shift - 1)
    for y in range(3, h):
        base = np.zeros(w - 6, np.int64)
        for c, dy, dx in above:
            base += c * grain[y + dy, 3 + dx : w - 3 + dx]
        if luma is not None:
            base += coeffs[len(taps)] * luma[y - 3]
        row, sums = grain[y].tolist(), base.tolist()
        for x in range(3, w - 3):
            s = sums[x - 3]
            for c, dx in left:
                s += c * row[x + dx]
            row[x] = min(hi, max(lo, row[x] + ((s + rnd) >> shift)))
        grain[y] = row


def _templates(g: FilmGrain, bd: int, ss_x: int, ss_y: int, chroma: bool) -> List[np.ndarray]:
    """The luma and (unless monochrome) the Cb and Cr grain templates."""
    shift = 12 - bd + g.grain_scale_shift
    lo, hi = -(128 << (bd - 8)), (128 << (bd - 8)) - 1
    ar_shift = g.ar_coeff_shift_minus_6 + 6
    luma = np.zeros((_LUMA_H, _LUMA_W), np.int64)
    if g.point_y:
        luma = _Random(g.grain_seed).gaussian(_LUMA_H, _LUMA_W, shift)
        _auto_regress(luma, g.ar_coeffs_y, g.ar_coeff_lag, ar_shift, lo, hi)
    if not chroma:
        return [luma]
    ch, cw = 38 if ss_y else _LUMA_H, 44 if ss_x else _LUMA_W
    avg = None
    if g.point_y:  # the luma grain under each chroma sample, averaged
        ys = ((np.arange(3, ch) - 3) << ss_y) + 3
        xs = ((np.arange(3, cw - 3) - 3) << ss_x) + 3
        acc = sum(luma[np.ix_(ys + i, xs + j)] for i in range(ss_y + 1) for j in range(ss_x + 1))
        avg = (acc + ((1 << (ss_x + ss_y)) >> 1)) >> (ss_x + ss_y)
    out = [luma]
    for key, points, coeffs in ((0xB524, g.point_cb, g.ar_coeffs_cb),
                                (0x49D8, g.point_cr, g.ar_coeffs_cr)):
        grain = np.zeros((ch, cw), np.int64)
        if points or g.chroma_scaling_from_luma:
            grain = _Random(g.grain_seed ^ key).gaussian(ch, cw, shift)
            _auto_regress(grain, coeffs, g.ar_coeff_lag, ar_shift, lo, hi, avg)
        out.append(grain)
    return out


def _scaling_lut(points) -> np.ndarray:
    lut = np.zeros(256, np.int64)
    if not points:
        return lut
    lut[: points[0][0]] = points[0][1]
    for (x0, y0), (x1, y1) in zip(points, points[1:]):
        dx = x1 - x0
        delta = (y1 - y0) * ((65536 + (dx >> 1)) // dx)
        lut[x0:x1] = y0 + ((np.arange(dx) * delta + 32768) >> 16)
    lut[points[-1][0] :] = points[-1][1]
    return lut


def _scale(lut: np.ndarray, index: np.ndarray, bd: int) -> np.ndarray:
    """``scale_lut``: the entry of ``index``'s top 8 bits, interpolated
    towards the next by the bits below."""
    if bd == 8:
        return lut[index]
    shift = bd - 8
    x = index >> shift
    start, end = lut[x], lut[np.minimum(x + 1, 255)]
    return start + (((end - start) * (index & ((1 << shift) - 1)) + (1 << (shift - 1))) >> shift)


def _noise(g: FilmGrain, templates: List[np.ndarray], bd: int, w: int, h: int, ss_x: int,
           ss_y: int) -> List[np.ndarray]:
    """The noise of each plane at the frame's size: 32 x 32 luma blocks
    cut from the templates at random offsets, stripe by stripe, blended
    with their left and upper neighbours where ``overlap_flag``."""
    lo, hi = -(128 << (bd - 8)), (128 << (bd - 8)) - 1
    subs = [(0, 0), (ss_x, ss_y), (ss_x, ss_y)][: len(templates)]
    out = [np.zeros(((h + sy) >> sy, (w + sx) >> sx), np.int64) for sx, sy in subs]
    prev: List[np.ndarray] = []

    def blend(old, new, weights):
        return np.clip((old * weights[0] + new * weights[1] + 16) >> 5, lo, hi)

    half_w = (w + 1) // 2
    for num, y in enumerate(range(0, (h + 1) // 2, 16)):
        rand = _Random(_stripe_seed(g.grain_seed, num))
        offsets = [rand.take(8) for _ in range(0, half_w, 16)]
        stripes = []
        for p, (sx, sy) in enumerate(subs):
            bh, bw = 34 >> sy, 34 >> sx
            stripe = np.zeros((bh, (len(offsets) * 32 >> sx) + bw), np.int64)
            for k, r in enumerate(offsets):
                ox, oy = r >> 4, r & 15
                px, py = 6 + ox if sx else 9 + 2 * ox, 6 + oy if sy else 9 + 2 * oy
                block = templates[p][py : py + bh, px : px + bw].copy()
                col = k * 32 >> sx
                if g.overlap_flag and k:
                    old = stripe[:, col : col + 2]
                    if sx:
                        block[:, 0] = blend(old[:, 0], block[:, 0], (23, 22))
                    else:
                        block[:, 0] = blend(old[:, 0], block[:, 0], (27, 17))
                        block[:, 1] = blend(old[:, 1], block[:, 1], (17, 27))
                stripe[:, col : col + bw] = block
            rows, (ph, pw) = 32 >> sy, out[p].shape
            y0 = num * rows
            n = min(rows, ph - y0)
            part = stripe[:n, :pw].copy()
            if g.overlap_flag and num:
                old = prev[p]
                if sy:
                    part[0] = blend(old[16, :pw], part[0], (23, 22))
                else:
                    part[0] = blend(old[32, :pw], part[0], (27, 17))
                    if n > 1:
                        part[1] = blend(old[33, :pw], part[1], (17, 27))
            out[p][y0 : y0 + n] = part
            stripes.append(stripe)
        prev = stripes
    return out


def apply_grain(planes: List[np.ndarray], g: FilmGrain, bd: int, ss_x: int, ss_y: int,
                mc_identity: bool) -> List[np.ndarray]:
    """The planes with ``g``'s grain added (module doc); ``mc_identity``
    (the sequence's matrix 0) clips chroma to the luma's restricted
    range."""
    chroma = len(planes) == 3
    templates = _templates(g, bd, ss_x, ss_y, chroma)
    h, w = planes[0].shape
    noise = _noise(g, templates, bd, w, h, ss_x, ss_y)
    shift = g.grain_scaling_minus_8 + 8
    rnd = 1 << (shift - 1)
    top = (1 << bd) - 1
    if g.clip_to_restricted_range:
        lo, max_luma = 16 << (bd - 8), 235 << (bd - 8)
        max_chroma = max_luma if mc_identity else 240 << (bd - 8)
    else:
        lo, max_luma, max_chroma = 0, top, top
    luma = planes[0].astype(np.int64)
    out = [luma]
    if chroma:
        rows = luma[:: 1 << ss_y]
        if ss_x:  # the pair under each chroma sample, the last column repeated
            nxt = np.minimum(np.arange(0, w, 2) + 1, w - 1)
            avg = (rows[:, ::2] + rows[:, nxt] + 1) >> 1
        else:
            avg = rows
        lut_y = _scaling_lut(g.point_y)
        for p, points, mult, luma_mult, offset in (
                (1, g.point_cb, g.cb_mult, g.cb_luma_mult, g.cb_offset),
                (2, g.point_cr, g.cr_mult, g.cr_luma_mult, g.cr_offset)):
            orig = planes[p].astype(np.int64)
            if g.chroma_scaling_from_luma:
                merged, lut = avg, lut_y
            elif points:
                combined = avg * (luma_mult - 128) + orig * (mult - 128)
                merged = np.clip((combined >> 6) + ((offset - 256) << (bd - 8)), 0, top)
                lut = _scaling_lut(points)
            else:
                out.append(orig)
                continue
            grain = (_scale(lut, merged, bd) * noise[p] + rnd) >> shift
            out.append(np.clip(orig + grain, lo, max_chroma))
    if g.point_y:
        grain = (_scale(_scaling_lut(g.point_y), luma, bd) * noise[0] + rnd) >> shift
        out[0] = np.clip(luma + grain, lo, max_luma)
    return [o.astype(planes[k].dtype) for k, o in enumerate(out)]
