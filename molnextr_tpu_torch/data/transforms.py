"""Keypoint-aware image transforms in numpy, without OpenCV.

Port of ``molnextr_tpu/data/transforms.py``: ``Compose`` over transforms that
map ``(image HxWx3 uint8, keypoints Nx2 float32)`` to the same pair, and
``get_transforms`` with the default augmenting set (SafeRotate, CropWhite,
PadToSquare, CropAndPad, PadWhite, Downscale, Blur, GaussNoise,
SaltAndPepperNoise, then Resize, ToGray and Normalize), the clutter family
of ``clutter=True`` and ``get_perturbation_transforms`` (AddLineNoise,
AddEdgeElementSymbolNoise, AddBondNoise, AddIncompleteStructuralNoise,
DrawBorder), and ResizePad, ConditionalPadToSquare and
NormalizedGridDistortion, which no composition uses.  Every transform
draws from the ``random.Random`` and ``np.random.RandomState`` instances it
is handed, in the order the JAX transform draws from the global ``random``
and ``np.random``: each transform's ``p`` gate draws one number, even at
``p = 1``.

Each pixel operation reproduces the cv2 call the JAX package makes, as the
installed OpenCV 5 computes it:

* CropWhite trims rows/columns that are entirely white and pads a constant
  white border (``cv2.copyMakeBorder(BORDER_CONSTANT)``);
* Resize is cv2's ``INTER_LINEAR`` for uint8: half-pixel centres, 11-bit
  fixed-point coefficients, the vertical pass's rounding of cv2's
  vectorized path; a horizontal tap past an edge moves onto the edge pixel,
  a vertical one keeps its weight on the clipped row (exact);
* ToGray uses cv2's fixed-point weights ``(9798 R + 19235 G + 3735 B +
  2**14) >> 15`` (the 15-bit form of 0.299/0.587/0.114 that ``cvtColor``
  computes for uint8) and replicates the grey channel;
* the pads, crops, noise, the box filter (``cv2.blur``: integer window sums
  over a ``BORDER_REFLECT_101`` border) and ``INTER_AREA`` (cv2's float32
  cell weights, summed in its order) are exact;
* ``cv2.remap`` (NormalizedGridDistortion; bilinear, constant border) is
  float32 in OpenCV 5, not the fixed-point tables of OpenCV 4: the
  coordinates' fractions weight two horizontal lerps and a vertical one,
  each a fused multiply-add, rounded to nearest; taps off the image read
  the border value (exact);
* ``warpAffine`` (the same bilinear step on an inverse map computed in
  float32) and ``INTER_CUBIC`` may differ from OpenCV 5 by one grey level
  at a few pixels (``tests/test_torch_data.py`` states the measured bound);
* the clutter draws ``cv2.line`` (``LINE_8``, thickness 1-2),
  ``cv2.rectangle`` and ``cv2.putText`` (``LINE_AA``) through
  ``chem/raster.py``, pixel for pixel.

:func:`device_normalize` is the ImageNet normalization as a torch op on the
device, for uint8 batches of one or three channels.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from molnextr_tpu_torch.chem import raster

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def gray_to_rgb(image: np.ndarray) -> np.ndarray:
    return np.repeat(image[..., None], 3, axis=2)


def crop_white(image: np.ndarray, pad: int = 50, value=(255, 255, 255)) -> np.ndarray:
    nonwhite = (image != np.asarray(value, image.dtype)).sum(axis=2)
    if nonwhite.sum() == 0:
        return image
    rows = nonwhite.sum(axis=1).nonzero()[0]
    cols = nonwhite.sum(axis=0).nonzero()[0]
    image = image[rows[0] : rows[-1] + 1, cols[0] : cols[-1] + 1]
    out = np.empty(
        (image.shape[0] + 2 * pad, image.shape[1] + 2 * pad, image.shape[2]), image.dtype
    )
    out[...] = np.asarray(value, image.dtype)
    out[pad : pad + image.shape[0], pad : pad + image.shape[1]] = image
    return out


def _linear_taps(src: int, dst: int, clamp: bool = True):
    """Source indices and fixed-point weights of cv2's INTER_LINEAR.  The
    horizontal pass (``clamp``) moves a tap that falls off either edge onto
    the edge pixel with weight 0; the vertical pass keeps its weights and
    clips the two source rows, which may then be one row twice."""
    scale = src / dst
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        low = s < 0
        f[low], s[low] = 0.0, 0
        high = s >= src - 1
        f[high], s[high] = 0.0, src - 1
    w1 = np.round(f * _COEF_SCALE).astype(np.int64)
    w0 = np.round((np.float32(1.0) - f) * _COEF_SCALE).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 (H, W, C) -> (height, width, C), cv2 INTER_LINEAR semantics."""
    h, w = image.shape[:2]
    img = image.astype(np.int64)
    x0, x1, a0, a1 = _linear_taps(w, width)
    y0, y1, b0, b1 = _linear_taps(h, height, clamp=False)
    rows = img[:, x0] * a0[None, :, None] + img[:, x1] * a1[None, :, None]
    # the vertical pass rounds as cv2's vectorized uint8 path does: each
    # product is truncated before the final rounding shift
    out = ((b0[:, None, None] * (rows[y0] >> 4)) >> 16) + ((b1[:, None, None] * (rows[y1] >> 4)) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def to_gray(image: np.ndarray) -> np.ndarray:
    """RGB uint8 -> grey replicated on three channels (cv2's weights)."""
    img = image.astype(np.int32)
    g = (img[..., 0] * 9798 + img[..., 1] * 19235 + img[..., 2] * 3735 + (1 << 14)) >> 15
    return gray_to_rgb(g.astype(np.uint8))


def pad_constant(image: np.ndarray, t: int, b: int, l: int, r: int, value) -> np.ndarray:
    """``cv2.copyMakeBorder(..., BORDER_CONSTANT, value=value)``."""
    h, w, c = image.shape
    out = np.empty((h + t + b, w + l + r, c), image.dtype)
    out[...] = np.asarray(value, image.dtype)[:c]
    out[t : t + h, l : l + w] = image
    return out


# -- warpAffine (bilinear, constant border) -----------------------------------


def rotation_matrix(center: Tuple[float, float], angle: float, scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D`` (angle in degrees, counter-clockwise)."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def warp_affine(image: np.ndarray, m: np.ndarray, dsize: Tuple[int, int], value) -> np.ndarray:
    """``cv2.warpAffine(image, m, dsize, INTER_LINEAR, BORDER_CONSTANT, value)``
    as OpenCV 5 computes it: the inverse map in float32 (``x`` term fused
    onto the row's ``y`` term), then its bilinear step (:func:`remap_linear`)."""
    width, height = dsize
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    inv = np.array([[m[1, 1] * d, -m[0, 1] * d, 0.0], [-m[1, 0] * d, m[0, 0] * d, 0.0]])
    inv[0, 2] = -inv[0, 0] * m[0, 2] - inv[0, 1] * m[1, 2]
    inv[1, 2] = -inv[1, 0] * m[0, 2] - inv[1, 1] * m[1, 2]
    inv = inv.astype(np.float32)
    xs = np.broadcast_to(np.arange(width, dtype=np.float32)[None, :], (height, width))
    ys = np.arange(height, dtype=np.float32)[:, None]
    sx = _fma(inv[0, 0], xs, inv[0, 1] * ys + inv[0, 2])
    sy = _fma(inv[1, 0], xs, inv[1, 1] * ys + inv[1, 2])
    return remap_linear(image, sx, sy, value)


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64."""
    return (np.float64(a) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(
        np.float32)


def remap_linear(image: np.ndarray, sx: np.ndarray, sy: np.ndarray, value) -> np.ndarray:
    """``cv2.remap(image, sx, sy, INTER_LINEAR, BORDER_CONSTANT, value)`` for
    float32 maps, as OpenCV 5 computes it: two horizontal lerps by the
    coordinates' fractions, then a vertical one, each a float32 fused
    multiply-add, rounded to nearest; taps outside the image read ``value``."""
    sx, sy = sx.astype(np.float32), sy.astype(np.float32)
    h, w, c = image.shape
    ix, iy = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    alpha = (sx - ix).astype(np.float32)[..., None]
    beta = (sy - iy).astype(np.float32)[..., None]
    src = image.astype(np.float32)
    val = np.asarray(value, np.float32)[:c]

    def tap(dy, dx):
        yy, xx = iy + dy, ix + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return np.where(inside[..., None], src[yy.clip(0, h - 1), xx.clip(0, w - 1)], val)

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    v0 = _fma(alpha, p01 - p00, p00)
    v1 = _fma(alpha, p11 - p10, p10)
    return np.clip(np.rint(_fma(beta, v1 - v0, v0)), 0, 255).astype(np.uint8)


# -- INTER_AREA downscale, INTER_CUBIC upscale ---------------------------------


def _area_tab(src: int, dst: int, scale: float):
    """cv2's ``computeResizeAreaTab``: per destination index, the source
    indices and float32 weights, in cv2's order (padded with weight 0)."""
    rows: List[List[Tuple[int, float]]] = []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, float(np.float32((sx1 - fsx1) / cell))))
        for sx in range(sx1, sx2):
            row.append((sx, float(np.float32(1.0 / cell))))
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, float(np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell))))
        rows.append(row)
    n = max(len(r) for r in rows)
    idx = np.zeros((dst, n), np.int64)
    wts = np.zeros((dst, n), np.float32)
    for i, r in enumerate(rows):
        for j, (sx, a) in enumerate(r):
            idx[i, j], wts[i, j] = sx, a
    return idx, wts


def resize_area(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 (H, W, C) -> (height, width, C), ``cv2.INTER_AREA`` for a
    downscale: integer ratios average whole cells (2 x 2 as ``(sum + 2) >>
    2``), other ratios sum float32 weights in cv2's order and round."""
    h, w = image.shape[:2]
    sx, sy = w / width, h / height
    isx, isy = int(round(sx)), int(round(sy))
    if abs(sx - isx) < np.finfo(np.float64).eps and abs(sy - isy) < np.finfo(np.float64).eps:
        cells = image[: height * isy, : width * isx].astype(np.int64)
        total = cells.reshape(height, isy, width, isx, -1).sum(axis=(1, 3))
        if isx == 2 and isy == 2:
            return ((total + 2) >> 2).astype(np.uint8)
        out = total.astype(np.float32) * np.float32(1.0 / (isx * isy))
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    xi, xw = _area_tab(w, width, sx)
    yi, yw = _area_tab(h, height, sy)
    src = image.astype(np.float32)
    buf = np.zeros((h, width, image.shape[2]), np.float32)
    for j in range(xi.shape[1]):  # horizontal pass, per source row
        buf = buf + src[:, xi[:, j]] * xw[None, :, j, None]
    out = yw[:, 0, None, None] * buf[yi[:, 0]]
    for j in range(1, yi.shape[1]):
        out = out + yw[:, j, None, None] * buf[yi[:, j]]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _cubic_taps(src: int, dst: int):
    """Source indices (clamped: a replicated border) and float32 weights
    of cv2's INTER_CUBIC (A = -0.75)."""
    scale = src / dst
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    x = (f - s.astype(np.float32)).astype(np.float32)
    a, one = np.float32(-0.75), np.float32(1)
    c0 = ((a * (x + one) - np.float32(5) * a) * (x + one) + np.float32(8) * a) * (x + one) - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    c2 = ((a + np.float32(2)) * (one - x) - (a + np.float32(3))) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None, :], 0, src - 1)
    return idx, np.stack([c0, c1, c2, c3], 1).astype(np.float32)


def resize_cubic(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 (H, W, C) -> (height, width, C), cv2's ``INTER_CUBIC`` as
    OpenCV 5 computes an upscale: float32 weights and sums, the horizontal
    pass first, rounded to nearest."""
    h, w = image.shape[:2]
    xi, xw = _cubic_taps(w, width)
    yi, yw = _cubic_taps(h, height)
    src = image.astype(np.float32)
    rows = src[:, xi[:, 0]] * xw[None, :, 0, None]
    for k in range(1, 4):
        rows = rows + src[:, xi[:, k]] * xw[None, :, k, None]
    out = rows[yi[:, 0]] * yw[:, 0, None, None]
    for k in range(1, 4):
        out = out + rows[yi[:, k]] * yw[:, k, None, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def box_blur(image: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(image, (k, k))`` for odd ``k``: integer window sums over a
    ``BORDER_REFLECT_101`` border, divided by ``k * k`` and rounded."""
    r = k // 2
    padded = np.pad(image.astype(np.int64), ((r, k - 1 - r), (r, k - 1 - r), (0, 0)),
                    mode="reflect")
    c = np.cumsum(np.pad(padded, ((1, 0), (1, 0), (0, 0))), axis=0).cumsum(axis=1)
    h, w = image.shape[:2]
    total = c[k:k + h, k:k + w] - c[:h, k:k + w] - c[k:k + h, :w] + c[:h, :w]
    d = k * k  # odd, so the rounding never ties
    return ((2 * total + d) // (2 * d)).astype(np.uint8)


# -- transforms ----------------------------------------------------------------


Rngs = Tuple[random.Random, np.random.RandomState]


class Transform:
    """Base: ``p`` gates ``apply`` with one draw from ``rng``."""

    def __init__(self, p: float = 1.0):
        self.p = p

    def __call__(self, image, keypoints, rng: random.Random, np_rng: np.random.RandomState):
        if rng.random() < self.p:
            return self.apply(image, keypoints, rng, np_rng)
        return image, keypoints

    def apply(self, image, keypoints, rng, np_rng):
        raise NotImplementedError


class Compose:
    """Chains transforms; called as ``transform(image=..., keypoints=...,
    rng=..., np_rng=...)["image"]``.  Without ``rng``/``np_rng`` it draws
    from its own instances, seeded with ``seed``."""

    def __init__(self, transforms: Sequence[Transform], seed: int = 0):
        self.transforms = list(transforms)
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)

    def __call__(self, image: np.ndarray, keypoints=None, rng: Optional[random.Random] = None,
                 np_rng: Optional[np.random.RandomState] = None):
        rng = self.rng if rng is None else rng
        np_rng = self.np_rng if np_rng is None else np_rng
        kps = (np.asarray(keypoints, np.float32).reshape(-1, 2)
               if keypoints is not None and len(keypoints) else np.zeros((0, 2), np.float32))
        if image.ndim == 2:
            image = gray_to_rgb(image)
        for t in self.transforms:
            image, kps = t(image, kps, rng, np_rng)
        return {"image": image, "keypoints": kps}


class SafeRotate(Transform):
    """Rotate by U(-limit, limit) degrees onto a canvas grown to hold the
    whole image."""

    def __init__(self, limit: int = 90, value=(255, 255, 255), p: float = 0.5):
        super().__init__(p)
        self.limit = limit
        self.value = value

    def apply(self, image, keypoints, rng, np_rng):
        angle = rng.uniform(-self.limit, self.limit)
        h, w = image.shape[:2]
        rad = math.radians(angle)
        new_w = int(math.ceil(abs(w * math.cos(rad)) + abs(h * math.sin(rad))))
        new_h = int(math.ceil(abs(w * math.sin(rad)) + abs(h * math.cos(rad))))
        m = rotation_matrix((w / 2, h / 2), angle)
        m[0, 2] += new_w / 2 - w / 2
        m[1, 2] += new_h / 2 - h / 2
        image = warp_affine(image, m, (new_w, new_h), self.value)
        if len(keypoints):
            ones = np.ones((len(keypoints), 1), np.float32)
            keypoints = (np.concatenate([keypoints, ones], axis=1) @ m.T).astype(np.float32)
        return image, keypoints


class CropWhite(Transform):
    """Trim white margins, then pad a fixed white border."""

    def __init__(self, value=(255, 255, 255), pad: int = 0, p: float = 1.0):
        super().__init__(p)
        self.value = value
        self.pad = pad

    def apply(self, image, keypoints, rng, np_rng):
        nonwhite = (image != np.asarray(self.value, image.dtype)).sum(axis=2)
        if nonwhite.sum() == 0:
            return image, keypoints
        rows = nonwhite.sum(axis=1).nonzero()[0]
        cols = nonwhite.sum(axis=0).nonzero()[0]
        image = crop_white(image, self.pad, self.value)
        if len(keypoints):
            keypoints = keypoints + np.asarray(
                [self.pad - int(cols[0]), self.pad - int(rows[0])], np.float32)
        return image, keypoints


class PadWhite(Transform):
    """White padding of up to ``pad_ratio`` on one random side."""

    def __init__(self, pad_ratio: float = 0.2, value=(255, 255, 255), p: float = 0.5):
        super().__init__(p)
        self.pad_ratio = pad_ratio
        self.value = value

    def apply(self, image, keypoints, rng, np_rng):
        h, w = image.shape[:2]
        side = rng.randrange(4)
        amount = rng.random() * self.pad_ratio
        t = b = l = r = 0
        if side == 0:
            t = int(h * amount)
        elif side == 1:
            b = int(h * amount)
        elif side == 2:
            l = int(w * amount)
        else:
            r = int(w * amount)
        image = pad_constant(image, t, b, l, r, self.value)
        if len(keypoints):
            keypoints = keypoints + np.asarray([l, t], np.float32)
        return image, keypoints


class PadToSquare(Transform):
    """Centre-pad the short side to a square."""

    def __init__(self, value=(255, 255, 255), p: float = 1.0):
        super().__init__(p)
        self.value = value

    def apply(self, image, keypoints, rng, np_rng):
        h, w = image.shape[:2]
        size = max(h, w)
        t, l = (size - h) // 2, (size - w) // 2
        image = pad_constant(image, t, size - h - t, l, size - w - l, self.value)
        if len(keypoints):
            keypoints = keypoints + np.asarray([l, t], np.float32)
        return image, keypoints


class ResizePad(Transform):
    """Clamp each side to (height, width) with INTER_LINEAR (no upscale,
    each axis on its own), then centre-pad with white to exactly that size."""

    def __init__(self, height: int, width: int, value=(255, 255, 255), p: float = 1.0):
        super().__init__(p)
        self.height = height
        self.width = width
        self.value = value

    def apply(self, image, keypoints, rng, np_rng):
        h, w = image.shape[:2]
        nh, nw = min(h, self.height), min(w, self.width)
        if (nh, nw) != (h, w):
            image = resize_linear(image, nh, nw)
            if len(keypoints):
                keypoints = keypoints * np.asarray([nw / w, nh / h], np.float32)
        t, l = (self.height - nh) // 2, (self.width - nw) // 2
        image = pad_constant(image, t, self.height - nh - t, l, self.width - nw - l, self.value)
        if len(keypoints):
            keypoints = keypoints + np.asarray([l, t], np.float32)
        return image, keypoints


class ConditionalPadToSquare(Transform):
    """Centre-pad the short side to a square only when the aspect ratio is
    at least ``ratio_threshold``."""

    def __init__(self, value=(255, 255, 255), ratio_threshold: float = 1.5, p: float = 1.0):
        super().__init__(p)
        self.value = value
        self.ratio_threshold = ratio_threshold

    def apply(self, image, keypoints, rng, np_rng):
        h, w = image.shape[:2]
        if max(h, w) / max(min(h, w), 1) < self.ratio_threshold:
            return image, keypoints
        diff = abs(h - w)
        p1, p2 = diff // 2, diff - diff // 2
        if h < w:
            image = pad_constant(image, p1, p2, 0, 0, self.value)
            shift = [0, p1]
        else:
            image = pad_constant(image, 0, 0, p1, p2, self.value)
            shift = [p1, 0]
        if len(keypoints):
            keypoints = keypoints + np.asarray(shift, np.float32)
        return image, keypoints


class CropAndPad(Transform):
    """Crop each side by a fraction drawn from ``percent`` (negative = crop)."""

    def __init__(self, percent=(-0.01, 0.0), p: float = 0.5):
        super().__init__(p)
        self.percent = percent

    def apply(self, image, keypoints, rng, np_rng):
        h, w = image.shape[:2]
        fracs = [rng.uniform(*self.percent) for _ in range(4)]  # t, r, b, l
        t = int(round(-fracs[0] * h)) if fracs[0] < 0 else 0
        r = int(round(-fracs[1] * w)) if fracs[1] < 0 else 0
        b = int(round(-fracs[2] * h)) if fracs[2] < 0 else 0
        l = int(round(-fracs[3] * w)) if fracs[3] < 0 else 0
        if t + b >= h or l + r >= w:
            return image, keypoints
        image = image[t : h - b, l : w - r]
        if len(keypoints):
            keypoints = keypoints - np.asarray([l, t], np.float32)
        return image, keypoints


class Resize(Transform):
    def __init__(self, height: int, width: int, p: float = 1.0):
        super().__init__(p)
        self.height = height
        self.width = width

    def apply(self, image, keypoints, rng, np_rng):
        h, w = image.shape[:2]
        image = resize_linear(image, self.height, self.width)
        if len(keypoints):
            keypoints = keypoints * np.asarray([self.width / w, self.height / h], np.float32)
        return image, keypoints


class Downscale(Transform):
    """Downscale by U(scale_min, scale_max) (INTER_AREA), then back up
    (INTER_CUBIC)."""

    def __init__(self, scale_min: float = 0.2, scale_max: float = 0.5, p: float = 0.5):
        super().__init__(p)
        self.scale_min = scale_min
        self.scale_max = scale_max

    def apply(self, image, keypoints, rng, np_rng):
        h, w = image.shape[:2]
        s = rng.uniform(self.scale_min, self.scale_max)
        small = resize_area(image, max(int(h * s), 1), max(int(w * s), 1))
        return resize_cubic(small, h, w), keypoints


class Blur(Transform):
    def __init__(self, max_ksize: int = 7, p: float = 0.5):
        super().__init__(p)
        self.max_ksize = max_ksize

    def apply(self, image, keypoints, rng, np_rng):
        k = rng.choice(range(3, self.max_ksize + 1, 2))
        return box_blur(image, k), keypoints


class GaussNoise(Transform):
    def __init__(self, var_limit=(10.0, 50.0), p: float = 0.5):
        super().__init__(p)
        self.var_limit = var_limit

    def apply(self, image, keypoints, rng, np_rng):
        var = rng.uniform(*self.var_limit)
        noise = np_rng.normal(0, var ** 0.5, image.shape).astype(np.float32)
        image = np.clip(image.astype(np.float32) + noise, 0, 255).astype(np.uint8)
        return image, keypoints


class SaltAndPepperNoise(Transform):
    """Up to ``num_dots`` pixels set to ``value``."""

    def __init__(self, num_dots: int = 20, value=(0, 0, 0), p: float = 0.5):
        super().__init__(p)
        self.num_dots = num_dots
        self.value = value

    def apply(self, image, keypoints, rng, np_rng):
        h, w = image.shape[:2]
        image = image.copy()
        for _ in range(rng.randrange(self.num_dots + 1)):
            image[rng.randrange(h), rng.randrange(w)] = self.value
        return image, keypoints


class NormalizedGridDistortion(Transform):
    """Grid distortion whose ``num_steps + 1`` step sizes per axis, drawn
    from 1 +- ``distort_limit``, are scaled to mean 1; the image is
    resampled with ``remap_linear`` and a white border, keypoints are left
    as they are (as the JAX transform leaves them)."""

    def __init__(self, num_steps: int = 10, distort_limit: float = 0.3, p: float = 0.5):
        super().__init__(p)
        self.num_steps = num_steps
        self.distort_limit = distort_limit

    def apply(self, image, keypoints, rng, np_rng):
        h, w = image.shape[:2]
        ns, lim = self.num_steps, self.distort_limit
        xsteps = np.array([1 + rng.uniform(-lim, lim) for _ in range(ns + 1)])
        ysteps = np.array([1 + rng.uniform(-lim, lim) for _ in range(ns + 1)])
        xsteps = xsteps / xsteps.mean()
        ysteps = ysteps / ysteps.mean()

        def axis_map(size, steps):
            span = size // ns
            pos = [0.0]
            for i in range(ns):
                pos.append(pos[-1] + span * steps[i])
            pos = np.asarray(pos) * (size - 1) / max(pos[-1], 1e-6)
            xs = np.zeros(size, np.float32)
            for i in range(ns):
                lo, hi = i * span, min((i + 1) * span, size)
                if hi > lo:
                    xs[lo:hi] = np.linspace(pos[i], pos[i + 1], hi - lo)
            if ns * span < size:
                xs[ns * span:] = np.linspace(pos[-1], size - 1, size - ns * span)
            return xs

        map_x = np.tile(axis_map(w, xsteps)[None], (h, 1))
        map_y = np.tile(axis_map(h, ysteps)[:, None], (1, w))
        return remap_linear(image, map_x, map_y, (255, 255, 255)), keypoints


# -- synthetic clutter: black marks drawn with chem/raster.py ------------------

BLACK = (0, 0, 0)


class AddLineNoise(Transform):
    """1 to ``num_lines`` stray lines between random pixels."""

    def __init__(self, num_lines: int = 3, p: float = 0.3):
        super().__init__(p)
        self.num_lines = num_lines

    def apply(self, image, keypoints, rng, np_rng):
        image = image.copy()
        h, w = image.shape[:2]
        for _ in range(rng.randrange(1, self.num_lines + 1)):
            p1 = (rng.randrange(w), rng.randrange(h))
            p2 = (rng.randrange(w), rng.randrange(h))
            raster.line8(image, p1, p2, BLACK, rng.randrange(1, 3))
        return image, keypoints


class AddEdgeElementSymbolNoise(Transform):
    """1 to ``num_symbols`` stray element symbols near a random border."""

    SYMBOLS = ["C", "N", "O", "H", "S", "Cl", "Br", "F", "P", "OH", "NH"]

    def __init__(self, num_symbols: int = 3, p: float = 0.3):
        super().__init__(p)
        self.num_symbols = num_symbols

    def apply(self, image, keypoints, rng, np_rng):
        image = image.copy()
        h, w = image.shape[:2]
        margin = max(min(h, w) // 10, 12)
        for _ in range(rng.randrange(1, self.num_symbols + 1)):
            side = rng.randrange(4)
            if side == 0:
                x, y = rng.randrange(w), rng.randrange(margin, 2 * margin)
            elif side == 1:
                x, y = rng.randrange(w), h - rng.randrange(margin, 2 * margin)
            elif side == 2:
                x, y = rng.randrange(margin, 2 * margin), rng.randrange(h)
            else:
                x, y = w - rng.randrange(margin, 2 * margin), rng.randrange(h)
            symbol = rng.choice(self.SYMBOLS)
            raster.put_text(image, symbol, (x, y), 0, rng.uniform(0.4, 0.8), BLACK)
        return image, keypoints


class DrawBorder(Transform):
    """A black frame of thickness 1 or 2 around the image."""

    def __init__(self, p: float = 0.2):
        super().__init__(p)

    def apply(self, image, keypoints, rng, np_rng):
        image = image.copy()
        h, w = image.shape[:2]
        raster.rectangle(image, (0, 0), (w - 1, h - 1), BLACK, rng.randrange(1, 3))
        return image, keypoints


class AddBondNoise(Transform):
    """1 to ``num_bonds`` short bond-like segments, 30 % of them doubled."""

    def __init__(self, num_bonds: int = 3, p: float = 0.3):
        super().__init__(p)
        self.num_bonds = num_bonds

    def apply(self, image, keypoints, rng, np_rng):
        image = image.copy()
        h, w = image.shape[:2]
        length = max(min(h, w) // 12, 8)
        for _ in range(rng.randrange(1, self.num_bonds + 1)):
            x, y = rng.randrange(w), rng.randrange(h)
            a = rng.uniform(0, 2 * math.pi)
            x2 = int(x + length * math.cos(a))
            y2 = int(y + length * math.sin(a))
            raster.line8(image, (x, y), (x2, y2), BLACK, rng.randrange(1, 3))
            if rng.random() < 0.3:  # double bond
                off = 3
                raster.line8(image, (x + off, y + off), (x2 + off, y2 + off), BLACK, 1)
        return image, keypoints


class AddIncompleteStructuralNoise(Transform):
    """1 to ``num_structs`` rings of 5 or 6 sides with only 2 to n - 1 of
    their sides drawn."""

    def __init__(self, num_structs: int = 2, p: float = 0.3):
        super().__init__(p)
        self.num_structs = num_structs

    def apply(self, image, keypoints, rng, np_rng):
        image = image.copy()
        h, w = image.shape[:2]
        r = max(min(h, w) // 10, 10)
        for _ in range(rng.randrange(1, self.num_structs + 1)):
            cx, cy = rng.randrange(w), rng.randrange(h)
            n = rng.choice([5, 6])
            start = rng.uniform(0, 2 * math.pi)
            pts = [(int(cx + r * math.cos(start + 2 * math.pi * k / n)),
                    int(cy + r * math.sin(start + 2 * math.pi * k / n))) for k in range(n)]
            for k in range(rng.randrange(2, n)):
                raster.line8(image, pts[k], pts[(k + 1) % n], BLACK, 1)
        return image, keypoints


def clutter_transforms(p: float, border_p: float) -> List[Transform]:
    """The clutter family, each at ``p``, the border at ``border_p``."""
    return [AddLineNoise(p=p), AddEdgeElementSymbolNoise(p=p), AddBondNoise(p=p),
            AddIncompleteStructuralNoise(p=p), DrawBorder(p=border_p)]


class ToGray(Transform):
    def apply(self, image, keypoints, rng, np_rng):
        return to_gray(image), keypoints


class Normalize(Transform):
    """ImageNet-normalized float32 output, HWC."""

    def apply(self, image, keypoints, rng, np_rng):
        img = image.astype(np.float32) / 255.0
        return (img - IMAGENET_MEAN) / IMAGENET_STD, keypoints


def dataset_pads_to_square(dataset: Optional[str]) -> bool:
    """The ACS and UOB eval sets get a PadToSquare after CropWhite; accepts a
    dataset name or a test-file path."""
    if not dataset:
        return False
    name = dataset.lower().rsplit("/", 1)[-1].replace(".csv", "")
    return name in ("acs", "uob")


def get_transforms(input_size: int, augment: bool = True, rotate: bool = True,
                   debug: bool = False, pad_to_square: bool = False,
                   dataset: Optional[str] = None, normalize: bool = True,
                   clutter: bool = False) -> Compose:
    """The JAX package's composition; ``normalize=False`` keeps uint8 (the
    training and serving wire).  ``clutter=True`` adds the clutter family
    after the photometric set (each at p 0.3, the border at 0.2), with or
    without ``augment``, as the JAX package's clutter fine-tune draws it."""
    trans: List[Transform] = []
    if augment and rotate:
        trans.append(SafeRotate(limit=90))
    trans.append(CropWhite(pad=50))
    if pad_to_square or dataset_pads_to_square(dataset):
        trans.append(PadToSquare(p=1.0))
    if augment:
        trans += [
            CropAndPad(percent=(-0.01, 0.0), p=0.5),
            PadWhite(pad_ratio=0.4, p=0.2),
            Downscale(scale_min=0.2, scale_max=0.5, p=0.5),
            Blur(p=0.5),
            GaussNoise(p=0.5),
            SaltAndPepperNoise(num_dots=20, p=0.5),
        ]
    if clutter:
        trans += clutter_transforms(0.3, 0.2)
    trans.append(Resize(input_size, input_size))
    if not debug:
        trans.append(ToGray(p=1.0))
        if normalize:
            trans.append(Normalize(p=1.0))
    return Compose(trans)


def get_perturbation_transforms(input_size: int) -> Compose:
    """The perturbed suite's pipeline: CropWhite, the clutter family (each at
    p 0.5, the border at 0.3), Resize, ToGray, Normalize."""
    return Compose([CropWhite(pad=50), *clutter_transforms(0.5, 0.3),
                    Resize(input_size, input_size), ToGray(p=1.0), Normalize(p=1.0)])


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 1|3) -> ImageNet-normalized float32 (B, H, W, 3) on
    the images' device; one channel broadcasts to three, as ToGray's
    replication would."""
    x = images.float() / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, device=images.device)
    return (x - mean) / std


def stack_gray_batch(images: Sequence[np.ndarray], transform: Compose) -> np.ndarray:
    """Transform each image and stack the single grey channel, (B, S, S, 1)."""
    out: List[np.ndarray] = [transform(image=im)["image"][..., :1] for im in images]
    return np.ascontiguousarray(np.stack(out, axis=0))
