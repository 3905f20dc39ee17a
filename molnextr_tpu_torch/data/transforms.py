"""Keypoint-aware image transforms in numpy, without OpenCV.

Port of ``molnextr_tpu/data/transforms.py``: ``Compose`` over transforms that
map ``(image HxWx3 uint8, keypoints Nx2 float32)`` to the same pair, and
``get_transforms`` with the default augmenting set (SafeRotate, CropWhite,
PadToSquare, CropAndPad, PadWhite, Downscale, Blur, GaussNoise,
SaltAndPepperNoise, then Resize, ToGray and Normalize).  Every transform
draws from the ``random.Random`` and ``np.random.RandomState`` instances it
is handed, in the order the JAX transform draws from the global ``random``
and ``np.random``: each transform's ``p`` gate draws one number, even at
``p = 1``.  The clutter family (``clutter=True``) and
``NormalizedGridDistortion`` are not ported.

Each pixel operation reproduces the cv2 call the JAX package makes:

* CropWhite trims rows/columns that are entirely white and pads a constant
  white border (``cv2.copyMakeBorder(BORDER_CONSTANT)``);
* Resize is cv2's ``INTER_LINEAR`` for uint8: half-pixel centres, edge
  clamping, 11-bit fixed-point coefficients, and the vertical pass's
  rounding of cv2's vectorized path (cv2 finishes a row's ragged tail with
  its scalar path, which rounds once; there the two differ by at most one
  grey level);
* ToGray uses cv2's fixed-point weights ``(9798 R + 19235 G + 3735 B +
  2**14) >> 15`` (the 15-bit form of 0.299/0.587/0.114 that ``cvtColor``
  computes for uint8) and replicates the grey channel;
* the pads, crops, noise, the box filter (``cv2.blur``: integer window sums
  over a ``BORDER_REFLECT_101`` border) and ``INTER_AREA`` (cv2's float32
  cell weights, summed in its order) are exact; ``warpAffine`` (bilinear,
  constant border) and ``INTER_CUBIC`` follow OpenCV 5's float32
  arithmetic and may differ from it by one grey level at a few pixels
  (``tests/test_torch_data.py`` states the measured bound).

:func:`device_normalize` is the ImageNet normalization as a torch op on the
device, for uint8 batches of one or three channels.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

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


def _linear_taps(src: int, dst: int):
    """Source indices and fixed-point weights of cv2's INTER_LINEAR."""
    scale = src / dst
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    low = s < 0
    f[low], s[low] = 0.0, 0
    high = s >= src - 1
    f[high], s[high] = 0.0, src - 1
    w1 = np.round(f * _COEF_SCALE).astype(np.int64)
    w0 = np.round((np.float32(1.0) - f) * _COEF_SCALE).astype(np.int64)
    return s, np.minimum(s + 1, src - 1), w0, w1


def resize_linear(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 (H, W, C) -> (height, width, C), cv2 INTER_LINEAR semantics."""
    h, w = image.shape[:2]
    img = image.astype(np.int64)
    x0, x1, a0, a1 = _linear_taps(w, width)
    y0, y1, b0, b1 = _linear_taps(h, height)
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
    as OpenCV 5 computes it: the inverse map in float32, bilinear
    interpolation in float32 (two horizontal lerps, then a vertical one),
    rounded to nearest; taps outside the image read ``value``."""
    width, height = dsize
    h, w, c = image.shape
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    inv = np.array([[m[1, 1] * d, -m[0, 1] * d, 0.0], [-m[1, 0] * d, m[0, 0] * d, 0.0]])
    inv[0, 2] = -inv[0, 0] * m[0, 2] - inv[0, 1] * m[1, 2]
    inv[1, 2] = -inv[1, 0] * m[0, 2] - inv[1, 1] * m[1, 2]
    inv = inv.astype(np.float32)
    xs = np.arange(width, dtype=np.float32)[None, :]
    ys = np.arange(height, dtype=np.float32)[:, None]
    sx = inv[0, 0] * xs + (inv[0, 1] * ys + inv[0, 2])
    sy = inv[1, 0] * xs + (inv[1, 1] * ys + inv[1, 2])
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
    v0 = p00 + alpha * (p01 - p00)
    v1 = p10 + alpha * (p11 - p10)
    return np.clip(np.rint(v0 + beta * (v1 - v0)), 0, 255).astype(np.uint8)


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
    training and serving wire)."""
    if clutter:
        raise NotImplementedError(
            "the clutter transforms are not ported (ROADMAP queue 1, item 4: bench suites)")
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
    trans.append(Resize(input_size, input_size))
    if not debug:
        trans.append(ToGray(p=1.0))
        if normalize:
            trans.append(Normalize(p=1.0))
    return Compose(trans)


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
