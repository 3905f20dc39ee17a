"""Inference image transforms in numpy, without OpenCV.

Port of the inference composition of ``molnextr_tpu/data/transforms.py``
(``get_transforms(..., augment=False, normalize=False)``): CropWhite(pad=50)
-> Resize -> ToGray, each reproducing the cv2 call the JAX package makes:

* CropWhite trims rows/columns that are entirely white and pads a constant
  white border (``cv2.copyMakeBorder(BORDER_CONSTANT)``);
* Resize is cv2's ``INTER_LINEAR`` for uint8: half-pixel centres, edge
  clamping, 11-bit fixed-point coefficients, and the vertical pass's
  rounding of cv2's vectorized path (cv2 finishes a row's ragged tail with
  its scalar path, which rounds once; there the two differ by at most one
  grey level);
* ToGray uses cv2's fixed-point weights ``(9798 R + 19235 G + 3735 B +
  2**14) >> 15`` (the 15-bit form of 0.299/0.587/0.114 that ``cvtColor``
  computes for uint8) and replicates the grey channel.

:func:`device_normalize` is the ImageNet normalization as a torch op on the
device, for uint8 batches of one or three channels.
"""

from __future__ import annotations

from typing import List, Sequence

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


class InferenceTransform:
    """CropWhite(pad=50) -> Resize(size) -> ToGray, on RGB uint8 images;
    called as ``transform(image=...)["image"]`` like the JAX ``Compose``."""

    def __init__(self, input_size: int):
        self.input_size = input_size

    def __call__(self, image: np.ndarray):
        if image.ndim == 2:
            image = gray_to_rgb(image)
        image = crop_white(image, pad=50)
        image = resize_linear(image, self.input_size, self.input_size)
        return {"image": to_gray(image)}


def get_transforms(input_size: int) -> InferenceTransform:
    return InferenceTransform(input_size)


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 1|3) -> ImageNet-normalized float32 (B, H, W, 3) on
    the images' device; one channel broadcasts to three, as ToGray's
    replication would."""
    x = images.float() / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, device=images.device)
    return (x - mean) / std


def stack_gray_batch(images: Sequence[np.ndarray], transform: InferenceTransform) -> np.ndarray:
    """Transform each image and stack the single grey channel, (B, S, S, 1)."""
    out: List[np.ndarray] = [transform(image=im)["image"][..., :1] for im in images]
    return np.ascontiguousarray(np.stack(out, axis=0))
