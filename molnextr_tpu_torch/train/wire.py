"""Host -> device wire-format decoding for training batches.

Port of ``molnextr_tpu/train/wire.py``.  The pipeline ships uint8 images,
one grey channel ``(B, H, W, 1)`` or three, and int8 label matrices (edges,
atom grid); these functions move a batch to the device and expand it there,
so the train step, the eval step and the engine read the same shapes.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from molnextr_tpu_torch.data.transforms import device_normalize


def as_model_images(images, device) -> torch.Tensor:
    """uint8 (B, H, W, 1|3) -> ImageNet-normalized float32 (B, H, W, 3) on
    ``device``; float batches pass through, already normalized."""
    x = torch.as_tensor(images, device=device)
    if x.dtype == torch.uint8:
        return device_normalize(x)
    return x.float()


def as_model_refs(refs: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Label leaves on ``device``: int8 and int32 ids become int64 (the index
    dtype of torch), float leaves (coordinate targets) stay float32."""
    out = {}
    for k, v in refs.items():
        t = torch.as_tensor(v, device=device)
        out[k] = t.long() if not t.is_floating_point() else t.float()
    return out
