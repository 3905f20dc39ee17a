"""ConvNeXt encoder backbone.

Port of ``molnextr_tpu/models/convnext.py``: the alternate image encoder of
``encoder.name = "convnext*"``.  Kept exact against the flax modules:

* the stem is a 4 x 4 stride-4 convolution and a LayerNorm; each later
  stage starts with a LayerNorm and a 2 x 2 stride-2 convolution;
* a block is the depthwise 7 x 7 convolution (``groups = dim``, padding 3),
  LayerNorm, ``pw1`` (4x), exact GELU, ``pw2``, the per-channel ``gamma``
  scale, drop-path, and the residual;
* every LayerNorm has eps 1e-6, with float32 statistics;
* drop-path rates rise as ``linspace(0, drop_path_rate, total_blocks)``
  and draw their per-sample masks from the seeded generators of
  :class:`~molnextr_tpu_torch.models.layers.Dropout` (one site each).

Activations stay NHWC.  ``forward`` returns the final map after
``final_norm`` as ``(B, H/32 * W/32, C)`` and each stage's map (before the
final norm).  The convolutions are library calls, as the JAX package leaves
them to XLA; no kernel of this repository runs here.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from molnextr_tpu_torch.config import EncoderConfig
from molnextr_tpu_torch.models.layers import Conv, Dense, Dropout, LayerNorm, number_dropout_sites

EPS = 1e-6


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, drop_path: float = 0.0):
        super().__init__()
        self.dwconv = Conv(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, EPS)
        self.pw1 = Dense(dim, 4 * dim)
        self.pw2 = Dense(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))
        self.drop_path = Dropout(drop_path, drop_path=True)

    def forward(self, x: torch.Tensor, dropout_seed=None) -> torch.Tensor:
        y = self.pw2(F.gelu(self.pw1(self.norm(self.dwconv(x)))))
        y = y * self.gamma.to(y.dtype)
        return x + self.drop_path(y, dropout_seed)


class ConvNeXtEncoder(nn.Module):
    """images (B, H, W, 3) -> (final tokens (B, M, C_last), per-stage maps)."""

    def __init__(self, cfg: EncoderConfig, input_size: int = 384):
        super().__init__()
        self.cfg = cfg
        depths, dims = cfg.convnext_depths, cfg.convnext_dims
        self.dims = [int(d) for d in dims]
        self.stem = Conv(3, dims[0], 4, stride=4)
        self.stem_norm = LayerNorm(dims[0], EPS)
        dpr = np.linspace(0, cfg.drop_path_rate, sum(depths))
        blk = 0
        for stage, depth in enumerate(depths):
            if stage > 0:
                self.add_module(f"down_norm{stage}", LayerNorm(dims[stage - 1], EPS))
                self.add_module(f"down{stage}", Conv(dims[stage - 1], dims[stage], 2, stride=2))
            for i in range(depth):
                self.add_module(f"s{stage}_b{i}", ConvNeXtBlock(dims[stage], float(dpr[blk])))
                blk += 1
        self.final_norm = LayerNorm(dims[-1], EPS)
        number_dropout_sites(self)

    def forward(self, images: torch.Tensor, dropout_seed=None):
        x = self.stem_norm(self.stem(images))
        hiddens: List[torch.Tensor] = []
        for stage, depth in enumerate(self.cfg.convnext_depths):
            if stage > 0:
                x = getattr(self, f"down{stage}")(getattr(self, f"down_norm{stage}")(x))
            for i in range(depth):
                x = getattr(self, f"s{stage}_b{i}")(x, dropout_seed)
            hiddens.append(x)
        x = self.final_norm(x)
        b, h, w, d = x.shape
        return x.reshape(b, h * w, d), hiddens
