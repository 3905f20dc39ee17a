"""Dual-attention (DANet) heads.

Port of ``molnextr_tpu/models/danet.py``: ``PositionAttention``,
``ChannelAttention`` and ``DAHead`` on NHWC maps, with the flax modules'
names, so ``weights.load_flax_params`` loads their JAX parameter trees.
Neither package's model calls them: they are selectable refinement heads
over encoder features.  As in flax: the attention softmaxes run in float32,
the channel attention attends over ``max - energy``, ``alpha`` and
``beta`` are learned scalars (zero at init), the conv blocks are a 3 x 3
bias-free convolution, a LayerNorm with flax's default eps 1e-6 and a
ReLU, and ``DAHead`` applies dropout 0.1 to the fused map in training
mode (seeded per site, as every dropout of the port).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from molnextr_tpu_torch.models.layers import Conv, Dropout, LayerNorm, number_dropout_sites


class PositionAttention(nn.Module):
    """Spatial self-attention over the H*W positions."""

    def __init__(self, in_channels: int):
        super().__init__()
        qk = max(in_channels // 8, 1)
        self.conv_b = Conv(in_channels, qk, 1)
        self.conv_c = Conv(in_channels, qk, 1)
        self.conv_d = Conv(in_channels, in_channels, 1)
        self.alpha = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> the same shape."""
        b, h, w, c = x.shape
        q = self.conv_b(x).reshape(b, h * w, -1)
        k = self.conv_c(x).reshape(b, h * w, -1)
        v = self.conv_d(x).reshape(b, h * w, c)
        attn = torch.softmax((q @ k.transpose(1, 2)).float(), dim=-1).to(x.dtype)
        out = (attn @ v).reshape(b, h, w, c)
        return self.alpha.to(x.dtype) * out + x


class ChannelAttention(nn.Module):
    """Self-attention across channels."""

    def __init__(self):
        super().__init__()
        self.beta = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        flat = x.reshape(b, h * w, c)
        energy = (flat.transpose(1, 2) @ flat).float()
        energy = energy.amax(dim=-1, keepdim=True) - energy
        attn = torch.softmax(energy, dim=-1).to(x.dtype)
        out = (flat @ attn.transpose(1, 2)).reshape(b, h, w, c)
        return self.beta.to(x.dtype) * out + x


class DAHead(nn.Module):
    """Position and channel attention branches, summed, then a 1 x 1
    convolution to ``out_channels``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        inter = max(in_channels // 4, 1)
        for name, cin in (("p1", in_channels), ("p2", inter), ("c1", in_channels),
                          ("c2", inter)):
            self.add_module(f"{name}_conv", Conv(cin, inter, 3, use_bias=False))
            self.add_module(f"{name}_norm", LayerNorm(inter, 1e-6))
        self.pam = PositionAttention(inter)
        self.cam = ChannelAttention()
        self.dropout = Dropout(0.1)
        self.out = Conv(inter, out_channels, 1)
        number_dropout_sites(self)

    def _conv_block(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.relu(getattr(self, f"{name}_norm")(getattr(self, f"{name}_conv")(x)))

    def forward(self, x: torch.Tensor, dropout_seed=None) -> torch.Tensor:
        """x (B, H, W, C) -> (B, H, W, out_channels)."""
        p = self._conv_block(self.pam(self._conv_block(x, "p1")), "p2")
        ch = self._conv_block(self.cam(self._conv_block(x, "c1")), "c2")
        return self.out(self.dropout(p + ch, dropout_seed))
