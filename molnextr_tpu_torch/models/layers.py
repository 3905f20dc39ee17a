"""Parameter-holding building blocks with the flax layout and dtype policy.

The port keeps the JAX package's parameter names and layouts so weights
carry over one to one (``weights.py``):

* :class:`Dense` — ``kernel (in, out)`` and ``bias (out,)``, like
  ``flax.linen.Dense``.  In a reduced-precision model both are cast to the
  model dtype and the product runs in it, as flax does with ``dtype=bf16``;
  ``f32_bias=True`` keeps the bias in float32 for the Swin kernels, which
  take their biases in f32 as the Pallas kernels do.
* :class:`LayerNorm` — ``scale``/``bias`` stay float32, statistics and
  normalization run in float32, the output is cast to the input dtype.
* :class:`Embed` — ``embedding (num, dim)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 f32_bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        self.f32_bias = f32_bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.kernel.dtype) @ self.kernel
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def cast(self, dtype: torch.dtype) -> None:
        self.kernel.data = self.kernel.data.to(dtype)
        if self.bias is not None and not self.f32_bias:
            self.bias.data = self.bias.data.to(dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias, self.eps)
        return y.to(x.dtype)


class Embed(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]

    def cast(self, dtype: torch.dtype) -> None:
        self.embedding.data = self.embedding.data.to(dtype)

