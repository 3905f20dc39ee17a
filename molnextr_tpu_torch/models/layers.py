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
* :class:`Conv` — ``flax.linen.Conv`` on NHWC activations: ``kernel`` in
  PyTorch's ``(out, in / groups, kh, kw)`` layout (``weights.py``
  transposes flax's HWIO), ``bias (out,)``, ``"SAME"`` padding by default
  (for a stride-k k x k kernel on a multiple of k: none) or an explicit
  symmetric pad.  The NHWC input is handed to ``F.conv2d`` as a
  channels-last NCHW view, so no layout copy is made.
* :class:`Dropout` — dropout (or stochastic depth) with masks seeded per
  step and site, which ``torch.utils.checkpoint`` recomputes exactly.
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


class Conv(nn.Module):
    def __init__(self, in_features: int, out_features: int, kernel_size: int, stride: int = 1,
                 padding="SAME", groups: int = 1, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.zeros(out_features, in_features // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        self.stride, self.padding, self.groups = stride, padding, groups

    def _pads(self, size: int):
        if self.padding != "SAME":
            return self.padding, self.padding
        k, s = self.kernel.shape[-1], self.stride
        total = max((-(-size // s) - 1) * s + k - size, 0)
        return total // 2, total - total // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C_in) -> (B, H', W', C_out) in the kernel's dtype."""
        x = x.to(self.kernel.dtype).permute(0, 3, 1, 2)
        (top, bottom), (left, right) = self._pads(x.shape[2]), self._pads(x.shape[3])
        if top == bottom and left == right:
            pad = (top, left)
        else:
            x, pad = F.pad(x, (left, right, top, bottom)), 0
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x, self.kernel, bias, self.stride, pad, groups=self.groups)
        return y.permute(0, 2, 3, 1)

    def cast(self, dtype: torch.dtype) -> None:
        self.kernel.data = self.kernel.data.to(dtype)
        if self.bias is not None:
            self.bias.data = self.bias.data.to(dtype)


class Embed(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]

    def cast(self, dtype: torch.dtype) -> None:
        self.embedding.data = self.embedding.data.to(dtype)



# ---------------------------------------------------------------------------
# seeded dropout
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``(seed, data)`` (splitmix64 of their mix), the
    role ``jax.random.fold_in`` plays for the JAX train step's dropout key."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


class Dropout(nn.Module):
    """Dropout whose mask is a function of ``(seed, site)`` alone.

    The training forward passes one seed per step; every dropout module of a
    model has its own ``site`` (:func:`number_dropout_sites`).  A mask is drawn
    from a generator seeded with ``fold_in(seed, site)``, never from the
    global generators, so ``torch.utils.checkpoint`` recomputes the same mask
    in the backward pass.  Active only in training mode with ``rate > 0``;
    ``drop_path`` masks whole samples (one draw per leading index), as the
    Swin blocks' stochastic depth does.
    """

    def __init__(self, rate: float, drop_path: bool = False):
        super().__init__()
        self.rate = float(rate)
        self.drop_path = drop_path
        self.site = 0

    def forward(self, x: torch.Tensor, seed) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if seed is None:
            raise ValueError("a training forward with dropout needs a dropout_seed")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1) if self.drop_path else x.shape
        gen = torch.Generator(device=x.device)
        gen.manual_seed(fold_in(seed, self.site))
        mask = torch.rand(shape, generator=gen, device=x.device) < keep
        return x * mask.to(x.dtype) / keep


def number_dropout_sites(module: nn.Module) -> None:
    """Give every :class:`Dropout` under ``module`` its own site, in module
    order."""
    for i, m in enumerate(m for m in module.modules() if isinstance(m, Dropout)):
        m.site = i
