"""Swin vision transformer encoder.

Port of ``molnextr_tpu/models/swin.py::SwinEncoder``.  A block takes one of
the JAX package's two paths, chosen as JAX chooses it by ``deterministic``:

* in eval mode, the inference path (``SwinEncoder._fused_block``): K1
  (:func:`~molnextr_tpu_torch.ops.swin_fused.fused_window_attention`) and K2
  (:func:`~molnextr_tpu_torch.ops.swin_fused.fused_ln_mlp`) on the natural
  ``(B, H, W, C)`` layout, with the ``-100`` shift mask;
* in training mode, the flax module path (``WindowAttention`` and
  ``SwinBlock``), differentiable by autograd: window partition, the ``-1e9``
  shift mask, the softmax in float32 when ``softmax_f32``, stochastic depth
  at ``linspace(0, drop_path_rate, total_blocks)``, and one
  ``torch.utils.checkpoint`` per block when ``use_remat``.  It never calls
  K1 or K2, which have no backward.

Kept exact against the JAX package:

* the relative-position index and the bias gather ``table[idx] -> (H, N, N)``;
* the shift mask (``-100/0`` on the fused path, ``-1e9`` on the module
  path), and the roll by ``-shift`` before and ``+shift`` after the
  attention;
* the shift is clamped to 0 when ``ws >= min(res)`` (every stage-3 block of
  Swin-B at 384 px is unshifted);
* PatchMerging's concat order (0::2,0::2), (1::2,0::2), (0::2,1::2),
  (1::2,1::2), then LN and a bias-free reduction;
* LayerNorm eps 1e-5 with float32 statistics.

The 4x4 stride-4 patch-embed convolution is a reshape plus one matmul over
the flattened ``(kh, kw, cin)`` patch, the flax HWIO kernel's order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from molnextr_tpu_torch.config import EncoderConfig
from molnextr_tpu_torch.models.layers import Dense, Dropout, LayerNorm, number_dropout_sites
from molnextr_tpu_torch.ops.swin_fused import fused_ln_mlp, fused_window_attention


def rel_pos_index(ws: int) -> np.ndarray:
    """Relative-position index table for a ws x ws window, (N, N)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # 2, N, N
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Boolean mask for shifted windows, True = masked, (nW, N, N)."""
    img = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wss] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return win[:, None, :] != win[:, :, None]


def effective_window(window_size: int, res: Tuple[int, int], shift: int) -> Tuple[int, int]:
    """(ws, shift) after clamping: the window never exceeds the map, and a
    window that covers the whole map is never shifted."""
    ws = min(window_size, min(res))
    return ws, (0 if ws >= min(res) else shift)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


class WindowAttention(nn.Module):
    """The flax ``attn`` submodule: its parameters, and its forward on the
    training path."""

    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, 3 * dim, f32_bias=True)
        self.proj = Dense(dim, dim, f32_bias=True)
        self.rel_bias = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, heads))

    def forward(self, x: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor],
                softmax_f32: bool) -> torch.Tensor:
        """x (nB, N, C) windows, bias (H, N, N), mask (nW, N, N) bool (True =
        masked) or None."""
        nb, n, c = x.shape
        h = self.heads
        hd = c // h
        qkv = self.qkv(x)
        q = qkv[..., :c].reshape(nb, n, h, hd)
        k = qkv[..., c:2 * c].reshape(nb, n, h, hd)
        v = qkv[..., 2 * c:].reshape(nb, n, h, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
        attn = attn + bias.to(attn.dtype)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(nb // nw, nw, h, n, n).masked_fill(mask[None, :, None], -1e9)
            attn = attn.reshape(nb, h, n, n)
        if softmax_f32:
            attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        else:
            attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.to(v.dtype), v).reshape(nb, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, resolution: Tuple[int, int],
                 window_size: int, shift: int, mlp_ratio: float,
                 drop_path: float = 0.0, softmax_f32: bool = True):
        super().__init__()
        self.dim, self.heads, self.resolution = dim, heads, resolution
        self.ws, self.shift = effective_window(window_size, resolution, shift)
        self.softmax_f32 = softmax_f32
        n = self.ws * self.ws
        self.norm1 = LayerNorm(dim, 1e-5)
        self.attn = WindowAttention(dim, heads, self.ws)
        self.norm2 = LayerNorm(dim, 1e-5)
        hidden = int(dim * mlp_ratio)
        self.fc1 = Dense(dim, hidden, f32_bias=True)
        self.fc2 = Dense(hidden, dim, f32_bias=True)
        self.register_buffer(
            "rel_index", torch.from_numpy(rel_pos_index(self.ws).reshape(-1)), persistent=False
        )
        mask = maskb = None
        if self.shift:
            maskb = torch.from_numpy(
                shift_attn_mask(resolution[0], resolution[1], self.ws, self.shift))
            mask = torch.where(maskb, -100.0, 0.0)
        self.register_buffer("mask", mask, persistent=False)  # the fused path's
        self.register_buffer("mask_bool", maskb, persistent=False)  # the module path's
        self.drop_path1 = Dropout(drop_path, drop_path=True)
        self.drop_path2 = Dropout(drop_path, drop_path=True)
        self._n = n

    def _rel_bias(self) -> torch.Tensor:
        n = self._n
        bias = self.attn.rel_bias[self.rel_index].reshape(n, n, self.heads)
        return bias.permute(2, 0, 1)

    def forward(self, x: torch.Tensor, dropout_seed=None) -> torch.Tensor:
        if self.training:
            return self.train_forward(x, dropout_seed)
        b, l, c = x.shape
        hres, wres = self.resolution
        shift = self.shift
        bias = self._rel_bias().float().contiguous()
        xsp = x.reshape(b, hres, wres, c)
        xin = torch.roll(xsp, (-shift, -shift), (1, 2)) if shift else xsp
        dt = x.dtype  # the kernels take their weights in the activation dtype
        attn = fused_window_attention(
            xin.contiguous(),
            self.attn.qkv.kernel.to(dt), self.attn.qkv.bias,
            self.attn.proj.kernel.to(dt), self.attn.proj.bias,
            self.norm1.scale, self.norm1.bias,
            bias, self.mask, self.heads, self.ws,
        )
        if shift:
            attn = torch.roll(attn, (shift, shift), (1, 2))
        xr = (xsp + attn).reshape(b * l, c)
        y = fused_ln_mlp(
            xr, self.norm2.scale, self.norm2.bias,
            self.fc1.kernel.to(dt), self.fc1.bias, self.fc2.kernel.to(dt), self.fc2.bias,
        )
        return (xr + y).reshape(b, l, c)

    def train_forward(self, x: torch.Tensor, dropout_seed=None) -> torch.Tensor:
        """The flax module path (``molnextr_tpu/models/swin.py:126-165``)."""
        b, l, c = x.shape
        hres, wres = self.resolution
        ws, shift = self.ws, self.shift
        h = self.norm1(x).reshape(b, hres, wres, c)
        if shift:
            h = torch.roll(h, (-shift, -shift), (1, 2))
        attn = self.attn(window_partition(h, ws), self._rel_bias(), self.mask_bool,
                         self.softmax_f32)
        h = window_reverse(attn, ws, hres, wres)
        if shift:
            h = torch.roll(h, (shift, shift), (1, 2))
        x = x + self.drop_path1(h.reshape(b, l, c), dropout_seed)
        y = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + self.drop_path2(y, dropout_seed)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, resolution: Tuple[int, int]):
        super().__init__()
        self.resolution = resolution
        self.norm = LayerNorm(4 * dim, 1e-5)
        self.reduction = Dense(4 * dim, 2 * dim, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.resolution
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1
        )
        x = x.reshape(b, (h // 2) * (w // 2), 4 * c)
        return self.reduction(self.norm(x))


class SwinEncoder(nn.Module):
    """images (B, H, W, 3) -> (final tokens (B, M, C_last), per-stage maps)."""

    def __init__(self, cfg: EncoderConfig, input_size: int = 384):
        super().__init__()
        c = cfg
        self.cfg = cfg
        p = c.patch_size
        self.patch_embed = Dense(p * p * 3, c.embed_dim)
        self.patch_norm = LayerNorm(c.embed_dim, 1e-5) if c.patch_norm else None
        res = (input_size // p, input_size // p)
        self.dims = [int(c.embed_dim * 2 ** i) for i in range(len(c.depths))]
        self.stage_res: List[Tuple[int, int]] = []
        dpr = np.linspace(0, c.drop_path_rate, sum(c.depths))
        blk = 0
        for stage, depth in enumerate(c.depths):
            self.stage_res.append(res)
            for i in range(depth):
                shift = 0 if i % 2 == 0 else c.window_size // 2
                self.add_module(
                    f"stage{stage}_block{i}",
                    SwinBlock(self.dims[stage], c.num_heads[stage], res, c.window_size,
                              shift, c.mlp_ratio, float(dpr[blk]), c.softmax_f32),
                )
                blk += 1
            if stage < len(c.depths) - 1:
                self.add_module(f"merge{stage}", PatchMerging(self.dims[stage], res))
                res = (res[0] // 2, res[1] // 2)
        self.norm = LayerNorm(self.dims[-1], 1e-5)
        number_dropout_sites(self)

    def forward(self, images: torch.Tensor, dropout_seed=None):
        c = self.cfg
        p = c.patch_size
        b, hh, ww, cin = images.shape
        h, w = hh // p, ww // p
        patches = images.reshape(b, h, p, w, p, cin).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_embed(patches.reshape(b, h * w, p * p * cin))
        if self.patch_norm is not None:
            x = self.patch_norm(x)
        hiddens = []
        remat = self.training and c.use_remat and torch.is_grad_enabled()
        for stage, depth in enumerate(c.depths):
            for i in range(depth):
                block = getattr(self, f"stage{stage}_block{i}")
                if remat:
                    x = checkpoint(block, x, dropout_seed, use_reentrant=False)
                else:
                    x = block(x, dropout_seed)
            res = self.stage_res[stage]
            hiddens.append(x.reshape(b, res[0], res[1], self.dims[stage]))
            if stage < len(c.depths) - 1:
                x = getattr(self, f"merge{stage}")(x)
        x = self.norm(x)
        res = self.stage_res[-1]
        hiddens[-1] = x.reshape(b, res[0], res[1], self.dims[-1])
        return x, hiddens
