"""Autoregressive transformer decoder.

Port of ``molnextr_tpu/models/decoder.py::Decoder``: pre-norm layers of
[LN -> masked self-attention -> +res], [LN -> cross-attention over the
encoder memory], [pre-norm GELU FFN with its own residual], and a final
LayerNorm (eps 1e-6 throughout).  Word embeddings are scaled by sqrt(dim)
and summed with the sinusoidal table of length ``max_len + 8``.

The flax layers are ``nn.scan``-stacked; here they are a ``ModuleList``
(``weights.py`` unstacks the leading ``L`` axis).  Each attention keeps
its q/k/v projections as one ``(D, 3D)`` Dense, the concatenation the JAX
``project_qkv`` builds per step; cross attention uses its q and kv column
blocks.

The teacher-forced ``forward`` is the training path too: in training mode
it applies the JAX decoder's dropout sites (the embedding, each attention's
probabilities, the two residual branches of a layer and the two inside the
FFN; ``hidden_dropout``/``attn_dropout``) as seeded masks
(``layers.Dropout``), and with ``use_remat`` it checkpoints each layer.

With ``use_flash_attention`` a layer's self-attention goes through
``ops.flash_attention`` (K7, and K8 and K9 in the backward) wherever the
JAX package's ``MHA._can_flash`` would send it to JAX's library flash
kernel: attention dropout inactive (eval mode, no ``dropout_seed``, or
``attn_dropout`` 0), ``T`` a multiple of 128, ``MOLNEXTR_NO_FLASH`` unset,
and the tensors on the card (:func:`flash_device`, the counterpart of the
JAX package's TPU backend; on the CPU the route is not taken).  As in the
JAX package the route is causal only and drops the padding mask: PAD only
follows EOS, so a real query never sees a PAD key, and only PAD query
rows, whose loss is ignored, come out otherwise.

Decode caches (``init_cache``): the self cache is ``(L, B, H, T, hd)`` with
``T = max_len`` rounded up to a multiple of 128, int8 with per-token f32
scales ``(L, B, H, T, 1)`` when ``kv_int8`` (the default) or in the model
dtype; the cross cache is head-folded ``(L, B, M, H*hd)``, int8 with one
scale per memory position when ``kv_int8``.  ``step`` writes the new K/V
row into the cache **in place** and returns the same dict.  Unlike the JAX
decode, which grows the self cache 128 -> T in phases, the port keeps one
T-long buffer: K3 never reads past ``pos``, and masked positions contribute
exactly 0 to the reference softmax, so the results are the same.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from molnextr_tpu_torch.config import DecoderConfig
from torch.utils.checkpoint import checkpoint

from molnextr_tpu_torch.models.layers import Dense, Dropout, Embed, LayerNorm, number_dropout_sites
from molnextr_tpu_torch.ops.decode_attention import (
    cross_decode_attention_folded,
    cross_decode_attention_folded_q8,
    decode_attention_layered,
    decode_attention_layered_q8,
    quantize_per_token,
)
from molnextr_tpu_torch.ops.flash_attention import flash_attention

FLASH_MIN_T = 128  # the JAX package's _can_flash: T a multiple of 128, at least 128


def flash_device(x: torch.Tensor) -> bool:
    """The flash route's device condition: a CUDA tensor, as the JAX
    package's is ``jax.default_backend() == "tpu"``."""
    return x.is_cuda


def sinusoidal_positions(max_len: int, dim: int) -> np.ndarray:
    pe = np.zeros((max_len, dim), dtype=np.float32)
    position = np.arange(max_len)[:, None].astype(np.float32)
    div = np.exp(np.arange(0, dim, 2).astype(np.float32) * -(np.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


class MHA(nn.Module):
    def __init__(self, heads: int, hidden: int, dropout: float = 0.0):
        super().__init__()
        self.heads, self.hidden = heads, hidden
        self.qkv = Dense(hidden, 3 * hidden)
        self.out = Dense(hidden, hidden)
        self.attn_drop = Dropout(dropout)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> (B, H, T, hd)."""
        b, t, _ = x.shape
        return x.reshape(b, t, self.heads, self.hidden // self.heads).transpose(1, 2)

    def project_q(self, x):
        d = self.hidden
        return x.to(self.qkv.kernel.dtype) @ self.qkv.kernel[:, :d] + self.qkv.bias[:d]

    def project_kv(self, x):
        d = self.hidden
        y = x.to(self.qkv.kernel.dtype) @ self.qkv.kernel[:, d:] + self.qkv.bias[d:]
        return y[..., :d], y[..., d:]

    def attend(self, q, k, v, mask: Optional[torch.Tensor], dropout_seed=None):
        """Teacher-forced attention; q/k/v (B, H, T, hd), mask True = masked."""
        hd = self.hidden // self.heads
        scores = (q @ k.transpose(-1, -2)) / torch.tensor(math.sqrt(hd), dtype=q.dtype)
        if mask is not None:
            scores = scores.masked_fill(mask, -1e9)
        probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        probs = self.attn_drop(probs, dropout_seed)
        ctx = (probs @ v).transpose(1, 2)
        return self.out(ctx.reshape(ctx.shape[0], ctx.shape[1], self.hidden))


class FeedForward(nn.Module):
    def __init__(self, hidden: int, ffn: int, dropout: float = 0.0):
        super().__init__()
        self.ln = LayerNorm(hidden, 1e-6)
        self.w1 = Dense(hidden, ffn)
        self.w2 = Dense(ffn, hidden)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)

    def forward(self, x, dropout_seed=None):
        y = self.drop1(F.gelu(self.w1(self.ln(x))), dropout_seed)
        return self.drop2(self.w2(y), dropout_seed) + x


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        d = cfg.hidden_size
        self.ln1 = LayerNorm(d, 1e-6)
        self.self_attn = MHA(cfg.attn_heads, d, cfg.attn_dropout)
        self.ln2 = LayerNorm(d, 1e-6)
        self.cross_attn = MHA(cfg.attn_heads, d, cfg.attn_dropout)
        self.ffn = FeedForward(d, d * cfg.ffn_mult, cfg.hidden_dropout)
        self.drop1 = Dropout(cfg.hidden_dropout)
        self.drop2 = Dropout(cfg.hidden_dropout)
        self.use_flash_attention = cfg.use_flash_attention

    def can_flash(self, x: torch.Tensor, dropout_seed) -> bool:
        """Whether the self-attention of ``x`` (B, T, D) takes the flash
        route: the JAX package's ``MHA._can_flash`` in the port's terms."""
        drop = self.self_attn.attn_drop
        if self.training and drop.rate > 0 and dropout_seed is not None:
            return False  # the kernels have no attention-dropout path
        t = x.shape[1]
        if t < FLASH_MIN_T or t % FLASH_MIN_T:
            return False
        if os.environ.get("MOLNEXTR_NO_FLASH"):
            return False
        return flash_device(x)

    def forward(self, x, memory, self_mask, dropout_seed=None):
        d = self.self_attn.hidden
        qkv = self.self_attn.qkv(self.ln1(x))
        sa = self.self_attn
        q, k, v = sa.split(qkv[..., :d]), sa.split(qkv[..., d:2 * d]), sa.split(qkv[..., 2 * d:])
        if self.use_flash_attention and self.can_flash(x, dropout_seed):
            # causal only: the padding mask is dropped, as in the JAX package
            ctx = flash_attention(q, k, v, causal=True, sm_scale=(d // sa.heads) ** -0.5)
            q = sa.out(ctx.transpose(1, 2).reshape(x.shape[0], x.shape[1], d))
        else:
            q = sa.attend(q, k, v, self_mask, dropout_seed)
        q = self.drop1(q, dropout_seed) + x
        ca = self.cross_attn
        mk, mv = ca.project_kv(memory)
        mid = ca.attend(ca.split(ca.project_q(self.ln2(q))), ca.split(mk), ca.split(mv), None,
                        dropout_seed)
        return self.ffn(self.drop2(mid, dropout_seed) + q, dropout_seed)

    def cached_step(self, x, cache, layer: int, pos: int, int8: bool):
        """One token (B, 1, D) against the caches; updates them in place."""
        sa, ca = self.self_attn, self.cross_attn
        b = x.shape[0]
        d, h = sa.hidden, sa.heads
        y = sa.qkv(self.ln1(x))[:, 0]  # (B, 3D)
        # K3 takes contiguous operands; the column blocks of y are strided views
        q, k_new, v_new = (t.reshape(b, h, d // h).contiguous() for t in y.split(d, dim=-1))
        if int8:
            k_q, k_s = quantize_per_token(k_new)
            v_q, v_s = quantize_per_token(v_new)
            cache["self_k"][layer, :, :, pos] = k_q
            cache["self_k_scale"][layer, :, :, pos] = k_s
            cache["self_v"][layer, :, :, pos] = v_q
            cache["self_v_scale"][layer, :, :, pos] = v_s
            ctx = decode_attention_layered_q8(
                q, cache["self_k"], cache["self_k_scale"],
                cache["self_v"], cache["self_v_scale"], pos, layer,
            )
        else:
            cache["self_k"][layer, :, :, pos] = k_new
            cache["self_v"][layer, :, :, pos] = v_new
            ctx = decode_attention_layered(q, cache["self_k"], cache["self_v"], pos, layer)
        q_res = sa.out(ctx.reshape(b, 1, d)) + x
        qq = ca.project_q(self.ln2(q_res)).reshape(b, h, d // h)
        if int8:
            cross = cross_decode_attention_folded_q8(
                qq, cache["mem_k"], cache["mem_k_scale"],
                cache["mem_v"], cache["mem_v_scale"], layer, h,
            )
        else:
            cross = cross_decode_attention_folded(qq, cache["mem_k"], cache["mem_v"], layer, h)
        mid = ca.out(cross.reshape(b, 1, d))
        return self.ffn(mid + q_res)


class Decoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, vocab_size: int):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.embed = Embed(vocab_size, d)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_positions(cfg.max_len + 8, d)), persistent=False
        )
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(d, 1e-6)
        self.emb_drop = Dropout(cfg.hidden_dropout)
        self.output = Dense(d, vocab_size)
        number_dropout_sites(self)

    def embed_tokens(self, tokens: torch.Tensor, start_pos: int) -> torch.Tensor:
        emb = self.embed(tokens)
        emb = emb * torch.tensor(math.sqrt(self.cfg.hidden_size), dtype=emb.dtype)
        pe = self.pe[start_pos : start_pos + tokens.shape[1]]
        return emb + pe.to(emb.dtype)[None]

    def forward(self, tokens, memory, pad_mask: Optional[torch.Tensor] = None,
                dropout_seed=None):
        """Teacher-forced: tokens (B, T), memory (B, M, D), pad_mask (B, T)
        True at padding.  Returns final hidden states (B, T, D)."""
        t = tokens.shape[1]
        x = self.emb_drop(self.embed_tokens(tokens, 0), dropout_seed)
        mask = torch.triu(torch.ones(t, t, dtype=torch.bool, device=tokens.device), 1)[None, None]
        if pad_mask is not None:
            mask = mask | pad_mask[:, None, None, :]
        remat = self.training and self.cfg.use_remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, memory, mask, dropout_seed, use_reentrant=False)
            else:
                x = layer(x, memory, mask, dropout_seed)
        return self.final_ln(x)

    def init_cache(self, memory: torch.Tensor) -> Dict[str, torch.Tensor]:
        c = self.cfg
        b = memory.shape[0]
        h = c.attn_heads
        hd = c.hidden_size // h
        kv = [layer.cross_attn.project_kv(memory) for layer in self.layers]
        mem_k = torch.stack([k for k, _ in kv])  # (L, B, M, H*hd)
        mem_v = torch.stack([v for _, v in kv])
        t_cache = ((c.max_len + 127) // 128) * 128
        shape = (c.num_layers, b, h, t_cache, hd)
        dev = memory.device
        if c.kv_int8:
            mem_k, mem_k_scale = quantize_per_token(mem_k)
            mem_v, mem_v_scale = quantize_per_token(mem_v)
            return {
                "self_k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "self_k_scale": torch.zeros(shape[:-1] + (1,), device=dev),
                "self_v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "self_v_scale": torch.zeros(shape[:-1] + (1,), device=dev),
                "mem_k": mem_k,
                "mem_k_scale": mem_k_scale,
                "mem_v": mem_v,
                "mem_v_scale": mem_v_scale,
            }
        return {
            "self_k": torch.zeros(shape, dtype=memory.dtype, device=dev),
            "self_v": torch.zeros(shape, dtype=memory.dtype, device=dev),
            "mem_k": mem_k,
            "mem_v": mem_v,
        }

    def step(self, token: torch.Tensor, pos: int, cache: Dict[str, torch.Tensor]):
        """token (B,) at position ``pos`` -> final-LN hidden (B, D); the
        cache is updated in place."""
        x = self.embed_tokens(token[:, None], pos)
        int8 = "self_k_scale" in cache
        for i, layer in enumerate(self.layers):
            x = layer.cached_step(x, cache, i, pos, int8)
        return self.final_ln(x)[:, 0]
