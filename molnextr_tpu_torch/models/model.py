"""Top-level model: Swin encoder + per-format decoders + edge head.

Port of ``molnextr_tpu/models/model.py::MolNexTRModel`` for inference:
``encode``, ``init_cache``, ``decode_step`` and ``predict_edges``.  Module
names follow the flax parameter tree (``decoders_<fmt>`` becomes
``decoders.<fmt>``), so ``weights.load_flax_params`` maps one to one.  No
heatmap head is built: it is a training-only head.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.models.decoder import Decoder
from molnextr_tpu_torch.models.heads import GraphPredictor
from molnextr_tpu_torch.models.layers import Dense, Embed
from molnextr_tpu_torch.models.swin import SwinEncoder

SEQ_FORMATS = ("atomtok", "atomtok_coords", "chartok_coords")


class MolNexTRModel(nn.Module):
    def __init__(self, cfg: Config, vocab_sizes: Dict[str, int]):
        super().__init__()
        self.cfg = cfg
        if not cfg.encoder.name.startswith("swin"):
            raise NotImplementedError(f"encoder {cfg.encoder.name}: only Swin is ported")
        self.encoder = SwinEncoder(cfg.encoder, cfg.data.input_size)
        self.enc_trans = Dense(cfg.encoder.num_features, cfg.decoder.hidden_size)
        self.enc_pos = Embed(144, cfg.encoder.num_features) if cfg.decoder.enc_pos_emb else None
        decoders = {}
        for fmt in cfg.data.formats:
            if fmt == "edges":
                continue
            if fmt not in SEQ_FORMATS:
                raise ValueError(f"unknown format {fmt}")
            decoders[fmt] = Decoder(cfg.decoder, vocab_sizes[fmt])
        self.decoders = nn.ModuleDict(decoders)
        self.edges_head = (
            GraphPredictor(cfg.decoder.hidden_size, coords=cfg.data.continuous_coords)
            if "edges" in cfg.data.formats else None
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.enc_trans.kernel.dtype

    def to_dtype(self, dtype: torch.dtype) -> "MolNexTRModel":
        """Cast every Dense and Embed to ``dtype``; LayerNorms and the Swin
        kernels' biases stay float32 (the flax ``dtype=`` policy)."""
        for m in self.modules():
            if isinstance(m, (Dense, Embed)):
                m.cast(dtype)
        return self

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) float -> memory bank (B, M, dec_hidden)."""
        feats, _ = self.encoder(images.to(self.dtype))
        if self.enc_pos is not None:
            pos = self.enc_pos.embedding[: feats.shape[1]]
            feats = feats + pos[None].to(feats.dtype)
        return self.enc_trans(feats)

    def init_cache(self, fmt: str, memory: torch.Tensor):
        return self.decoders[fmt].init_cache(memory)

    def decode_step(self, fmt: str, token: torch.Tensor, pos: int, cache):
        """-> (logits (B, V), hidden (B, D), cache updated in place)."""
        dec = self.decoders[fmt]
        hidden = dec.step(token, pos, cache)
        return dec.output(hidden), hidden, cache

    def predict_edges(self, hidden: torch.Tensor, indices: torch.Tensor):
        return self.edges_head(hidden, indices.clamp_min(0))
