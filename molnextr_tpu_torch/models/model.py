"""Top-level model: Swin or ConvNeXt encoder + per-format decoders + edge
head.

Port of ``molnextr_tpu/models/model.py::MolNexTRModel``: the teacher-forced
``forward`` (the JAX ``__call__``, used for training and the eval loss) and
the inference helpers ``encode``, ``init_cache``, ``decode_step`` and
``predict_edges``.  Module names follow the flax parameter tree
(``decoders_<fmt>`` becomes ``decoders.<fmt>``), so ``weights.py`` maps one
to one.  The training-only ``heatmap_head`` is built when
``train.aux_heatmap_weight > 0``, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.models.convnext import ConvNeXtBlock, ConvNeXtEncoder
from molnextr_tpu_torch.models.decoder import Decoder
from molnextr_tpu_torch.models.heads import AtomHeatmapHead, GraphPredictor
from molnextr_tpu_torch.models.layers import Conv, Dense, Embed, number_dropout_sites
from molnextr_tpu_torch.models.swin import SwinEncoder
from molnextr_tpu_torch.tokenization import PAD_ID

SEQ_FORMATS = ("atomtok", "atomtok_coords", "chartok_coords")


class MolNexTRModel(nn.Module):
    def __init__(self, cfg: Config, vocab_sizes: Dict[str, int]):
        super().__init__()
        self.cfg = cfg
        self.vocab_sizes = dict(vocab_sizes)
        if cfg.encoder.name.startswith("swin"):
            self.encoder = SwinEncoder(cfg.encoder, cfg.data.input_size)
        elif cfg.encoder.name.startswith("convnext"):
            self.encoder = ConvNeXtEncoder(cfg.encoder, cfg.data.input_size)
        else:
            raise ValueError(f"unknown encoder {cfg.encoder.name}")
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
        self.heatmap_head = None
        if cfg.train.aux_heatmap_weight > 0:
            dims = self.encoder.dims
            self.heatmap_head = AtomHeatmapHead(dims[1] if len(dims) > 1 else dims[0], dims[-1])
        number_dropout_sites(self)

    @property
    def dtype(self) -> torch.dtype:
        return self.enc_trans.kernel.dtype

    def to_dtype(self, dtype: torch.dtype) -> "MolNexTRModel":
        """Cast every Dense, Embed and Conv (the ConvNeXt convolutions) and
        ConvNeXt's ``gamma`` to ``dtype``; LayerNorms and the Swin kernels'
        biases stay float32 (the flax ``dtype=`` policy)."""
        for m in self.modules():
            if isinstance(m, (Dense, Embed, Conv)):
                m.cast(dtype)
            elif isinstance(m, ConvNeXtBlock):
                m.gamma.data = m.gamma.data.to(dtype)
        return self

    def _memory(self, feats: torch.Tensor) -> torch.Tensor:
        if self.enc_pos is not None:
            pos = self.enc_pos.embedding[: feats.shape[1]]
            feats = feats + pos[None].to(feats.dtype)
        return self.enc_trans(feats)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) float -> memory bank (B, M, dec_hidden)."""
        feats, _ = self.encoder(images.to(self.dtype))
        return self._memory(feats)

    def forward(self, images: torch.Tensor, refs: Dict[str, torch.Tensor],
                dropout_seed=None) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward of every configured format: ``{fmt: logits
        (B, T-1, V)}``, ``"heatmap"`` (B, G, G, 13) when the head is built,
        and the edge head's ``"edges"`` (B, 7, K, K) (and ``"coords"``) on the
        hidden states of the last coordinate format.  ``refs[fmt]`` (B, T)
        holds label ids, ``refs["atom_indices"]`` (B, K) atom positions
        (-1 padded).  In training mode dropout draws its masks from
        ``dropout_seed``."""
        feats, hiddens = self.encoder(images.to(self.dtype), dropout_seed)
        memory = self._memory(feats)
        out: Dict[str, torch.Tensor] = {}
        if self.heatmap_head is not None:
            stride8 = hiddens[1] if len(hiddens) > 1 else hiddens[0]
            out["heatmap"] = self.heatmap_head(stride8, hiddens[-1])
        last_hidden = None
        for fmt, decoder in self.decoders.items():
            labels = refs[fmt]
            hidden = decoder(labels, memory, labels == PAD_ID, dropout_seed)
            out[fmt] = decoder.output(hidden)[:, :-1]
            if fmt in ("atomtok_coords", "chartok_coords"):
                last_hidden = hidden
        if self.edges_head is not None and last_hidden is not None:
            out.update(self.edges_head(last_hidden, refs["atom_indices"].clamp_min(0)))
        return out

    def init_cache(self, fmt: str, memory: torch.Tensor):
        return self.decoders[fmt].init_cache(memory)

    def decode_step(self, fmt: str, token: torch.Tensor, pos: int, cache):
        """-> (logits (B, V), hidden (B, D), cache updated in place)."""
        dec = self.decoders[fmt]
        hidden = dec.step(token, pos, cache)
        return dec.output(hidden), hidden, cache

    def predict_edges(self, hidden: torch.Tensor, indices: torch.Tensor):
        return self.edges_head(hidden, indices.clamp_min(0))
