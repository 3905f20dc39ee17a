"""Inference engine: batched encode -> constrained decode -> edges.

Port of ``molnextr_tpu/inference.py::InferenceEngine``: greedy decoding, or
beam search when ``cfg.decode.beam_size > 1``, with the ``n_best`` list in
``pred["beams"]`` when ``cfg.decode.n_best > 1``.  The device path is
encode, decode and the edge head (on the best beam's hidden states);
sequence -> SMILES and graph assembly stay on the host.

The engine owns the module it is given: it moves it to its device and puts
it in eval mode.  ``load_params`` and ``predict_images_raw(params=...)``
copy another module's parameters (a training module's float32 masters)
into it, casting to its dtype, so one engine serves every epoch of a
training run without touching the training module.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.data.transforms import device_normalize
from molnextr_tpu_torch.decoding.beam import beam_decode
from molnextr_tpu_torch.decoding.greedy import greedy_decode
from molnextr_tpu_torch.models.heads import symmetrize_edge_probs
from molnextr_tpu_torch.models.model import MolNexTRModel
from molnextr_tpu_torch.utils import FORMAT_INFO


def primary_format(cfg: Config) -> str:
    for fmt in cfg.data.formats:
        if fmt in ("chartok_coords", "atomtok_coords", "atomtok"):
            return fmt
    raise ValueError("no sequence format configured")


def resolve_device(device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU.
    A CUDA device must exist and be compute capability 9.x (Hopper), where
    the kernels are built for; nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    major, minor = torch.cuda.get_device_capability(dev)
    if major != 9:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} is compute capability {major}.{minor}; "
            "the kernels are built for sm_90a (Hopper)"
        )
    return dev


class InferenceEngine:
    """Owns the model on its device and the host-side assembly.  With
    ``pad_batch`` (the default) a batch is padded to the next power of two,
    as the JAX engine pads it to bound its recompilations; without it the
    encoder, the decoder and the edge head run on the batch's own rows.
    The port compiles nothing per batch size: the switch is here so the
    engine takes the JAX engine's arguments, and goes if the padding does."""

    def __init__(self, cfg: Config, tokenizers: Dict[str, Any], model: MolNexTRModel,
                 device="cuda", pad_batch: bool = True):
        self.cfg = cfg
        self.pad_batch = pad_batch
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.fmt = primary_format(cfg)
        self.tokenizer = tokenizers[self.fmt]
        self.max_len = min(FORMAT_INFO[self.fmt]["max_len"], cfg.decoder.max_len)
        self.max_atoms = cfg.data.max_atoms
        tc, cm = self.tokenizer.constraint_tables()
        self._token_class = torch.as_tensor(tc, dtype=torch.long, device=self.device)
        self._class_mask = torch.as_tensor(cm, dtype=torch.bool, device=self.device)
        self._use_constraint = bool(self.tokenizer.output_constraint)

    # -- device functions -------------------------------------------------
    @torch.no_grad()
    def decode(self, images: np.ndarray, min_len=None):
        """uint8 (B, H, W, 1|3) or normalized float32 (B, H, W, 3) images
        -> (seq, avg_scores, token_scores, hiddens) on the device, plus
        (all_seq, all_scores) for a beam search with ``n_best > 1``."""
        x = torch.as_tensor(images, device=self.device)
        if x.dtype == torch.uint8:
            x = device_normalize(x)
        model = self.model
        memory = model.encode(x)
        fmt = self.fmt
        dcfg = self.cfg.decode
        args = (
            lambda tok, pos, cache: model.decode_step(fmt, tok, pos, cache),
            lambda mem: model.init_cache(fmt, mem),
            memory,
            self._token_class,
            self._class_mask,
            self.max_len,
            self.cfg.decoder.hidden_size,
        )
        kwargs = dict(
            min_len=dcfg.min_length if min_len is None else min_len,
            use_constraint=self._use_constraint,
            unroll=dcfg.unroll,
        )
        if dcfg.beam_size > 1:
            return beam_decode(*args, beam_size=dcfg.beam_size,
                               return_all=dcfg.n_best > 1, **kwargs)
        return greedy_decode(*args, **kwargs)

    @torch.no_grad()
    def edges(self, hiddens: torch.Tensor, indices: torch.Tensor):
        """-> (argmax class, its probability), each (B, K, K), after the
        wedge/dash-aware symmetrization."""
        logits = self.model.predict_edges(hiddens, indices)["edges"].permute(0, 2, 3, 1)
        sym = symmetrize_edge_probs(torch.softmax(logits.float(), dim=-1))
        return sym.argmax(dim=-1), sym.amax(dim=-1)

    @torch.no_grad()
    def load_params(self, source: Union[nn.Module, Mapping[str, torch.Tensor]]) -> None:
        """Copy the parameters of ``source`` (a module with this model's
        parameter names, or a name -> tensor mapping) into the engine's
        module, each cast to the engine parameter's dtype and device."""
        named = dict(source.named_parameters()) if isinstance(source, nn.Module) else source
        own = dict(self.model.named_parameters())
        missing = sorted(set(own) - set(named))
        if missing:
            raise KeyError(f"load_params: missing {missing[:8]}")
        for name, p in own.items():
            p.copy_(named[name])

    # -- host orchestration ----------------------------------------------
    def predict_images_raw(self, images: np.ndarray, params: Optional[
            Union[nn.Module, Mapping[str, torch.Tensor]]] = None) -> Dict[str, np.ndarray]:
        """Numeric prediction: token ids ``seq`` (B, max_len) and, with the
        edges format, the edge classes ``edges`` (B, K, K).  ``params``, when
        given, is copied in first (:meth:`load_params`)."""
        if params is not None:
            self.load_params(params)
        n = images.shape[0]
        images = self._pad_to_pow2(images)
        seq_d, _, _, hiddens = self.decode(images)[:4]
        seq = seq_d.cpu().numpy()[:n]
        result: Dict[str, np.ndarray] = {"seq": seq}
        if "edges" in self.cfg.data.formats:
            indices = np.zeros((hiddens.shape[0], self.max_atoms), np.int64)
            for i in range(n):
                parsed = self.tokenizer.sequence_to_smiles(seq[i].tolist())
                k = min(len(parsed["indices"]), self.max_atoms)
                indices[i, :k] = np.asarray(parsed["indices"][:k], np.int64)
            cls, _ = self.edges(hiddens, torch.as_tensor(indices, device=self.device))
            result["edges"] = cls.cpu().numpy()[:n].astype(np.int32)
        return result

    def _pad_to_pow2(self, images: np.ndarray) -> np.ndarray:
        """Repeat the last image up to the next power of two, as the JAX
        engine does to bound its recompilations (not without ``pad_batch``)."""
        if not self.pad_batch:
            return images
        n = images.shape[0]
        target = 1
        while target < n:
            target *= 2
        if target == n:
            return images
        pad = np.repeat(images[-1:], target - n, axis=0)
        return np.concatenate([images, pad], axis=0)

    def predict_images(self, images: np.ndarray, compute_confidence: bool = False
                       ) -> List[Dict[str, Any]]:
        """images: uint8 (B, H, W, 1|3) or normalized float32 (B, H, W, 3)."""
        n = images.shape[0]
        images = self._pad_to_pow2(images)
        out = self.decode(images)
        seq_d, avg_d, tok_d, hiddens = out[:4]
        all_seq = out[4].cpu().numpy()[:n] if len(out) > 4 else None
        all_scores = out[5].cpu().numpy()[:n] if len(out) > 4 else None
        seq = seq_d.cpu().numpy()[:n]
        avg_scores = avg_d.cpu().numpy()[:n]
        token_scores = tok_d.cpu().numpy()[:n]

        predictions: List[Dict[str, Any]] = []
        batch_indices = np.zeros((hiddens.shape[0], self.max_atoms), dtype=np.int64)
        for i in range(n):
            parsed = self.tokenizer.sequence_to_smiles(seq[i].tolist())
            k = min(len(parsed["indices"]), self.max_atoms)
            batch_indices[i, :k] = np.asarray(parsed["indices"][:k], dtype=np.int64)
            pred = {self.fmt: parsed}
            if compute_confidence:
                pred[self.fmt]["atom_scores"] = self._atom_scores(parsed, token_scores[i])
                pred[self.fmt]["average_token_score"] = float(avg_scores[i])
            if all_seq is not None:
                pred["beams"] = [
                    {"smiles": self.tokenizer.sequence_to_smiles(all_seq[i, j].tolist())["smiles"],
                     "score": float(all_scores[i, j])}
                    for j in range(min(self.cfg.decode.n_best, all_seq.shape[1]))
                ]
            predictions.append(pred)

        if "edges" in self.cfg.data.formats:
            pred_d, score_d = self.edges(hiddens, torch.as_tensor(batch_indices, device=self.device))
            edge_pred = pred_d.cpu().numpy()[:n]
            edge_score = score_d.cpu().numpy()[:n]
            for i, pred in enumerate(predictions):
                k = min(len(pred[self.fmt]["indices"]), self.max_atoms)
                pred["edges"] = edge_pred[i, :k, :k].tolist()
                if compute_confidence:
                    es = edge_score[i, :k, :k]
                    pred["edge_scores"] = es.tolist()
                    prod = float(np.sqrt(np.prod(np.clip(es, 1e-12, 1.0))))
                    pred["overall_score"] = pred[self.fmt]["average_token_score"] * prod
        return predictions

    def _atom_scores(self, parsed: Dict[str, Any], token_scores: np.ndarray) -> List[float]:
        """Per-atom confidence: geometric mean of the symbol characters'
        scores for chartok, the symbol token's score otherwise."""
        scores = np.exp(token_scores)
        out = []
        for symbol, index in zip(parsed["symbols"], parsed["indices"]):
            idx = index - 3
            if self.fmt == "chartok_coords":
                lo = max(idx - len(symbol) + 1, 0)
                seg = scores[lo: idx + 1]
                out.append(float(np.prod(seg) ** (1.0 / max(len(seg), 1))))
            else:
                out.append(float(scores[idx]))
        return out
