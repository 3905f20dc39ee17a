"""Losses: label-smoothing sequence CE, the weighted 7-class edge CE and the
auxiliary heatmap loss.

Port of ``molnextr_tpu/train/losses.py``.  Every reduction is a mean over the
elements that are not ignored, and all loss math runs in float32 whatever
the dtype of the logits.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from molnextr_tpu_torch.tokenization import MASK_ID, PAD_ID

EDGE_IGNORE = -100
# "no bond" weighted 1, all six bond classes weighted 10
EDGE_CLASS_WEIGHTS = (1.0, 10.0, 10.0, 10.0, 10.0, 10.0, 10.0)


def _nll(logp: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return -torch.gather(logp, -1, targets[..., None])[..., 0]


def label_smoothing_ce(logits: torch.Tensor, targets: torch.Tensor, smoothing: float = 0.0,
                       ignore_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Smoothed cross entropy, mean over non-ignored targets.  logits
    (..., V); targets (...,) int; ignore_mask (...,) bool, True where the
    target must not contribute."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = _nll(logp, targets)
    if smoothing > 0.0:
        loss = (1.0 - smoothing) * nll + smoothing * -logp.mean(dim=-1)
    else:
        loss = nll
    if ignore_mask is not None:
        keep = (~ignore_mask).float()
        return (loss * keep).sum() / keep.sum().clamp_min(1.0)
    return loss.mean()


def sequence_loss(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.1) -> torch.Tensor:
    """Token CE of (B, T-1, V) teacher-forced logits against labels[:, 1:];
    PAD and MASK targets are ignored."""
    targets = labels[:, 1:]
    ignore = (targets == PAD_ID) | (targets == MASK_ID)
    safe = torch.where(ignore, torch.zeros_like(targets), targets)
    return label_smoothing_ce(logits, safe, smoothing, ignore)


def graph_loss(edge_logits: torch.Tensor, edge_targets: torch.Tensor,
               coords_pred: Optional[torch.Tensor] = None,
               coords_targets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Class-weighted CE over all atom pairs: edge_logits (B, 7, K, K),
    edge_targets (B, K, K) with EDGE_IGNORE padding; plus the masked mean L1
    of continuous coordinates when both are given."""
    logits = edge_logits.permute(0, 2, 3, 1)
    ignore = edge_targets == EDGE_IGNORE
    safe = torch.where(ignore, torch.zeros_like(edge_targets), edge_targets)
    nll = _nll(torch.log_softmax(logits.float(), dim=-1), safe)
    w = torch.tensor(EDGE_CLASS_WEIGHTS, device=logits.device)[safe]
    w = torch.where(ignore, torch.zeros_like(w), w)
    loss = (nll * w).sum() / w.sum().clamp_min(1.0)
    if coords_pred is not None and coords_targets is not None:
        cmask = (coords_targets >= 0).all(dim=-1, keepdim=True)
        l1 = (coords_pred.float() - coords_targets).abs() * cmask
        loss = loss + l1.sum() / (cmask.sum() * 2).clamp_min(1.0)
    return loss


def heatmap_loss(logits: torch.Tensor, grid: torch.Tensor,
                 pos_weight: float = 10.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense atom-detection loss over (B, G, G, 1 + C) logits against a
    (B, G, G) grid: -1 empty cell, -2 unlabeled sample (skipped), >= 0 an
    element class.  Returns (loss, presence recall)."""
    presence = logits[..., 0].float()
    classes = logits[..., 1:].float()
    known = grid != -2
    pos = grid >= 0
    target = pos.float()
    bce = presence.clamp_min(0) - presence * target + torch.log1p(torch.exp(-presence.abs()))
    w = torch.where(pos, pos_weight, 1.0) * known.float()
    loss = (bce * w).sum() / w.sum().clamp_min(1.0)
    safe = torch.where(pos, grid, torch.zeros_like(grid))
    nll = _nll(torch.log_softmax(classes, dim=-1), safe)
    posf = pos.float()
    loss = loss + (nll * posf).sum() / posf.sum().clamp_min(1.0)
    recall = ((presence > 0) & pos).sum() / pos.sum().clamp_min(1)
    return loss, recall


class Criterion:
    """Per-format losses and teacher-forced accuracies; call with the
    model's outputs and the refs -> (total, {name: value})."""

    def __init__(self, formats: Tuple[str, ...], label_smoothing: float = 0.1,
                 coord_vocab: Optional[Tuple[int, int, int, bool]] = None,
                 heatmap_weight: float = 0.0):
        """``coord_vocab`` = (offset, maxx, maxy, sep_xy) of the primary
        coordinate tokenizer; when given, argmax accuracy is reported per
        token class (symbols, x bins, y bins)."""
        self.formats = tuple(formats)
        self.smoothing = label_smoothing
        self.coord_vocab = coord_vocab
        self.heatmap_weight = heatmap_weight

    def _seq_accuracies(self, logits, labels) -> Dict[str, torch.Tensor]:
        off, maxx, _maxy, sep_xy = self.coord_vocab
        targets = labels[:, 1:]
        pred = logits.argmax(dim=-1)
        valid = (targets != PAD_ID) & (targets != MASK_ID)
        correct = (pred == targets) & valid

        def acc(mask):
            m = valid & mask
            return (correct & m).sum() / m.sum().clamp_min(1)

        if sep_xy:
            is_x = (targets >= off) & (targets < off + maxx)
            is_y = targets >= off + maxx
            return {"acc_sym": acc(~is_x & ~is_y), "acc_x": acc(is_x), "acc_y": acc(is_y)}
        is_coord = targets >= off
        return {"acc_sym": acc(~is_coord), "acc_xy": acc(is_coord)}

    @staticmethod
    def _edge_accuracies(edge_logits, edge_targets) -> Dict[str, torch.Tensor]:
        pred = edge_logits.permute(0, 2, 3, 1).argmax(dim=-1)
        valid = edge_targets != EDGE_IGNORE
        correct = (pred == edge_targets) & valid
        bond = valid & (edge_targets > 0)
        return {
            "acc_edge": (correct & valid).sum() / valid.sum().clamp_min(1),
            "acc_bond": (correct & bond).sum() / bond.sum().clamp_min(1),
        }

    def __call__(self, outputs: Dict[str, Any], refs: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        losses: Dict[str, torch.Tensor] = {}
        metrics: Dict[str, torch.Tensor] = {}
        for fmt in self.formats:
            if fmt == "edges":
                losses[fmt] = graph_loss(outputs["edges"], refs["edges"],
                                         outputs.get("coords"), refs.get("coords"))
                metrics.update(self._edge_accuracies(outputs["edges"], refs["edges"]))
            else:
                losses[fmt] = sequence_loss(outputs[fmt], refs[fmt], self.smoothing)
                if self.coord_vocab is not None and fmt.endswith("_coords"):
                    metrics.update(self._seq_accuracies(outputs[fmt], refs[fmt]))
        if self.heatmap_weight > 0 and "heatmap" in outputs and "atom_grid" in refs:
            hl, recall = heatmap_loss(outputs["heatmap"], refs["atom_grid"])
            losses["heatmap"] = self.heatmap_weight * hl
            metrics["acc_heat"] = recall
        total = sum(losses.values(), torch.zeros((), device=next(iter(losses.values())).device))
        return total, {**losses, **metrics}
