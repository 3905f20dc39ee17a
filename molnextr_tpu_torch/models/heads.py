"""The pairwise bond (edge) head and the symmetrization of its output.

Port of ``molnextr_tpu/models/heads.py::GraphPredictor`` in its factored
form: ``mlp1([a_i ; a_j]) == a_i @ W_row + a_j @ W_col + b``, so the
all-pairs tensor only exists at the GELU input.  The training-only
``AtomHeatmapHead`` is not ported.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from molnextr_tpu_torch.models.layers import Dense


class GraphPredictor(nn.Module):
    def __init__(self, hidden: int, coords: bool = False):
        super().__init__()
        self.mlp1_row = Dense(hidden, hidden)
        self.mlp1_col = Dense(hidden, hidden, use_bias=False)
        self.mlp2 = Dense(hidden, 7)
        self.coords = coords
        if coords:
            self.coords1 = Dense(hidden, hidden)
            self.coords2 = Dense(hidden, 2)

    def forward(self, hidden_states: torch.Tensor, indices: torch.Tensor) -> Dict[str, torch.Tensor]:
        """hidden_states (B, T, D), indices (B, K) -> ``edges`` logits
        (B, 7, K, K) and, with ``coords``, ``coords`` (B, K, 2)."""
        t = hidden_states.shape[1]
        idx = indices.clamp(0, t - 1).long()
        gathered = torch.gather(
            hidden_states, 1, idx[..., None].expand(-1, -1, hidden_states.shape[-1])
        )
        row = self.mlp1_row(gathered)
        col = self.mlp1_col(gathered)
        y = F.gelu(row[:, :, None, :] + col[:, None, :, :])
        out = {"edges": self.mlp2(y).permute(0, 3, 1, 2)}
        if self.coords:
            out["coords"] = self.coords2(F.gelu(self.coords1(gathered)))
        return out


def symmetrize_edge_probs(prob: torch.Tensor) -> torch.Tensor:
    """Symmetrize (..., K, K, 7) probabilities: classes 0-4 average with
    the transpose, wedge (5) and dash (6) swap under it."""
    pt = prob.transpose(-2, -3)
    sym = (prob[..., :5] + pt[..., :5]) / 2
    w = (prob[..., 5] + pt[..., 6]) / 2
    d = (prob[..., 6] + pt[..., 5]) / 2
    return torch.cat([sym, w[..., None], d[..., None]], dim=-1)
