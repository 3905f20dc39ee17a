"""Output heads: the pairwise bond (edge) head, its symmetrization, and the
training-only atom heatmap head.

Port of ``molnextr_tpu/models/heads.py``: ``GraphPredictor`` in its factored
form (``mlp1([a_i ; a_j]) == a_i @ W_row + a_j @ W_col + b``, so the
all-pairs tensor only exists at the GELU input), and ``AtomHeatmapHead``
with ``HEATMAP_ELEMENTS`` and ``heatmap_class_of``.  The heatmap head
upsamples the final map with ``F.interpolate(mode="nearest-exact")``, which
samples source ``floor((i + 0.5) * in / out)`` as ``jax.image.resize(...,
"nearest")`` does; ``mode="nearest"`` would sample ``floor(i * in / out)``.
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


# Element classes for the auxiliary atom heatmap (last slot = "other",
# covering superatom aliases, R-groups and rare elements).
HEATMAP_ELEMENTS = ("C", "N", "O", "S", "F", "Cl", "Br", "I", "P", "B", "Si")


def heatmap_class_of(symbol: str) -> int:
    """Map a graph node symbol (possibly bracketed, charged, aromatic or a
    superatom alias) onto a HEATMAP_ELEMENTS class; unknown -> len(list)."""
    s = symbol.strip("[]")
    i = 0  # strip isotope digits to reach the leading element token
    while i < len(s) and s[i].isdigit():
        i += 1
    s = s[i:]
    two, one = s[:2].capitalize(), s[:1].upper()
    for j, el in enumerate(HEATMAP_ELEMENTS):
        if len(el) == 2 and two == el:
            return j
    # a two-letter element not in the list (Na, Fe, Se, ...) is "other", not
    # its first letter's class
    if len(s) >= 2 and s[1].islower():
        return len(HEATMAP_ELEMENTS)
    for j, el in enumerate(HEATMAP_ELEMENTS):
        if len(el) == 1 and one == el:
            return j
    return len(HEATMAP_ELEMENTS)


class AtomHeatmapHead(nn.Module):
    """Per-cell [atom presence, element classes] logits over the stride-8
    map, with the final encoder map upsampled onto it as a second input."""

    def __init__(self, fine_dim: int, coarse_dim: int, hidden: int = 128):
        super().__init__()
        self.fine = Dense(fine_dim, hidden)
        self.coarse = Dense(coarse_dim, hidden)
        self.out = Dense(hidden, 1 + len(HEATMAP_ELEMENTS) + 1)

    def forward(self, fine: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
        """fine (B, G, G, Cf), coarse (B, g, g, Cc) -> (B, G, G, 13)."""
        g = fine.shape[1]
        up = F.interpolate(coarse.permute(0, 3, 1, 2), size=(g, g), mode="nearest-exact")
        y = self.fine(fine) + self.coarse(up.permute(0, 2, 3, 1))
        return self.out(F.gelu(y))


def symmetrize_edge_probs(prob: torch.Tensor) -> torch.Tensor:
    """Symmetrize (..., K, K, 7) probabilities: classes 0-4 average with
    the transpose, wedge (5) and dash (6) swap under it."""
    pt = prob.transpose(-2, -3)
    sym = (prob[..., :5] + pt[..., :5]) / 2
    w = (prob[..., 5] + pt[..., 6]) / 2
    d = (prob[..., 6] + pt[..., 5]) / 2
    return torch.cat([sym, w[..., None], d[..., None]], dim=-1)


def edge_prediction(prob: torch.Tensor):
    """The argmax class of (..., K, K, 7) edge probabilities after
    :func:`symmetrize_edge_probs`, and its probability."""
    sym = symmetrize_edge_probs(prob)
    best, cls = sym.max(dim=-1)
    return cls, best
