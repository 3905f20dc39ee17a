"""Molecule rasterizer: Mol + 2D coords -> training image.

The renderer side of the synthetic data engine, replacing Indigo's native
``renderToBuffer`` (`MolNexTR/indigo/renderer.py:25-113`,
consumed at `dataset.py:318-319`).  Port of ``molnextr_tpu/chem/render.py``
without OpenCV: it draws with the numpy primitives of
:mod:`molnextr_tpu_torch.chem.raster`, which give the same pixels as the
OpenCV calls of the JAX package.  It draws:

* single/double/triple bonds with proper parallel offsets,
* aromatic rings with an inner dashed circle or alternating double bonds,
* solid wedges (filled triangles) and dashed wedges (hash marks),
* atom labels with H counts, charges and superatom alias text,
* style jitter matching the reference's rendering-option randomization
  (`dataset.py:213-236`): line thickness, font scale, label visibility,
  optional atom indices, colors.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from molnextr_tpu_torch.chem import raster
from molnextr_tpu_torch.chem.mol import (
    AROMATIC, DASH_BEGIN, DOUBLE, SINGLE, TRIPLE, WEDGE_BEGIN, Mol,
)

# OpenCV's Hershey font ids, in the JAX package's order (the style draw
# picks by position): SIMPLEX, DUPLEX, COMPLEX, TRIPLEX, PLAIN
FONT_SIMPLEX = 0
FONTS = [FONT_SIMPLEX, 2, 3, 4, 1]


class RenderOptions:
    """Style jitter (`dataset.py:213-236`)."""

    def __init__(self, rng: Optional[random.Random] = None, jitter: bool = True):
        r = rng or random
        self.size = 384
        self.pad = 30
        self.thickness = r.choice([1, 2, 3]) if jitter else 2
        self.font = r.choice(FONTS) if jitter else FONT_SIMPLEX
        self.font_scale = r.uniform(0.45, 0.8) if jitter else 0.6
        self.show_carbon = (r.random() < 0.05) if jitter else False
        self.show_atom_numbers = (r.random() < 0.05) if jitter else False
        self.implicit_h = (r.random() < 0.9) if jitter else True
        self.color = (0, 0, 0)
        if jitter and r.random() < 0.05:
            self.color = r.choice([(60, 60, 60), (0, 0, 128), (128, 0, 0)])
        self.double_gap = r.uniform(0.10, 0.16) if jitter else 0.13
        self.label_margin = r.uniform(0.22, 0.32) if jitter else 0.27


def _scale_coords(
    coords: List[Tuple[float, float]], size: int, pad: int
) -> np.ndarray:
    pts = np.asarray(coords, np.float64)
    if len(pts) == 0:
        return pts
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    scale = (size - 2 * pad) / span.max()
    # cap the bond length in pixels so single atoms aren't huge
    scale = min(scale, (size - 2 * pad) / 2.0)
    out = (pts - (lo + hi) / 2) * scale
    out[:, 1] *= -1  # molecule y up -> image y down
    out += size / 2
    return out


def _atom_label(mol: Mol, idx: int, opts: RenderOptions) -> str:
    atom = mol.atoms[idx]
    if atom.alias:
        return atom.alias
    sym = atom.symbol
    if sym == "C" and not opts.show_carbon and mol.degree(idx) > 0 and not atom.charge and not atom.isotope:
        return ""
    label = sym
    if opts.implicit_h and sym != "C":
        h = mol.total_h(idx)
        if h == 1:
            label += "H"
        elif h > 1:
            label += f"H{h}"
    if atom.charge == 1:
        label += "+"
    elif atom.charge == -1:
        label += "-"
    elif atom.charge > 1:
        label += f"{atom.charge}+"
    elif atom.charge < -1:
        label += f"{-atom.charge}-"
    if atom.isotope:
        label = f"{atom.isotope}{label}"
    return label


def _shorten(p1: np.ndarray, p2: np.ndarray, t1: float, t2: float):
    """Pull both ends toward the middle by t1/t2 fractions."""
    d = p2 - p1
    return p1 + d * t1, p2 - d * t2


def render(
    mol: Mol,
    size: int = 384,
    opts: Optional[RenderOptions] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rasterize; returns (image uint8 HxWx3, pixel_coords Nx2 float)."""
    opts = opts or RenderOptions(jitter=False)
    opts.size = size
    img = np.full((size, size, 3), 255, np.uint8)
    n = mol.num_atoms()
    if n == 0:
        return img, np.zeros((0, 2))
    if not mol.coords or len(mol.coords) != n:
        from molnextr_tpu_torch.chem.layout import layout

        layout(mol)
    pix = _scale_coords(mol.coords, size, opts.pad)
    labels = [_atom_label(mol, i, opts) for i in range(n)]
    bond_px = np.median(
        [np.linalg.norm(pix[b.a1] - pix[b.a2]) for b in mol.iter_bonds()]
    ) if any(True for _ in mol.iter_bonds()) else size / 4

    ring_bonds = set()
    rings = mol.ring_info()
    for ring in rings:
        m = len(ring)
        for i in range(m):
            a, b = ring[i], ring[(i + 1) % m]
            ring_bonds.add((min(a, b), max(a, b)))
    ring_center: Dict[Tuple[int, int], np.ndarray] = {}
    for ring in rings:
        c = pix[ring].mean(axis=0)
        m = len(ring)
        for i in range(m):
            a, b = ring[i], ring[(i + 1) % m]
            ring_center.setdefault((min(a, b), max(a, b)), c)

    def margin(i: int) -> float:
        return opts.label_margin if labels[i] else 0.02

    for bond in mol.iter_bonds():
        a, b = bond.a1, bond.a2
        p1, p2 = pix[a].copy(), pix[b].copy()
        p1s, p2s = _shorten(p1, p2, margin(a), margin(b))
        d = p2 - p1
        ln = np.linalg.norm(d)
        if ln < 1e-6:
            continue
        u = d / ln
        perp = np.array([-u[1], u[0]])
        gap = opts.double_gap * bond_px
        col = opts.color
        th = opts.thickness

        def line(q1, q2, thickness=th):
            raster.line(
                img, tuple(np.round(q1).astype(int)), tuple(np.round(q2).astype(int)),
                col, thickness,
            )

        if bond.wedge == WEDGE_BEGIN:
            # filled triangle: narrow at a1, wide at a2
            w = gap * 1.2
            tri = np.array(
                [p1s, p2s + perp * w, p2s - perp * w], np.int32
            )
            raster.fill_poly(img, np.round(tri).astype(np.int32), col)
        elif bond.wedge == DASH_BEGIN:
            steps = 6
            for k in range(1, steps + 1):
                t = k / steps
                q = p1s + (p2s - p1s) * t
                w = gap * 1.2 * t
                line(q + perp * w, q - perp * w, 1)
        elif bond.order == SINGLE:
            line(p1s, p2s)
        elif bond.order in (DOUBLE, AROMATIC):
            key = (min(a, b), max(a, b))
            if key in ring_center:
                # inner line offset toward the ring center
                c = ring_center[key]
                side = perp if np.dot(perp, c - (p1 + p2) / 2) > 0 else -perp
                line(p1s, p2s)
                q1, q2 = _shorten(p1 + side * gap, p2 + side * gap, 0.18, 0.18)
                if bond.order == AROMATIC:
                    # dashed inner line for aromatic
                    segs = 4
                    for k in range(segs):
                        t0, t1 = k / segs, (k + 0.6) / segs
                        line(q1 + (q2 - q1) * t0, q1 + (q2 - q1) * t1, 1)
                else:
                    line(q1, q2)
            else:
                line(p1s + perp * gap / 2, p2s + perp * gap / 2)
                line(p1s - perp * gap / 2, p2s - perp * gap / 2)
        elif bond.order == TRIPLE:
            line(p1s, p2s)
            line(p1s + perp * gap, p2s + perp * gap)
            line(p1s - perp * gap, p2s - perp * gap)

    for i in range(n):
        label = labels[i]
        if opts.show_atom_numbers:
            label = label + str(i) if label else str(i)
        if not label:
            continue
        tw, th_px = raster.text_size(label, opts.font, opts.font_scale, 1)
        org = (int(pix[i][0] - tw / 2), int(pix[i][1] + th_px / 2))
        # white backing so bonds don't cross the text
        raster.fill_rect(
            img,
            (org[0] - 2, org[1] - th_px - 2),
            (org[0] + tw + 2, org[1] + 3),
            (255, 255, 255),
        )
        raster.put_text(img, label, org, opts.font, opts.font_scale, opts.color)

    return img, pix.astype(np.float32)
