"""Stereochemistry perception.

Covers the two reference code paths:

* parse-time: directional-bond (``/`` ``\\``) -> double-bond cis/trans specs,
  the information RDKit keeps as bond stereo.
* graph-time: 2D coordinates + wedge/dash bonds -> tetrahedral tags and
  double-bond stereo, replacing ``_verify_chirality``
  (`MolNexTR/chemical.py:212-287`), which routes through
  RDKit's ``AssignStereochemistryFrom3D`` / ``AssignChiralTypesFromBondDirs``.

Conventions
-----------
Tetrahedral parity: ``CHI_CCW`` (``@``) means that, looking from the first
neighbor in ``atom.chiral_order`` toward the center, the remaining neighbors
appear counterclockwise.  Numerically: with pseudo-3D positions (wedge z=+1
toward viewer, dash z=-1, y axis pointing *up*), signed volume
``V = (p2-p1) . ((p3-p1) x (p4-p1)) > 0`` corresponds to ``CHI_CW`` (``@@``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from molnextr_tpu_torch.chem.mol import (
    CHI_CCW, CHI_CW, CHI_NONE, DASH_BEGIN, DIR_NONE, DIR_UP, DOUBLE, SINGLE,
    WEDGE_BEGIN, Mol,
)

DBStereo = Tuple[int, int, int, int, bool]  # (c1, n1, c2, n2, cis)


def perceive_db_stereo_from_directions(mol: Mol) -> List[DBStereo]:
    """Derive cis/trans specs from parsed ``/`` ``\\`` bond directions."""

    def u_value(nbr: int, center: int) -> Optional[int]:
        bidx = mol.bond_between(nbr, center)
        if bidx is None:
            return None
        bond = mol.bonds[bidx]
        if bond.order != SINGLE or bond.direction == DIR_NONE:
            return None
        up = bond.direction == DIR_UP
        if bond.a1 == nbr:  # written nbr->center: "/" puts center above nbr
            return -1 if up else 1
        return 1 if up else -1

    specs: List[DBStereo] = []
    for bond in mol.iter_bonds():
        if bond.order != DOUBLE:
            continue
        c1, c2 = bond.a1, bond.a2
        pick1 = pick2 = None
        for n in mol.neighbors(c1):
            if n != c2 and u_value(n, c1) is not None:
                pick1 = (n, u_value(n, c1))
                break
        for n in mol.neighbors(c2):
            if n != c1 and u_value(n, c2) is not None:
                pick2 = (n, u_value(n, c2))
                break
        if pick1 and pick2:
            specs.append((c1, pick1[0], c2, pick2[0], pick1[1] == pick2[1]))
    mol.db_stereo = specs
    return specs


def _pseudo3d_positions(
    mol: Mol, center: int, order: Sequence[int], allow_far: bool = False
) -> Optional[np.ndarray]:
    """Positions for the ordered neighbors; -1 entries are the implicit H."""
    if not mol.coords:
        return None
    cx, cy = mol.coords[center]
    pts = []
    real = [n for n in order if n >= 0]
    for n in order:
        if n >= 0:
            x, y = mol.coords[n]
            z = 0.0
            bidx = mol.bond_between(center, n)
            bond = mol.bonds[bidx]
            if bond.wedge and bond.a1 == center:
                z = 1.0 if bond.wedge == WEDGE_BEGIN else -1.0
            elif bond.wedge and bond.a2 == center and allow_far:
                # wedge narrow at the far atom, wide end here: the far atom
                # sits below (wedge) / above (dash) this atom's plane
                z = -1.0 if bond.wedge == WEDGE_BEGIN else 1.0
            pts.append((x - cx, -(y - cy), z))
        else:
            # implicit H: opposite the centroid of the real neighbors
            xs = np.array([mol.coords[n] for n in real], dtype=float)
            hx, hy = -np.mean(xs[:, 0] - cx), -np.mean(xs[:, 1] - cy)
            pts.append((hx, -hy, 0.0))
    return np.asarray(pts, dtype=float)


def _signed_volume(p: np.ndarray) -> float:
    v1, v2, v3 = p[1] - p[0], p[2] - p[0], p[3] - p[0]
    return float(np.dot(v1, np.cross(v2, v3)))


def assign_chirality_from_2d(mol: Mol) -> Mol:
    """Set tetrahedral tags from coords + wedge bonds (in place).

    Pass 1 tags atoms with a wedge/dash bond *beginning* at them (3-4
    neighbors, carbon only — `chemical.py:277-280`).  Pass 2 re-roots
    wedges whose narrow-end atom stayed untagged at their wide end with
    inverted depth sense, mirroring how the reference re-roots wedges at
    chiral centers (`chemical.py:262-275`): the antisymmetric edge-matrix
    codes mean a predicted graph can legally deliver a wedge rooted at
    either endpoint, and without re-rooting the stereocenter at the wide
    end loses its tag entirely.
    """
    if not mol.coords:
        return mol

    def _tag(idx: int, atom, allow_far: bool) -> bool:
        if atom.symbol != "C":
            return False
        nbrs = mol.neighbors(idx)
        h = mol.implicit_h(idx) if atom.explicit_h < 0 else atom.explicit_h
        order: List[int] = list(nbrs)
        if len(order) == 3 and h == 1:
            order.append(-1)
        if len(order) != 4:
            return False
        pts = _pseudo3d_positions(mol, idx, order, allow_far=allow_far)
        if pts is None:
            return False
        vol = _signed_volume(pts)
        if abs(vol) < 1e-9:
            return False
        atom.chiral = CHI_CW if vol > 0 else CHI_CCW
        atom.chiral_order = order
        return True

    tagged = set()
    for idx, atom in enumerate(mol.atoms):
        if any(b.wedge and b.a1 == idx for b in mol.bonds_of(idx)):
            if _tag(idx, atom, allow_far=False):
                tagged.add(idx)
    # The antisymmetric edge-matrix codes root every wedge at the lower atom
    # index, so a wedge is a *relative z displacement* readable from either
    # end; an atom whose only incident wedge is rooted at the far atom (e.g.
    # the higher-index one of two adjacent stereocenters) still needs a tag.
    for idx, atom in enumerate(mol.atoms):
        if idx in tagged:
            continue
        if any(b.wedge and b.a2 == idx for b in mol.bonds_of(idx)):
            _tag(idx, atom, allow_far=True)
    return mol


def assign_db_stereo_from_2d(mol: Mol) -> Mol:
    """Set double-bond cis/trans from 2D geometry (in place).

    Replaces the reference's 3D-conformer round-trip through
    ``AssignStereochemistryFrom3D`` (`chemical.py:238-246`).  Ring double
    bonds and terminal double bonds are skipped.
    """
    if not mol.coords:
        return mol
    ring_bonds = set()
    for ring in mol.ring_info():
        n = len(ring)
        for i in range(n):
            a, b = ring[i], ring[(i + 1) % n]
            ring_bonds.add((min(a, b), max(a, b)))
    specs: List[DBStereo] = []
    for bond in mol.iter_bonds():
        if bond.order != DOUBLE:
            continue
        c1, c2 = bond.a1, bond.a2
        if (min(c1, c2), max(c1, c2)) in ring_bonds:
            continue
        ns1 = [n for n in mol.neighbors(c1) if n != c2]
        ns2 = [n for n in mol.neighbors(c2) if n != c1]
        if not ns1 or not ns2:
            continue
        # substituents must be distinguishable for stereo to be meaningful;
        # a cheap necessary check: different canonical-invariant tuples would
        # be ideal, here we only skip identical-atom duplicates
        n1 = min(ns1)
        n2 = min(ns2)
        p1 = np.asarray(mol.coords[n1], dtype=float)
        p2 = np.asarray(mol.coords[n2], dtype=float)
        a1 = np.asarray(mol.coords[c1], dtype=float)
        a2 = np.asarray(mol.coords[c2], dtype=float)
        axis = a2 - a1
        if np.linalg.norm(axis) < 1e-9:
            continue
        d1, d2 = p1 - a1, p2 - a2
        s1 = float(axis[0] * d1[1] - axis[1] * d1[0])
        s2 = float(axis[0] * d2[1] - axis[1] * d2[0])
        if abs(s1) < 1e-9 or abs(s2) < 1e-9:
            continue
        specs.append((c1, n1, c2, n2, (s1 > 0) == (s2 > 0)))
    mol.db_stereo = specs
    return mol
