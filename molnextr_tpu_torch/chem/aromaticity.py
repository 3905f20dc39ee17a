"""Aromaticity perception and kekulization.

The reference delegates these to RDKit (`Chem.SanitizeMol`) and Indigo
(`mol.aromatize()/dearomatize()`, used for synthetic-image augmentation at
`MolNexTR/dataset.py:304-307`).  This module implements both
directions on our own :class:`Mol`:

* :func:`kekulize`  -- aromatic bond orders -> alternating single/double via
  backtracking perfect matching.
* :func:`aromatize` -- Hueckel 4n+2 perception on SSSR rings (iterated to a
  fixpoint so fused systems like naphthalene resolve ring by ring).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from molnextr_tpu_torch.chem.mol import (
    AROMATIC, AROMATIC_OK, DOUBLE, SINGLE, ChemError, Mol,
)


class KekulizeError(ChemError):
    pass


def _sigma_count(mol: Mol, idx: int) -> int:
    return mol.degree(idx) + max(mol.atoms[idx].explicit_h, 0) + (
        mol.implicit_h(idx) if mol.atoms[idx].explicit_h < 0 else 0
    )


def _needs_double(mol: Mol, idx: int) -> Optional[bool]:
    """Whether an aromatic atom must carry exactly one in-ring double bond.

    Returns None when the atom cannot be part of an aromatic system.
    """
    atom = mol.atoms[idx]
    sym = atom.symbol
    # an existing exocyclic (non-aromatic) double bond satisfies sp2
    for b in mol.bonds_of(idx):
        if b.order == DOUBLE:
            return False
    sigma = _sigma_count(mol, idx)
    if sym == "C":
        if atom.charge != 0 and sigma == 3:
            return False  # carbanion/carbocation contributes lone pair / empty p
        return sigma <= 3
    if sym in ("N", "P", "As"):
        if atom.charge == 1:
            return True
        if atom.charge == -1:
            return False
        return sigma == 2  # pyridine-type; 3-sigma N is a lone-pair donor
    if sym in ("O", "S", "Se", "Te"):
        return atom.charge == 1
    if sym == "B":
        return False
    if sym == "*":
        return False
    if sym == "Si":
        return sigma <= 3
    return None


def kekulize(mol: Mol, strict: bool = True) -> Mol:
    """Replace AROMATIC bond orders with alternating SINGLE/DOUBLE in place."""
    arom_bonds = [i for i, b in enumerate(mol.bonds) if b is not None and b.order == AROMATIC]
    if not arom_bonds:
        return mol
    atoms: Set[int] = set()
    for bi in arom_bonds:
        atoms.add(mol.bonds[bi].a1)
        atoms.add(mol.bonds[bi].a2)

    need: Dict[int, bool] = {}
    for a in atoms:
        nd = _needs_double(mol, a)
        need[a] = bool(nd)

    # perfect matching on the "needs double" subgraph, restricted to aromatic
    # bonds; backtracking DFS (ring systems are small)
    adj: Dict[int, List[int]] = {a: [] for a in atoms}
    for bi in arom_bonds:
        b = mol.bonds[bi]
        adj[b.a1].append(b.a2)
        adj[b.a2].append(b.a1)

    matched: Dict[int, int] = {}
    targets = sorted(a for a in atoms if need[a])

    def bt(i: int) -> bool:
        while i < len(targets) and targets[i] in matched:
            i += 1
        if i == len(targets):
            return True
        a = targets[i]
        for nb in adj[a]:
            if need.get(nb) and nb not in matched:
                matched[a] = nb
                matched[nb] = a
                if bt(i + 1):
                    return True
                del matched[a]
                del matched[nb]
        return False

    ok = bt(0)
    if not ok and strict:
        raise KekulizeError("cannot kekulize aromatic system")
    for bi in arom_bonds:
        b = mol.bonds[bi]
        if matched.get(b.a1) == b.a2:
            b.order = DOUBLE
        else:
            b.order = SINGLE
    return mol


def dearomatize(mol: Mol, strict: bool = True) -> Mol:
    """Kekulize and clear aromatic flags: the Indigo ``mol.dearomatize()``
    analogue used by the synthetic generator (`dataset.py:304-305`)."""
    kekulize(mol, strict=strict)
    for a in mol.atoms:
        a.aromatic = False
    return mol


def _pi_contribution(mol: Mol, idx: int, ring: Set[int]) -> Optional[int]:
    """Pi electrons contributed by `idx` to the candidate aromatic ring."""
    atom = mol.atoms[idx]
    sym = atom.symbol
    if sym not in AROMATIC_OK and sym != "*":
        return None
    double_in_ring = False
    double_exo = False
    for b in mol.bonds_of(idx):
        if b.order == DOUBLE:
            if b.other(idx) in ring:
                double_in_ring = True
            else:
                double_exo = True
        elif b.order == AROMATIC:
            double_in_ring = True  # already-aromatic fused neighbor
        elif b.order == 3:
            return None
    sigma = _sigma_count(mol, idx)
    if double_in_ring:
        return 1
    if double_exo:
        # sp2 but contributes no electrons (e.g. quinone carbonyl C) unless
        # charged heteroatom
        if sym == "C":
            return 0
        return 0
    # no double bonds at all: lone-pair donor or empty orbital
    if sym == "C":
        if atom.charge == -1 and sigma == 3:
            return 2  # cyclopentadienyl anion
        if atom.charge == 1 and sigma == 3:
            return 0  # tropylium
        return None
    if sym in ("N", "P", "As"):
        if sigma == 3 and atom.charge == 0:
            return 2  # pyrrole-type
        if sigma == 3 and atom.charge == 1:
            return None
        if sigma == 2 and atom.charge == -1:
            return 2
        return None
    if sym in ("O", "S", "Se", "Te"):
        if atom.charge == 0:
            return 2
        return None
    if sym == "B":
        return 0  # empty p orbital
    if sym == "*":
        return 1  # wildcard: be permissive
    return None


def aromatize(mol: Mol) -> Mol:
    """Perceive aromatic rings and mark atoms/bonds aromatic, in place."""
    rings = [r for r in mol.ring_info() if 3 <= len(r) <= 7]
    changed = True
    guard = 0
    while changed and guard < 10:
        changed = False
        guard += 1
        for ring in rings:
            rset = set(ring)
            if all(mol.atoms[a].aromatic for a in ring):
                continue
            contribs = [_pi_contribution(mol, a, rset) for a in ring]
            if any(c is None for c in contribs):
                continue
            pi = sum(contribs)
            if pi % 4 != 2:
                continue
            # freeze hydrogen counts before flipping bond orders
            for a in ring:
                atom = mol.atoms[a]
                if atom.explicit_h < 0:
                    h = mol.implicit_h(a)
                    if h > 0 and atom.symbol != "C":
                        atom.explicit_h = h
            for a in ring:
                mol.atoms[a].aromatic = True
            n = len(ring)
            for i in range(n):
                bidx = mol.bond_between(ring[i], ring[(i + 1) % n])
                if bidx is not None:
                    mol.bonds[bidx].order = AROMATIC
            changed = True
    return mol


def sanitize(mol: Mol, strict: bool = True) -> Mol:
    """Kekulize (validity check) then re-perceive aromaticity.

    The rough analogue of RDKit's ``Chem.SanitizeMol`` for our needs: after
    this, aromatic flags are consistent and the molecule is kekulizable.
    """
    kekulize(mol, strict=strict)
    for a in mol.atoms:
        a.aromatic = False
    aromatize(mol)
    return mol
