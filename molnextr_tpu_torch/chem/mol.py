"""Molecular graph structures.

This module is the foundation of ``molnextr_tpu.chem``, a self-contained
cheminformatics kernel that replaces the reference's RDKit and Indigo C++
dependencies (`MolNexTR/chemical.py`,
`MolNexTR/indigo/`) for the operations the OCSR pipeline
needs: SMILES parse/write/canonicalize, implicit-H/valence accounting,
aromaticity, 2D stereo perception, molfile output, substructure matching,
layout and rendering.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Bond orders; AROMATIC uses 4 to match the edge-matrix encoding used across
# the pipeline (1/2/3/4 = single/double/triple/aromatic, `dataset.py:264`).
SINGLE, DOUBLE, TRIPLE, AROMATIC = 1, 2, 3, 4

# Wedge direction codes (edge classes 5/6 in the graph head,
# `components.py:383-400`).
WEDGE_NONE, WEDGE_BEGIN, DASH_BEGIN = 0, 5, 6

# Tetrahedral chirality tags. CCW corresponds to ``@`` and CW to ``@@`` with
# neighbors enumerated in SMILES encounter order, viewed from the first
# neighbor.
CHI_NONE, CHI_CCW, CHI_CW = 0, 1, 2

# Directional single bonds for cis/trans ("/" = UP, "\" = DOWN).
DIR_NONE, DIR_UP, DIR_DOWN = 0, 1, 2

PERIODIC_TABLE = [
    "*", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
    "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds",
    "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]
ATOMIC_NUM = {s: i for i, s in enumerate(PERIODIC_TABLE)}

# Default valence lists used for implicit-H computation (RDKit-equivalent for
# the organic subset; mirrors `abbrs.py:220-224` with additions).
DEFAULT_VALENCES: Dict[str, Tuple[int, ...]] = {
    "H": (1,), "Li": (1,), "Be": (2,), "B": (3,), "C": (4,), "N": (3,),
    "O": (2,), "F": (1,), "Na": (1,), "Mg": (2,), "Al": (3,), "Si": (4,),
    "P": (3, 5), "S": (2, 4, 6), "Cl": (1,), "K": (1,), "Ca": (2,),
    "Br": (1,), "I": (1,), "As": (3, 5), "Se": (2, 4, 6), "Te": (2, 4, 6),
    "At": (1,), "B-": (4,),
}

# Atoms that may be written without brackets in SMILES.
ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I", "*"}
AROMATIC_OK = {"B", "C", "N", "O", "P", "S", "Se", "As", "Te", "Si"}


class ChemError(Exception):
    pass


@dataclass
class Atom:
    symbol: str  # element symbol, or "*" for dummy/R-group/superatom
    charge: int = 0
    isotope: int = 0
    explicit_h: int = -1  # -1 = implicit (computed); >=0 = set by brackets
    aromatic: bool = False
    chiral: int = CHI_NONE
    # neighbor atom indices in SMILES encounter order, used for parity; -1
    # denotes the implicit hydrogen slot
    chiral_order: List[int] = field(default_factory=list)
    alias: str = ""  # superatom/R-group label (reference: Chem.SetAtomAlias)
    radical: int = 0
    map_num: int = 0

    @property
    def atomic_num(self) -> int:
        return ATOMIC_NUM.get(self.symbol, 0)

    def copy(self) -> "Atom":
        return Atom(
            self.symbol, self.charge, self.isotope, self.explicit_h,
            self.aromatic, self.chiral, list(self.chiral_order), self.alias,
            self.radical, self.map_num,
        )


@dataclass
class Bond:
    a1: int
    a2: int
    order: int = SINGLE  # SINGLE/DOUBLE/TRIPLE/AROMATIC
    wedge: int = WEDGE_NONE  # begin-wedge/begin-dash, begins at a1
    direction: int = DIR_NONE  # cis/trans marker as written a1->a2

    def other(self, idx: int) -> int:
        return self.a2 if idx == self.a1 else self.a1

    def order_value(self) -> float:
        return 1.5 if self.order == AROMATIC else float(self.order)

    def copy(self) -> "Bond":
        return Bond(self.a1, self.a2, self.order, self.wedge, self.direction)


class Mol:
    """An editable molecular graph (the RWMol analogue)."""

    def __init__(self):
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        self._adj: Dict[int, List[int]] = {}  # atom idx -> list of bond idx
        # optional 2D coordinates, filled by layout or graph construction
        self.coords: List[Tuple[float, float]] = []

    # -- construction -----------------------------------------------------
    def add_atom(self, atom: Atom) -> int:
        idx = len(self.atoms)
        self.atoms.append(atom)
        self._adj[idx] = []
        return idx

    def add_bond(self, a1: int, a2: int, order: int = SINGLE, wedge: int = WEDGE_NONE,
                 direction: int = DIR_NONE) -> int:
        if a1 == a2:
            raise ChemError("self bond")
        if self.bond_between(a1, a2) is not None:
            raise ChemError(f"duplicate bond {a1}-{a2}")
        bidx = len(self.bonds)
        self.bonds.append(Bond(a1, a2, order, wedge, direction))
        self._adj[a1].append(bidx)
        self._adj[a2].append(bidx)
        return bidx

    def remove_bond(self, a1: int, a2: int) -> None:
        bidx = self.bond_between(a1, a2)
        if bidx is None:
            return
        self.bonds[bidx] = None  # tombstone; compact() cleans up
        self._adj[a1] = [b for b in self._adj[a1] if b != bidx]
        self._adj[a2] = [b for b in self._adj[a2] if b != bidx]

    def remove_atoms(self, indices) -> "Mol":
        """Return a new Mol with `indices` removed (bonds to them dropped)."""
        drop = set(indices)
        remap = {}
        out = Mol()
        for i, atom in enumerate(self.atoms):
            if i in drop:
                continue
            remap[i] = out.add_atom(atom.copy())
        for bond in self.iter_bonds():
            if bond.a1 in drop or bond.a2 in drop:
                continue
            out.add_bond(remap[bond.a1], remap[bond.a2], bond.order, bond.wedge, bond.direction)
        for i, atom in enumerate(out.atoms):
            atom.chiral_order = [
                n if n == -1 else remap[n]
                for n in atom.chiral_order
                if n == -1 or n in remap
            ]
        if self.coords:
            out.coords = [
                self.coords[i] if i < len(self.coords) else (0.0, 0.0)
                for i in range(len(self.atoms))
                if i not in drop
            ]
        return out

    def compact(self) -> None:
        """Drop tombstoned bonds left by remove_bond."""
        new_bonds = [b for b in self.bonds if b is not None]
        self.bonds = new_bonds
        self._adj = {i: [] for i in range(len(self.atoms))}
        for bi, b in enumerate(self.bonds):
            self._adj[b.a1].append(bi)
            self._adj[b.a2].append(bi)

    # -- queries ----------------------------------------------------------
    def num_atoms(self) -> int:
        return len(self.atoms)

    def iter_bonds(self):
        return (b for b in self.bonds if b is not None)

    def bond_between(self, a1: int, a2: int) -> Optional[int]:
        for bidx in self._adj.get(a1, []):
            b = self.bonds[bidx]
            if b is not None and b.other(a1) == a2:
                return bidx
        return None

    def neighbors(self, idx: int) -> List[int]:
        return [self.bonds[b].other(idx) for b in self._adj[idx] if self.bonds[b] is not None]

    def bonds_of(self, idx: int) -> List[Bond]:
        return [self.bonds[b] for b in self._adj[idx] if self.bonds[b] is not None]

    def degree(self, idx: int) -> int:
        return len(self._adj[idx])

    def bond_order_sum(self, idx: int) -> float:
        return sum(b.order_value() for b in self.bonds_of(idx))

    def copy(self) -> "Mol":
        out = Mol()
        for a in self.atoms:
            out.add_atom(a.copy())
        for b in self.iter_bonds():
            out.add_bond(b.a1, b.a2, b.order, b.wedge, b.direction)
        out.coords = list(self.coords)
        return out

    def renumbered(self, perm: List[int]) -> "Mol":
        """New Mol with atom i moved to position perm[i] (stereo preserved)."""
        out = Mol()
        inv = [0] * len(perm)
        for i, p in enumerate(perm):
            inv[p] = i
        for p in range(len(perm)):
            out.add_atom(self.atoms[inv[p]].copy())
        for b in self.iter_bonds():
            out.add_bond(perm[b.a1], perm[b.a2], b.order, b.wedge, b.direction)
        for atom in out.atoms:
            atom.chiral_order = [perm[n] if n >= 0 else n for n in atom.chiral_order]
        if self.coords:
            out.coords = [self.coords[inv[p]] for p in range(len(perm))]
        if hasattr(self, "db_stereo"):
            out.db_stereo = [
                (perm[c1], perm[n1], perm[c2], perm[n2], cis)
                for (c1, n1, c2, n2, cis) in self.db_stereo
            ]
        return out

    # -- hydrogen accounting ---------------------------------------------
    def implicit_h(self, idx: int) -> int:
        """Implicit hydrogen count for atom `idx`.

        Bracket atoms carry their explicit H count; others get the smallest
        default valence that accommodates the bond-order sum (RDKit model).
        Aromatic bonds count 1.5 each; an aromatic atom's contribution is
        rounded down after summing, matching the kekulized interpretation.
        """
        atom = self.atoms[idx]
        if atom.explicit_h >= 0:
            return atom.explicit_h
        if atom.symbol == "*" or atom.symbol not in DEFAULT_VALENCES:
            return 0
        bos = self.bond_order_sum(idx)
        if atom.aromatic:
            bos = int(bos + 0.51)  # n aromatic bonds ~ n+1 valence units for C
        else:
            bos = int(round(bos))
        valences = DEFAULT_VALENCES[atom.symbol]
        # charge adjustment: +1 on N/O/S/P adds a valence slot, -1 removes one
        adj = 0
        if atom.symbol in ("N", "P"):
            adj = atom.charge
        elif atom.symbol in ("O", "S", "Se", "Te"):
            adj = atom.charge
        elif atom.symbol in ("C", "Si"):
            adj = -abs(atom.charge)
        elif atom.symbol == "B":
            adj = -atom.charge  # B- has 4
        for v in valences:
            cap = v + adj
            if bos <= cap:
                return max(int(cap - bos) - atom.radical, 0)
        return 0

    def total_h(self, idx: int) -> int:
        explicit = sum(1 for n in self.neighbors(idx) if self.atoms[n].symbol == "H")
        return self.implicit_h(idx) + explicit

    # -- rings ------------------------------------------------------------
    def ring_info(self) -> List[List[int]]:
        """A small set of smallest rings (SSSR approximation).

        Computes, for every bond in a cycle, the smallest ring through it via
        BFS, then deduplicates.  Adequate for organic ring perception.
        """
        rings: List[List[int]] = []
        seen = set()
        for bond in self.iter_bonds():
            ring = self._smallest_ring_through(bond)
            if ring is None:
                continue
            key = frozenset(ring)
            if key in seen:
                continue
            seen.add(key)
            rings.append(ring)
        return rings

    def _smallest_ring_through(self, bond: Bond) -> Optional[List[int]]:
        # BFS from a1 to a2 avoiding the direct bond
        from collections import deque

        start, goal = bond.a1, bond.a2
        prev = {start: -1}
        q = deque([start])
        while q:
            cur = q.popleft()
            for nb in self.neighbors(cur):
                if cur == start and nb == goal:
                    continue
                if nb not in prev:
                    prev[nb] = cur
                    if nb == goal:
                        path = [nb]
                        while path[-1] != start:
                            path.append(prev[path[-1]])
                        return path
                    q.append(nb)
        return None

    def rings_of_atom(self) -> Dict[int, List[List[int]]]:
        out: Dict[int, List[List[int]]] = {i: [] for i in range(len(self.atoms))}
        for ring in self.ring_info():
            for a in ring:
                out[a].append(ring)
        return out

    def ring_membership(self) -> List[bool]:
        member = [False] * len(self.atoms)
        for ring in self.ring_info():
            for a in ring:
                member[a] = True
        return member

    def in_ring(self, idx: int) -> bool:
        return self.ring_membership()[idx]

    def bond_in_ring(self, bidx: int) -> bool:
        b = self.bonds[bidx]
        return self._smallest_ring_through(b) is not None

    # -- fragments --------------------------------------------------------
    def fragments(self) -> List[List[int]]:
        seen = [False] * len(self.atoms)
        frags = []
        for i in range(len(self.atoms)):
            if seen[i]:
                continue
            stack, comp = [i], []
            seen[i] = True
            while stack:
                cur = stack.pop()
                comp.append(cur)
                for nb in self.neighbors(cur):
                    if not seen[nb]:
                        seen[nb] = True
                        stack.append(nb)
            frags.append(sorted(comp))
        return frags
