"""SMILES parser: text -> :class:`~molnextr_tpu.chem.mol.Mol`.

Supports the full OpenSMILES feature set the OCSR pipeline produces:
bracket atoms (isotope, stereo, H-count, charge, atom map), aromatic
lowercase atoms, all bond symbols including directional ``/`` ``\\``,
branches, ring-closure digits and ``%nn``, dot-separated fragments, and
wildcard ``*`` atoms.  Unknown bracket contents (superatom labels such as
``[OBoc]``) parse into ``*`` atoms carrying the label as an alias, mirroring
how the reference funnels unparseable tokens through
``_replace_functional_group`` (`MolNexTR/chemical.py:508-533`).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from molnextr_tpu_torch.chem.mol import (
    AROMATIC, AROMATIC_OK, ATOMIC_NUM, CHI_CCW, CHI_CW, DIR_DOWN, DIR_UP,
    DOUBLE, ORGANIC_SUBSET, SINGLE, TRIPLE, Atom, Bond, ChemError, Mol,
)

_BRACKET_RE = re.compile(
    r"^(?P<isotope>\d+)?"
    r"(?P<symbol>[A-Za-z][a-z]?|\*)"
    r"(?P<chiral>@@|@)?"
    r"(?P<hcount>H\d*)?"
    r"(?P<charge>\+{1,3}|-{1,3}|\+\d+|-\d+)?"
    r"(?::(?P<map>\d+))?$"
)

_AROMATIC_ORGANIC = {"b", "c", "n", "o", "p", "s"}
_AROMATIC_BRACKET = {"b", "c", "n", "o", "p", "s", "se", "as", "te", "si"}

_BOND_CHARS = {
    "-": (SINGLE, 0),
    "=": (DOUBLE, 0),
    "#": (TRIPLE, 0),
    ":": (AROMATIC, 0),
    "/": (SINGLE, DIR_UP),
    "\\": (SINGLE, DIR_DOWN),
    "~": (SINGLE, 0),
}


class SmilesParseError(ChemError):
    pass


def _parse_bracket(body: str) -> Atom:
    m = _BRACKET_RE.match(body)
    if m is None:
        # Superatom / abbreviation label: represent as "*" with alias.
        atom = Atom("*")
        atom.alias = body
        return atom
    sym = m.group("symbol")
    aromatic = False
    if sym.islower():
        if sym in _AROMATIC_BRACKET:
            aromatic = True
            sym = sym.capitalize() if len(sym) == 2 else sym.upper()
        else:
            atom = Atom("*")
            atom.alias = body
            return atom
    if sym != "*" and sym not in ATOMIC_NUM:
        atom = Atom("*")
        atom.alias = body
        return atom
    atom = Atom(sym, aromatic=aromatic)
    if m.group("isotope"):
        atom.isotope = int(m.group("isotope"))
    if m.group("chiral"):
        atom.chiral = CHI_CW if m.group("chiral") == "@@" else CHI_CCW
    h = m.group("hcount")
    atom.explicit_h = 0
    if h:
        atom.explicit_h = int(h[1:]) if len(h) > 1 else 1
    ch = m.group("charge")
    if ch:
        if ch[0] == "+":
            atom.charge = int(ch[1:]) if ch[1:].isdigit() else len(ch)
        else:
            atom.charge = -(int(ch[1:]) if ch[1:].isdigit() else len(ch))
    if m.group("map"):
        atom.map_num = int(m.group("map"))
    return atom


def parse_smiles(smiles: str, strict: bool = True) -> Mol:
    """Parse a SMILES string into a molecular graph.

    ``strict=False`` tolerates unmatched ring bonds and dangling branch
    parens (useful when parsing model output that may be slightly malformed).
    """
    if not isinstance(smiles, str) or smiles == "":
        raise SmilesParseError("empty SMILES")
    mol = Mol()
    prev: Optional[int] = None
    pending: Tuple[int, int] = (0, 0)  # (order, direction); 0 order = default
    branch_stack: List[Tuple[Optional[int], Tuple[int, int]]] = []
    ring_open: Dict[int, Tuple[int, Tuple[int, int]]] = {}
    i, n = 0, len(smiles)

    def attach(idx: int):
        nonlocal prev, pending
        if prev is not None:
            order, direction = pending
            if order == 0:
                a, b = mol.atoms[prev], mol.atoms[idx]
                order = AROMATIC if (a.aromatic and b.aromatic) else SINGLE
            mol.add_bond(prev, idx, order, direction=direction)
            mol.atoms[prev].chiral_order.append(idx)
            mol.atoms[idx].chiral_order.append(prev)
        # implicit-H slot for bracket chiral atoms comes right after the
        # preceding atom in the neighbor ordering
        atom = mol.atoms[idx]
        if atom.chiral and atom.explicit_h and atom.explicit_h > 0:
            atom.chiral_order.append(-1)
        pending = (0, 0)
        prev = idx

    def open_or_close_ring(num: int):
        nonlocal pending
        if num in ring_open:
            other, (o_order, o_dir) = ring_open.pop(num)
            order, direction = pending
            if order == 0 and o_order != 0:
                # the opening marker was written from the other end: flip dir
                order = o_order
                direction = {DIR_UP: DIR_DOWN, DIR_DOWN: DIR_UP}.get(o_dir, o_dir)
            elif order == 0:
                a, b = mol.atoms[other], mol.atoms[prev]
                order = AROMATIC if (a.aromatic and b.aromatic) else SINGLE
            if other == prev:
                raise SmilesParseError("ring bond to self")
            mol.add_bond(prev, other, order, direction=direction)
            # ring closure occupies the position where the digit appears
            mol.atoms[prev].chiral_order.append(other)
            # on the opening atom, the partner slot was reserved at open time
            oc = mol.atoms[other].chiral_order
            try:
                oc[oc.index(-(num + 1000))] = prev
            except ValueError:
                oc.append(prev)
            pending = (0, 0)
        else:
            if prev is None:
                raise SmilesParseError("ring bond before any atom")
            ring_open[num] = (prev, pending)
            # reserve the neighbor-order slot with a placeholder
            mol.atoms[prev].chiral_order.append(-(num + 1000))
            pending = (0, 0)

    while i < n:
        c = smiles[i]
        if c == "[":
            j = smiles.find("]", i)
            if j < 0:
                raise SmilesParseError("unclosed bracket")
            atom = _parse_bracket(smiles[i + 1: j])
            idx = mol.add_atom(atom)
            attach(idx)
            i = j + 1
        elif c in _BOND_CHARS:
            pending = _BOND_CHARS[c]
            i += 1
        elif c == "(":
            branch_stack.append((prev, pending))
            pending = (0, 0)
            i += 1
        elif c == ")":
            if not branch_stack:
                if strict:
                    raise SmilesParseError("unmatched )")
                i += 1
                continue
            p, pend = branch_stack.pop()
            prev, pending = p, (0, 0)
            i += 1
        elif c == ".":
            prev = None
            pending = (0, 0)
            i += 1
        elif c == "%":
            if i + 2 < n and smiles[i + 1: i + 3].isdigit():
                open_or_close_ring(int(smiles[i + 1: i + 3]))
                i += 3
            else:
                raise SmilesParseError("bad %ring")
        elif c.isdigit():
            open_or_close_ring(int(c))
            i += 1
        elif c.isupper():
            sym = c
            if i + 1 < n and smiles[i: i + 2] in ("Cl", "Br"):
                sym = smiles[i: i + 2]
            if sym not in ORGANIC_SUBSET:
                raise SmilesParseError(f"atom {sym!r} needs brackets")
            idx = mol.add_atom(Atom(sym))
            attach(idx)
            i += len(sym)
        elif c in _AROMATIC_ORGANIC:
            idx = mol.add_atom(Atom(c.upper(), aromatic=True))
            attach(idx)
            i += 1
        elif c == "*":
            idx = mol.add_atom(Atom("*"))
            attach(idx)
            i += 1
        elif c in " \t":
            break  # SMILES extensions (e.g. "smiles |$...$|") are ignored
        else:
            raise SmilesParseError(f"unexpected character {c!r} at {i}")

    if ring_open and strict:
        raise SmilesParseError(f"unclosed ring bonds: {sorted(ring_open)}")
    if branch_stack and strict:
        raise SmilesParseError("unclosed branch")
    # clear unresolved ring placeholders from chirality orders
    for atom in mol.atoms:
        atom.chiral_order = [x for x in atom.chiral_order if x >= -1]
    return mol
