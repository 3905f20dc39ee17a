"""InChI-style identifier generation and parsing.

API-surface counterpart of the reference's ``IndigoInchi`` binding
(`MolNexTR/indigo/inchi.py:21-84`): ``getInchi`` ->
:func:`mol_to_inchi`, ``getInchiKey`` -> :func:`inchi_key`,
``loadMolecule`` -> :func:`mol_from_inchi`.  Not imported by any reference
pipeline path — it exists for API completeness.

Scope (documented honestly): the emitted strings follow the standard InChI
layer SYNTAX (``InChI=1S/<formula>/c<connections>/h<H>/q<charge>``) with
Hill-ordered formulas and a deterministic canonical numbering, but the
numbering comes from this package's canonical-rank algorithm, not the
official InChI normalizer — so strings are stable, round-trippable
identifiers *within this framework* and are not guaranteed byte-identical
to IUPAC InChI output for molecules where the two canonical orderings
differ.  Stereo layers are omitted (the reference never consumes them).
"""

from __future__ import annotations

import hashlib
import re
from collections import defaultdict
from typing import Dict, List, Tuple

from molnextr_tpu_torch.chem.canon import canonical_ranks
from molnextr_tpu_torch.chem.mol import DOUBLE, SINGLE, TRIPLE, Atom, ChemError, Mol


def hill_formula(mol: Mol) -> str:
    """Molecular formula in Hill order (C, H, then alphabetical)."""
    counts: Dict[str, int] = defaultdict(int)
    h = 0
    for i, atom in enumerate(mol.atoms):
        if atom.symbol == "H":
            h += 1
            continue
        counts[atom.symbol] += 1
        h += mol.total_h(i)
    parts = []
    if counts.get("C"):
        parts.append(("C", counts.pop("C")))
        if h:
            parts.append(("H", h))
        parts += sorted(counts.items())
    else:
        items = sorted(counts.items())
        if h:
            items = sorted(items + [("H", h)])
        parts = items
    return "".join(s + (str(n) if n > 1 else "") for s, n in parts if n > 0)


def _heavy_numbering(mol: Mol) -> Tuple[List[int], List[int]]:
    """(heavy atom indices ordered by canonical number, atom->number map)."""
    heavy = [i for i, a in enumerate(mol.atoms) if a.symbol != "H"]
    sub = mol.remove_atoms([i for i in range(mol.num_atoms()) if i not in heavy])
    ranks = canonical_ranks(sub)
    # like standard InChI, numbers group by Hill element class (C first,
    # others alphabetical) with canonical rank ordering within a class —
    # this also lets mol_from_inchi recover element identities from the
    # formula layer alone
    def key(k: int):
        sym = mol.atoms[heavy[k]].symbol
        return (sym != "C", sym, ranks[k])

    order = sorted(range(len(heavy)), key=key)
    numbering = [0] * mol.num_atoms()
    for num, k in enumerate(order, start=1):
        numbering[heavy[k]] = num
    return [heavy[k] for k in order], numbering


def _c_layer(mol: Mol, ordered: List[int], numbering: List[int]) -> str:
    """Connection layer: DFS over heavy atoms from the lowest canonical
    number, branches parenthesized, ring closures as back-references."""
    if len(ordered) <= 1:
        return ""
    adj: Dict[int, List[int]] = {}
    for i in ordered:
        nbrs = [n for n in mol.neighbors(i) if mol.atoms[n].symbol != "H"]
        adj[i] = sorted(nbrs, key=lambda n: numbering[n])
    visited = set()
    used_bonds = set()
    out: List[str] = []

    def dfs(i: int, root: bool) -> str:
        visited.add(i)
        segs: List[str] = []
        children = []
        for n in adj[i]:
            key = (min(i, n), max(i, n))
            if key in used_bonds:
                continue
            used_bonds.add(key)
            if n in visited:  # ring closure
                segs.append(str(numbering[n]))
            else:
                children.append(n)
        for n in children:
            segs.append(dfs(n, False))
        me = str(numbering[i])
        if not segs:
            return me
        tail = segs[-1]
        branches = "".join(f"({s})" for s in segs[:-1])
        return f"{me}{branches}-{tail}"

    for i in ordered:
        if i not in visited and adj[i]:
            out.append(dfs(i, True))
    # isolated heavy atoms contribute nothing to /c (like standard InChI)
    return ";".join(out) if len(out) > 1 else (out[0] if out else "")


def _h_layer(mol: Mol, numbering: List[int]) -> str:
    """Hydrogen layer: 'h<atoms>H<n>' groups sorted by atom number."""
    byh: Dict[int, List[int]] = defaultdict(list)
    for i, atom in enumerate(mol.atoms):
        if atom.symbol == "H":
            continue
        nh = mol.total_h(i)
        if nh > 0:
            byh[nh].append(numbering[i])
    if not byh:
        return ""
    groups = []
    for nh in sorted(byh):
        nums = sorted(byh[nh])
        # compress runs: 1,2,3 -> 1-3
        runs: List[str] = []
        start = prev = nums[0]
        for x in nums[1:] + [None]:
            if x is not None and x == prev + 1:
                prev = x
                continue
            runs.append(str(start) if start == prev else f"{start}-{prev}")
            if x is not None:
                start = prev = x
        suffix = "H" if nh == 1 else f"H{nh}"
        groups.append(",".join(runs) + suffix)
    return ",".join(groups)


def mol_to_inchi(mol: Mol) -> str:
    """InChI-syntax identifier (see module docstring for conformance)."""
    if mol.num_atoms() == 0:
        raise ChemError("empty molecule")
    ordered, numbering = _heavy_numbering(mol)
    layers = ["InChI=1S", hill_formula(mol)]
    c = _c_layer(mol, ordered, numbering)
    if c:
        layers.append("c" + c)
    h = _h_layer(mol, numbering)
    if h:
        layers.append("h" + h)
    q = sum(a.charge for a in mol.atoms)
    if q:
        layers.append(f"q{q:+d}")
    return "/".join(layers)


def smiles_to_inchi(smiles: str) -> str:
    from molnextr_tpu_torch.chem import mol_from_smiles

    return mol_to_inchi(mol_from_smiles(smiles, strict=True))


_B26 = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _b26(data: bytes, n: int) -> str:
    v = int.from_bytes(data, "big")
    out = []
    for _ in range(n):
        out.append(_B26[v % 26])
        v //= 26
    return "".join(reversed(out))


def inchi_key(inchi: str) -> str:
    """27-character key in InChIKey FORMAT (14-10 hash blocks + 'S'
    standard flag + 'A' version + 'N' protonation), hashed with SHA-256.
    Stable within this framework; not the IUPAC truncated-SHA scheme."""
    if not inchi.startswith("InChI="):
        raise ChemError("not an InChI string")
    body = inchi.split("=", 1)[1]
    parts = body.split("/")
    skeleton = "/".join(parts[:3])  # version/formula/connections
    rest = "/".join(parts[3:])
    h1 = hashlib.sha256(skeleton.encode()).digest()
    h2 = hashlib.sha256(rest.encode()).digest()
    return f"{_b26(h1, 14)}-{_b26(h2, 8)}SA-N"


_FORMULA_RE = re.compile(r"([A-Z][a-z]?)(\d*)")


def mol_from_inchi(inchi: str) -> Mol:
    """Parse an identifier produced by :func:`mol_to_inchi` back to a Mol.

    Handles the formula, connection, hydrogen, and charge layers (charge is
    placed on the first atom, like a net-charge annotation)."""
    if not inchi.startswith("InChI="):
        raise ChemError("not an InChI string")
    parts = inchi.split("/")
    if len(parts) < 2:
        raise ChemError("missing formula layer")
    formula = parts[1]
    clayer = hlayer = qlayer = ""
    for p in parts[2:]:
        if p.startswith("c"):
            clayer = p[1:]
        elif p.startswith("h"):
            hlayer = p[1:]
        elif p.startswith("q"):
            qlayer = p[1:]
    counts: List[Tuple[str, int]] = []
    for sym, num in _FORMULA_RE.findall(formula):
        if not sym:
            continue
        counts.append((sym, int(num) if num else 1))
    mol = Mol()
    n_h = 0
    # heavy atoms appear in canonical-number order: C first (Hill), then
    # alphabetical — matching the numbering only for single-element-class
    # layouts; the c-layer references are resolved against this order
    for sym, cnt in counts:
        if sym == "H":
            n_h = cnt
            continue
        for _ in range(cnt):
            mol.add_atom(Atom(sym))
    if clayer:
        for frag in clayer.split(";"):
            _parse_connections(mol, frag)
    # the h layer FULLY determines hydrogen counts (standard InChI
    # semantics): atoms not listed carry zero H — the c layer has no bond
    # orders, so valence-implicit H would over-count
    for atom in mol.atoms:
        atom.explicit_h = 0
    if hlayer:
        _apply_h_layer(mol, hlayer)
    if qlayer:
        mol.atoms[0].charge = int(qlayer)
    return mol


def _parse_connections(mol: Mol, s: str) -> None:
    """Parse a c-layer fragment like '1-2(-3)-4' into bonds (single order:
    the InChI c-layer is bond-order-free)."""
    pos = 0
    stack: List[int] = []
    prev = -1

    def read_num() -> int:
        nonlocal pos
        j = pos
        while j < len(s) and s[j].isdigit():
            j += 1
        if j == pos:
            raise ChemError(f"bad c-layer at {pos}: {s!r}")
        v = int(s[pos:j])
        pos = j
        return v

    while pos < len(s):
        ch = s[pos]
        if ch == "(":
            stack.append(prev)
            pos += 1
        elif ch == ")":
            prev = stack.pop()
            pos += 1
        elif ch == "-":
            pos += 1
        else:
            num = read_num()
            idx = num - 1
            if prev >= 0 and mol.bond_between(prev, idx) is None:
                mol.add_bond(prev, idx, SINGLE)
            prev = idx


def _apply_h_layer(mol: Mol, s: str) -> None:
    """Apply 'h' groups: '1-3H2,5H' -> explicit H counts on those atoms."""
    for m in re.finditer(r"([0-9,\-]+)H(\d*)", s):
        nums_s, cnt_s = m.group(1), m.group(2)
        nh = int(cnt_s) if cnt_s else 1
        for token in nums_s.strip(",").split(","):
            if not token:
                continue
            if "-" in token:
                a, b = token.split("-")
                rng = range(int(a), int(b) + 1)
            else:
                rng = [int(token)]
            for num in rng:
                if 1 <= num <= mol.num_atoms():
                    mol.atoms[num - 1].explicit_h = nh
