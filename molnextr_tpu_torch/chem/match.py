"""Substructure matching for abbreviation collapse.

The training-time analogue of Indigo's SMARTS matcher
(`MolNexTR/dataset.py:36-71`): find occurrences of an
abbreviation's expansion graph inside a molecule so the synthetic generator
can contract them into superatom labels.  The pattern is the expansion
SMILES itself — bracket atoms encode exact H counts, and open valence on the
attachment atom maps to "may have external bonds", mirroring the intent of
the reference's ``[OH0;D2]``-style SMARTS annotations.

The search runs in C++ (``native.py``, ``native_src/matcher.cpp``) unless
``MOLNEXTR_NO_NATIVE`` is set; the Python backtracking search below gives
the same matches in the same order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from molnextr_tpu_torch import native
from molnextr_tpu_torch.chem.mol import Mol


def _composition(mol: Mol):
    """Multiset of (symbol, charge, aromatic) per atom, cached on the Mol."""
    from collections import Counter

    # O(1) validity key: composition depends only on atom fields, so atom
    # count plus the bond-list length (tombstones included) is as protective
    # as the old live-bond count, without re-scanning bonds per call
    key = (len(mol.atoms), len(mol.bonds))
    cached = getattr(mol, "_composition_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    c = Counter((a.symbol, a.charge, bool(a.aromatic)) for a in mol.atoms)
    mol._composition_cache = (key, c)
    return c


def _atoms_compatible(pat: Mol, p: int, mol: Mol, m: int) -> bool:
    pa, ma = pat.atoms[p], mol.atoms[m]
    if pa.symbol != ma.symbol:
        return False
    if pa.charge != ma.charge:
        return False
    if bool(pa.aromatic) != bool(ma.aromatic):
        return False
    if ma.alias:
        return False  # never match existing superatoms
    # bracket pattern atoms pin the hydrogen count
    if pa.explicit_h >= 0 and mol.total_h(m) != pa.explicit_h:
        return False
    return True


def find_substructures(
    mol: Mol, pattern: Mol, attachment_free: Optional[Dict[int, int]] = None,
    max_matches: int = 64,
) -> List[Dict[int, int]]:
    """All matches of ``pattern`` in ``mol`` as {pattern_idx: mol_idx} maps.

    ``attachment_free[p]`` caps the total external bond order a matched mol
    atom may carry (0 if absent): non-attachment atoms must be fully
    internal to the match, the attachment atom carries the bond back to the
    parent structure.
    """
    attachment_free = attachment_free or {}
    np_, nm = pattern.num_atoms(), mol.num_atoms()
    if np_ == 0 or np_ > nm:
        return []
    # composition pre-filter: if the pattern needs more atoms of some
    # (element, charge, aromatic) type than the molecule has, no match is
    # possible — skip the expensive search entirely.  (Plain dict loop:
    # Counter.__sub__ copies both counters and was itself hot.)
    mc = _composition(mol)
    for k, c in _composition(pattern).items():
        if mc.get(k, 0) < c:
            return []
    # native C++ fast path (the host hot loop of synthetic data generation)
    if native.enabled():
        return native.find_substructures_native(mol, pattern, attachment_free, max_matches)
    matches: List[Dict[int, int]] = []
    seen_atomsets: Set[frozenset] = set()

    # order pattern atoms so each new atom connects to an already-mapped one
    order: List[int] = [0]
    placed = {0}
    while len(order) < np_:
        nxt = None
        for p in order:
            for nb in pattern.neighbors(p):
                if nb not in placed:
                    nxt = nb
                    break
            if nxt is not None:
                break
        if nxt is None:  # disconnected pattern: take any
            nxt = next(i for i in range(np_) if i not in placed)
        order.append(nxt)
        placed.add(nxt)

    mapping: Dict[int, int] = {}
    used: Set[int] = set()

    def externals_ok(final: Dict[int, int]) -> bool:
        matched_mol = set(final.values())
        for p, m in final.items():
            ext = 0.0
            for b in mol.bonds_of(m):
                if b.other(m) not in matched_mol:
                    ext += b.order_value()
            if ext > attachment_free.get(p, 0):
                return False
        return True

    def backtrack(k: int):
        if len(matches) >= max_matches:
            return
        if k == np_:
            key = frozenset(mapping.values())
            if key not in seen_atomsets and externals_ok(dict(mapping)):
                seen_atomsets.add(key)
                matches.append(dict(mapping))
            return
        p = order[k]
        anchors = [
            (q, mapping[q]) for q in pattern.neighbors(p) if q in mapping
        ]
        if anchors:
            q, mq = anchors[0]
            candidates = mol.neighbors(mq)
        else:
            candidates = range(nm)
        for m in candidates:
            if m in used or not _atoms_compatible(pattern, p, mol, m):
                continue
            ok = True
            for q in pattern.neighbors(p):
                if q not in mapping:
                    continue
                pb = pattern.bonds[pattern.bond_between(p, q)]
                mb_idx = mol.bond_between(m, mapping[q])
                if mb_idx is None:
                    ok = False
                    break
                mb = mol.bonds[mb_idx]
                if pb.order != mb.order:
                    ok = False
                    break
            if not ok:
                continue
            mapping[p] = m
            used.add(m)
            backtrack(k + 1)
            del mapping[p]
            used.discard(m)

    backtrack(0)
    return matches
