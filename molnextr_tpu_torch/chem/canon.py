"""Canonical atom ranking (Morgan-style invariant refinement).

Replaces RDKit's canonical ranking for our canonical SMILES writer.  The
algorithm: initial invariants -> iterative neighborhood refinement until the
partition stabilizes -> STEREO-aware refinement (normalized tetrahedral
parities and double-bond cis/trans descriptors folded into the invariants,
matching RDKit's use of chiral invariants in canonical ranking) ->
deterministic tie-breaking by splitting the lowest remaining class and
re-refining.  The stereo pass separates graph-automorphic but
stereo-distinct atoms (e.g. the two ends of (2E,4Z)-hexa-2,4-diene), so the
canonical string is unique for such molecules too — without it, exact-match
scoring could spuriously fail on them (`evaluation.py` assumes RDKit-like
canonical semantics).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from molnextr_tpu_torch.chem.mol import CHI_NONE, Mol


def _refine(mol: Mol, ranks: List[int]) -> List[int]:
    n = mol.num_atoms()
    while True:
        keys = []
        for i in range(n):
            nb = sorted(
                (b.order, ranks[b.other(i)]) for b in mol.bonds_of(i)
            )
            keys.append((ranks[i], tuple(nb)))
        order = sorted(range(n), key=lambda i: keys[i])
        new_ranks = [0] * n
        r = 0
        for j, i in enumerate(order):
            if j > 0 and keys[i] != keys[order[j - 1]]:
                r = j
            new_ranks[i] = r
        if new_ranks == ranks:
            return ranks
        ranks = new_ranks


def _perm_parity(seq: List[int]) -> int:
    """0 for an even permutation of sorted(seq), 1 for odd."""
    s = list(seq)
    inv = 0
    for i in range(len(s)):
        for j in range(i + 1, len(s)):
            if s[i] > s[j]:
                inv += 1
    return inv & 1


def _stereo_keys(mol: Mol, ranks: List[int]) -> List[Tuple]:
    """Per-atom stereo descriptors normalized by the current ranks.

    * Tetrahedral: the stored parity re-expressed relative to neighbors in
      (rank, index) order — automorphism-invariant once ranks are.
    * Double-bond: cis(1)/trans(2) re-referenced to the lowest-ranked
      substituent on each end (switching reference neighbor on a trigonal
      end flips the side).
    """
    n = mol.num_atoms()
    keys: List[List[int]] = [[] for _ in range(n)]
    for i, atom in enumerate(mol.atoms):
        if atom.chiral != CHI_NONE and len(atom.chiral_order) >= 3:
            by_rank = sorted(
                range(len(atom.chiral_order)),
                key=lambda j: (
                    (-1, -1)
                    if atom.chiral_order[j] < 0
                    else (ranks[atom.chiral_order[j]], atom.chiral_order[j])
                ),
            )
            flip = _perm_parity(by_rank)
            parity = (3 - atom.chiral) if flip else atom.chiral  # swap CW/CCW
            keys[i].append(10 + parity)
    for (c1, n1, c2, n2, cis) in getattr(mol, "db_stereo", []) or []:
        subs1 = [x for x in mol.neighbors(c1) if x != c2]
        subs2 = [x for x in mol.neighbors(c2) if x != c1]
        if not subs1 or not subs2:
            continue
        ref1 = min(subs1, key=lambda x: (ranks[x], x))
        ref2 = min(subs2, key=lambda x: (ranks[x], x))
        flag = bool(cis)
        if ref1 != n1:
            flag = not flag
        if ref2 != n2:
            flag = not flag
        code = 1 if flag else 2
        keys[c1].append(code)
        keys[c2].append(code)
    return [tuple(sorted(k)) for k in keys]


def _rerank(combined: List[Tuple]) -> List[int]:
    n = len(combined)
    order = sorted(range(n), key=lambda i: combined[i])
    ranks = [0] * n
    r = 0
    for j, i in enumerate(order):
        if j > 0 and combined[i] != combined[order[j - 1]]:
            r = j
        ranks[i] = r
    return ranks


def canonical_ranks(mol: Mol) -> List[int]:
    """Return a canonical rank (0..n-1, all distinct) per atom."""
    n = mol.num_atoms()
    if n == 0:
        return []
    ring_member = mol.ring_membership()
    inv = []
    for i, atom in enumerate(mol.atoms):
        inv.append(
            (
                atom.atomic_num,
                atom.symbol,  # separates "*" aliases from elements
                mol.degree(i),
                atom.charge,
                mol.total_h(i),
                atom.isotope,
                atom.aromatic,
                ring_member[i],
                atom.alias,
            )
        )
    order = sorted(range(n), key=lambda i: inv[i])
    ranks = [0] * n
    r = 0
    for j, i in enumerate(order):
        if j > 0 and inv[i] != inv[order[j - 1]]:
            r = j
        ranks[i] = r
    ranks = _refine(mol, ranks)

    # stereo-aware refinement: fold normalized stereo descriptors into the
    # invariants and re-refine until stable (separates graph-symmetric but
    # stereo-asymmetric atoms before any arbitrary tie-break)
    for _ in range(n):
        skeys = _stereo_keys(mol, ranks)
        if not any(skeys):
            break
        new = _refine(mol, _rerank([(ranks[i], skeys[i]) for i in range(n)]))
        if new == ranks:
            break
        ranks = new

    # tie-breaking: promote one member of the lowest tied class, re-refine
    while True:
        count: Dict[int, List[int]] = {}
        for i, rk in enumerate(ranks):
            count.setdefault(rk, []).append(i)
        tied = sorted(k for k, v in count.items() if len(v) > 1)
        if not tied:
            return ranks
        cls = count[tied[0]]
        chosen = min(cls)  # in-class members are automorphic; see module doc
        ranks = [rk + 1 if rk > ranks[chosen] or (rk == ranks[chosen] and i != chosen) else rk
                 for i, rk in enumerate(ranks)]
        ranks = _refine(mol, ranks)
