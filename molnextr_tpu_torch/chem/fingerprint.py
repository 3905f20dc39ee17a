"""Topological path fingerprints + Tanimoto similarity.

The similarity analogue of ``Chem.RDKFingerprint`` +
``DataStructs.FingerprintSimilarity`` used by the evaluator
(`evaluate.py:118-136`): enumerate all linear bond paths up
to length 7, hash each path's (atom invariants, bond orders) sequence into a
2048-bit set, and compare bit sets with Tanimoto.  Bit values differ from
RDKit's, but the similarity metric has the same character (1.0 iff identical
path sets; near-0 for unrelated molecules).
"""

from __future__ import annotations

import hashlib
from typing import FrozenSet, List, Set, Tuple

from molnextr_tpu_torch.chem.mol import Mol

N_BITS = 2048
MAX_PATH = 7


def _atom_inv(mol: Mol, idx: int) -> Tuple:
    a = mol.atoms[idx]
    return (a.atomic_num, a.charge, a.aromatic, mol.degree(idx))


def _path_hash(mol: Mol, atoms: List[int]) -> int:
    parts = []
    for i, a in enumerate(atoms):
        parts.append(str(_atom_inv(mol, a)))
        if i + 1 < len(atoms):
            bidx = mol.bond_between(a, atoms[i + 1])
            parts.append(str(mol.bonds[bidx].order))
    # canonical direction: a path and its reverse must hash identically
    fwd = "|".join(parts)
    rev = "|".join(reversed(parts))
    key = min(fwd, rev)
    return int(hashlib.blake2b(key.encode(), digest_size=8).hexdigest(), 16)


def path_fingerprint(mol: Mol, max_path: int = MAX_PATH, n_bits: int = N_BITS) -> FrozenSet[int]:
    """Bit set of hashed linear paths of 1..max_path bonds (plus atoms)."""
    bits: Set[int] = set()
    n = mol.num_atoms()
    for i in range(n):
        bits.add(_path_hash(mol, [i]) % n_bits)

    def dfs(path: List[int], visited: Set[int]):
        if len(path) > 1:
            h = _path_hash(mol, path)
            bits.add(h % n_bits)
            bits.add((h >> 32) % n_bits)
        if len(path) > max_path:
            return
        for nb in mol.neighbors(path[-1]):
            if nb in visited:
                continue
            path.append(nb)
            visited.add(nb)
            dfs(path, visited)
            visited.discard(nb)
            path.pop()

    for i in range(n):
        dfs([i], {i})
    return frozenset(bits)


def tanimoto(fp1: FrozenSet[int], fp2: FrozenSet[int]) -> float:
    if not fp1 and not fp2:
        return 1.0
    union = len(fp1 | fp2)
    if union == 0:
        return 0.0
    return len(fp1 & fp2) / union


def tanimoto_similarity(smiles1: str, smiles2: str) -> float:
    """SMILES-level convenience (`evaluate.py:118-136`); 0 on any failure."""
    from molnextr_tpu_torch.chem import mol_from_smiles

    try:
        m1 = mol_from_smiles(smiles1, do_sanitize=True, strict=False)
        m2 = mol_from_smiles(smiles2, do_sanitize=True, strict=False)
        if m1.num_atoms() == 0 or m2.num_atoms() == 0:
            return 0.0
        return tanimoto(path_fingerprint(m1), path_fingerprint(m2))
    except Exception:
        return 0.0
