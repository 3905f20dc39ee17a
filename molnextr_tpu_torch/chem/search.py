"""Chemical similarity / substructure search index.

The framework's analogue of the reference's vendored Bingo cartridge
(`MolNexTR/indigo/bingo.py` — a chemical-database search
engine over libbingo.so, not imported by the OCSR pipeline there either):
an in-memory index over path fingerprints supporting Tanimoto similarity
queries and substructure screening, built on the self-contained chem
kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from molnextr_tpu_torch.chem import mol_from_smiles
from molnextr_tpu_torch.chem.fingerprint import path_fingerprint, tanimoto
from molnextr_tpu_torch.chem.match import find_substructures
from molnextr_tpu_torch.chem.mol import Mol


class MoleculeIndex:
    """In-memory fingerprint index (the ``Bingo`` analogue)."""

    def __init__(self):
        self._smiles: List[str] = []
        self._mols: List[Mol] = []
        self._fps: List[frozenset] = []

    def insert(self, smiles: str) -> int:
        """Add a molecule; returns its record id."""
        mol = mol_from_smiles(smiles, do_sanitize=True, strict=False)
        self._smiles.append(smiles)
        self._mols.append(mol)
        self._fps.append(path_fingerprint(mol))
        return len(self._smiles) - 1

    def insert_many(self, smiles_list) -> List[int]:
        return [self.insert(s) for s in smiles_list]

    def __len__(self) -> int:
        return len(self._smiles)

    def search_sim(
        self, query: str, min_sim: float = 0.7, top_k: Optional[int] = None
    ) -> List[Tuple[int, float]]:
        """Tanimoto similarity search; returns (id, similarity) sorted desc."""
        qmol = mol_from_smiles(query, do_sanitize=True, strict=False)
        qfp = path_fingerprint(qmol)
        hits = [
            (i, tanimoto(qfp, fp))
            for i, fp in enumerate(self._fps)
        ]
        hits = [(i, s) for i, s in hits if s >= min_sim]
        hits.sort(key=lambda t: -t[1])
        return hits[:top_k] if top_k else hits

    def search_sub(self, query: str, top_k: Optional[int] = None) -> List[int]:
        """Substructure search: records containing the query as a subgraph.

        Fingerprint screen first (a superstructure's bit set is *mostly* a
        superset), exact VF2 match to confirm.
        """
        qmol = mol_from_smiles(query, do_sanitize=True, strict=False)
        nq = qmol.num_atoms()
        # permissive attachment: any query atom may carry external bonds
        attach = {i: 8 for i in range(nq)}
        out: List[int] = []
        for i, mol in enumerate(self._mols):
            if mol.num_atoms() < nq:
                continue
            if find_substructures(mol, qmol, attach, max_matches=1):
                out.append(i)
                if top_k and len(out) >= top_k:
                    break
        return out

    def smiles(self, record_id: int) -> str:
        return self._smiles[record_id]
