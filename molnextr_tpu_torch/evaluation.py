"""SMILES evaluation metrics.

Re-implements both reference evaluators — the in-package one
(`MolNexTR/evaluation.py:10-131`) and the top-level CLI one
with Tanimoto (`evaluate.py:157-195`), which is the one
``main.py`` imports — on the self-contained chem kernel:

* ``canon_smiles``  — exact match of cis/trans-agnostic canonical SMILES
* ``graph``         — exact match ignoring chirality AND cis/trans
* ``chiral``        — ``canon_smiles`` restricted to golds containing ``@``
* ``tanimoto``      — mean path-fingerprint Tanimoto similarity

Empty gold entries are replaced with ``"<empty>"`` so an empty prediction is
never counted correct (`evaluate.py:173-176`).
"""

from __future__ import annotations

import multiprocessing
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from molnextr_tpu_torch.chem import canonicalize_smiles
from molnextr_tpu_torch.chem.fingerprint import tanimoto_similarity


def convert_smiles_to_canonsmiles(
    smiles_list: Sequence[str],
    ignore_chiral: bool = False,
    ignore_cistrans: bool = False,
    replace_rgroup: bool = True,
    num_workers: int = 16,
) -> Tuple[List[str], float]:
    """Pool-parallel canonicalization (`evaluate.py:67-88`)."""
    args = [
        (s, ignore_chiral, ignore_cistrans, replace_rgroup) for s in smiles_list
    ]
    if num_workers <= 1 or len(args) < 4:
        results = [canonicalize_smiles(*a) for a in args]
    else:
        with multiprocessing.Pool(num_workers) as p:
            results = p.starmap(canonicalize_smiles, args, chunksize=128)
    canon, success = zip(*results) if results else ((), ())
    return list(canon), float(np.mean(success)) if success else 0.0


def compute_tanimoto_similarities(
    gold_smiles: Sequence[str], pred_smiles: Sequence[str], num_workers: int = 16
) -> List[float]:
    pairs = list(zip(gold_smiles, pred_smiles))
    if num_workers <= 1 or len(pairs) < 4:
        return [tanimoto_similarity(g, p) for g, p in pairs]
    with multiprocessing.Pool(num_workers) as p:
        return p.starmap(tanimoto_similarity, pairs, chunksize=32)


class SmilesEvaluator:
    """Gold-vs-pred scorer (`evaluate.py:157-195`)."""

    def __init__(
        self,
        gold_smiles: Sequence[str],
        num_workers: int = 16,
        tanimoto: bool = False,
    ):
        self.gold_smiles = list(gold_smiles)
        self.num_workers = num_workers
        self.tanimoto = tanimoto
        self.gold_smiles_cistrans, _ = convert_smiles_to_canonsmiles(
            gold_smiles, ignore_cistrans=True, num_workers=num_workers
        )
        self.gold_smiles_chiral, _ = convert_smiles_to_canonsmiles(
            gold_smiles, ignore_chiral=True, ignore_cistrans=True,
            num_workers=num_workers,
        )
        self.gold_smiles_cistrans = self._replace_empty(self.gold_smiles_cistrans)
        self.gold_smiles_chiral = self._replace_empty(self.gold_smiles_chiral)

    @staticmethod
    def _replace_empty(smiles_list: Sequence[Optional[str]]) -> List[str]:
        return [
            s if s is not None and isinstance(s, str) and s != "" else "<empty>"
            for s in smiles_list
        ]

    def evaluate(self, pred_smiles: Sequence[str], include_details: bool = False) -> Dict:
        results: Dict = {}
        if self.tanimoto:
            results["tanimoto"] = float(
                np.mean(
                    compute_tanimoto_similarities(
                        self.gold_smiles, pred_smiles, self.num_workers
                    )
                )
            )
        pred_cistrans, _ = convert_smiles_to_canonsmiles(
            pred_smiles, ignore_cistrans=True, num_workers=self.num_workers
        )
        gold_ct = np.array(self.gold_smiles_cistrans)
        pred_ct = np.array(pred_cistrans)
        results["canon_smiles"] = float(np.mean(gold_ct == pred_ct))
        if include_details:
            results["canon_smiles_details"] = gold_ct == pred_ct
        pred_chiral, _ = convert_smiles_to_canonsmiles(
            pred_smiles, ignore_chiral=True, ignore_cistrans=True,
            num_workers=self.num_workers,
        )
        results["graph"] = float(
            np.mean(np.array(self.gold_smiles_chiral) == np.array(pred_chiral))
        )
        chiral = [
            (g, p) for g, p in zip(self.gold_smiles_cistrans, pred_cistrans) if "@" in g
        ]
        results["chiral"] = (
            float(np.mean([g == p for g, p in chiral])) if chiral else -1
        )
        results["chiral_ratio"] = len(chiral) / max(len(self.gold_smiles), 1)
        return results
