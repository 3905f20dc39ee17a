"""Self-contained cheminformatics kernel.

Replaces the reference's native-dependency stack (RDKit wheel + vendored
Indigo C++ ctypes bindings, `MolNexTR/indigo/`) with an
in-repo implementation of exactly the surface the OCSR pipeline uses:
parsing, canonical writing, sanitization, stereo perception, molfile output,
substructure matching, 2D layout, rendering, fingerprints, and the
graph->SMILES conversion with abbreviation expansion.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from molnextr_tpu_torch.chem.mol import Atom, Bond, ChemError, Mol  # noqa: F401
from molnextr_tpu_torch.chem.smiles_parser import SmilesParseError, parse_smiles
from molnextr_tpu_torch.chem.smiles_writer import write_smiles
from molnextr_tpu_torch.chem.aromaticity import aromatize, kekulize, sanitize
from molnextr_tpu_torch.chem.stereo import (
    assign_chirality_from_2d,
    assign_db_stereo_from_2d,
    perceive_db_stereo_from_directions,
)
from molnextr_tpu_torch.tokenization import atomwise_tokens


def mol_from_smiles(smiles: str, do_sanitize: bool = True, strict: bool = False) -> Mol:
    """Parse + sanitize + perceive stereo: the ``Chem.MolFromSmiles`` analogue."""
    mol = parse_smiles(smiles, strict=strict)
    if do_sanitize:
        sanitize(mol, strict=strict)
    perceive_db_stereo_from_directions(mol)
    return mol


def mol_to_smiles(
    mol: Mol,
    isomeric: bool = True,
    canonical: bool = True,
    alias_mode: bool = False,
) -> str:
    return write_smiles(mol, isomeric=isomeric, canonical=canonical, alias_mode=alias_mode)


def _is_parseable_bracket(token: str) -> bool:
    from molnextr_tpu_torch.chem.smiles_parser import _parse_bracket

    return not _parse_bracket(token[1:-1]).alias


def canonicalize_smiles(
    smiles: str,
    ignore_chiral: bool = False,
    ignore_cistrans: bool = False,
    replace_rgroup: bool = True,
) -> Tuple[str, bool]:
    """Canonical form + success flag (`evaluate.py:29-63`)."""
    if not isinstance(smiles, str) or smiles == "":
        return "", False
    if ignore_cistrans:
        smiles = smiles.replace("/", "").replace("\\", "")
    if replace_rgroup:
        tokens = atomwise_tokens(smiles)
        for j, token in enumerate(tokens):
            if token and token[0] == "[" and token[-1] == "]":
                symbol = token[1:-1]
                if symbol[:1] == "R" and symbol[1:].isdigit():
                    tokens[j] = f"[{symbol[1:]}*]"
                elif not _is_parseable_bracket(token):
                    tokens[j] = "*"
        smiles = "".join(tokens)
    try:
        mol = mol_from_smiles(smiles, do_sanitize=True, strict=False)
        if mol.num_atoms() == 0:
            return smiles, False
        if ignore_chiral:
            for atom in mol.atoms:
                atom.chiral = 0
        canon = write_smiles(mol, isomeric=True, canonical=True)
        return canon, True
    except Exception:
        return smiles, False


def canon_smiles(smiles: str, useChiral: bool = True) -> str:
    """``Chem.CanonSmiles`` analogue; raises on parse failure."""
    mol = mol_from_smiles(smiles, do_sanitize=True, strict=True)
    if not useChiral:
        for atom in mol.atoms:
            atom.chiral = 0
        mol.db_stereo = []
    return write_smiles(mol, isomeric=True, canonical=True)


def num_atoms(smiles: str) -> int:
    try:
        return mol_from_smiles(smiles).num_atoms()
    except Exception:
        return 0
