"""Predicted graph -> molecule -> SMILES / molfile.

The host-side assembly layer: takes the model's (coords, symbols, edges)
prediction and produces canonical SMILES plus a molblock, expanding
functional-group abbreviations.  Behavioral counterpart of
`MolNexTR/chemical.py:880-1036` (graph assembly,
``_verify_chirality``, ``_expand_functional_group``, ``postprocess_smiles``,
``keep_main_molecule``) on top of the self-contained ``molnextr_tpu.chem``
kernel instead of RDKit.

Chirality transfer during expansion is exact by construction: the kernel
stores tetrahedral parity as an ordered neighbor list, so splicing a
substituent just substitutes the placeholder's index in that list — no
swap-count bookkeeping needed (the reference reconstructs parity through
atom-prop marks, `chemical.py:735-830`).
"""

from __future__ import annotations

import multiprocessing
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from molnextr_tpu_torch.chem import mol_from_smiles
from molnextr_tpu_torch.chem.abbreviations import ABBREVIATIONS, RGROUP_SYMBOLS
from molnextr_tpu_torch.chem.aromaticity import sanitize
from molnextr_tpu_torch.chem.formula import condensed_formula_to_smiles
from molnextr_tpu_torch.chem.mol import (
    AROMATIC, DASH_BEGIN, DEFAULT_VALENCES, DOUBLE, SINGLE, TRIPLE,
    WEDGE_BEGIN, Atom, ChemError, Mol,
)
from molnextr_tpu_torch.chem.molfile import write_molfile
from molnextr_tpu_torch.chem.smiles_parser import _parse_bracket, parse_smiles
from molnextr_tpu_torch.chem.smiles_writer import write_smiles
from molnextr_tpu_torch.chem.stereo import (
    assign_chirality_from_2d,
    assign_db_stereo_from_2d,
)

_RGROUPS = set(RGROUP_SYMBOLS)


def normalize_nodes(nodes: np.ndarray, flip_y: bool = True) -> np.ndarray:
    """Normalize coordinates to [0, 1] (`chemical.py:201-210`)."""
    x, y = nodes[:, 0], nodes[:, 1]
    minx, maxx = x.min(), x.max()
    miny, maxy = y.min(), y.max()
    x = (x - minx) / max(maxx - minx, 1e-6)
    if flip_y:
        y = (maxy - y) / max(maxy - miny, 1e-6)
    else:
        y = (y - miny) / max(maxy - miny, 1e-6)
    return np.stack([x, y], axis=1)


def _atom_from_symbol(symbol: str) -> Atom:
    """Predicted symbol token -> Atom; unknown tokens become aliased ``*``.

    Mirrors the per-symbol branch of `_convert_graph_to_smiles`
    (`chemical.py:884-907`): R-groups keep their number as an isotope tag,
    abbreviations become aliased placeholders, plain tokens parse as atoms.
    """
    inner = symbol[1:-1] if symbol.startswith("[") and symbol.endswith("]") else symbol
    if inner in _RGROUPS:
        atom = Atom("*")
        if inner[:1] == "R" and inner[1:].isdigit():
            atom.isotope = int(inner[1:])
        atom.alias = inner
        return atom
    if inner in ABBREVIATIONS:
        atom = Atom("*")
        atom.alias = inner
        return atom
    parsed = _parse_bracket(inner)
    if parsed.alias:
        return parsed  # unparseable -> aliased placeholder
    parsed.chiral = 0  # chirality comes from geometry, not the token
    parsed.chiral_order = []
    if not symbol.startswith("["):
        parsed.explicit_h = -1  # organic-subset token: implicit H
    return parsed


def free_valence(mol: Mol, idx: int) -> int:
    """Open valence of a bracket atom in an expansion fragment.

    The analogue of RDKit's radical-electron count on table SMILES like
    ``[C](=O)OC(C)(C)C`` (`chemical.py:676-686`).
    """
    atom = mol.atoms[idx]
    if atom.symbol == "*":
        return 1
    if atom.explicit_h < 0:
        return 0  # organic-subset atom: implicit H fills the valence
    caps = DEFAULT_VALENCES.get(atom.symbol)
    if not caps:
        return 0
    used = int(round(mol.bond_order_sum(idx))) + atom.explicit_h
    # step up through the valence list until there is room: a bracket
    # ``[S](=O)=O`` in a table entry means hexavalent sulfonyl with two open
    # slots, not a saturated SO2 molecule
    for cap in caps:
        adj = cap + (atom.charge if atom.symbol in ("N", "P", "O", "S") else 0)
        if adj - used > 0:
            return int(adj - used)
    return 0


def _attachment_points(sub: Mol, sub_smiles: str) -> List[int]:
    """Attachment atoms of an expansion fragment, in order
    (`chemical.py:672-706`): open-valence atoms; atom 0 is always primary
    when the SMILES begins with a bracket or ``*``."""
    points = [i for i in range(sub.num_atoms()) if free_valence(sub, i) > 0]
    if sub_smiles[:1] in ("[", "*") and 0 not in points:
        points.insert(0, 0)
    if not points:
        points = [0]
    return points


def expand_functional_groups(mol: Mol) -> Mol:
    """Replace aliased ``*`` placeholders with their substituent graphs.

    R-group placeholders stay.  Unexpandable symbols keep the placeholder
    (isotope cleared), matching `chemical.py:597-607`.
    """
    if not any(a.symbol == "*" and a.alias for a in mol.atoms):
        return mol
    mol = mol.copy()
    to_remove: List[int] = []
    for i in range(mol.num_atoms()):
        atom = mol.atoms[i]
        if atom.symbol != "*" or not atom.alias:
            continue
        symbol = atom.alias
        if symbol in _RGROUPS:
            continue
        bonds = mol.bonds_of(i)
        total_bonds = int(sum(b.order_value() for b in bonds))
        if symbol in ABBREVIATIONS:
            sub_smiles = ABBREVIATIONS[symbol].smiles
        else:
            sub_smiles = condensed_formula_to_smiles(symbol, max(total_bonds, 1))
        sub = None
        if sub_smiles:
            try:
                sub = parse_smiles(sub_smiles, strict=False)
                sanitize(sub, strict=False)
            except Exception:
                sub = None
        if sub is None or sub.num_atoms() == 0:
            atom.isotope = 0
            continue

        neighbor_bonds = [(b.other(i), b.order) for b in bonds]
        attach = _attachment_points(sub, sub_smiles)
        # splice the substituent atoms into the main graph
        base = mol.num_atoms()
        ph_coord = mol.coords[i] if i < len(mol.coords) else (0.0, 0.0)
        for a in sub.atoms:
            mol.add_atom(a.copy())
            if mol.coords:
                mol.coords.append(ph_coord)
        for b in sub.iter_bonds():
            mol.add_bond(base + b.a1, base + b.a2, b.order, b.wedge, b.direction)
        for a_idx in range(sub.num_atoms()):
            mol.atoms[base + a_idx].chiral_order = [
                (base + x if x >= 0 else x) for x in sub.atoms[a_idx].chiral_order
            ]
        if hasattr(sub, "db_stereo") and sub.db_stereo:
            own = getattr(mol, "db_stereo", [])
            own.extend(
                (base + c1, base + n1, base + c2, base + n2, cis)
                for (c1, n1, c2, n2, cis) in sub.db_stereo
            )
            mol.db_stereo = own

        for j, (nbr, order) in enumerate(neighbor_bonds):
            target = base + attach[min(j, len(attach) - 1)]
            mol.remove_bond(i, nbr)
            if mol.bond_between(nbr, target) is None:
                mol.add_bond(nbr, target, min(max(order, 1), 3))
            # exact chirality transfer: the placeholder's slot in any chiral
            # neighbor's ordered list becomes the attachment atom
            for lst_owner in (nbr,):
                co = mol.atoms[lst_owner].chiral_order
                mol.atoms[lst_owner].chiral_order = [
                    target if x == i else x for x in co
                ]
            mol.atoms[target].chiral_order.append(nbr)
        mol.compact()
        to_remove.append(i)

    if to_remove:
        mol = mol.remove_atoms(to_remove)
    return mol


def _build_graph_mol(
    coords: Sequence[Sequence[float]],
    symbols: Sequence[str],
    edges: Sequence[Sequence[int]],
) -> Mol:
    """Assemble the raw predicted graph (`chemical.py:880-926`)."""
    mol = Mol()
    n = len(symbols)
    for i in range(n):
        mol.add_atom(_atom_from_symbol(symbols[i]))
    for i in range(n):
        for j in range(i + 1, n):
            e = int(edges[i][j])
            if e == 0:
                continue
            if e in (1, 2, 3, 4):
                mol.add_bond(i, j, e)
            elif e == 5:
                mol.add_bond(i, j, SINGLE, wedge=WEDGE_BEGIN)
            elif e == 6:
                mol.add_bond(i, j, SINGLE, wedge=DASH_BEGIN)
            # SMILES-encounter neighbor order for downstream parity handling
            mol.atoms[i].chiral_order.append(j)
            mol.atoms[j].chiral_order.append(i)
    if coords is not None and len(coords) == n:
        mol.coords = [(float(x), float(y)) for x, y in coords]
    return mol


def _convert_graph_to_smiles(
    coords,
    symbols,
    edges,
    image_shape: Optional[Tuple[int, int]] = None,
) -> Tuple[str, str, bool]:
    """One-molecule conversion: returns (smiles, molblock, success)."""
    try:
        if image_shape is not None and coords is not None and len(coords):
            height, width = image_shape[:2]
            ratio = width / max(height, 1)
            coords = [[x * ratio * 10, y * 10] for x, y in coords]
        mol = _build_graph_mol(coords, symbols, edges)
    except Exception:
        return "<invalid>", "", False
    try:
        sanitize(mol, strict=False)
        assign_db_stereo_from_2d(mol)
        assign_chirality_from_2d(mol)
        # molblock is written before expansion so it keeps coordinates and
        # the superatom aliases (`chemical.py:944-946`)
        pred_molblock = write_molfile(mol)
        expanded = expand_functional_groups(mol)
        sanitize(expanded, strict=False)
        pred_smiles = write_smiles(expanded, isomeric=True, canonical=True)
        return pred_smiles, pred_molblock, True
    except Exception:
        try:
            pred_smiles = write_smiles(mol, isomeric=True, canonical=True, alias_mode=True)
        except Exception:
            pred_smiles = "<invalid>"
        return pred_smiles, "", False


def convert_graph_to_smiles(
    coords, symbols, edges, images=None, num_workers: int = 16
):
    """Batch API with a process pool (`chemical.py:960-975`)."""
    shapes = [im.shape[:2] if im is not None else None for im in images] if images is not None else [None] * len(symbols)
    args = list(zip(coords, symbols, edges, shapes))
    if num_workers <= 1 or len(args) < 4:
        results = [_convert_graph_to_smiles(*a) for a in args]
    else:
        with multiprocessing.Pool(num_workers) as p:
            results = p.starmap(_convert_graph_to_smiles, args, chunksize=128)
    smiles_list, molblock_list, success = zip(*results)
    return list(smiles_list), list(molblock_list), float(np.mean(success))


def _postprocess_smiles(
    smiles: str,
    coords=None,
    symbols=None,
    edges=None,
    molblock: bool = False,
) -> Tuple[str, str, bool]:
    """Re-derive stereo from coords and expand groups in a predicted SMILES
    string (`chemical.py:978-1005`)."""
    if not isinstance(smiles, str) or smiles == "":
        return "", "", False
    try:
        src = smiles.replace("<unk>", "C")
        if coords is not None and symbols is not None and edges is not None:
            src = src.replace("@", "").replace("/", "").replace("\\", "")
            mol = parse_smiles(src, strict=False)
            sanitize(mol, strict=False)
            if len(coords) == mol.num_atoms():
                mol.coords = [(float(x), float(y)) for x, y in coords]
                # restore wedge directions from the edge matrix
                n = mol.num_atoms()
                for i in range(n):
                    for j in range(n):
                        e = int(edges[i][j])
                        if e in (5, 6):
                            bidx = mol.bond_between(i, j)
                            if bidx is not None:
                                b = mol.bonds[bidx]
                                if b.a1 != i:
                                    b.a1, b.a2 = b.a2, b.a1
                                b.wedge = WEDGE_BEGIN if e == 5 else DASH_BEGIN
                assign_db_stereo_from_2d(mol)
                assign_chirality_from_2d(mol)
        else:
            mol = parse_smiles(src, strict=False)
            sanitize(mol, strict=False)
        pred_molblock = write_molfile(mol) if molblock else ""
        expanded = expand_functional_groups(mol)
        sanitize(expanded, strict=False)
        pred_smiles = write_smiles(expanded, isomeric=True, canonical=True)
        return pred_smiles, pred_molblock, True
    except Exception:
        return smiles, "", False


def postprocess_smiles(
    smiles, coords=None, symbols=None, edges=None, molblock: bool = False,
    num_workers: int = 16,
):
    """Batch post-processing (`chemical.py:1008-1016`)."""
    if coords is not None and symbols is not None and edges is not None:
        args = list(zip(smiles, coords, symbols, edges))
        fn = _postprocess_smiles
        if num_workers <= 1 or len(args) < 4:
            results = [fn(*a, molblock=molblock) for a in args]
        else:
            with multiprocessing.Pool(num_workers) as p:
                results = p.starmap(fn, args, chunksize=128)
    else:
        if num_workers <= 1 or len(smiles) < 4:
            results = [_postprocess_smiles(s, molblock=molblock) for s in smiles]
        else:
            with multiprocessing.Pool(num_workers) as p:
                results = p.map(_postprocess_smiles, smiles, chunksize=128)
    smiles_list, molblock_list, success = zip(*results)
    return list(smiles_list), list(molblock_list), float(np.mean(success))


def _keep_main_molecule(smiles: str) -> str:
    """Largest fragment only (`chemical.py:1019-1030`)."""
    try:
        mol = mol_from_smiles(smiles, do_sanitize=True, strict=False)
        frags = mol.fragments()
        if len(frags) > 1:
            sizes = [len(f) for f in frags]
            keep = frags[int(np.argmax(sizes))]
            drop = [i for i in range(mol.num_atoms()) if i not in set(keep)]
            mol = mol.remove_atoms(drop)
            smiles = write_smiles(mol, isomeric=True, canonical=True)
    except Exception:
        pass
    return smiles


def keep_main_molecule(smiles, num_workers: int = 16):
    if isinstance(smiles, str):
        return _keep_main_molecule(smiles)
    if num_workers <= 1 or len(smiles) < 4:
        return [_keep_main_molecule(s) for s in smiles]
    with multiprocessing.Pool(num_workers) as p:
        return p.map(_keep_main_molecule, smiles, chunksize=128)
