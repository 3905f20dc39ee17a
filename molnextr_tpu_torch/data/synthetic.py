"""Synthetic training-image generation.

The TPU-framework replacement of the reference's Indigo-backed generator
(`MolNexTR/dataset.py:36-330`): SMILES -> molecular
augmentations -> 2D layout -> rasterized image + graph labels, entirely on
the self-contained chem kernel.

Augmentations (probabilities follow `dataset.py:27-33`):

* random dearomatize/aromatize of the input,
* functional-group collapse: matched substituents contract into superatom
  labels (e.g. an acetyl group becomes an ``Ac`` pseudo-atom),
* random explicit hydrogens,
* R-group attachment,
* random condensed-formula pseudo-atoms (``C2H4OMe``-style gibberish labels
  that teach the model to read arbitrary group text),
* rendering-style jitter (fonts, thickness, colors, atom ids, comments).

The output SMILES keeps superatoms as bracket tokens (``[Ac]``), matching
``generate_output_smiles`` (`dataset.py:189-207`), and the graph dict holds
pixel coords, per-atom symbol tokens, and the edge matrix with
antisymmetric wedge codes (``edges[t,s] = 11 - stereo``, `dataset.py:264`).
"""

from __future__ import annotations

import random
import string
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from molnextr_tpu_torch.chem.abbreviations import (
    ABBREVIATIONS, ELEMENTS, RGROUP_SYMBOLS, SUBSTITUTIONS,
)
from molnextr_tpu_torch.chem.aromaticity import aromatize, dearomatize, sanitize
from molnextr_tpu_torch.chem.graph import _attachment_points, free_valence
from molnextr_tpu_torch.chem.layout import layout
from molnextr_tpu_torch.chem.match import find_substructures
from molnextr_tpu_torch.chem.mol import Atom, Mol, SINGLE, WEDGE_BEGIN, DASH_BEGIN
from molnextr_tpu_torch.chem.render import RenderOptions, render
from molnextr_tpu_torch.chem.smiles_parser import parse_smiles
from molnextr_tpu_torch.chem.smiles_writer import write_smiles

HYDROGEN_PROB = 0.2
FUNCTIONAL_GROUP_PROB = 0.8
CONDENSED_PROB = 0.5
RGROUP_PROB = 0.5
DEAROMATIZE_PROB = 0.8

# pre-parsed expansion patterns for the matcher (lazy-initialized)
_PATTERNS: Optional[List[Tuple[Any, Mol, Dict[int, int]]]] = None


def _patterns():
    global _PATTERNS
    if _PATTERNS is None:
        pats = []
        for sub in SUBSTITUTIONS:
            try:
                pat = parse_smiles(sub.smiles, strict=False)
                sanitize(pat, strict=False)
            except Exception:
                continue
            attach_free = {
                p: free_valence(pat, p) for p in range(pat.num_atoms())
            }
            for p in _attachment_points(pat, sub.smiles):
                attach_free[p] = max(attach_free.get(p, 0), 3)
            pats.append((sub, pat, attach_free))
        _PATTERNS = pats
    return _PATTERNS


# -- molecular augmentations ---------------------------------------------------


def collapse_functional_groups(mol: Mol) -> Mol:
    """Contract matched substituents into aliased superatoms
    (`dataset.py:36-71`)."""
    if random.random() > FUNCTIONAL_GROUP_PROB:
        return mol
    pats = list(_patterns())
    random.shuffle(pats)
    used: set = set()
    for sub, pat, attach_free in pats:
        if pat.num_atoms() >= mol.num_atoms():
            continue
        try:
            matches = find_substructures(mol, pat, attach_free, max_matches=8)
        except Exception:
            continue
        for mapping in matches:
            if random.random() >= sub.probability:
                continue
            matched = set(mapping.values())
            if matched & used:
                continue
            # external bonds: (outside_atom, order)
            ext: List[Tuple[int, int]] = []
            ok = True
            for m in matched:
                for b in mol.bonds_of(m):
                    o = b.other(m)
                    if o not in matched:
                        ext.append((o, b.order))
            if not ok or not ext:
                continue
            abbrv = random.choice(sub.abbrvs)
            super_idx = mol.add_atom(Atom("*", alias=abbrv))
            if mol.coords:
                anchor = next(iter(matched))
                mol.coords.append(mol.coords[anchor] if anchor < len(mol.coords) else (0.0, 0.0))
            for o, order in ext:
                if mol.bond_between(super_idx, o) is None:
                    mol.add_bond(super_idx, o, order)
            used |= matched
    if used:
        mol = mol.remove_atoms(sorted(used))
    return mol


def add_explicit_hydrogen(mol: Mol) -> Mol:
    """Turn one atom's implicit Hs explicit (`dataset.py:74-88`)."""
    candidates = [
        i for i in range(mol.num_atoms())
        if mol.atoms[i].symbol != "*" and mol.implicit_h(i) > 0
    ]
    if candidates and random.random() < HYDROGEN_PROB:
        idx = random.choice(candidates)
        hs = mol.implicit_h(idx)
        for _ in range(hs):
            h = mol.add_atom(Atom("H"))
            mol.add_bond(h, idx, SINGLE)
        mol.atoms[idx].explicit_h = 0
    return mol


def add_rgroup(mol: Mol, smiles: str) -> Mol:
    """Attach one random R-group label (`dataset.py:91-108`)."""
    if "*" in smiles or random.random() >= RGROUP_PROB:
        return mol
    candidates = [
        i for i in range(mol.num_atoms())
        if mol.atoms[i].symbol != "*" and mol.implicit_h(i) > 0
    ]
    if candidates:
        idx = random.choice(candidates)
        symbol = random.choice(RGROUP_SYMBOLS)
        r = mol.add_atom(Atom("*", alias=symbol))
        mol.add_bond(r, idx, SINGLE)
    return mol


def get_rand_symb() -> str:
    symb = random.choice(ELEMENTS)
    if random.random() < 0.1:
        symb += random.choice(string.ascii_lowercase)
    if random.random() < 0.1:
        symb += random.choice(string.ascii_uppercase)
    if random.random() < 0.1:
        symb = f"({gen_rand_condensed()})"
    return symb


def get_rand_num() -> str:
    if random.random() < 0.9:
        if random.random() < 0.8:
            return ""
        return str(random.randint(2, 9))
    return "1" + str(random.randint(2, 9))


def gen_rand_condensed() -> str:
    tokens = []
    for i in range(5):
        if i >= 1 and random.random() < 0.8:
            break
        tokens.append(get_rand_symb())
        tokens.append(get_rand_num())
    return "".join(tokens)


def add_rand_condensed(mol: Mol) -> Mol:
    """Attach a random condensed-formula pseudo-atom (`dataset.py:111-156`)."""
    if random.random() >= CONDENSED_PROB:
        return mol
    candidates = [
        i for i in range(mol.num_atoms())
        if mol.atoms[i].symbol != "*" and mol.implicit_h(i) > 0
    ]
    if candidates:
        idx = random.choice(candidates)
        r = mol.add_atom(Atom("*", alias=gen_rand_condensed()))
        mol.add_bond(r, idx, SINGLE)
    return mol


# -- wedges from chirality -----------------------------------------------------


def assign_wedges_from_chirality(mol: Mol) -> Mol:
    """Give each chiral center one wedge/dash bond consistent with its
    parity, so rendered stereo matches the label stereo.

    The probe mirrors the layout coords into the IMAGE frame (y down) before
    perceiving: `render._scale_coords` negates y when rasterizing, and the
    label/eval pipeline perceives chirality from those pixel-frame coords
    (`graph.convert_graph_to_smiles` on `get_graph`/token coords).  A wedge
    calibrated in the y-up layout frame would be systematically inverted when
    perceived in the y-down frame — every chirality round-trip failed this
    way until the frames were matched.
    """
    from molnextr_tpu_torch.chem.stereo import assign_chirality_from_2d
    from molnextr_tpu_torch.chem.mol import CHI_NONE

    if not mol.coords:
        return mol
    image_frame_coords = [(x, -y) for (x, y) in mol.coords]
    for idx, atom in enumerate(mol.atoms):
        want = atom.chiral
        if want == CHI_NONE:
            continue
        # pick a non-ring single bond from the center if possible; prefer a
        # neighbor that cannot itself be perceived as a far-end stereocenter
        # (terminal / low-degree, achiral) so the antisymmetric matrix
        # re-rooting never plants a spurious tag at the wide end
        bonds = [
            b for b in mol.bonds_of(idx) if b.order == SINGLE and not b.wedge
        ]
        if not bonds:
            continue
        target = min(
            bonds,
            key=lambda b: (
                mol.atoms[b.other(idx)].chiral != CHI_NONE,
                mol.degree(b.other(idx)) >= 3,
                mol.degree(b.other(idx)),
            ),
        )
        if target.a1 != idx:
            target.a1, target.a2 = target.a2, target.a1
        for wedge in (WEDGE_BEGIN, DASH_BEGIN):
            target.wedge = wedge
            probe = mol.copy()
            probe.coords = list(image_frame_coords)
            probe.atoms[idx].chiral = CHI_NONE
            assign_chirality_from_2d(probe)
            got = probe.atoms[idx]
            if got.chiral == CHI_NONE:
                continue
            # compare parity in the original neighbor order
            from molnextr_tpu_torch.chem.smiles_writer import _perm_parity

            parity = _perm_parity(got.chiral_order, atom.chiral_order)
            eff = got.chiral if parity == 0 or parity is None else (
                3 - got.chiral
            )
            if eff == want:
                break
        else:
            target.wedge = 0
    return mol


# -- graph extraction ----------------------------------------------------------


def get_graph(
    mol: Mol, image: np.ndarray, pixel_coords: np.ndarray,
    order: Optional[List[int]] = None,
) -> Dict[str, Any]:
    """Graph labels from the rendered molecule (`dataset.py:239-276`).

    ``order`` is the SMILES atom-emission order: the coords/symbols/edges
    arrays must be indexed by the label SMILES' atom counter so the training
    targets align (the reference relies on Indigo emitting atoms in index
    order, `dataset.py:467-531`).
    """
    n = mol.num_atoms()
    if order is None:
        order = list(range(n))
    index_map = {old: new for new, old in enumerate(order)}
    coords = [[float(pixel_coords[o][0]), float(pixel_coords[o][1])] for o in order]
    symbols = []
    for o in order:
        a = mol.atoms[o]
        if a.alias:
            symbols.append(f"[{a.alias}]")
        else:
            symbols.append(_atom_token(mol, o))
    edges = np.zeros((n, n), dtype=int)
    for b in mol.iter_bonds():
        s, t = index_map[b.a1], index_map[b.a2]
        edges[s, t] = b.order
        edges[t, s] = b.order
        if b.wedge in (WEDGE_BEGIN, DASH_BEGIN):
            edges[s, t] = b.wedge
            edges[t, s] = 11 - b.wedge
    return {
        "coords": coords,
        "symbols": symbols,
        "edges": edges,
        "num_atoms": n,
    }


def _atom_token(mol: Mol, idx: int) -> str:
    """SMILES-style token for one atom (what the tokenizer will see)."""
    a = mol.atoms[idx]
    sym = a.symbol
    if (
        a.charge == 0 and a.isotope == 0 and a.explicit_h < 0
        and sym in ("B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I")
    ):
        return sym.lower() if a.aromatic else sym
    body = sym.lower() if a.aromatic else sym
    out = "["
    if a.isotope:
        out += str(a.isotope)
    out += body
    h = mol.total_h(idx) - sum(
        1 for nb in mol.neighbors(idx) if mol.atoms[nb].symbol == "H"
    )
    if a.explicit_h >= 0:
        if h == 1:
            out += "H"
        elif h > 1:
            out += f"H{h}"
    if a.charge == 1:
        out += "+"
    elif a.charge == -1:
        out += "-"
    elif a.charge > 1:
        out += f"+{a.charge}"
    elif a.charge < -1:
        out += f"-{-a.charge}"
    return out + "]"


# -- the generator -------------------------------------------------------------


def generate_synthetic_image(
    smiles: str,
    mol_augment: bool = True,
    default_option: bool = False,
    shuffle_nodes: bool = False,
    include_condensed: bool = True,
    size: int = 384,
    debug: bool = False,
) -> Tuple[np.ndarray, str, Dict[str, Any], bool]:
    """SMILES -> (image, label_smiles, graph, success)
    (`dataset.py:279-330`)."""
    try:
        from molnextr_tpu_torch.chem.stereo import perceive_db_stereo_from_directions

        mol = parse_smiles(smiles, strict=True)
        sanitize(mol, strict=False)
        # keep cis/trans specs from the input's /\ markers so the output
        # label preserves them (geometry honors the common trans default;
        # cis double bonds are a known layout limitation)
        perceive_db_stereo_from_directions(mol)
        if mol_augment:
            if random.random() < DEAROMATIZE_PROB:
                dearomatize(mol, strict=False)
            else:
                aromatize(mol)
            mol = collapse_functional_groups(mol)
            mol = add_explicit_hydrogen(mol)
            label_probe = write_smiles(mol, isomeric=True, canonical=False, alias_mode=True)
            mol = add_rgroup(mol, label_probe)
            if include_condensed:
                mol = add_rand_condensed(mol)
        if shuffle_nodes:
            # shuffle by renumbering BEFORE writing, so labels stay aligned
            perm = list(range(mol.num_atoms()))
            random.shuffle(perm)
            mol = mol.renumbered(perm)
        layout(mol, jitter=0.05 if mol_augment else 0.0)
        assign_wedges_from_chirality(mol)
        opts = RenderOptions(jitter=not default_option)
        img, pix = render(mol, size=size, opts=opts)
        out_smiles, order = write_smiles(
            mol, isomeric=True, canonical=False, alias_mode=True, return_order=True
        )
        graph = get_graph(mol, img, pix, order)
        return img, out_smiles, graph, True
    except Exception:
        if debug:
            raise
        img = np.full((10, 10, 3), 255, np.float32)
        return img, smiles, {}, False
