"""MDL molfile (V2000) writer.

Replaces ``Chem.MolToMolBlock`` for the prediction API's
``predicted_molfile`` output (`MolNexTR/chemical.py:944-948`,
`molnextr.py:289-293`).  Writes 2D coordinates, bond wedge/dash stereo flags,
charges (M  CHG), isotopes (M  ISO) and superatom aliases (A lines).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from molnextr_tpu_torch.chem.mol import (
    AROMATIC, DASH_BEGIN, DOUBLE, SINGLE, TRIPLE, WEDGE_BEGIN, Mol,
)

_BOND_CODE = {SINGLE: 1, DOUBLE: 2, TRIPLE: 3, AROMATIC: 4}


def write_molfile(mol: Mol, name: str = "", program: str = "molnextr_tpu") -> str:
    """Serialize to a V2000 molblock string."""
    n = mol.num_atoms()
    bonds = list(mol.iter_bonds())
    coords = mol.coords if len(mol.coords) == n else [(0.0, 0.0)] * n

    lines: List[str] = [name, f"  {program[:8]:<8}2D", ""]
    lines.append(
        f"{n:>3}{len(bonds):>3}  0  0  0  0  0  0  0  0999 V2000"
    )
    for i, atom in enumerate(mol.atoms):
        x, y = coords[i]
        sym = atom.symbol if atom.symbol != "*" else "*"
        # molfile y axis points up; image-space y points down
        lines.append(
            f"{x:>10.4f}{-y:>10.4f}{0.0:>10.4f} {sym:<3}"
            f" 0  0  0  0  0  0  0  0  0  0  0  0"
        )
    for b in bonds:
        stereo = 0
        if b.wedge == WEDGE_BEGIN:
            stereo = 1
        elif b.wedge == DASH_BEGIN:
            stereo = 6
        lines.append(
            f"{b.a1 + 1:>3}{b.a2 + 1:>3}{_BOND_CODE.get(b.order, 1):>3}{stereo:>3}"
        )
    charged = [(i + 1, a.charge) for i, a in enumerate(mol.atoms) if a.charge]
    for start in range(0, len(charged), 8):
        chunk = charged[start : start + 8]
        lines.append(
            f"M  CHG{len(chunk):>3}"
            + "".join(f"{idx:>4}{chg:>4}" for idx, chg in chunk)
        )
    isotopes = [(i + 1, a.isotope) for i, a in enumerate(mol.atoms) if a.isotope]
    for start in range(0, len(isotopes), 8):
        chunk = isotopes[start : start + 8]
        lines.append(
            f"M  ISO{len(chunk):>3}"
            + "".join(f"{idx:>4}{iso:>4}" for idx, iso in chunk)
        )
    for i, atom in enumerate(mol.atoms):
        if atom.alias:
            lines.append(f"A  {i + 1:>3}")
            lines.append(atom.alias)
    lines.append("M  END")
    return "\n".join(lines) + "\n"
