"""Reaction-image synthesis.

Port of ``molnextr_tpu/data/reaction.py`` without OpenCV: renders
``reactants>agents>products`` as side-by-side molecule panels joined by
``+`` signs and a reaction arrow, and returns the combined graph labels in
the same format as the molecule generator.  The arrow is
``chem/raster.py::arrowed_line`` (``cv2.arrowedLine`` at thickness 2,
``tipLength`` 0.25) and the ``+`` is ``raster.put_text`` at
``FONT_HERSHEY_SIMPLEX``, scale 1.0, thickness 2 (weight 600, 27 px), so
the image equals the JAX package's pixel for pixel.  Importing this module
has no side effects.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from molnextr_tpu_torch.chem import raster
from molnextr_tpu_torch.chem.aromaticity import sanitize
from molnextr_tpu_torch.chem.layout import layout
from molnextr_tpu_torch.chem.render import RenderOptions, render
from molnextr_tpu_torch.chem.smiles_parser import parse_smiles
from molnextr_tpu_torch.chem.smiles_writer import write_smiles
from molnextr_tpu_torch.data.synthetic import get_graph

FONT_HERSHEY_SIMPLEX = 0


def _render_panel(smiles: str, size: int, opts: RenderOptions):
    mol = parse_smiles(smiles, strict=True)
    sanitize(mol, strict=False)
    layout(mol)
    img, pix = render(mol, size=size, opts=opts)
    out, order = write_smiles(mol, canonical=False, alias_mode=True, return_order=True)
    return img, pix, mol, out, order


def generate_reaction_image(
    reaction_smiles: str,
    size: int = 384,
    panel: int = 224,
    mol_augment: bool = False,
    debug: bool = False,
) -> Tuple[np.ndarray, str, Dict[str, Any], bool]:
    """reaction SMILES -> (image, label, graph, success).

    The graph concatenates every component's atoms; coords are in final
    image pixels.
    """
    try:
        parts = reaction_smiles.split(">")
        if len(parts) != 3:
            raise ValueError("reaction SMILES needs 2 '>' separators")
        groups = [
            [s for s in part.split(".") if s] for part in parts
        ]  # reactants, agents, products
        opts = RenderOptions(jitter=mol_augment)
        panels: List[Tuple[np.ndarray, np.ndarray, Any, str, List[int]]] = []
        kinds: List[Tuple[int, int]] = []  # (group, index-in-group)
        for gi, group in enumerate(groups):
            for mi, smi in enumerate(group):
                panels.append(_render_panel(smi, panel, opts))
                kinds.append((gi, mi))

        sep = 40
        arrow_w = 90
        widths = []
        for idx, (img, *_rest) in enumerate(panels):
            widths.append(img.shape[1])
        total_w = sum(widths) + sep * max(len(panels) - 1, 0) + arrow_w + 2 * sep
        height = panel + 40
        canvas = np.full((height, total_w, 3), 255, np.uint8)

        label_parts: List[str] = [[], [], []]
        coords: List[List[float]] = []
        symbols: List[str] = []
        all_edges: List[np.ndarray] = []
        x_cursor = sep // 2
        y_off = (height - panel) // 2
        prev_group = 0
        for (img, pix, mol, out_smiles, order), (gi, mi) in zip(panels, kinds):
            if gi != prev_group:
                # draw the reaction arrow between groups
                y_mid = height // 2
                raster.arrowed_line(
                    canvas, (x_cursor + 8, y_mid), (x_cursor + arrow_w - 8, y_mid),
                    (0, 0, 0), 2, tip_length=0.25,
                )
                x_cursor += arrow_w
                prev_group = gi
            elif mi > 0:
                raster.put_text(
                    canvas, "+", (x_cursor + sep // 4, height // 2 + 8),
                    FONT_HERSHEY_SIMPLEX, 1.0, (0, 0, 0), 2,
                )
                x_cursor += sep
            h, w = img.shape[:2]
            canvas[y_off : y_off + h, x_cursor : x_cursor + w] = img
            g = get_graph(mol, img, pix, order)
            for c in g["coords"]:
                coords.append([c[0] + x_cursor, c[1] + y_off])
            symbols.extend(g["symbols"])
            all_edges.append(np.asarray(g["edges"]))
            label_parts[gi].append(out_smiles)
            x_cursor += w

        n = len(symbols)
        edges = np.zeros((n, n), dtype=int)
        off = 0
        for e in all_edges:
            k = e.shape[0]
            edges[off : off + k, off : off + k] = e
            off += k
        label = ">".join(".".join(g) for g in label_parts)
        graph = {
            "coords": coords,
            "symbols": symbols,
            "edges": edges,
            "num_atoms": n,
        }
        return canvas, label, graph, True
    except Exception:
        if debug:
            raise
        return np.full((10, 10, 3), 255, np.float32), reaction_smiles, {}, False
