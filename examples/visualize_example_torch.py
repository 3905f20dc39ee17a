"""Gold-vs-predicted side-by-side drawing with the PyTorch port.

Draws a molecule with the port's renderer (or reads a drawing with
``--image``), predicts it back, and writes the drawing and the prediction's
own drawing side by side as a PNG.

Run:  python examples/visualize_example_torch.py ["CC(=O)Oc1ccccc1C(=O)O" [out.png]]
          [--image drawing.png] [--device cpu]
Uses seeded random weights unless MOLNEXTR_MODEL_PATH points at a bundle.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from molnextr_tpu_torch.api import MolNexTR  # noqa: E402
from molnextr_tpu_torch.chem import mol_from_smiles  # noqa: E402
from molnextr_tpu_torch.chem.layout import layout  # noqa: E402
from molnextr_tpu_torch.chem.render import render  # noqa: E402
from molnextr_tpu_torch.config import Config  # noqa: E402
from molnextr_tpu_torch.data.image import imread  # noqa: E402
from molnextr_tpu_torch.data.png import write_png  # noqa: E402


def drawing(smiles: str) -> np.ndarray:
    """RGB drawing of ``smiles`` (the renderer draws B, G, R, as OpenCV does)."""
    mol = mol_from_smiles(smiles, strict=False)
    layout(mol)
    return np.ascontiguousarray(render(mol, 384)[0][..., ::-1])


p = argparse.ArgumentParser()
p.add_argument("smiles", nargs="?", default="CC(=O)Oc1ccccc1C(=O)O")
p.add_argument("out_path", nargs="?", default="side_by_side.png")
p.add_argument("--image", default=None, help="predict this drawing instead of rendering SMILES")
p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = p.parse_args()

gold = imread(args.image) if args.image else drawing(args.smiles)
if gold is None:
    raise SystemExit(f"cannot read {args.image}")
bundle = os.environ.get("MOLNEXTR_MODEL_PATH")
model = MolNexTR(model_path=bundle, device=args.device) if bundle else \
    MolNexTR(cfg=Config(), device=args.device)  # seeded random weights
pred = model.predict_image(gold)
print("gold:", args.image or args.smiles)
print("pred:", pred["predicted_smiles"])

try:
    pred_img = drawing(pred["predicted_smiles"])
except Exception:
    pred_img = np.full((384, 384, 3), 255, np.uint8)
height = max(gold.shape[0], pred_img.shape[0])
panels = [np.pad(im, ((0, height - im.shape[0]), (0, 0), (0, 0)), constant_values=255)
          for im in (gold, pred_img)]
write_png(args.out_path, np.concatenate(panels, axis=1))
print("wrote", args.out_path)
