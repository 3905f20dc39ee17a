"""Single-image prediction walkthrough with the PyTorch port.

Run:  python examples/predict_example_torch.py [image] [--device cpu]
The image defaults to ``molnextr_tpu_torch/fixtures/demo_0.png``; any format
``imread`` reads will do.  Uses seeded random weights unless
MOLNEXTR_MODEL_PATH points at a bundle (``examples/demo_model`` is one).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from molnextr_tpu_torch.api import get_predictions  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
p = argparse.ArgumentParser()
p.add_argument("image", nargs="?", default=os.path.join(ROOT, "molnextr_tpu_torch", "fixtures",
                                                        "demo_0.png"))
p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = p.parse_args()

result = get_predictions(args.image, atoms_bonds=True, predicted_molfile=True, device=args.device)
print("SMILES:", result["predicted_smiles"])
print("atoms:", json.dumps(result["atom_sets"][:5], indent=2))
print("bonds:", json.dumps(result["bond_sets"][:5], indent=2))
print("molfile (head):")
print("\n".join(result["predicted_molfile"].splitlines()[:8]))
print("device:", result["device_info"], "| took", round(result["prediction_time_seconds"], 2), "s")
