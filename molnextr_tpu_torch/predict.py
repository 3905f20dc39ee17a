"""``molnextr-torch-predict``: SMILES (and optionally molfiles, atoms and
bonds, confidences) for image files, as JSON.

Port of ``molnextr_tpu/predict.py`` with the same flags and output, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch versions).
``--batch_size`` sets the batch of ``MolNexTR.predict_image_files``.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Predict SMILES from molecule images")
    p.add_argument("images", nargs="+", help="image file path(s)")
    p.add_argument("--model_path", type=str, default=None,
                   help="model bundle directory or .pth (or set MOLNEXTR_MODEL_PATH)")
    p.add_argument("--atoms_bonds", action="store_true",
                   help="include atom_sets/bond_sets in the output")
    p.add_argument("--confidence", action="store_true", help="include confidence scores")
    p.add_argument("--molfile", action="store_true", help="include the predicted molblock")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--output", type=str, default=None, help="write JSON here")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from molnextr_tpu_torch.api import MolNexTR, MolNexTRSingleton

    if args.model_path:
        model = MolNexTR(model_path=args.model_path, device=args.device)
    else:
        model = MolNexTRSingleton.get_instance(device=args.device)
    outputs = model.predict_image_files(
        args.images, return_atoms_bonds=args.atoms_bonds,
        return_confidence=args.confidence, batch_size=args.batch_size,
    )
    results = []
    for path, out in zip(args.images, outputs):
        d = {"image": path, "predicted_smiles": out["predicted_smiles"]}
        if args.molfile:
            d["predicted_molfile"] = out["predicted_molfile"]
        if args.atoms_bonds:
            d["atom_sets"] = out["atom_sets"]
            d["bond_sets"] = out["bond_sets"]
        if args.confidence and "confidence" in out:
            d["confidence"] = out["confidence"]
        results.append(d)
    text = json.dumps(results, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        print(text)


if __name__ == "__main__":
    main()
