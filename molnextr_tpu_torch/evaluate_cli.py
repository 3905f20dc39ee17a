"""``molnextr-torch-evaluate``: score predicted SMILES against gold.

Port of ``molnextr_tpu/evaluate_cli.py`` with the same flags and JSON.  The
CSV files are read with ``utils.read_csv``, which keeps the meaning pandas
gives the JAX package's code: missing cells (pandas' NA strings, the empty
cell among them) score as empty predictions, and ``image_id`` cells compare
as pandas parses their column (an integer column matches ``"7"`` with
``7``; a missing id matches nothing).  Prediction rows are aligned to gold
rows by ``image_id`` when both files have it (a missing prediction is
empty), else by position; a length mismatch is reported.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Score predicted SMILES against gold")
    p.add_argument("--gold_file", type=str, required=True)
    p.add_argument("--pred_file", type=str, required=True)
    p.add_argument("--pred_field", type=str, default="SMILES")
    p.add_argument("--gold_field", type=str, default="SMILES")
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--tanimoto", action="store_true")
    p.add_argument("--keep_main", action="store_true")
    args = p.parse_args(argv)

    from molnextr_tpu_torch.chem.graph import keep_main_molecule
    from molnextr_tpu_torch.evaluation import SmilesEvaluator
    from molnextr_tpu_torch.utils import read_csv

    gold, pred = read_csv(args.gold_file), read_csv(args.pred_file)
    n_gold, n_pred = len(gold[args.gold_field]), len(pred[args.pred_field])
    if n_pred != n_gold:
        print(f"Pred ({n_pred}) and Gold ({n_gold}) have different lengths!")

    if "image_id" in gold and "image_id" in pred:
        pred_map = dict(zip(pred["image_id"], pred[args.pred_field]))
        preds = [pred_map.get(i, "") for i in gold["image_id"]]
    else:
        preds = list(pred[args.pred_field])[:n_gold]
        preds += [""] * (n_gold - len(preds))
    preds = ["" if not isinstance(s, str) else s for s in preds]
    if args.keep_main:
        preds = keep_main_molecule(preds, num_workers=args.num_workers)

    evaluator = SmilesEvaluator(gold[args.gold_field], num_workers=args.num_workers,
                                tanimoto=args.tanimoto)
    print(json.dumps(evaluator.evaluate(preds), indent=4))


if __name__ == "__main__":
    main()
