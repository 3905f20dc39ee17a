#!/bin/bash
# Evaluation on the real-world suites with the PyTorch port — scripts/eval.sh
# over molnextr-torch-bench (add --device cpu off the card); the exps/eval.sh analogue
# of the reference. Each CSV has image_id, SMILES, file_path.
set -euo pipefail

MODEL=${MODEL:-output/molnextr/ckpt_best}

for ds in CLEF UOB USPTO JPO staker acs; do
  csv="data/real/${ds}.csv"
  [ -f "$csv" ] || { echo "skip $ds (no $csv)"; continue; }
  molnextr-torch-bench --model_path "$MODEL" --eval_csv "$csv" \
    --output "eval_${ds}.json"
done
