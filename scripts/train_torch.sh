#!/bin/bash
# Production training run with the PyTorch port — scripts/train.sh over
# molnextr-torch-train (add --device cpu off the card); the exps/train.sh analogue
# of the reference: PubChem synthetic rendering + USPTO aux,
# swin_base encoder, chartok_coords + edges, 40 epochs.
#
# Data CSVs need a SMILES column; aux/valid CSVs may add file_path (+ the
# reference's node_coords column is accepted for pseudo-coord labels).
set -euo pipefail

SAVE_PATH=${SAVE_PATH:-output/molnextr}
mkdir -p "$SAVE_PATH"

molnextr-torch-train \
  --train_file data/pubchem/train_200k.csv \
  --aux_file data/uspto_mol/train.csv \
  --valid_file data/synthetic/valid.csv \
  --save_path "$SAVE_PATH" \
  --encoder swin_base \
  --formats chartok_coords,edges \
  --epochs 40 \
  --batch_size 256 \
  --encoder_lr 4e-4 \
  --decoder_lr 4e-4 \
  --num_workers 8 \
  "$@"
