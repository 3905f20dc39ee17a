#!/usr/bin/env python
"""Overfit a tiny model on K chiral molecules with the PyTorch port and
evaluate it on the same molecules (the chirality proof of
``scripts/overfit_chiral.py``).

Usage:
    python scripts/overfit_chiral_torch.py --k 4 --epochs 400 --save-path output/chiral_proof

Flags: ``molnextr_tpu_torch/train/overfit_chiral.py::make_parser`` (``--device cpu`` runs it on the CPU).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from molnextr_tpu_torch.train.overfit_chiral import main  # noqa: E402

if __name__ == "__main__":
    main()
