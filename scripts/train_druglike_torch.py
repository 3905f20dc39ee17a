#!/usr/bin/env python
"""Train a mid-size model on a generated drug-like corpus with the PyTorch
port, on one card (the recipe of ``scripts/train_druglike.py``).

Usage:
    python scripts/train_druglike_torch.py --steps-per-epoch 200 --save-path output/druglike

Flags: ``molnextr_tpu_torch/train/druglike.py::make_parser`` (``--device cpu``
runs it on the CPU).  Writes a checkpoint bundle that ``MolNexTR``, the
bench suites and ``molnextr_tpu.checkpoint`` read.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from molnextr_tpu_torch.train.druglike import main  # noqa: E402

if __name__ == "__main__":
    main()
