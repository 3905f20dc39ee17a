#!/usr/bin/env python
"""Error modes of a trained bundle with the PyTorch port
(``scripts/diagnose_errors.py``): graph against token SMILES, invalid
predictions, the beam's oracle at k.

Usage:
    python scripts/diagnose_errors_torch.py --model_path examples/demo_model --n 64 [--beam 4]

Flags: ``molnextr_tpu_torch/diagnostics.py::diagnose_errors_parser`` (``--device cpu`` runs it on the CPU).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from molnextr_tpu_torch.diagnostics import diagnose_errors  # noqa: E402

if __name__ == "__main__":
    diagnose_errors()
