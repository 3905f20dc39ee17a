#!/usr/bin/env python
"""A/B the int8 KV-cache decode against the dense cache on a trained bundle
with the PyTorch port (``scripts/ab_int8_suites.py``): both arms' batch
suites and the per-sample SMILES agreement.

Usage:
    python scripts/ab_int8_suites_torch.py --model_path examples/demo_model [--n 256] [--output AB_INT8.json]

Flags: ``molnextr_tpu_torch/diagnostics.py::ab_int8_parser`` (``--device cpu`` runs it on the CPU).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from molnextr_tpu_torch.diagnostics import ab_int8  # noqa: E402

if __name__ == "__main__":
    ab_int8()
