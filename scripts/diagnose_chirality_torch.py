#!/usr/bin/env python
"""Where the stereo signal drops, stage by stage, with the PyTorch port
(``scripts/diagnose_chirality.py``): label oracle, model tokens, model
edges, the whole pipeline.

Usage:
    python scripts/diagnose_chirality_torch.py --bundle output/chiral_proof/ckpt_best --corpus output/chiral_proof/corpus_valid.txt

Flags: ``molnextr_tpu_torch/diagnostics.py::diagnose_chirality_parser`` (``--device cpu`` runs it on the CPU).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from molnextr_tpu_torch.diagnostics import diagnose_chirality  # noqa: E402

if __name__ == "__main__":
    diagnose_chirality()
