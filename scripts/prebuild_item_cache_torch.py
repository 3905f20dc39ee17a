#!/usr/bin/env python
"""Prebuild the item cache of a ``train_druglike_torch.py`` run: every train
item built on the host with the run's config, written to
``<save-path>/item_cache.pkl``, so that the run (one process, no workers)
skips rendering from step 0.

Usage (the training run's data flags):
    python scripts/prebuild_item_cache_torch.py --corpus 20000 --valid 256 \\
        --batch-size 128 --no-augment --save-path output/druglike3
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from molnextr_tpu_torch.train.druglike import prebuild_main  # noqa: E402

if __name__ == "__main__":
    prebuild_main()
