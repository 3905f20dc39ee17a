"""Shared utilities: format metadata, meters, logging, seeding, CSV input.

Copied from ``molnextr_tpu/utils.py`` for the PyTorch port; the changes:
:func:`is_main_process` asks ``torch.distributed`` instead of JAX, and
:func:`read_csv` reads the CLIs' CSV files with the ``csv`` module, as
``pandas.read_csv`` would type them (the card's machine has no pandas).
"""

from __future__ import annotations

import csv
import json
import logging
import re
import math
import os
import random
import time
from typing import Any, Dict, List

import numpy as np

# Sequence-length caps per output format (`MolNexTR/utils.py:12-26`).
FORMAT_INFO: Dict[str, Dict[str, Any]] = {
    "inchi": {"name": "InChI_text", "max_len": 300},
    "atomtok": {"name": "SMILES_atomtok", "max_len": 256},
    "nodes": {"max_len": 384},
    "atomtok_coords": {"max_len": 480},
    "chartok_coords": {"max_len": 480},
}

logger = logging.getLogger("molnextr_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("MOLNEXTR_DEBUG", "INFO").upper())


def seed_everything(seed: int = 42) -> None:
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)


def is_main_process() -> bool:
    from molnextr_tpu_torch.parallel.distributed import is_main_process as main

    return main()


def print_rank_0(message: str) -> None:
    if is_main_process():
        print(message, flush=True)


class AverageMeter:
    """Running average (`utils.py:66-82`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class EpochMeter(AverageMeter):
    def __init__(self):
        super().__init__()
        self.epoch = AverageMeter()

    def update(self, val, n: int = 1):
        super().update(val, n)
        self.epoch.update(val, n)


class LossMeter(EpochMeter):
    """Tracks the total loss plus named sub-losses (`utils.py:94-111`)."""

    def __init__(self):
        self.subs: Dict[str, EpochMeter] = {}
        super().__init__()

    def reset(self):
        super().reset()
        for m in self.subs.values():
            m.reset()

    def update(self, loss, losses: Dict[str, Any], n: int = 1):
        super().update(float(loss), n)
        for k, v in losses.items():
            self.subs.setdefault(k, EpochMeter()).update(float(v), n)


def as_minutes(s: float) -> str:
    m = math.floor(s / 60)
    return "%dm %ds" % (m, s - m * 60)


def time_since(since: float, percent: float) -> str:
    s = time.time() - since
    es = s / max(percent, 1e-9)
    return "%s (remain %s)" % (as_minutes(s), as_minutes(es - s))


def save_config(cfg, save_path: str) -> str:
    os.makedirs(save_path, exist_ok=True)
    path = os.path.join(save_path, "config.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return path


def round_floats(o):
    if isinstance(o, float):
        return round(o, 3)
    if isinstance(o, dict):
        return {k: round_floats(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [round_floats(x) for x in o]
    return o


def format_df(df):
    """JSON-encode nested columns for CSV output (`utils.py:155-163`)."""

    def _dumps(obj):
        if obj is None:
            return obj
        return json.dumps(round_floats(obj)).replace(" ", "")

    for field in ["node_coords", "node_symbols", "edges"]:
        if field in df.columns:
            df[field] = [_dumps(obj) for obj in df[field]]
    return df


# the cells pandas.read_csv reads as missing by default
CSV_NA = frozenset(["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                    "nan", "null"])
_INT = re.compile(r"[+-]?[0-9]+")


def _typed_column(cells: List[str]) -> List[Any]:
    """One column as pandas types it: missing cells are NaN (a new float
    each, so no two are equal); a column whose other cells all read as
    integers holds ints, as numbers floats, else the strings."""
    present = [c for c in cells if c not in CSV_NA]
    if present and all(_INT.fullmatch(c.strip()) for c in present):
        cast = int
    else:
        cast = float
        for c in present:
            try:
                float(c)
            except ValueError:
                cast = str
                break
    return [float("nan") if c in CSV_NA else cast(c) for c in cells]


def read_csv(path: str) -> Dict[str, List[Any]]:
    """Column name -> typed cells of a CSV file with a header row (blank
    lines skipped, short rows padded with missing cells), in the meaning
    ``pandas.read_csv`` gives them: see :func:`_typed_column`."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header, body = rows[0], rows[1:]
    return {name: _typed_column([r[i] if i < len(r) else "" for r in body])
            for i, name in enumerate(header)}
