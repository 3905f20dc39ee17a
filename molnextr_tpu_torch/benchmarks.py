"""``molnextr-torch-bench``: the JAX package's five benchmark suites on the
port.

Port of ``molnextr_tpu/benchmarks.py`` with the same suites, keys and
flags, plus ``--device`` (default ``cuda``):

1. ``suite_single_image``: one-call ``predict_final_results`` latency;
2. ``suite_batch_inference``: greedy or beam accuracy and images/s on
   synthetic renders;
3. ``suite_dataset_eval``: a CSV of ``file_path``/``SMILES`` (PNG files,
   read with ``data/png.py``; rows whose file is missing are skipped, as
   ``cv2.imread`` returning None skips them), or a synthetic fallback;
4. ``suite_perturbed``: the clutter perturbations of
   ``get_perturbation_transforms``, drawn from the module-level ``random``
   and ``np.random`` that ``_synthetic_eval_set`` leaves behind, as the JAX
   suite draws them, so its images equal the JAX suite's pixel for pixel;
5. ``suite_train_throughput``: the augmenting data pipeline and the port's
   train step on one device (data parallel is not ported), with
   ``torch.cuda.synchronize`` before each clock read on the card.

Each suite returns a dict; ``run_all`` runs them into one report.  Its
default single image is ``fixtures/demo_0.png`` of this package.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from molnextr_tpu_torch.config import Config

DEMO_IMAGE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "demo_0.png")


def _engine(cfg: Config, params=None, device="cuda"):
    from molnextr_tpu_torch.api import MolNexTR

    return MolNexTR(cfg=cfg, params=params, num_workers=4, device=device)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _synthetic_eval_set(n: int, seed: int = 0, size: int = 384):
    """Deterministic synthetic eval pairs (image, gold smiles): drug-like
    molecules of ``generate_corpus`` with eval-only seeds, drawn after
    ``random.seed(seed)`` (the renderer draws from the module-level
    generators)."""
    from molnextr_tpu_torch.data.corpus import generate_corpus
    from molnextr_tpu_torch.data.synthetic import generate_synthetic_image

    random.seed(seed)
    pool = generate_corpus(max(n, 16), seed=900000 + seed, max_atoms=40)
    images, golds = [], []
    i = 0
    while len(images) < n and i < len(pool) * 4:
        smi = pool[i % len(pool)]
        i += 1
        img, out, _, ok = generate_synthetic_image(
            smi, mol_augment=False, default_option=True, size=size)
        if ok:
            images.append(img)
            golds.append(out)
    return images, golds


def suite_single_image(model, image_path: str, device="cuda") -> Dict[str, Any]:
    """Config 1: one-call prediction latency, cold then warm."""
    t0 = time.perf_counter()
    out = model.predict_final_results(image_path)
    _sync(device)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.predict_final_results(image_path)
    _sync(device)
    steady = time.perf_counter() - t0
    return {"suite": "single_image_greedy", "first_call_s": round(first, 3),
            "steady_s": round(steady, 3), "smiles": out["predicted_smiles"]}


def suite_batch_inference(cfg: Config, model, n: int = 32, device="cuda") -> Dict[str, Any]:
    """Config 2: batch inference accuracy and throughput on synthetic renders."""
    from molnextr_tpu_torch.evaluation import SmilesEvaluator

    images, golds = _synthetic_eval_set(n, size=cfg.data.input_size)
    t0 = time.perf_counter()
    preds = model.predict_images(images, batch_size=cfg.decode.batch_size)
    _sync(device)
    dt = time.perf_counter() - t0
    smiles = [p["predicted_smiles"] for p in preds]
    scores = SmilesEvaluator(golds, num_workers=4).evaluate(smiles)
    return {
        "suite": "batch_beam" if cfg.decode.beam_size > 1 else "batch_greedy",
        "n": n,
        "img_per_s": round(n / dt, 2),
        **{k: round(v, 4) if isinstance(v, float) else v for k, v in scores.items()},
        "_smiles": smiles,  # raw predictions for A/B tooling; run_all drops them
    }


def suite_dataset_eval(model, csv_path: Optional[str], n_fallback: int = 16) -> Dict[str, Any]:
    """Config 3: a real dataset's CSV (graph exact match), or the synthetic
    fallback when there is none."""
    from molnextr_tpu_torch.data.png import read_png
    from molnextr_tpu_torch.evaluation import SmilesEvaluator
    from molnextr_tpu_torch.utils import read_csv

    if csv_path and os.path.exists(csv_path):
        table = read_csv(csv_path)
        paths = table.get("file_path", [""] * len(table["SMILES"]))
        images, golds = [], []
        for path, smiles in zip(paths, table["SMILES"]):
            if not os.path.isfile(str(path)):
                continue
            images.append(read_png(str(path)))
            golds.append(smiles)
        name = os.path.basename(csv_path)
    else:
        images, golds = _synthetic_eval_set(n_fallback, seed=7, size=model.cfg.data.input_size)
        name = "synthetic-fallback"
    preds = model.predict_images(images)
    scores = SmilesEvaluator(golds, num_workers=4).evaluate(
        [p["predicted_smiles"] for p in preds])
    return {"suite": "dataset_eval", "dataset": name, "n": len(golds), **scores}


def suite_perturbed(cfg: Config, model, n: int = 16) -> Dict[str, Any]:
    """Config 4: robustness under clutter-noise perturbations of ``n``
    renders (seed 3), un-normalized back to uint8 for the predict path."""
    from molnextr_tpu_torch.data.transforms import (
        IMAGENET_MEAN, IMAGENET_STD, get_perturbation_transforms,
    )
    from molnextr_tpu_torch.evaluation import SmilesEvaluator

    images, golds = _synthetic_eval_set(n, seed=3, size=cfg.data.input_size)
    perturb = get_perturbation_transforms(cfg.data.input_size)
    noisy = []
    for img in images:
        # the module-level generators, where _synthetic_eval_set left them
        out = perturb(image=img, rng=random, np_rng=np.random)["image"]
        raw = np.clip((out * IMAGENET_STD + IMAGENET_MEAN) * 255, 0, 255)
        noisy.append(raw.astype(np.uint8))
    preds = model.predict_images(noisy)
    scores = SmilesEvaluator(golds, num_workers=4).evaluate(
        [p["predicted_smiles"] for p in preds])
    return {"suite": "perturbed", "n": n, **scores}


def suite_train_throughput(cfg: Config, n_batches: int = 3, num_workers: int = 8,
                           device="cuda") -> Dict[str, Any]:
    """Config 5: host pipeline + device step throughput at the train batch
    size, on one device; the first batch (start-up) is not timed."""
    from molnextr_tpu_torch.data.dataset import DataLoader, Sample, TrainDataset
    from molnextr_tpu_torch.inference import resolve_device
    from molnextr_tpu_torch.models.model import MolNexTRModel
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.train.loop import _criterion
    from molnextr_tpu_torch.train.state import create_train_state
    from molnextr_tpu_torch.train.step import train_step

    dev = resolve_device(device)
    smiles = [
        "CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "CCN(CC)CC",
        "C1CCCCC1", "c1ccc2ccccc2c1", "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
        "C[C@H](N)C(=O)O",
    ] * ((cfg.train.batch_size * (n_batches + 1)) // 8 + 1)
    tokenizers = get_tokenizer(cfg.data)
    ds = TrainDataset(cfg, [Sample(s) for s in smiles], tokenizers)
    loader = DataLoader(ds, batch_size=cfg.train.batch_size, num_workers=num_workers)
    model = MolNexTRModel(cfg, {f: len(t) for f, t in tokenizers.items()})
    state = create_train_state(cfg, model, 100, seed=0, device=dev)
    criterion = _criterion(cfg, tokenizers)
    times = []
    seen = 0
    t_prev = time.perf_counter()
    for i, batch in enumerate(loader):
        if i > n_batches:
            break
        batch.pop("smiles", None)
        batch["refs"].pop("num_atoms", None)
        train_step(cfg, criterion, state, batch, seed=i)
        _sync(dev)
        if i > 0:  # skip the start-up batch
            times.append(time.perf_counter() - t_prev)
            seen += cfg.train.batch_size
        t_prev = time.perf_counter()
    total = sum(times) if times else float("inf")
    return {
        "suite": "train_throughput",
        "global_batch": cfg.train.batch_size,
        "img_per_s": round(seen / total, 2) if times else 0.0,
        "step_s": round(float(np.mean(times)), 3) if times else -1,
    }


def run_all(cfg: Optional[Config] = None, params=None, image_path: str = DEMO_IMAGE,
            eval_csvs: Optional[Sequence[str]] = None, n: int = 32, equal_n: bool = False,
            rerank: bool = False, beam_size: int = 2, device="cuda") -> List[Dict[str, Any]]:
    """Every suite into one report.  ``n`` scales the accuracy suites (at
    n = 32 one image is +-3 %); by default the beam suite runs at n / 4 and
    the dataset and perturbed suites at n / 2, and ``equal_n`` runs all at
    ``n``.  ``rerank`` turns on round-trip candidate verification for every
    accuracy suite, and the beam suite then surfaces its n-best list.  The
    train suite runs its pipeline inline (no pool), as the JAX package's."""
    import copy

    cfg = cfg or Config()
    if rerank:
        cfg = copy.deepcopy(cfg)
        cfg.decode.rerank = "roundtrip"
    model = _engine(cfg, params, device)
    report = []
    if os.path.exists(image_path):
        report.append(suite_single_image(model, image_path, device))
    report.append(suite_batch_inference(cfg, model, n=n, device=device))
    cfg_beam = copy.deepcopy(cfg)
    cfg_beam.decode.beam_size = beam_size
    if rerank:
        cfg_beam.decode.n_best = beam_size
    n_beam = n if equal_n else max(n // 4, 8)
    n_half = n if equal_n else max(n // 2, 16)
    beam_model = _engine(cfg_beam, params, device)
    report.append(suite_batch_inference(cfg_beam, beam_model, n=n_beam, device=device))
    del beam_model
    for csv in eval_csvs or [None]:
        report.append(suite_dataset_eval(model, csv, n_fallback=n_half))
    report.append(suite_perturbed(cfg, model, n=n_half))
    del model
    report.append(suite_train_throughput(cfg, num_workers=0, device=device))
    for suite in report:
        suite.pop("_smiles", None)
    return report


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Run the benchmark suites on the PyTorch port")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--tiny", action="store_true", help="tiny config (CI/smoke)")
    p.add_argument("--eval_csv", action="append", default=None)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--n", type=int, default=32, help="accuracy-suite sample size")
    p.add_argument("--equal-n", action="store_true",
                   help="run every accuracy suite at the full --n")
    p.add_argument("--rerank", action="store_true",
                   help="round-trip candidate verification on every accuracy suite")
    p.add_argument("--beam_size", type=int, default=2, help="beam width for the beam suite")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    params = None
    if args.model_path:
        from molnextr_tpu_torch.checkpoint import load_model

        cfg, params = load_model(args.model_path)
    elif args.tiny:
        from molnextr_tpu_torch.config import tiny_test_config

        cfg = tiny_test_config()
    else:
        cfg = Config()
    report = run_all(cfg, params, eval_csvs=args.eval_csv, n=args.n, equal_n=args.equal_n,
                     rerank=args.rerank, beam_size=args.beam_size, device=args.device)
    text = json.dumps(report, indent=2, default=float)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
