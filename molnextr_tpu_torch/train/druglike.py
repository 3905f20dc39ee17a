"""The drug-like training recipe: a mid-size model trained on a generated
corpus of drug-like molecules, the one route to a trained model without a
download.

This is the port of ``scripts/train_druglike.py`` and
``scripts/prebuild_item_cache.py``, with the same flags and defaults
(corpus 60,000 and 384 valid from ``generate_corpus``, 192 px, a Swin of
embed 64, depths 2/2/6/2 and heads 2/4/8/16, a 4 x 256 x 8 decoder with
``max_len`` 256, batch 256, 30 epochs; ``--flagship`` for ``Config()`` at
global batch 256 through 4 x 64 accumulation) plus ``--device`` (default
``cuda``).  The JAX script re-executes itself to raise glibc's malloc
thresholds for its TPU host; this one does not.

Run it with ``python scripts/train_druglike_torch.py --save-path
output/druglike``; prebuild the item cache of a ``--no-augment`` run with
``python scripts/prebuild_item_cache_torch.py`` and the same data flags.
"""

from __future__ import annotations

import argparse
import os
import time

from molnextr_tpu_torch.config import Config, DataConfig, DecoderConfig, EncoderConfig, TrainConfig


def build_config(args) -> Config:
    """The recipe's ``Config`` for parsed flags (``make_parser``)."""
    cfg = Config()
    if args.flagship:
        # Config()'s Swin-B 384 and 6 x 256 x 8 decoder at global batch 256:
        # micro-batches of 64 accumulated args.batch_size // 64 times per update
        micro = min(args.batch_size, 64)
        if args.batch_size % micro:
            raise ValueError(f"--flagship batch-size must be a multiple of {micro} "
                             f"(got {args.batch_size}; accumulation would drop the remainder)")
        cfg.data = DataConfig(input_size=384, formats=("chartok_coords", "edges"), max_atoms=64,
                              render_cache=True)
        cfg.train = TrainConfig(
            epochs=args.epochs, batch_size=micro, grad_accum_steps=max(args.batch_size // micro, 1),
            encoder_lr=4e-4, decoder_lr=4e-4, warmup_ratio=0.02, label_smoothing=0.1,
            save_mode="best", save_path=args.save_path, num_workers=args.workers,
            train_steps_per_epoch=args.steps_per_epoch, dispatch_steps=args.dispatch)
        cfg.decode.batch_size = 32
        if args.no_augment:
            _clean_renders(cfg)
        return cfg
    cfg.encoder = EncoderConfig(name="swin_medium", patch_size=4, window_size=12,
                                embed_dim=args.embed_dim, depths=(2, 2, 6, 2),
                                num_heads=(2, 4, 8, 16), drop_path_rate=0.1, use_remat=True)
    cfg.decoder = DecoderConfig(num_layers=4, hidden_size=256, attn_heads=8, max_len=256)
    cfg.data = DataConfig(input_size=args.input_size, formats=("chartok_coords", "edges"),
                          max_atoms=64, render_cache=True)
    cfg.train = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, encoder_lr=4e-4, decoder_lr=4e-4,
        warmup_ratio=0.02, label_smoothing=0.1, save_mode="best", save_path=args.save_path,
        num_workers=args.workers, train_steps_per_epoch=args.steps_per_epoch,
        dispatch_steps=args.dispatch)
    cfg.decode.batch_size = 64
    if args.no_augment:
        # deterministic renders in the evaluation's default style, no image
        # noise: a working pipeline memorises a small corpus fast
        _clean_renders(cfg)
    elif args.image_augment_only:
        # clean labels and renders plus only the clutter family that the
        # perturbed suite applies
        _clean_renders(cfg)
        cfg.data.clutter_augment = True
    return cfg


def _clean_renders(cfg: Config) -> None:
    cfg.data.mol_augment = False
    cfg.data.augment = False
    cfg.data.include_condensed = False
    cfg.data.default_style = True


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train on a generated drug-like corpus "
                                            "(the PyTorch port)")
    p.add_argument("--corpus", type=int, default=60000)
    p.add_argument("--valid", type=int, default=384)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--steps-per-epoch", type=int, default=-1)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--input-size", type=int, default=192)
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--workers", type=int, default=0)
    p.add_argument("--save-path", default="output/druglike")
    p.add_argument("--resume", default=None)
    p.add_argument("--no-eval", action="store_true")
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--image-augment-only", action="store_true",
                   help="clean molecular labels and renders plus the clutter noise "
                        "(robustness fine-tune after a --no-augment run)")
    p.add_argument("--eval-train", action="store_true",
                   help="evaluate on the first --valid TRAIN samples (overfit check)")
    p.add_argument("--max-mol-atoms", type=int, default=40)
    p.add_argument("--flagship", action="store_true",
                   help="train Config() (Swin-B 384) at global batch 256 by accumulation")
    p.add_argument("--dispatch", type=int, default=12,
                   help="optimizer updates per train-step call")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def corpus(args):
    """The recipe's train SMILES and valid SMILES."""
    from molnextr_tpu_torch.data.corpus import generate_corpus

    train = generate_corpus(args.corpus, seed=42, max_atoms=args.max_mol_atoms)
    if args.eval_train:
        return train, train[: args.valid]
    return train, generate_corpus(args.valid, seed=20260816, existing=set(train),
                                  max_atoms=args.max_mol_atoms)


def main(argv=None):
    """Train with the recipe's flags (``make_parser``); returns the final state."""
    from molnextr_tpu_torch.data.dataset import Sample
    from molnextr_tpu_torch.train.loop import train_loop
    from molnextr_tpu_torch.utils import print_rank_0

    args = make_parser().parse_args(argv)
    cfg = build_config(args)
    os.makedirs(args.save_path, exist_ok=True)
    print_rank_0(f"generating corpus: {args.corpus} train + {args.valid} valid")
    train_smiles, valid_smiles = corpus(args)
    with open(os.path.join(args.save_path, "corpus_valid.txt"), "w") as f:
        f.write("\n".join(valid_smiles))
    print_rank_0(f"corpus ready: {len(train_smiles)} train / {len(valid_smiles)} valid")
    state = train_loop(cfg, [Sample(smiles=s) for s in train_smiles],
                       valid_samples=[Sample(smiles=s) for s in valid_smiles],
                       num_workers=args.workers, print_freq=25, do_eval=not args.no_eval,
                       eval_every=args.eval_every, resume=args.resume, device=args.device)
    print_rank_0(f"done at step {int(state.step)}")
    return state


def prebuild_main(argv=None) -> str:
    """Build every train item on the host with the training run's config and
    write ``<save-path>/item_cache.pkl``, so that a run (one process, no
    workers) skips rendering from step 0.  Returns the cache's path."""
    from molnextr_tpu_torch.data.dataset import Sample, TrainDataset
    from molnextr_tpu_torch.tokenization import get_tokenizer

    args = make_parser().parse_args(argv)
    cfg = build_config(args)
    train_smiles, _ = corpus(args)
    ds = TrainDataset(cfg, [Sample(smiles=s) for s in train_smiles], get_tokenizer(cfg.data))
    if not ds._item_cacheable:
        raise SystemExit("config is not item-cacheable (augment/mask_ratio on?)")
    path = os.path.join(args.save_path, "item_cache.pkl")
    if ds.load_item_cache(path):
        print(f"cache already complete: {len(ds._item_cache)} items")
        return path
    t0 = time.time()
    for i in range(len(ds)):
        ds[i]
        if (i + 1) % 2000 == 0:
            print(f"{i + 1}/{len(ds)} items ({(i + 1) / (time.time() - t0):.0f} items/s)",
                  flush=True)
    os.makedirs(args.save_path, exist_ok=True)
    if not ds.save_item_cache(path):
        raise SystemExit(f"cache incomplete: {len(ds) - len(ds._item_cache)} items failed "
                         "to build")
    print(f"saved {len(ds._item_cache)} items -> {path} ({time.time() - t0:.0f}s total)")
    return path
