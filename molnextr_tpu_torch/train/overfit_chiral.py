"""The chirality proof: overfit a tiny model on K chiral molecules and
evaluate it on the same molecules (deterministic renders) until the
evaluation's ``chiral`` score leaves 0.

This is the port of ``scripts/overfit_chiral.py``, with the same flags and
defaults (K 4, 400 epochs, an evaluation every 50, embed 16, save path
``output/chiral_proof``) plus ``--device`` (default ``cuda``).  It takes the
first K SMILES holding ``@`` from ``generate_corpus(4000, seed=42,
max_atoms=28)``, writes them to ``<save-path>/corpus_valid.txt`` and trains
a Swin of embed 16 (depths 2/2/6/2, heads 2/4/8/16, window 12) at 192 px
with a 4 x 256 x 8 decoder on them, one batch of K an epoch, keeping the
best evaluation's bundle (``ckpt_best``).  The JAX script re-executes
itself to raise glibc's malloc thresholds for its host; this one does not.

Run it with ``python scripts/overfit_chiral_torch.py --save-path
output/chiral_proof`` (``--device cpu`` on a machine without the card).
"""

from __future__ import annotations

import argparse
import json
import os

from molnextr_tpu_torch.config import Config, DataConfig, DecoderConfig, EncoderConfig, TrainConfig


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Overfit a tiny model on K chiral molecules "
                                            "(the PyTorch port)")
    p.add_argument("--k", type=int, default=4, help="number of chiral molecules")
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--eval-every", type=int, default=50)
    p.add_argument("--embed-dim", type=int, default=16)
    p.add_argument("--save-path", default="output/chiral_proof")
    p.add_argument("--resume", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def build_config(args) -> Config:
    """The overfit's ``Config`` for parsed flags (``make_parser``)."""
    cfg = Config()
    cfg.encoder = EncoderConfig(
        name="swin_tiny_cpu", patch_size=4, window_size=12,
        embed_dim=args.embed_dim, depths=(2, 2, 6, 2), num_heads=(2, 4, 8, 16),
        drop_path_rate=0.0, use_remat=False,
    )
    cfg.decoder = DecoderConfig(num_layers=4, hidden_size=256, attn_heads=8, max_len=256)
    cfg.data = DataConfig(
        input_size=192, formats=("chartok_coords", "edges"), max_atoms=64,
        render_cache=True, mol_augment=False, augment=False, include_condensed=False,
        default_style=True,
    )
    cfg.train = TrainConfig(
        epochs=args.epochs, batch_size=args.k, encoder_lr=4e-4, decoder_lr=4e-4,
        warmup_ratio=0.02, label_smoothing=0.1, save_mode="best", save_path=args.save_path,
        num_workers=0, dispatch_steps=1,
    )
    cfg.decode.batch_size = args.k
    return cfg


def main(argv=None) -> dict:
    """Run the overfit; returns ``{"chiral": the K SMILES, "step": the final
    step, "save_path": ..., "epochs": this run's rows of metrics.jsonl}``
    (each row's ``valid_*`` keys are that epoch's evaluation, where one
    ran)."""
    from molnextr_tpu_torch.data.corpus import generate_corpus
    from molnextr_tpu_torch.data.dataset import Sample
    from molnextr_tpu_torch.train.loop import train_loop
    from molnextr_tpu_torch.utils import print_rank_0

    args = make_parser().parse_args(argv)
    pool = generate_corpus(4000, seed=42, max_atoms=28)
    chiral = [s for s in pool if "@" in s][: args.k]
    if len(chiral) != args.k:
        raise ValueError(f"only {len(chiral)} chiral molecules found")
    print_rank_0(f"chiral overfit set: {chiral}")
    cfg = build_config(args)
    os.makedirs(args.save_path, exist_ok=True)
    with open(os.path.join(args.save_path, "corpus_valid.txt"), "w") as f:
        f.write("\n".join(chiral))
    metrics_path = os.path.join(args.save_path, "metrics.jsonl")
    seen = _rows(metrics_path)

    samples = [Sample(smiles=s) for s in chiral]
    state = train_loop(cfg, samples, valid_samples=samples,  # eval-train: deterministic renders
                       num_workers=0, print_freq=25, do_eval=True, eval_every=args.eval_every,
                       resume=args.resume, device=args.device)
    print_rank_0(f"done at step {int(state.step)}")
    return {"chiral": chiral, "step": int(state.step), "save_path": args.save_path,
            "epochs": _rows(metrics_path)[len(seen):]}


def _rows(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
