from molnextr_tpu_torch.train.losses import (
    Criterion,
    graph_loss,
    label_smoothing_ce,
    sequence_loss,
)
from molnextr_tpu_torch.train.state import TrainState, create_train_state, make_schedules
from molnextr_tpu_torch.train.step import eval_step, multi_train_step, train_step

__all__ = [
    "Criterion",
    "graph_loss",
    "label_smoothing_ce",
    "sequence_loss",
    "TrainState",
    "create_train_state",
    "make_schedules",
    "train_step",
    "multi_train_step",
    "eval_step",
    "main",
]


def main(argv=None):
    """``molnextr-torch-train``: the JAX package's ``molnextr-train`` with
    the same flags plus ``--device`` (default ``cuda``), over the port's
    ``train_loop``.  CSVs are read with ``utils.read_csv`` (pandas' typing,
    without pandas): a ``SMILES`` column to render, and optionally
    ``file_path`` for image files (relative to ``--data_path``)."""
    import argparse
    import os

    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.data.dataset import Sample
    from molnextr_tpu_torch.utils import read_csv

    p = argparse.ArgumentParser(description="Train MolNexTR with the PyTorch port")
    p.add_argument("--train_file", type=str, required=True,
                   help="CSV with a SMILES column (synthetic rendering) and "
                        "optionally file_path for real images")
    p.add_argument("--valid_file", type=str, default=None)
    p.add_argument("--aux_file", type=str, default=None,
                   help="extra real-image CSV concatenated with the synthetic set")
    p.add_argument("--data_path", type=str, default="",
                   help="prefix for relative file_path entries")
    p.add_argument("--config", type=str, default=None, help="config JSON")
    p.add_argument("--save_path", type=str, default="output/")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--encoder_lr", type=float, default=None)
    p.add_argument("--decoder_lr", type=float, default=None)
    p.add_argument("--encoder", type=str, default=None)
    p.add_argument("--formats", type=str, default=None,
                   help="comma-separated, e.g. chartok_coords,edges")
    p.add_argument("--num_workers", type=int, default=None)
    p.add_argument("--steps_per_epoch", type=int, default=None)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--no_eval", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="snapshot tag to restore (best/last/ep<N>) from save_path before training")
    p.add_argument("--save_image", type=int, default=0,
                   help="dump the first N synthetic renders to save_path/images")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.config and os.path.exists(args.config):
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    cfg.train.save_path = args.save_path
    for name in ("epochs", "batch_size", "encoder_lr", "decoder_lr", "seed"):
        v = getattr(args, name)
        if v is not None:
            setattr(cfg.train, name, v)
    if args.encoder:
        cfg.encoder.name = args.encoder
    if args.formats:
        cfg.data.formats = tuple(args.formats.split(","))
    if args.steps_per_epoch is not None:
        cfg.train.train_steps_per_epoch = args.steps_per_epoch

    def load_samples(path):
        table = read_csv(path)
        paths = table.get("file_path", [None] * len(table["SMILES"]))
        return [Sample(smiles=smi, image_path=os.path.join(args.data_path, fp)
                       if isinstance(fp, str) else None)
                for smi, fp in zip(table["SMILES"], paths)]

    train_samples = load_samples(args.train_file)
    if args.aux_file:
        train_samples = train_samples + load_samples(args.aux_file)
    if args.max_samples:
        train_samples = train_samples[: args.max_samples]
    valid_samples = load_samples(args.valid_file) if args.valid_file else None

    from molnextr_tpu_torch.train.loop import train_loop

    train_loop(cfg, train_samples, valid_samples, num_workers=args.num_workers,
               do_eval=not args.no_eval, save_images=args.save_image, resume=args.resume,
               device=args.device)
