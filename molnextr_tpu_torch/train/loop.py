"""Training orchestration: epochs, meters, per-epoch eval, checkpoints.

Port of ``molnextr_tpu/train/loop.py``, on one device or on every rank of
a process group (``parallel.initialize``, one process per device):

* the train step of ``train/step.py`` over the mesh of
  ``cfg.train.mesh_shape``/``mesh_axes`` (``dispatch_steps`` batches a
  call), each rank fed its rows of every global batch by the sharded
  ``DataLoader``;
* step-time meters with ETA printing;
* per-epoch greedy evaluation through an engine that owns its own module at
  the serving dtype (``InferenceEngine.load_params`` copies the training
  weights in), scored with ``SmilesEvaluator``: on a world of ranks each
  decodes its round-robin share, the numeric results are gathered as
  tensors (``_gather_shards``) and rank 0 alone scores;
* best/all/last checkpointing keyed on the validation ``canon_smiles``
  score, and resume with fallbacks (every rank restores the same bundle;
  rank 0 alone writes, and the others wait for it);
* metrics appended to ``metrics.jsonl`` by rank 0.

As in the JAX loop, a ``model`` mesh axis holds replicas of the data
ranks' rows; the decoder's tensor-parallel split is ``parallel/tp.py``'s,
applied by a caller that owns the state.
"""

from __future__ import annotations

import csv
import json
import os
import random
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from molnextr_tpu_torch.checkpoint import CheckpointManager
from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.data.dataset import DataLoader, Sample, TrainDataset
from molnextr_tpu_torch.data.image import imread
from molnextr_tpu_torch.data.synthetic import generate_synthetic_image
from molnextr_tpu_torch.inference import InferenceEngine, resolve_device
from molnextr_tpu_torch.models.model import MolNexTRModel
from molnextr_tpu_torch.parallel import distributed as pdist
from molnextr_tpu_torch.parallel.mesh import axis_rank, axis_size, make_mesh
from molnextr_tpu_torch.tokenization import get_tokenizer
from molnextr_tpu_torch.train.losses import Criterion
from molnextr_tpu_torch.train.state import TrainState, create_train_state
from molnextr_tpu_torch.train.step import multi_train_step, train_step
from molnextr_tpu_torch.utils import (
    AverageMeter, LossMeter, print_rank_0, round_floats, seed_everything, time_since,
)


# evaluation golds cross ranks as fixed-width UTF-8 byte rows
GOLD_BYTES = 512


def _gather_shards(arrays: Dict[str, np.ndarray], idx: np.ndarray, gather, world: int):
    """Pad per-rank result arrays to a common length, all-gather them, and
    restore global order, dropping pad rows.

    ``arrays``: per-rank numeric results keyed by name (leading axis =
    local samples); ``idx``: global sample index per local row; ``gather``:
    a ``gather_arrays``-style function (all-gather along axis 0), passed in
    so the logic is testable with a fake gather."""
    n_local = int(idx.shape[0])
    n_max = int(gather(np.asarray([n_local], np.int32)).max())
    pad = n_max - n_local

    def pad0(a):
        if pad == 0:
            return a
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths)

    idx_g = gather(pad0(np.asarray(idx, np.int32) + 1))  # +1: 0 marks padding
    idx_g = idx_g.reshape(world * n_max)
    keep = idx_g > 0
    order = np.argsort(idx_g[keep], kind="stable")
    out: Dict[str, np.ndarray] = {}
    for k, a in arrays.items():
        g = gather(pad0(a)).reshape((world * n_max,) + a.shape[1:])
        out[k] = g[keep][order]
    return out, idx_g[keep][order] - 1


def _wire_image(image: np.ndarray) -> np.ndarray:
    """Eval wire: one grey channel of a uint8 RGB image; float passes."""
    if image.dtype == np.uint8 and image.ndim == 3 and image.shape[-1] == 3:
        return np.ascontiguousarray(image[..., :1])
    return image if image.dtype == np.uint8 else image.astype(np.float32)


def serving_engine(cfg: Config, tokenizers, device) -> InferenceEngine:
    """An engine over a module of its own at the serving dtype (bf16 when
    ``train.bf16``), into which ``load_params`` copies training weights."""
    vocab = {f: len(t) for f, t in tokenizers.items()}
    model = MolNexTRModel(cfg, vocab).to_dtype(torch.bfloat16 if cfg.train.bf16 else torch.float32)
    return InferenceEngine(cfg, tokenizers, model, device=device)


def _write_predictions(path: str, golds, smiles, coords, symbols, edges, scores) -> None:
    """The predictions CSV (nested columns JSON-encoded) and its scores."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image_id", "gold_SMILES", "SMILES", "node_coords", "node_symbols", "edges"])
        for i, row in enumerate(zip(golds, smiles, coords, symbols, edges)):
            enc = [json.dumps(round_floats(x)).replace(" ", "") for x in row[2:]]
            w.writerow([i, row[0], row[1]] + enc)
    with open(path.replace(".csv", "_scores.json"), "w") as f:
        json.dump(scores, f, indent=2)


def evaluate_model(cfg: Config, model: MolNexTRModel, tokenizers,
                   valid_samples: Sequence[Sample], num_workers: int = 8,
                   batch_size: Optional[int] = None, dump_csv: Optional[str] = None,
                   engine: Optional[InferenceEngine] = None,
                   render_cache: Optional[Dict[int, Any]] = None) -> Dict[str, Any]:
    """Greedy-decode the validation set with ``model``'s current weights and
    score it.  The weights are copied into ``engine`` (built by
    :func:`serving_engine` on the model's device when None); ``model``'s
    mode and parameters are left as they were.  ``render_cache`` keeps the
    deterministic validation renders across calls.

    On a world of ranks every rank calls it: samples go round-robin over
    the ranks, each decodes its share to numeric arrays (token ids, edge
    classes, and its golds as byte rows, since a synthetic gold is the
    canonical form its rank drew), the arrays are all-gathered as tensors
    (``parallel.gather_arrays``), and rank 0 alone runs the chemistry and
    scores; the other ranks return ``{}``."""
    from molnextr_tpu_torch.chem.graph import convert_graph_to_smiles
    from molnextr_tpu_torch.evaluation import SmilesEvaluator

    if engine is None:
        engine = serving_engine(cfg, tokenizers, next(model.parameters()).device)
    engine.load_params(model)
    ds = TrainDataset(cfg, list(valid_samples), tokenizers, split="valid", dynamic=True)
    bs = batch_size or cfg.decode.batch_size
    world, rank = pdist.process_count(), pdist.process_index()
    golds_all: List[Optional[str]] = [s.smiles for s in ds.samples]
    seqs: List[np.ndarray] = []
    edges_mats: List[np.ndarray] = []
    kept_idx: List[int] = []
    batch_imgs: List[np.ndarray] = []
    batch_idx: List[int] = []

    def flush():
        if not batch_imgs:
            return
        raw = engine.predict_images_raw(np.stack(batch_imgs))
        seqs.append(raw["seq"])
        if "edges" in raw:
            edges_mats.append(raw["edges"])
        kept_idx.extend(batch_idx)
        batch_imgs.clear()
        batch_idx.clear()

    for i in range(rank, len(ds), world):
        sample = ds.samples[i]
        if sample.image_path is None:
            if render_cache is not None and i in render_cache:
                image, golds_all[i] = render_cache[i]
            else:
                img, smiles, _graph, ok = generate_synthetic_image(
                    sample.smiles, mol_augment=False, default_option=True,
                    size=cfg.data.input_size)
                if not ok:
                    continue
                golds_all[i] = smiles  # the canonical form actually drawn
                image = _wire_image(ds.transform(image=img, keypoints=[])["image"])
                if render_cache is not None:
                    render_cache[i] = (image, smiles)
        else:
            img = imread(sample.image_path)
            if img is None:  # skipped, as the JAX loop skips cv2.imread's None
                continue
            image = _wire_image(ds.transform(image=img, keypoints=[])["image"])
        batch_imgs.append(image)
        batch_idx.append(i)
        if len(batch_imgs) == bs:
            flush()
    flush()

    local = {"seq": np.concatenate(seqs) if seqs else np.zeros((0, engine.max_len), np.int32)}
    if "edges" in cfg.data.formats:
        # present even at zero length, so every rank issues the same collectives
        k = engine.max_atoms
        local["edges"] = (np.concatenate(edges_mats) if edges_mats
                          else np.zeros((0, k, k), np.int32))
    idx = np.asarray(kept_idx, np.int32)
    if world > 1:
        gold_rows = np.zeros((len(kept_idx), GOLD_BYTES), np.uint8)
        for r, i in enumerate(kept_idx):
            enc = (golds_all[i] or "").encode("utf-8")[:GOLD_BYTES]
            gold_rows[r, : len(enc)] = np.frombuffer(enc, np.uint8)
        local["gold"] = gold_rows
        local, idx = _gather_shards(local, idx, pdist.gather_arrays, world)
        if not pdist.is_main_process():
            return {}
        for r, i in enumerate(idx):
            golds_all[i] = bytes(local["gold"][r]).rstrip(b"\x00").decode("utf-8", "replace")
    coords, symbols, edges = [], [], []
    for r in range(local["seq"].shape[0]):
        parsed = engine.tokenizer.sequence_to_smiles(local["seq"][r].tolist())
        coords.append(parsed["coords"])
        symbols.append(parsed["symbols"])
        k = min(len(parsed["indices"]), engine.max_atoms)
        if "edges" in local:
            edges.append(local["edges"][r, :k, :k].tolist())
        else:
            edges.append([[0] * k for _ in range(k)])
    golds = [golds_all[i] for i in idx]
    smiles_list, _, _ = convert_graph_to_smiles(coords, symbols, edges, num_workers=num_workers)
    scores = SmilesEvaluator(golds[: len(smiles_list)], num_workers=num_workers).evaluate(
        smiles_list)
    scores["n"] = len(smiles_list)
    if dump_csv:
        _write_predictions(dump_csv, golds[: len(smiles_list)], smiles_list, coords, symbols,
                           edges, scores)
    return scores


def _criterion(cfg: Config, tokenizers) -> Criterion:
    coord_vocab = None
    for fmt in cfg.data.formats:
        tok = tokenizers.get(fmt)
        if fmt.endswith("_coords") and tok is not None and not tok.continuous_coords:
            coord_vocab = (tok.offset, tok.maxx, tok.maxy, tok.sep_xy)
            break
    return Criterion(cfg.data.formats, cfg.train.label_smoothing, coord_vocab=coord_vocab,
                     heatmap_weight=cfg.train.aux_heatmap_weight)


def train_loop(cfg: Config, train_samples: Sequence[Sample],
               valid_samples: Optional[Sequence[Sample]] = None,
               num_workers: Optional[int] = None, print_freq: int = 50, do_eval: bool = True,
               eval_every: int = 1, save_images: int = 0, profile_steps: int = 0,
               resume: Optional[str] = None, device="cuda") -> TrainState:
    """A whole training run on ``device`` (CUDA unless the caller asks for
    the CPU; under a process group, this rank's device from
    ``parallel.initialize``); returns the final state.  ``save_images``
    writes the first N synthetic renders as PNG; ``profile_steps`` traces
    that many steps with ``torch.profiler`` into ``save_path/profile``."""
    from molnextr_tpu_torch.data.png import write_png

    dev = resolve_device(device)
    seed_everything(cfg.train.seed)  # the renderer's module-level generators
    main_rank = pdist.is_main_process()
    if save_images > 0 and main_rank:
        img_dir = os.path.join(cfg.train.save_path, "images")
        os.makedirs(img_dir, exist_ok=True)
        for i, sample in enumerate(train_samples[:save_images]):
            if sample.image_path is None:
                img, _, _, ok = generate_synthetic_image(sample.smiles)
                if ok:
                    write_png(os.path.join(img_dir, f"{i}.png"), img)
    mesh = make_mesh(cfg.train.mesh_shape, cfg.train.mesh_axes, device=dev)
    data_rank, data_world = axis_rank(mesh, "data"), axis_size(mesh, "data")
    if dev.type == "cuda" and pdist.process_count() > 1:
        # the evaluation's kernels: rank 0 builds them once, the others then
        # find the libraries built instead of each running nvcc
        if main_rank:
            from molnextr_tpu_torch.ops._build import build_all

            build_all()
        pdist.barrier()
    tokenizers = get_tokenizer(cfg.data)
    vocab_sizes = {f: len(t) for f, t in tokenizers.items()}
    if data_world > 1:  # each rank's augmentations from its own generators
        rank_seed = int(np.random.SeedSequence([cfg.train.seed, data_rank]).generate_state(1)[0])
        ds = TrainDataset(cfg, list(train_samples), tokenizers, split="train",
                          rng=random.Random(rank_seed), np_rng=np.random.RandomState(rank_seed))
    else:
        ds = TrainDataset(cfg, list(train_samples), tokenizers, split="train")
    workers = cfg.train.num_workers if num_workers is None else num_workers
    # the item cache holds one process's items: off on a world of ranks
    use_item_cache = workers == 0 and pdist.process_count() == 1
    item_cache_path = os.path.join(cfg.train.save_path, "item_cache.pkl")
    if use_item_cache and ds._item_cacheable and ds.load_item_cache(item_cache_path):
        print_rank_0(f"item cache loaded: {len(ds._item_cache)} prebuilt items")
    loader = DataLoader(ds, batch_size=cfg.train.batch_size, shuffle=True,
                        num_workers=workers, seed=cfg.train.seed, rank=data_rank,
                        world=data_world)
    steps_per_epoch = (cfg.train.train_steps_per_epoch if cfg.train.train_steps_per_epoch > 0
                       else len(loader))
    # the schedules count optimizer updates: one per grad_accum_steps batches
    accum = max(cfg.train.grad_accum_steps, 1)
    total_steps = max(steps_per_epoch * cfg.train.epochs // accum, 1)
    print_rank_0(f"device={dev} ranks={pdist.process_count()} mesh={tuple(mesh.shape)} "
                 f"micro_batch={cfg.train.batch_size} "
                 f"global_batch={cfg.train.batch_size * accum} "
                 f"steps/epoch={steps_per_epoch} total_updates={total_steps}")

    state = create_train_state(cfg, MolNexTRModel(cfg, vocab_sizes), total_steps,
                               seed=cfg.train.seed, device=dev, mesh=mesh)
    criterion = _criterion(cfg, tokenizers)
    ckpt = CheckpointManager(cfg.train.save_path, cfg.train.save_mode)
    start_epoch = 0
    if resume:
        # a missing or partial snapshot falls back to ckpt_best, then to a
        # fresh start
        for tag in [resume] + (["best"] if resume != "best" else []):
            try:
                state, meta = ckpt.restore(state, tag)
                start_epoch = int(meta.get("epoch", -1)) + 1
                print_rank_0(f"resumed from {tag}: step {state.step}, epoch {start_epoch}")
                break
            except (FileNotFoundError, OSError, ValueError, KeyError, RuntimeError) as e:
                print_rank_0(f"resume from {tag} failed ({e!r}); trying next fallback")
        else:
            print_rank_0("no loadable snapshot; starting fresh")
    metrics_path = os.path.join(cfg.train.save_path, "metrics.jsonl")
    os.makedirs(cfg.train.save_path, exist_ok=True)
    seed = cfg.train.seed + 1
    dispatch_k = max(cfg.train.dispatch_steps, 1)

    def epoch_batches(epoch: int):
        """Up to steps_per_epoch batches, reshuffling the loader for another
        pass when one pass gives fewer."""
        produced = pass_i = 0
        while produced < steps_per_epoch:
            if pass_i:
                loader.set_epoch(epoch + 9973 * pass_i)
            got_any = False
            for b in loader:
                got_any = True
                yield b
                produced += 1
                if produced >= steps_per_epoch:
                    return
            if not got_any:
                return
            pass_i += 1

    def dispatch_units(epoch: int):
        """Groups of ``dispatch_steps`` batches; a trailing partial group
        goes one batch at a time."""
        buf: list = []
        for b in epoch_batches(epoch):
            b.pop("smiles", None)
            b["refs"].pop("num_atoms", None)
            buf.append(b)
            if len(buf) == dispatch_k:
                yield buf
                buf = []
        for b in buf:
            yield [b]

    global_step = state.step
    profile_base = global_step
    profiler = None
    start = time.time()
    eval_engine = None
    eval_render_cache: Dict[int, Any] = {}
    for epoch in range(start_epoch, cfg.train.epochs):
        loader.set_epoch(epoch)
        loss_meter = LossMeter()
        batch_time = AverageMeter()
        data_time = AverageMeter()
        t_prev = time.time()
        bidx = -1
        for unit in dispatch_units(epoch):
            k = len(unit)
            bidx += k
            data_time.update(time.time() - t_prev)
            if profile_steps and profiler is None and global_step >= profile_base + 1:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=acts)
                profiler.start()
            if k > 1:
                metrics = multi_train_step(cfg, criterion, state, unit, seed)
            else:
                metrics = train_step(cfg, criterion, state, unit[0], seed)
            global_step += k
            if profiler is not None and global_step >= profile_base + 1 + profile_steps:
                profiler.stop()
                trace_dir = os.path.join(cfg.train.save_path, "profile")
                os.makedirs(trace_dir, exist_ok=True)
                name = ("trace.json" if pdist.process_count() == 1
                        else f"trace_rank{pdist.process_index()}.json")
                profiler.export_chrome_trace(os.path.join(trace_dir, name))
                profiler, profile_steps = None, 0
            if bidx % print_freq < k or bidx >= steps_per_epoch - 1:
                host = {name: float(v) for name, v in metrics.items()}
                loss_meter.update(host.pop("loss"), host, n=cfg.train.batch_size)
                accs = " ".join(f"{n[4:]} {v:.3f}" for n, v in host.items()
                                if n.startswith("acc_"))
                pct = (bidx + 1) / steps_per_epoch
                print_rank_0(
                    f"epoch {epoch} [{bidx + 1}/{steps_per_epoch}] "
                    f"loss {loss_meter.val:.4f} (avg {loss_meter.avg:.4f}) {accs} "
                    f"data {data_time.avg:.3f}s batch {batch_time.avg:.3f}s "
                    f"{time_since(start, (epoch + pct) / cfg.train.epochs)}")
            batch_time.update(time.time() - t_prev)
            t_prev = time.time()

        scores: Dict[str, Any] = {}
        is_eval_epoch = (epoch + 1) % max(eval_every, 1) == 0 or epoch == cfg.train.epochs - 1
        if do_eval and valid_samples and is_eval_epoch:
            if eval_engine is None:  # one engine, one module, every epoch
                eval_engine = serving_engine(cfg, tokenizers, dev)
            scores = evaluate_model(cfg, state.model, tokenizers, valid_samples,
                                    num_workers=max(workers, 1), engine=eval_engine,
                                    render_cache=eval_render_cache)
            print_rank_0(f"epoch {epoch} eval: {scores}")
        if main_rank:  # rank 0 alone writes; the others wait for its files
            with open(metrics_path, "a") as f:
                f.write(json.dumps({
                    "epoch": epoch, "step": global_step, "train_loss": loss_meter.epoch.avg,
                    **{f"train_{n}": m.epoch.avg for n, m in loss_meter.subs.items()},
                    **{f"valid_{n}": v for n, v in scores.items()},
                }) + "\n")
            ckpt.save(cfg, state, epoch, score=scores.get("canon_smiles"))
        pdist.barrier()
        if use_item_cache and ds.item_cache_complete() and not os.path.exists(item_cache_path):
            t0 = time.time()
            if ds.save_item_cache(item_cache_path):
                print_rank_0(f"item cache saved ({len(ds._item_cache)} items, "
                             f"{time.time() - t0:.1f}s)")
    return state
