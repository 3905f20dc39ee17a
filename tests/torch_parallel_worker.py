"""Rank processes for the port's data-parallel tests.

``tests/test_torch_parallel.py`` (gloo over CPU ranks) and
``tests/test_torch_cuda.py`` (gloo ranks sharing one card) start these with
:func:`spawn`: ``world`` processes from ``torch.multiprocessing``'s spawn
context, joined over ``tcp://127.0.0.1:<free port>``.  Each runs one case
function on its rank and saves what it returns to ``rank<r>.pt``.  This
module imports torch and the port only, so a rank starts without JAX.
"""

import os
import socket
import time

import numpy as np
import torch

JOIN_TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(cases, rank, world, port, outdir, device, backend):
    torch.set_num_threads(1)
    from molnextr_tpu_torch.parallel.distributed import initialize, shutdown

    dev = initialize(backend=backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                     rank=rank, local_rank=rank, device=device)
    try:
        out = [CASES[name](dev, **kwargs) for name, kwargs in cases]
    finally:
        shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def _start_main(cases, rank, world, port, outdir, device, backend):
    """Only the start: what ``initialize`` raised on this rank, or None."""
    from molnextr_tpu_torch.parallel.distributed import initialize, shutdown

    try:
        initialize(backend=backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                   rank=rank, local_rank=rank, device=device)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    shutdown()
    torch.save([refused], os.path.join(outdir, f"rank{rank}.pt"))


class Ranks:
    """``world`` rank processes running ``cases`` ([(name, kwargs), ...])
    one after another, started at construction; :meth:`join` returns each
    rank's list of results.  ``start_only`` runs no case: each rank's one
    result is what ``initialize`` raised, or None."""

    def __init__(self, world, outdir, cases, device="cpu", backend="gloo", start_only=False):
        ctx = torch.multiprocessing.get_context("spawn")
        self.outdir, self.names = str(outdir), [name for name, _ in cases] or ["start"]
        os.makedirs(self.outdir, exist_ok=True)
        port = free_port()
        target = _start_main if start_only else _rank_main
        self.procs = [ctx.Process(target=target,
                                  args=(cases, r, world, port, self.outdir, device, backend))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + JOIN_TIMEOUT_S

    def join(self):
        """Wait until ``JOIN_TIMEOUT_S`` after the start, or kill every rank
        and raise."""
        for p in self.procs:
            p.join(max(self.deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if hung:
            raise AssertionError(f"{self.names}: ranks {hung} still running after "
                                 f"{JOIN_TIMEOUT_S} s")
        codes = [p.exitcode for p in self.procs]
        if any(codes):
            raise AssertionError(f"{self.names}: rank exit codes {codes}")
        return [torch.load(os.path.join(self.outdir, f"rank{r}.pt"), weights_only=False)
                for r in range(len(self.procs))]


    def stop(self):
        """Kill any rank still running (a fixture's teardown)."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)


def spawn(case, world, outdir, device="cpu", backend="gloo", **kwargs):
    """Run one case on ``world`` ranks; returns each rank's result."""
    return [r[0] for r in Ranks(world, outdir, [(case, kwargs)], device, backend).join()]


# ---------------------------------------------------------------------------
# the cases, one rank each
# ---------------------------------------------------------------------------


def _setup(cfg_json, dev, mesh_shape=(-1,), mesh_axes=("data",), seed=0, total=10):
    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.models.model import MolNexTRModel
    from molnextr_tpu_torch.parallel.mesh import make_mesh
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.train.loop import _criterion
    from molnextr_tpu_torch.train.state import create_train_state

    cfg = Config.from_json(cfg_json)
    toks = get_tokenizer(cfg.data)
    mesh = make_mesh(mesh_shape, mesh_axes, device=dev)
    state = create_train_state(cfg, MolNexTRModel(cfg, {f: len(t) for f, t in toks.items()}),
                               total, seed=seed, device=dev, mesh=mesh)
    return cfg, toks, mesh, state, _criterion(cfg, toks)


def full_params(state, mesh, tp, tensors=None):
    """Every leaf whole (a tensor-parallel shard all-gathered over
    ``model``), on the CPU: the parameters, or ``tensors`` named as
    they are."""
    import torch.distributed as dist

    from molnextr_tpu_torch.parallel.mesh import axis_group, axis_size
    from molnextr_tpu_torch.parallel.tp import decoder_tp_shardings

    shardings = decoder_tp_shardings(state.model, mesh)
    if tensors is None:
        tensors = dict(state.model.named_parameters())
    out = {}
    for name, p in tensors.items():
        t = p.detach().contiguous()
        d = shardings[name].dim_of("model") if tp else None
        if d is not None:
            parts = [torch.empty_like(t) for _ in range(axis_size(mesh, "model"))]
            dist.all_gather(parts, t, group=axis_group(mesh, "model"))
            t = torch.cat(parts, dim=d)
        out[name] = t.cpu().clone()
    return out


def adam_first_moments(state):
    """The optimizer's first moments, by parameter name."""
    opt = state.optimizer
    return {n: m for g in opt.names for n, m in zip(opt.names[g], opt.mu[g])}


def case_steps(dev, cfg_json, batch_path, steps=2, mesh_shape=(-1,), mesh_axes=("data",),
               tp=False, dispatch=False):
    """``steps`` train steps on this rank's rows of the global batch (with
    ``dispatch``, one ``multi_train_step`` call over them)."""
    from molnextr_tpu_torch.parallel.mesh import shard_batch
    from molnextr_tpu_torch.parallel.tp import shard_params
    from molnextr_tpu_torch.train.step import multi_train_step, train_step

    cfg, _, mesh, state, crit = _setup(cfg_json, dev, mesh_shape, mesh_axes, seed=3)
    if tp:
        shard_params(state, mesh)
    with np.load(batch_path) as f:
        batch = {"images": f["images"],
                 "refs": {k[4:]: f[k] for k in f.files if k.startswith("ref_")}}
    local = shard_batch(mesh, batch)
    if dispatch:
        runs = [multi_train_step(cfg, crit, state, [local] * steps, seed=0)]
    else:
        runs = [train_step(cfg, crit, state, local, seed=0) for _ in range(steps)]
    metrics = [{k: float(v) for k, v in m.items()} for m in runs]
    return {"metrics": metrics, "params": full_params(state, mesh, tp),
            "mu": full_params(state, mesh, tp, adam_first_moments(state)), "step": state.step,
            "updates": state.optimizer.count, "local_rows": int(local["images"].shape[0])}


def case_dropout(dev, cfg_json, batch_path):
    """Both ranks feed the same rows; the losses before any reduction, with
    dropout on and (eval mode) off."""
    from molnextr_tpu_torch.train.step import dropout_seed
    from molnextr_tpu_torch.train.wire import as_model_images, as_model_refs

    _, _, _, state, crit = _setup(cfg_json, dev, seed=3)
    with np.load(batch_path) as f:
        images = as_model_images(f["images"][:4], dev)
        refs = as_model_refs({k[4:]: f[k][:4] for k in f.files if k.startswith("ref_")}, dev)
    model = state.model
    with torch.no_grad():
        on = crit(model(images, refs, dropout_seed=dropout_seed(state, 0)), refs)[0]
        model.eval()
        off = crit(model(images, refs), refs)[0]
    return {"dropout": float(on), "no_dropout": float(off)}


def read_predictions(path):
    """The rows of ``evaluate_model``'s predictions CSV, header first."""
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def bundle_model(bundle, dev):
    """A bundle's config and its model on ``dev``, in float32."""
    from molnextr_tpu_torch.checkpoint import load_model
    from molnextr_tpu_torch.models.model import MolNexTRModel
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.weights import load_flax_params

    cfg, params = load_model(bundle)
    toks = get_tokenizer(cfg.data)
    model = MolNexTRModel(cfg, {f: len(t) for f, t in toks.items()})
    load_flax_params(model, params)
    return cfg, toks, model.to(dev)


def case_evaluate(dev, bundle, smiles, dump_csv, batch_size):
    """``evaluate_model`` of a bundle's weights; rank 0's predictions CSV
    rows (global order) beside the scores."""
    from molnextr_tpu_torch.data.dataset import Sample
    from molnextr_tpu_torch.parallel.distributed import is_main_process
    from molnextr_tpu_torch.train.loop import evaluate_model

    cfg, toks, model = bundle_model(bundle, dev)
    scores = evaluate_model(cfg, model, toks, [Sample(s) for s in smiles], num_workers=0,
                            batch_size=batch_size, dump_csv=dump_csv)
    return {"scores": scores,
            "predictions": read_predictions(dump_csv) if is_main_process() else None}


def case_loop(dev, cfg_json, smiles, save_path):
    """One epoch of ``train_loop`` with its evaluation and checkpoint."""
    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.data.dataset import Sample
    from molnextr_tpu_torch.train.loop import train_loop

    cfg = Config.from_json(cfg_json)
    cfg.train.save_path = save_path
    samples = [Sample(s) for s in smiles]
    state = train_loop(cfg, samples, valid_samples=samples[:3], num_workers=0, print_freq=1,
                       device=dev)
    return {"step": state.step,
            "params": {n: p.detach().cpu().clone() for n, p in state.model.named_parameters()}}


def case_column_gather(dev, n_in=8, n_out=12, seed=5):
    """A column-parallel ``Dense`` whose outputs are gathered, against the
    whole layer: forward and gradients."""
    from molnextr_tpu_torch.models.layers import Dense
    from molnextr_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size, make_mesh
    from molnextr_tpu_torch.parallel.tp import ColumnParallelDense

    mesh = make_mesh((-1,), ("model",), device=dev)
    n, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
    g = torch.Generator().manual_seed(seed)
    full = Dense(n_in, n_out)
    with torch.no_grad():
        full.kernel.copy_(torch.randn(n_in, n_out, generator=g))
        full.bias.copy_(torch.randn(n_out, generator=g))
    x = torch.randn(3, n_in, generator=g)
    part = Dense(n_in, n_out)
    with torch.no_grad():
        part.kernel.data = full.kernel.detach().chunk(n, dim=1)[r].clone()
        part.bias.data = full.bias.detach().clone()
    col = ColumnParallelDense(part, axis_group(mesh, "model"), gather=True)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = full(xa), col(xb)
    w = torch.randn(ya.shape, generator=g)
    (ya * w).sum().backward()
    (yb * w).sum().backward()
    return {"y": (ya.detach(), yb.detach()), "dx": (xa.grad, xb.grad),
            "dkernel": (full.kernel.grad.chunk(n, dim=1)[r], col.kernel.grad),
            "dbias": (full.bias.grad, col.bias.grad)}


CASES = {"steps": case_steps, "dropout": case_dropout, "evaluate": case_evaluate,
         "loop": case_loop, "column_gather": case_column_gather}
