"""The port's data parallelism (``molnextr_tpu_torch/parallel``, the train
step on a mesh, the sharded loader, the rank-sharded evaluation) against
the JAX package, on the CPU.

Multi-rank cases run in ``torch.multiprocessing`` spawn processes over
gloo (``tests/torch_parallel_worker.py``), each joined within 120 s or
killed.  The reference for a W-rank step is the JAX ``jit_train_step`` over
a W-device CPU mesh on the same global batch and the same seeded weights
(``weights.seeded_flax_params``).  Tolerances are
``test_torch_train.py::test_train_step_matches_train_step_fn``'s: metrics
rtol 1e-5 / atol 1e-6; parameters after two steps 1e-6 where the gradient
is at least ten times Adam's eps, lr / 10 elsewhere (the warmup makes the
first update's rate 0, so the second moves the parameters by about
``lr * g / (|g| + eps)``, and for a gradient near eps that ratio turns
float32 rounding into a few per cent of lr).  The clip's norm is set below
both groups' gradient norms, so every step clips and the clip's global
norm (over ranks, and over a tensor-parallel split's shards) shows in
Adam's first moments.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_worker as worker
from molnextr_tpu.config import tiny_test_config as jax_tiny_config
from molnextr_tpu.models.model import MolNexTRModel as JModel
from molnextr_tpu.parallel import local_batch_size as jax_local_batch_size
from molnextr_tpu.parallel import make_mesh as jax_make_mesh
from molnextr_tpu.parallel import pad_to_devices as jax_pad_to_devices
from molnextr_tpu.parallel import shard_batch as jax_shard_batch
from molnextr_tpu.parallel.tp import decoder_tp_shardings as jax_tp_shardings
from molnextr_tpu.parallel.tp import shard_params as jax_shard_params
from molnextr_tpu.train import losses as jlosses
from molnextr_tpu.train import wire as jwire
from molnextr_tpu.train.loop import _gather_shards as jax_gather_shards
from molnextr_tpu.train.state import TrainState as JState
from molnextr_tpu.train.state import make_optimizer
from molnextr_tpu.train.step import jit_multi_train_step, jit_train_step
from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.data.dataset import DataLoader, Sample, TrainDataset
from molnextr_tpu_torch.models.layers import fold_in
from molnextr_tpu_torch.models.model import MolNexTRModel
from molnextr_tpu_torch.parallel import (
    barrier, gather_arrays, initialize, is_main_process, local_batch_size, make_mesh,
    pad_to_devices, process_count, shard_batch, shard_batch_group,
)
from molnextr_tpu_torch.parallel.distributed import shutdown
from molnextr_tpu_torch.parallel.mesh import TrivialMesh
from molnextr_tpu_torch.parallel.tp import decoder_tp_shardings
from molnextr_tpu_torch.tokenization import get_tokenizer
from molnextr_tpu_torch.train.loop import _criterion, _gather_shards
from molnextr_tpu_torch.train.state import create_train_state
from molnextr_tpu_torch.train.step import train_step
from molnextr_tpu_torch.train.wire import as_model_images, as_model_refs
from molnextr_tpu_torch.weights import _flatten, flax_to_state_dict, seeded_flax_params

torch.set_num_threads(2)

FMT = "chartok_coords"
GLOBAL_BATCH = 8
TOTAL_STEPS = 10
SEED = 3  # the weights' seed, in the rank processes too
EVAL_SMILES = ["C", "CC", "CCO", "CCC", "CCN"]  # tests/multihost_eval_worker.py's
BUNDLE = os.path.join(os.path.dirname(__file__), "..", "examples", "demo_model")
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-6
CLIP = 0.1  # below the test batch's gradient norms: encoder 0.21, decoder 0.77


def _configs(dropout=0.0):
    """The JAX tiny config and the port's copy of it."""
    jcfg = jax_tiny_config()
    jcfg.encoder = dataclasses.replace(jcfg.encoder, drop_path_rate=dropout)
    jcfg.decoder = dataclasses.replace(jcfg.decoder, hidden_dropout=dropout,
                                       attn_dropout=dropout)
    jcfg.train = dataclasses.replace(jcfg.train, max_grad_norm=CLIP)
    return jcfg, Config.from_dict(jcfg.to_dict())


def _vocab(cfg):
    return {f: len(t) for f, t in get_tokenizer(cfg.data).items()}


def _global_batch(cfg, vocab, seed=0):
    """Rows 0-3 carry labels padded after a quarter of their length; rows
    4-7 are full, with ignored (-100) edge rows: the halves hold unequal
    numbers of targets."""
    rng = np.random.RandomState(seed)
    b, t, s, k = GLOBAL_BATCH, cfg.decoder.max_len, cfg.data.input_size, cfg.data.max_atoms
    labels = rng.randint(3, vocab[FMT], (b, t)).astype(np.int32)
    labels[:, 0] = 1
    labels[:4, t // 4:] = 0
    idx = np.full((b, k), -1, np.int32)
    idx[:, :4] = [1, 2, 3, 4]
    edges = rng.randint(0, 7, (b, k, k)).astype(np.int8)
    edges[4:, 5:, :] = -100
    edges[4:, :, 5:] = -100
    g = s // cfg.train.aux_heatmap_stride
    grid = rng.randint(-1, 12, (b, g, g)).astype(np.int8)
    grid[6] = -2  # an unlabeled sample
    return {"images": rng.randint(0, 256, (b, s, s, 1)).astype(np.uint8),
            "refs": {FMT: labels, "atom_indices": idx, "edges": edges, "atom_grid": grid}}


def _save_batch(batch, path):
    np.savez(path, images=batch["images"], **{f"ref_{k}": v for k, v in batch["refs"].items()})
    return str(path)


def _jax_criterion(cfg):
    return jlosses.Criterion(cfg.data.formats, cfg.train.label_smoothing,
                             _criterion(cfg, get_tokenizer(cfg.data)).coord_vocab,
                             cfg.train.aux_heatmap_weight)


def _jax_steps(jcfg, cfg, vocab, batch, shape, axes=("data",), steps=2, dispatch=False):
    """The JAX package's jitted train step over a mesh of ``shape``: with a
    ``model`` axis the parameters are placed by its ``shard_params``; with
    ``dispatch``, one ``jit_multi_train_step`` call over ``steps`` copies of
    the batch (metrics averaged), else ``steps`` calls of ``jit_train_step``.
    The optimizer is ``make_optimizer``'s, ``optax.MultiSteps`` when
    ``jcfg.train.grad_accum_steps`` > 1.  Returns the metrics, the
    parameters and Adam's first moments."""
    jm = JModel(jcfg, vocab)
    tx = make_optimizer(jcfg, TOTAL_STEPS)
    mesh = jax_make_mesh(shape, axes, jax.devices()[:math.prod(shape)])
    jp = jax.tree_util.tree_map(jnp.asarray, seeded_flax_params(cfg, vocab, SEED))
    if "model" in axes:
        jp = jax_shard_params(jp, mesh)
    state = JState(step=jnp.asarray(0, jnp.int32), params=jp, opt_state=tx.init(jp), tx=tx)
    on = jax.tree_util.tree_map(jnp.asarray, batch)
    rng = jax.random.PRNGKey(0)
    if dispatch:
        group = jax.tree_util.tree_map(lambda x: jnp.stack([x] * steps), on)
        state, m = jit_multi_train_step(jm, _jax_criterion(cfg), mesh, group)(state, group, rng)
        metrics = [{k: float(v) for k, v in m.items()}]
    else:
        dev_batch = jax_shard_batch(mesh, on)
        step = jit_train_step(jm, _jax_criterion(cfg), mesh, dev_batch)
        metrics = []
        for _ in range(steps):
            state, m = step(state, dev_batch, rng)
            metrics.append({k: float(v) for k, v in m.items()})
    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]  # one a group
    mu = {}
    for s in adam:  # (a leaf of the other group is an empty MaskedNode)
        mu.update({k: v for k, v in _flatten(s.mu).items() if v.size})
    return metrics, _flatten(jax.tree_util.tree_map(np.asarray, state.params)), mu


def _jax_loss_fn(jcfg, cfg, vocab):
    """The JAX training loss of (params, batch), rates 0."""
    jm = JModel(jcfg, vocab)
    jc = _jax_criterion(cfg)

    def loss_fn(p, batch):
        refs = jwire.as_model_refs(batch["refs"])
        out = jm.apply(p, jwire.as_model_images(batch["images"]), refs,
                       deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        return jc(out, refs)[0]

    return loss_fn


def _assert_the_clip_acts(grads):
    """Both groups' (``encoder`` and the rest) gradient norms exceed the
    clip's, so ``make_optimizer``'s ``clip_by_global_norm`` scales them."""
    for enc in (True, False):
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                           for p, g in grads.items() if (p.split("/")[1] == "encoder") == enc))
        assert norm > CLIP, (enc, norm)


def _port_flat(params):
    """The port's named tensors -> flax paths, as ``_flatten`` gives them."""
    from molnextr_tpu_torch.weights import state_dict_to_flax

    return _flatten(state_dict_to_flax({n: t.numpy() for n, t in params.items()}))


def _assert_params_match(got, want, grads, lr):
    assert set(got) == set(want)
    for path in want:
        tol = np.where(np.abs(grads[path]) >= 10 * 1e-8, 1e-6, lr / 10)
        err = np.abs(got[path] - want[path])
        assert (err <= tol).all(), (path, float(err.max()))


def _assert_moments_match(got, want):
    """Adam's first moments (the clipped gradients, averaged) under
    ``test_torch_train.py::test_gradients_match_jax_grad``'s rule: 1e-4 of
    each leaf's largest magnitude, and 1e-7 over it for the key
    projection's bias, whose gradient is rounding noise."""
    assert set(got) == set(want)
    for path in want:
        floor = 1e-7 if path.endswith(("k/bias", "qkv/bias")) else 0.0
        err = float(np.abs(got[path] - want[path]).max())
        assert err <= 1e-4 * float(np.abs(want[path]).max()) + floor, (path, err)


def _assert_metrics_match(got, want):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=name)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The global batch on disk, the JAX package's gradients of it, and its
    loss on each half alone."""
    jcfg, cfg = _configs()
    vocab = _vocab(cfg)
    batch = _global_batch(cfg, vocab)
    path = _save_batch(batch, tmp_path_factory.mktemp("batch") / "batch.npz")
    # the rank processes start now and run while the JAX package compiles
    common = dict(cfg_json=cfg.to_json(), batch_path=path)
    accum = _accum_config(cfg)
    ranks = {
        "w2": worker.Ranks(2, tmp_path_factory.mktemp("w2"), [
            ("steps", common),
            ("steps", dict(common, cfg_json=accum.to_json(), steps=4, dispatch=True))]),
        "w4": worker.Ranks(4, tmp_path_factory.mktemp("w4"), [
            ("steps", common),
            ("steps", dict(common, mesh_shape=(2, 2), mesh_axes=("data", "model"), tp=True)),
            ("column_gather", {})]),
    }
    loss_fn = _jax_loss_fn(jcfg, cfg, vocab)
    jp = jax.tree_util.tree_map(jnp.asarray, seeded_flax_params(cfg, vocab, SEED))
    on = lambda b: jax.tree_util.tree_map(jnp.asarray, b)  # noqa: E731
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp, on(batch))
    grads = _flatten(jax.tree_util.tree_map(np.asarray, grads))
    _assert_the_clip_acts(grads)
    half = jax.jit(loss_fn)
    halves = [float(half(jp, on({"images": batch["images"][sl],
                                 "refs": {k: v[sl] for k, v in batch["refs"].items()}})))
              for sl in (slice(0, 4), slice(4, 8))]
    yield {"jcfg": jcfg, "cfg": cfg, "vocab": vocab, "batch": batch, "path": path, "accum": accum,
           "loss": float(loss), "grads": grads, "half_losses": halves, "ranks": ranks}
    for r in ranks.values():
        r.stop()


# ---------------------------------------------------------------------------
# helpers on one process
# ---------------------------------------------------------------------------


def test_single_process_helpers_are_noops(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize(device="cpu") == torch.device("cpu")
    assert process_count() == 1 and is_main_process()
    x = np.arange(6).reshape(2, 3)
    np.testing.assert_array_equal(gather_arrays(x), x)
    barrier()  # no-op, must not raise
    shutdown()  # no group: nothing to end


@pytest.mark.parametrize("shape,axes,want", [
    ((-1,), ("data",), (1,)),
    ((1, -1), ("data", "model"), (1, 1)),
    ((-1, 1), ("data", "model"), (1, 1)),
])
def test_make_mesh_shapes(shape, axes, want):
    mesh = make_mesh(shape, axes, device="cpu")
    assert isinstance(mesh, TrivialMesh)
    assert tuple(mesh.shape) == want and mesh.mesh_dim_names == axes
    assert tuple(jax_make_mesh(shape, axes, jax.devices()[:1]).devices.shape) == want


@pytest.mark.parametrize("shape,axes", [((2,), ("data",)), ((1,), ("data", "model"))])
def test_make_mesh_refuses_a_shape_that_is_not_the_world(shape, axes):
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh(shape, axes, device="cpu")


def test_batch_sizes_and_rows_on_two_data_ranks():
    """A stand-in mesh of two data ranks: the JAX package's divisibility
    error and padding, and rank 1's contiguous rows."""
    class RankOne(TrivialMesh):
        def get_local_rank(self, mesh_dim=None):
            return 1

    mesh = RankOne((2,), ("data",), "cpu")
    jmesh = jax_make_mesh((2,), ("data",), jax.devices()[:2])
    for fn in (lambda: local_batch_size(7, mesh), lambda: jax_local_batch_size(7, jmesh)):
        with pytest.raises(ValueError, match="not divisible"):
            fn()
    assert local_batch_size(8, mesh) == jax_local_batch_size(8, jmesh) == 4
    assert pad_to_devices(5, mesh) == jax_pad_to_devices(5, jmesh) == 6
    batch = {"images": np.arange(8 * 2).reshape(8, 2), "refs": {"a": np.arange(8)},
             "smiles": list("abcdefgh")}
    rows = shard_batch(mesh, batch)
    assert rows["refs"]["a"].tolist() == [4, 5, 6, 7] and rows["smiles"] == list("efgh")
    assert torch.equal(rows["images"], torch.arange(8, 16).reshape(4, 2))
    group = shard_batch_group(mesh, {"refs": {"a": np.arange(16).reshape(2, 8)}})
    assert group["refs"]["a"].tolist() == [[4, 5, 6, 7], [12, 13, 14, 15]]


def test_initialize_names_its_backend_and_device():
    """No backend is picked behind the caller's back: NCCL refuses CPU
    ranks, and an unknown backend or device raises before any group
    starts."""
    for kwargs in (dict(backend="nccl", device="cpu"), dict(backend="mpi", device="cpu"),
                   dict(device="meta")):
        with pytest.raises(ValueError):
            initialize(world_size=2, rank=0, **kwargs)
    assert process_count() == 1


def test_tp_shardings_match_the_jax_rules():
    """Every decoder leaf's spec over a (2, 2) mesh, against the JAX
    package's ``decoder_tp_shardings`` on the same parameter tree."""
    _, cfg = _configs()
    vocab = _vocab(cfg)
    params = seeded_flax_params(cfg, vocab, SEED)
    jspecs = jax_tp_shardings(params, jax_make_mesh((2, 2), ("data", "model"),
                                                    jax.devices()[:4]))
    port = decoder_tp_shardings(MolNexTRModel(cfg, vocab),
                                TrivialMesh((2, 2), ("data", "model"), "cpu"))
    flat = {"/".join(str(k.key) for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(jspecs)[0]}
    ruled = ("ffn/w1/kernel", "ffn/w1/bias", "ffn/w2/kernel", "output/kernel")
    split = 0
    for path, spec in flat.items():
        if not path.endswith(ruled):  # (the attention's q/k/v leaves are one qkv here)
            assert spec == (), path
            continue
        tree = node = {}
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.zeros(cfg.decoder.num_layers if "/layers/" in path else 1)
        for name in flax_to_state_dict(tree):  # a stacked leaf: every layer
            # the JAX decoder stacks its layers on a leading axis: the split
            # dim is compared counting from the last
            got = port[name].spec
            assert ("model" in got) == ("model" in spec), (path, name, got, spec)
            if "model" in spec:
                assert got.index("model") - len(got) == spec.index("model") - len(spec)
                split += 1
    assert sum(bool(s.spec) for s in port.values()) == split == 3 * cfg.decoder.num_layers


# ---------------------------------------------------------------------------
# the rank-sharded evaluation's gather (the JAX package's four cases)
# ---------------------------------------------------------------------------


def _fake_gather_run(gather_shards, world_arrays, world_idx):
    """Rank 0's call of ``gather_shards`` with a gather that stacks what
    every rank contributes at the same call (their pad logic replayed)."""
    world = len(world_arrays)
    n_max = max(len(i) for i in world_idx)
    contribs = []
    for arrays, idx in zip(world_arrays, world_idx):
        idx = np.asarray(idx, np.int32)
        pad = n_max - len(idx)
        seq = [np.asarray([len(idx)], np.int32), np.pad(idx + 1, (0, pad))]
        seq += [np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)) for a in arrays.values()]
        contribs.append(seq)
    calls = []

    def gather(a):
        calls.append(a)
        return np.stack([c[len(calls) - 1] for c in contribs])

    if world == 1:
        gather = lambda a: np.asarray(a)[None]  # noqa: E731
    return gather_shards(world_arrays[0], np.asarray(world_idx[0], np.int32), gather, world)


GATHER_CASES = {
    "unequal_shards_reorder": (
        [{"seq": np.arange(12).reshape(3, 4).astype(np.int32)},
         {"seq": (100 + np.arange(8).reshape(2, 4)).astype(np.int32)}],
        [[0, 2, 4], [1, 3]], [0, 1, 2, 3, 4]),
    "dropped_samples_skipped": (
        [{"seq": np.ones((2, 4), np.int32)}, {"seq": np.full((1, 4), 7, np.int32)}],
        [[0, 2], [1]], [0, 1, 2]),
    "multiple_arrays_consistent": (
        [{"seq": np.zeros((2, 4), np.int32), "edges": np.zeros((2, 3, 3), np.int32)},
         {"seq": np.ones((2, 4), np.int32), "edges": np.ones((2, 3, 3), np.int32)}],
        [[0, 2], [1, 3]], [0, 1, 2, 3]),
    "single_process_identity": (
        [{"seq": np.arange(8).reshape(2, 4).astype(np.int32)}], [[0, 1]], [0, 1]),
}


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_shards_matches_jax(case):
    arrays, idx, want_idx = GATHER_CASES[case]
    got, got_idx = _fake_gather_run(_gather_shards, arrays, idx)
    ref, ref_idx = _fake_gather_run(jax_gather_shards, arrays, idx)
    assert got_idx.tolist() == ref_idx.tolist() == want_idx
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    if case == "unequal_shards_reorder":
        np.testing.assert_array_equal(got["seq"][1], arrays[1]["seq"][0])


# ---------------------------------------------------------------------------
# the sharded loader
# ---------------------------------------------------------------------------


LOADER_SMILES = ["C" * (i % 5 + 1) + "O" * (i // 5 + 1) for i in range(20)] + \
    ["CCN", "CNC", "NCCN", "OCCO"]


@pytest.mark.parametrize("world", [2, 4])
def test_rank_shards_partition_the_loader_batches(world):
    """Each step's shards, in rank order, are the one-process loader's batch
    of that step, over two epochs (reshuffled by the shared seed)."""
    _, cfg = _configs()
    cfg.data.augment = cfg.data.mol_augment = False
    toks = get_tokenizer(cfg.data)

    def loader(rank=0, n=1):
        ds = TrainDataset(cfg, [Sample(s) for s in LOADER_SMILES], toks)
        return DataLoader(ds, batch_size=GLOBAL_BATCH, shuffle=True, seed=4, prefetch=0,
                          rank=rank, world=n)

    whole = loader()
    shards = [loader(r, world) for r in range(world)]
    assert {len(s) for s in shards} == {len(whole)} == {len(LOADER_SMILES) // GLOBAL_BATCH}
    seen = set()
    for epoch in range(2):
        for ld in [whole, *shards]:
            ld.set_epoch(epoch)
        steps = list(zip(whole, *shards))
        assert len(steps) == len(whole)
        for batch, *parts in steps:
            assert all(len(p["smiles"]) == GLOBAL_BATCH // world for p in parts)
            assert sum((p["smiles"] for p in parts), []) == batch["smiles"]
            for p, name in ((p, n) for p in parts for n in ("images",)):
                assert p[name].shape[0] == GLOBAL_BATCH // world
            seen.add(tuple(batch["smiles"]))
    assert len(seen) == 2 * len(whole)  # the second epoch reshuffled
    with pytest.raises(ValueError, match="data ranks"):
        DataLoader(whole.dataset, batch_size=6, rank=0, world=4)


# ---------------------------------------------------------------------------
# the train step on one rank
# ---------------------------------------------------------------------------


def _pr8_train_step(cfg, criterion, state, batch, seed):
    """The single-device step as it stood before data parallelism."""
    model = state.model
    model.train()
    refs = as_model_refs(batch["refs"], "cpu")
    images = as_model_images(batch["images"], "cpu")
    for p in model.parameters():
        p.grad = None
    outputs = model(images, refs, dropout_seed=fold_in(seed, state.step))
    total, losses = criterion(outputs, refs)
    total.backward()
    state.optimizer.step()
    state.step += 1
    return {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}


def test_world_one_step_is_the_single_device_step_bit_for_bit(reference):
    """Dropout on.  With no process group the step is the single-device
    step; over a gloo group of one rank it is too: the collectives of a
    world of one change no bit."""
    _, cfg = _configs(dropout=0.1)
    vocab, batch = reference["vocab"], reference["batch"]
    crit = _criterion(cfg, get_tokenizer(cfg.data))

    def state(mesh=None):
        return create_train_state(cfg, MolNexTRModel(cfg, vocab), TOTAL_STEPS, seed=SEED,
                                  device="cpu", mesh=mesh)

    runs = {}
    old, new = state(), state(make_mesh(device="cpu"))
    runs["pr8"] = (old, [_pr8_train_step(cfg, crit, old, batch, 1) for _ in range(2)])
    runs["no_group"] = (new, [train_step(cfg, crit, new, batch, 1) for _ in range(2)])
    initialize(backend="gloo", init_method=f"tcp://127.0.0.1:{worker.free_port()}",
               world_size=1, rank=0, device="cpu")
    try:
        one = state(make_mesh(device="cpu"))
        assert not isinstance(one.mesh, TrivialMesh)
        runs["gloo_world_1"] = (one, [train_step(cfg, crit, one, batch, 1) for _ in range(2)])
    finally:
        shutdown()
    want_state, want_metrics = runs["pr8"]
    for name, (st, metrics) in runs.items():
        for m, w in zip(metrics, want_metrics):
            assert set(m) == set(w)
            assert all(torch.equal(m[k], w[k]) for k in w), name
        for (n, p), (_, q) in zip(st.model.named_parameters(),
                                  want_state.model.named_parameters()):
            assert torch.equal(p, q), (name, n)


# ---------------------------------------------------------------------------
# two and four ranks
# ---------------------------------------------------------------------------


def _accum_config(cfg):
    """``cfg`` with two micro-steps an update (``optax.MultiSteps``)."""
    accum = Config.from_json(cfg.to_json())
    accum.train.grad_accum_steps = 2
    return accum


@pytest.fixture(scope="module")
def two_ranks_runs(reference):
    """Each rank's results: two steps, then four micro-steps of the
    accumulating config in one ``multi_train_step`` call."""
    return list(zip(*reference["ranks"]["w2"].join()))


@pytest.fixture(scope="module")
def two_ranks(two_ranks_runs):
    return two_ranks_runs[0]


@pytest.fixture(scope="module")
def four_ranks(reference):
    """Per case, each rank's result: mesh (4,), mesh (2, 2) with the split,
    and the gathered column-parallel layer on a ("model",) mesh of 4."""
    return list(zip(*reference["ranks"]["w4"].join()))


def test_two_rank_step_matches_the_jax_sharded_step(reference, two_ranks):
    """Two gloo ranks, 4 rows each, against ``jit_train_step`` over a
    2-device mesh: metrics of both steps, parameters after them, and both
    ranks' parameters bit for bit."""
    jcfg, cfg, vocab = reference["jcfg"], reference["cfg"], reference["vocab"]
    jmetrics, jparams, jmu = _jax_steps(jcfg, cfg, vocab, reference["batch"], (2,))
    assert [r["local_rows"] for r in two_ranks] == [4, 4]
    assert [r["step"] for r in two_ranks] == [2, 2]
    for r in two_ranks:
        for got, want in zip(r["metrics"], jmetrics):
            _assert_metrics_match(got, want)
    _assert_params_match(_port_flat(two_ranks[0]["params"]), jparams, reference["grads"],
                         jcfg.train.encoder_lr)
    _assert_moments_match(_port_flat(two_ranks[0]["mu"]), jmu)
    for name, p in two_ranks[0]["params"].items():
        assert torch.equal(p, two_ranks[1]["params"][name]), name


def test_two_rank_accumulation_and_dispatch_keep_their_meaning(reference, two_ranks_runs):
    """``grad_accum_steps`` 2 and four micro-steps dispatched in one call on
    two ranks against the JAX package's ``optax.MultiSteps`` in one
    ``jit_multi_train_step`` call over a 2-device mesh: two real updates
    (the first at rate 0), the averaged metrics, the parameters under the
    rule above."""
    jcfg = dataclasses.replace(reference["jcfg"])
    jcfg.train = dataclasses.replace(jcfg.train, grad_accum_steps=2)
    jmetrics, jparams, jmu = _jax_steps(jcfg, reference["accum"], reference["vocab"],
                                        reference["batch"], (2,), steps=4, dispatch=True)
    for r in two_ranks_runs[1]:
        assert (r["step"], r["updates"]) == (4, 2)
        _assert_metrics_match(r["metrics"][0], jmetrics[0])
    _assert_params_match(_port_flat(two_ranks_runs[1][0]["params"]), jparams,
                         reference["grads"], jcfg.train.encoder_lr)
    _assert_moments_match(_port_flat(two_ranks_runs[1][0]["mu"]), jmu)


def test_rank_shares_of_the_criterion_sum_to_the_global_batch():
    """Every loss and accuracy of the criterion on two halves of a batch,
    each divided by the summed weight sums (``Criterion.denominators``),
    adds up to the criterion on the whole batch; each half's own mean does
    not."""
    _, cfg = _configs()
    vocab = _vocab(cfg)
    batch = _global_batch(cfg, vocab)
    crit = _criterion(cfg, get_tokenizer(cfg.data))
    rng = np.random.RandomState(9)
    k, g, t = cfg.data.max_atoms, cfg.data.input_size // cfg.train.aux_heatmap_stride, \
        cfg.decoder.max_len
    outputs = {FMT: torch.from_numpy(rng.randn(GLOBAL_BATCH, t - 1, vocab[FMT]).astype(np.float32)),
               "edges": torch.from_numpy(rng.randn(GLOBAL_BATCH, 7, k, k).astype(np.float32)),
               "heatmap": torch.from_numpy(rng.randn(GLOBAL_BATCH, g, g, 13).astype(np.float32))}
    refs = as_model_refs(batch["refs"], "cpu")
    whole_total, whole = crit(outputs, refs)
    halves = [({n: v[sl] for n, v in outputs.items()}, {n: v[sl] for n, v in refs.items()})
              for sl in (slice(0, 4), slice(4, 8))]
    local = [crit.denominators(r) for _, r in halves]
    denoms = {n: local[0][n] + local[1][n] for n in local[0]}
    parts = [crit(o, r, denoms) for o, r in halves]
    own = [crit(o, r) for o, r in halves]
    np.testing.assert_allclose(float(parts[0][0] + parts[1][0]), float(whole_total), rtol=1e-6)
    assert set(whole) == set(parts[0][1]) and len(whole) == 9
    for name in whole:
        np.testing.assert_allclose(float(parts[0][1][name] + parts[1][1][name]),
                                   float(whole[name]), rtol=1e-6, atol=1e-7, err_msg=name)
    assert abs(float(own[0][0] + own[1][0]) / 2 - float(whole_total)) > 1e-3


def test_two_rank_batch_would_catch_a_mean_of_rank_means(reference, two_ranks):
    """The halves hold unequal target counts, so the mean of the two ranks'
    own means misses the global loss by far more than the tolerance; the
    step's loss does not."""
    loss = reference["loss"]
    tol = METRIC_ATOL + METRIC_RTOL * abs(loss)
    assert abs(np.mean(reference["half_losses"]) - loss) > 10 * tol
    assert abs(two_ranks[0]["metrics"][0]["loss"] - loss) <= tol


def test_two_rank_dropout_masks_differ(reference, tmp_path):
    """Both ranks fed the same rows: with dropout the losses before any
    reduction differ (the data rank is folded into the seed); in eval mode
    they are equal."""
    _, cfg = _configs(dropout=0.1)
    r0, r1 = worker.spawn("dropout", 2, tmp_path, cfg_json=cfg.to_json(),
                          batch_path=reference["path"])
    assert r0["no_dropout"] == r1["no_dropout"]
    assert r0["dropout"] != r1["dropout"]


def test_two_rank_evaluation_scores_on_rank_zero(tmp_path):
    """The trained demo bundle over five samples round-robin on two ranks (3
    and 2): rank 0's predictions, in global order, and its scores are one
    process's; rank 1 returns {}.  The bundle reads most of them right and
    no two predictions are equal, so a lost, zeroed or misordered row of
    the gather would show."""
    kw = dict(bundle=BUNDLE, smiles=EVAL_SMILES, batch_size=2)
    r0, r1 = worker.spawn("evaluate", 2, tmp_path, dump_csv=str(tmp_path / "ranks.csv"), **kw)
    want = worker.case_evaluate("cpu", dump_csv=str(tmp_path / "one.csv"), **kw)
    assert want["scores"]["n"] == 5 and want["scores"]["canon_smiles"] > 0
    preds = [row[2:] for row in want["predictions"][1:]]
    assert len({tuple(p) for p in preds}) == 5
    assert r0["predictions"] == want["predictions"]
    assert r0["scores"] == want["scores"]
    assert r1["scores"] == {}


def test_two_rank_train_loop_writes_on_rank_zero(tmp_path):
    """``train_loop`` on two ranks: one epoch of two global batches, the
    gathered evaluation, rank 0's metrics line and checkpoint, and equal
    parameters on both ranks."""
    import json
    import os

    _, cfg = _configs()
    cfg.train.epochs = 1
    out = tmp_path / "run"
    r0, r1 = worker.spawn("loop", 2, tmp_path, cfg_json=cfg.to_json(),
                          smiles=LOADER_SMILES[:16], save_path=str(out))
    assert r0["step"] == r1["step"] == 2
    for name, p in r0["params"].items():
        assert torch.equal(p, r1["params"][name]), name
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 1 and lines[0]["valid_n"] == 3 and np.isfinite(lines[0]["train_loss"])
    assert os.path.exists(os.path.join(out, "ckpt_last", "params.msgpack"))


def test_four_rank_tensor_parallel_step_matches_data_parallel(reference, four_ranks):
    """Mesh (2, 2) ("data", "model") with the decoder's FFN split against
    mesh (4,): the loss of both steps within rtol 1e-5 and the parameters
    after them (the shards gathered) under the rule above; every rank's
    whole parameters equal bit for bit within each run."""
    dp, tp, _ = four_ranks
    assert [r["local_rows"] for r in dp] == [2] * 4 and [r["local_rows"] for r in tp] == [4] * 4
    for a, b in zip(dp[0]["metrics"], tp[0]["metrics"]):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    _assert_params_match(_port_flat(tp[0]["params"]), _port_flat(dp[0]["params"]),
                         reference["grads"], reference["jcfg"].train.encoder_lr)
    for run in (dp, tp):
        for r in run[1:]:
            for name, p in run[0]["params"].items():
                assert torch.equal(p, r["params"][name]), name


@pytest.mark.parametrize("run", ["data", "data_model"])
def test_four_rank_step_matches_the_jax_step(reference, four_ranks, run):
    """Mesh (4,), and mesh (2, 2) ("data", "model") with the decoder's FFN
    split, against ``jit_train_step`` over the same JAX mesh (the split
    placed by the JAX package's ``shard_params``): metrics of both steps on
    every rank, the parameters after them (the shards gathered) under the
    rule above, and every rank's Adam first moments, which carry the clip's
    factor that Adam's update all but cancels."""
    shape, axes, ranks = {"data": ((4,), ("data",), four_ranks[0]),
                          "data_model": ((2, 2), ("data", "model"), four_ranks[1])}[run]
    jcfg, cfg, vocab = reference["jcfg"], reference["cfg"], reference["vocab"]
    jmetrics, jparams, jmu = _jax_steps(jcfg, cfg, vocab, reference["batch"], shape, axes)
    for r in ranks:
        for got, want in zip(r["metrics"], jmetrics):
            _assert_metrics_match(got, want)
    _assert_params_match(_port_flat(ranks[0]["params"]), jparams, reference["grads"],
                         jcfg.train.encoder_lr)
    for r in ranks:
        _assert_moments_match(_port_flat(r["mu"]), jmu)


def test_column_parallel_gather_matches_the_whole_layer(four_ranks):
    """The vocabulary projection's form (columns split over 4 ranks, logits
    all-gathered, replicated bias) against the whole layer: output and
    every gradient (the chartok vocabulary does not divide, so the model
    leaves it whole)."""
    for r in four_ranks[2]:
        for name, (want, got) in r.items():
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6, msg=name)
