"""The port's training loop, checkpoints and per-epoch engine (CPU, tiny
config), and model bundles exchanged with the JAX package."""

import json
import os

import numpy as np
import pytest
import torch

from molnextr_tpu import checkpoint as jckpt
from molnextr_tpu_torch import checkpoint as pckpt
from molnextr_tpu_torch.config import tiny_test_config
from molnextr_tpu_torch.data.dataset import Sample
from molnextr_tpu_torch.models.model import MolNexTRModel
from molnextr_tpu_torch.tokenization import get_tokenizer
from molnextr_tpu_torch.train.loop import serving_engine, train_loop
from molnextr_tpu_torch.train.state import create_train_state
from molnextr_tpu_torch.weights import _flatten, model_to_flax_params

torch.set_num_threads(2)

SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CCCCC1", "CCOC", "CN", "CO",
          "CCC", "CCCl", "CBr", "CCS", "CC=C", "C#N", "CCCO", "COC"]


def _cfg(tmp_path, epochs=2):
    cfg = tiny_test_config()
    cfg.train.epochs = epochs
    cfg.train.batch_size = 8
    cfg.train.save_path = str(tmp_path)
    return cfg


def _state(cfg, seed=0):
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    return create_train_state(cfg, MolNexTRModel(cfg, vocab), 10, seed=seed, device="cpu")


def test_two_epoch_run_with_eval_checkpoint_and_resume(tmp_path):
    cfg = _cfg(tmp_path)
    samples = [Sample(s) for s in SMILES]
    state = train_loop(cfg, samples, valid_samples=samples[:4], num_workers=0, print_freq=1,
                       device="cpu")
    assert state.step == 2 * (len(SMILES) // 8) and state.model.training
    with open(os.path.join(tmp_path, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    assert len(metrics) == 2 and metrics[0]["valid_n"] == 4
    assert "valid_canon_smiles" in metrics[0] and np.isfinite(metrics[-1]["train_loss"])
    assert np.isfinite(metrics[-1]["train_heatmap"]) and "train_acc_edge" in metrics[-1]
    for name in ("config.json", "params.msgpack", "opt_state.pt", "train_meta.json"):
        assert os.path.exists(os.path.join(tmp_path, "ckpt_best", name))
        assert os.path.exists(os.path.join(tmp_path, "ckpt_last", name))
    # resume from the rolling last snapshot for a third epoch
    cfg.train.epochs = 3
    state = train_loop(cfg, samples, valid_samples=samples[:4], num_workers=0, print_freq=1,
                       resume="last", device="cpu")
    assert state.step == 3 * (len(SMILES) // 8)
    with open(os.path.join(tmp_path, "metrics.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1, 2]


def test_bundles_round_trip_with_the_jax_package(tmp_path):
    """A bundle the port writes is the bytes the JAX package writes for the
    same parameters; each package loads the other's with equal values."""
    cfg = tiny_test_config()
    state = _state(cfg, seed=5)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.01)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    pckpt.save_model(port_dir, cfg, state.model)
    from molnextr_tpu.config import Config as JConfig

    tree = model_to_flax_params(state.model)
    jckpt.save_model(jax_dir, JConfig.from_dict(cfg.to_dict()), tree)
    with open(os.path.join(port_dir, "params.msgpack"), "rb") as a, \
            open(os.path.join(jax_dir, "params.msgpack"), "rb") as b:
        assert a.read() == b.read()
    _, jparams = jckpt.load_model(port_dir)
    _, pparams = pckpt.load_model(jax_dir)
    want = _flatten(tree)
    for got in (_flatten(jparams), _flatten(pparams)):
        assert set(got) == set(want)
        for path in want:
            np.testing.assert_array_equal(np.asarray(got[path]), want[path])
    assert "heatmap_head" in jparams["params"]


def test_resume_restores_step_and_optimizer(tmp_path):
    cfg = _cfg(tmp_path)
    state = _state(cfg)
    for p in state.model.parameters():
        p.grad = torch.ones_like(p) * 0.01
    state.optimizer.step()
    state.step = 7
    mgr = pckpt.CheckpointManager(str(tmp_path), "best")
    mgr.save(cfg, state, epoch=0, score=0.5)
    fresh = _state(cfg, seed=1)
    restored, meta = mgr.restore(fresh, "best")
    assert restored.step == 7 and meta["epoch"] == 0 and restored.optimizer.count == 1
    for (n, p), (_, q) in zip(state.model.named_parameters(), restored.model.named_parameters()):
        assert torch.equal(p, q), n
    for g in ("encoder", "decoder"):
        for a, b in zip(state.optimizer.mu[g], restored.optimizer.mu[g]):
            assert torch.equal(a, b)



def test_restore_that_fails_leaves_the_state_as_it_was(tmp_path):
    """A snapshot whose optimizer state does not fit (saved without
    accumulation, restored with grad_accum_steps 2) raises before anything
    is copied: the parameters, the optimizer and the step stay as they were,
    so the loop's fallback starts from an untouched state."""
    cfg = _cfg(tmp_path)
    saved = _state(cfg, seed=0)
    saved.step = 5
    pckpt.CheckpointManager(str(tmp_path), "best").save(cfg, saved, epoch=0, score=0.5)
    cfg.train.grad_accum_steps = 2
    state = _state(cfg, seed=1)
    before = {n: p.clone() for n, p in state.model.named_parameters()}
    assert any(not torch.equal(before[n], p) for n, p in saved.model.named_parameters())
    with pytest.raises(KeyError, match="acc/"):
        pckpt.CheckpointManager(str(tmp_path), "best").restore(state, "best")
    assert state.step == 0 and state.optimizer.count == 0
    for n, p in state.model.named_parameters():
        assert torch.equal(p, before[n]), n


def test_snapshot_atomic_swap_keeps_old_on_partial(tmp_path):
    cfg = _cfg(tmp_path)
    state = _state(cfg)
    mgr = pckpt.CheckpointManager(str(tmp_path), "last")
    mgr.save(cfg, state, epoch=0, score=0.1)
    stale = os.path.join(str(tmp_path), "ckpt_last.tmp")
    os.makedirs(stale)
    with open(os.path.join(stale, "params.msgpack"), "wb") as f:
        f.write(b"partial")
    state.step = 3
    mgr.save(cfg, state, epoch=1, score=0.2)
    assert not os.path.exists(stale)
    restored, meta = mgr.restore(_state(cfg, seed=2), "last")
    assert restored.step == 3 and meta["epoch"] == 1


def test_predict_raw_override_leaves_the_training_module_alone():
    """The engine owns a module of its own; the override copies the live
    float32 weights into it (cast to its dtype) and changes nothing of the
    training module: not its mode, not its dtype, not its values."""
    cfg = tiny_test_config()
    cfg.train.bf16 = True
    state = _state(cfg, seed=3)
    model = state.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    engine = serving_engine(cfg, get_tokenizer(cfg.data), "cpu")
    assert engine.model is not model and engine.model.dtype == torch.bfloat16
    images = np.random.RandomState(0).randint(0, 256, (3, 32, 32, 1)).astype(np.uint8)
    raw = engine.predict_images_raw(images, params=model)
    assert raw["seq"].shape == (3, engine.max_len) and raw["edges"].shape == (3, 8, 8)
    assert model.training and model.dtype == torch.float32
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, before[n]), n
    assert engine.model.enc_trans.kernel.dtype == torch.bfloat16
    torch.testing.assert_close(engine.model.enc_trans.kernel.float(),
                               model.enc_trans.kernel.to(torch.bfloat16).float())
    # the same weights through an engine built on a copy give the same tokens
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    from molnextr_tpu_torch.inference import InferenceEngine
    from molnextr_tpu_torch.weights import load_flax_params

    copy = load_flax_params(MolNexTRModel(cfg, vocab), model_to_flax_params(model))
    ref = InferenceEngine(cfg, get_tokenizer(cfg.data), copy.to_dtype(torch.bfloat16), "cpu")
    np.testing.assert_array_equal(ref.predict_images_raw(images)["seq"], raw["seq"])
    with pytest.raises(KeyError):
        engine.load_params({"enc_trans.kernel": model.enc_trans.kernel})


def test_training_entry_points_need_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(tmp_path)
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(cfg, MolNexTRModel(cfg, vocab), 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_loop(cfg, [Sample(s) for s in SMILES])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving_engine(cfg, get_tokenizer(cfg.data), "cuda")
    assert not os.listdir(tmp_path)  # nothing ran before the device check


def test_loop_options_dispatch_accumulation_images_and_profile(tmp_path):
    """dispatch_steps 2 and grad_accum_steps 2: four batches are four train
    steps and two optimizer updates; save_images writes PNG renders and
    profile_steps a trace."""
    from molnextr_tpu_torch.data.png import read_png

    cfg = _cfg(tmp_path, epochs=1)
    cfg.train.batch_size = 4
    cfg.train.dispatch_steps = cfg.train.grad_accum_steps = 2
    state = train_loop(cfg, [Sample(s) for s in SMILES], num_workers=0, do_eval=False,
                       save_images=2, profile_steps=1, device="cpu")
    assert state.step == len(SMILES) // 4 and state.optimizer.count == state.step // 2
    images = sorted(os.listdir(tmp_path / "images"))
    assert images == ["0.png", "1.png"]
    assert read_png(str(tmp_path / "images" / "0.png")).ndim == 3
    assert os.path.getsize(tmp_path / "profile" / "trace.json") > 0
