"""The port's training path (CPU, float32) against the JAX package's, on the
same seeded parameters (``weights.seeded_flax_params``) and numpy batches.

Tolerances: losses and metrics 1e-6 (the same float32 formulas); schedules
1e-7 (optax's float32 arithmetic); optimizer updates 1e-6 on the parameters
(Adam divides by the root of the second moment, so a last-bit difference of
a gradient moves a parameter by a few 1e-8); the training forward 1e-5;
gradients 1e-4 of each leaf's largest magnitude.  The model is the tiny test
config widened to three Swin stages at 64 px, so the heatmap head upsamples
its final map and the first stage has a shifted block.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from molnextr_tpu.config import tiny_test_config as jax_tiny_config
from molnextr_tpu.models.heads import AtomHeatmapHead as JHeatmap
from molnextr_tpu.models.heads import heatmap_class_of as jax_heatmap_class_of
from molnextr_tpu.models.model import MolNexTRModel as JModel
from molnextr_tpu.train import losses as jlosses
from molnextr_tpu.train import wire as jwire
from molnextr_tpu.train.state import TrainState as JState
from molnextr_tpu.train.state import make_optimizer, make_schedules as jax_schedules
from molnextr_tpu.train.step import train_step_fn
from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.models import swin as port_swin
from molnextr_tpu_torch.models.heads import AtomHeatmapHead, HEATMAP_ELEMENTS, heatmap_class_of
from molnextr_tpu_torch.models.model import MolNexTRModel
from molnextr_tpu_torch.tokenization import get_tokenizer
from molnextr_tpu_torch.train import losses as plosses
from molnextr_tpu_torch.train import wire as pwire
from molnextr_tpu_torch.train.state import create_train_state, make_schedules
from molnextr_tpu_torch.train.step import eval_step, multi_train_step, train_step
from molnextr_tpu_torch.weights import (
    _flatten, flax_to_state_dict, load_flax_params, model_to_flax_params, seeded_flax_params,
    state_dict_to_flax,
)

torch.set_num_threads(2)

FMT = "chartok_coords"
B, T = 2, 14


def _jcfg(dropout=0.0, remat=False):
    c = jax_tiny_config()
    c.encoder = dataclasses.replace(c.encoder, depths=(2, 2, 2), num_heads=(2, 2, 2),
                                    drop_path_rate=dropout, use_remat=remat)
    c.decoder = dataclasses.replace(c.decoder, hidden_dropout=dropout, attn_dropout=dropout,
                                    use_remat=remat)
    c.data = dataclasses.replace(c.data, input_size=64)
    c.train = dataclasses.replace(c.train, max_grad_norm=5.0)
    return c


def _port_cfg(jcfg):
    return Config.from_dict(jcfg.to_dict())


def _vocab(cfg):
    return {f: len(t) for f, t in get_tokenizer(cfg.data).items()}


def _coord_vocab(cfg):
    tok = get_tokenizer(cfg.data)[FMT]
    return tok.offset, tok.maxx, tok.maxy, tok.sep_xy


def _batch(cfg, seed, vocab):
    rng = np.random.RandomState(seed)
    s, k = cfg.data.input_size, cfg.data.max_atoms
    labels = rng.randint(3, vocab[FMT], (B, T)).astype(np.int32)
    labels[:, 0] = 1
    labels[1, 10:] = 0
    labels[0, 5] = 4  # a MASK target
    idx = np.full((B, k), -1, np.int32)
    idx[:, :4] = [2, 5, 7, 9]
    edges = np.full((B, k, k), -100, np.int8)
    edges[:, :4, :4] = rng.randint(0, 7, (B, 4, 4))
    g = s // cfg.train.aux_heatmap_stride
    grid = rng.randint(-1, len(HEATMAP_ELEMENTS) + 1, (B, g, g)).astype(np.int8)
    grid[1, 0, 0] = -2
    return {"images": rng.randint(0, 256, (B, s, s, 1)).astype(np.uint8),
            "refs": {FMT: labels, "atom_indices": idx, "edges": edges, "atom_grid": grid}}


def _jax_batch(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _criteria(cfg):
    cv = _coord_vocab(cfg)
    return (jlosses.Criterion(cfg.data.formats, 0.1, cv, 1.0),
            plosses.Criterion(cfg.data.formats, 0.1, cv, 1.0))


@pytest.fixture(scope="module")
def setup():
    jcfg = _jcfg()
    cfg = _port_cfg(jcfg)
    vocab = _vocab(cfg)
    params = seeded_flax_params(cfg, vocab, 3)
    return jcfg, cfg, vocab, params


def _port_model(cfg, vocab, params):
    return load_flax_params(MolNexTRModel(cfg, vocab), params).train()


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_label_smoothing_ce_matches(smoothing, masked):
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 5, 11).astype(np.float32) * 3
    targets = rng.randint(0, 11, (3, 5))
    mask = rng.rand(3, 5) < 0.3 if masked else None
    want = jlosses.label_smoothing_ce(jnp.asarray(logits), jnp.asarray(targets), smoothing,
                                      None if mask is None else jnp.asarray(mask))
    got = plosses.label_smoothing_ce(torch.from_numpy(logits), torch.from_numpy(targets),
                                     smoothing, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)


def test_sequence_graph_and_heatmap_losses_match():
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 9, 30).astype(np.float32) * 2
    labels = rng.randint(0, 30, (2, 10))
    labels[0, 7:] = 0
    labels[1, 3] = 4
    np.testing.assert_allclose(
        plosses.sequence_loss(torch.from_numpy(logits), torch.from_numpy(labels)).item(),
        float(jlosses.sequence_loss(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6, atol=1e-6)
    e_logits = rng.randn(2, 7, 6, 6).astype(np.float32)
    e_t = rng.randint(0, 7, (2, 6, 6))
    e_t[:, 4:] = -100
    coords = rng.rand(2, 6, 2).astype(np.float32)
    c_t = rng.rand(2, 6, 2).astype(np.float32)
    c_t[1, 3:] = -1
    want = jlosses.graph_loss(jnp.asarray(e_logits), jnp.asarray(e_t), jnp.asarray(coords),
                              jnp.asarray(c_t))
    got = plosses.graph_loss(torch.from_numpy(e_logits), torch.from_numpy(e_t),
                             torch.from_numpy(coords), torch.from_numpy(c_t))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    h_logits = rng.randn(2, 5, 5, 13).astype(np.float32) * 2
    grid = rng.randint(-1, 12, (2, 5, 5))
    grid[1] = -2  # an unlabeled sample
    (wl, wr), (gl, gr) = (jlosses.heatmap_loss(jnp.asarray(h_logits), jnp.asarray(grid)),
                          plosses.heatmap_loss(torch.from_numpy(h_logits), torch.from_numpy(grid)))
    np.testing.assert_allclose([gl.item(), gr.item()], [float(wl), float(wr)], rtol=1e-6, atol=1e-6)


def test_criterion_matches_with_accuracies(setup):
    jcfg, cfg, vocab, params = setup
    rng = np.random.RandomState(2)
    batch = _batch(cfg, 4, vocab)
    refs = batch["refs"]
    k, g = cfg.data.max_atoms, cfg.data.input_size // 8
    outputs = {FMT: rng.randn(B, T - 1, vocab[FMT]).astype(np.float32),
               "edges": rng.randn(B, 7, k, k).astype(np.float32),
               "heatmap": rng.randn(B, g, g, 13).astype(np.float32)}
    jc, pc = _criteria(cfg)
    wt, wm = jc({n: jnp.asarray(v) for n, v in outputs.items()},
                jwire.as_model_refs({n: jnp.asarray(v) for n, v in refs.items()}))
    gt, gm = pc({n: torch.from_numpy(v) for n, v in outputs.items()},
                pwire.as_model_refs(refs, "cpu"))
    assert set(gm) == set(wm) and {"acc_x", "acc_y", "acc_edge", "acc_bond", "acc_heat"} <= set(gm)
    np.testing.assert_allclose(gt.item(), float(wt), rtol=1e-6, atol=1e-6)
    for name in wm:
        np.testing.assert_allclose(float(gm[name]), float(wm[name]), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# schedules and the two-group optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheduler", ["cosine", "constant"])
def test_schedules_match_optax(scheduler):
    jcfg = jax_tiny_config()
    jcfg.train = dataclasses.replace(jcfg.train, scheduler=scheduler, warmup_ratio=0.1,
                                     encoder_lr=4e-4, decoder_lr=1e-3)
    total = 37
    ports = make_schedules(_port_cfg(jcfg), total)
    for jsched, psched in zip(jax_schedules(jcfg, total), ports):
        for step in range(total + 3):
            np.testing.assert_allclose(psched(step), float(jsched(jnp.asarray(step))),
                                       rtol=0, atol=1e-7)


def _grads_tree(params, seed, enc_scale, dec_scale):
    rng = np.random.RandomState(seed)
    flat = _flatten(params)
    return {path: (rng.standard_normal(a.shape) * (enc_scale if "/encoder/" in path else dec_scale)
                   ).astype(np.float32) for path, a in flat.items()}


def _unflatten(flat):
    from molnextr_tpu_torch.weights import _unflatten as unf

    return unf(flat)


@pytest.mark.parametrize("accum", [1, 2])
def test_two_group_optimizer_matches_optax(setup, accum):
    """Both groups with their own schedules; the encoder's gradient norm is
    above max_grad_norm (clipped), the decoder's below.  accum 2 is
    optax.MultiSteps: the mean of two micro-steps, applied once."""
    jcfg, cfg, vocab, params = setup
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, grad_accum_steps=accum, weight_decay=0.01, encoder_lr=4e-4,
        decoder_lr=1e-3, warmup_ratio=0.2))
    cfg = _port_cfg(jcfg)
    total = 10
    tx = make_optimizer(jcfg, total)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)

    @jax.jit
    def update(g, s, p):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    state = create_train_state(cfg, MolNexTRModel(cfg, vocab), total, seed=3, device="cpu")
    named = dict(state.model.named_parameters())
    for step in range(3 * accum):
        grads = _grads_tree(params, 10 + step, enc_scale=0.2, dec_scale=1e-3)
        jp, opt_state = update(jax.tree_util.tree_map(jnp.asarray, _unflatten(grads)),
                               opt_state, jp)
        for name, g in flax_to_state_dict(_unflatten(grads)).items():
            named[name].grad = torch.from_numpy(np.ascontiguousarray(g))
        norms = state.optimizer.group_norms()
        assert norms["encoder"] > cfg.train.max_grad_norm > norms["decoder"]
        applied = state.optimizer.step()
        assert applied == ((step + 1) % accum == 0)
    assert state.optimizer.count == 3
    got = _flatten(model_to_flax_params(state.model))
    want = _flatten(jax.tree_util.tree_map(np.asarray, jp))
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=1e-6, err_msg=path)


# ---------------------------------------------------------------------------
# forward, gradients and the train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_reference(setup):
    """The JAX training forward (rates 0) and its gradients on one batch,
    from one jitted ``value_and_grad``."""
    jcfg, cfg, vocab, params = setup
    batch = _batch(cfg, 6, vocab)
    jm = JModel(jcfg, vocab)
    jc, _ = _criteria(cfg)

    def loss_fn(p):
        refs = jwire.as_model_refs(_jax_batch(batch["refs"]))
        out = jm.apply(p, jwire.as_model_images(jnp.asarray(batch["images"])), refs,
                       deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        return jc(out, refs)[0], out

    (_, outputs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return batch, to_np(outputs), _flatten(to_np(grads))


def test_training_forward_matches(setup, jax_reference):
    jcfg, cfg, vocab, params = setup
    batch, want, _ = jax_reference
    port = _port_model(cfg, vocab, params)
    with torch.no_grad():
        got = port(pwire.as_model_images(batch["images"], "cpu"),
                   pwire.as_model_refs(batch["refs"], "cpu"), dropout_seed=0)
    assert set(got) == set(want) == {FMT, "edges", "heatmap"}
    assert got["heatmap"].shape == (B, 8, 8, 13)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_gradients_match_jax_grad(setup, jax_reference):
    jcfg, cfg, vocab, params = setup
    batch, _, want = jax_reference
    _, pc = _criteria(cfg)
    port = _port_model(cfg, vocab, params)
    refs = pwire.as_model_refs(batch["refs"], "cpu")
    total, _ = pc(port(pwire.as_model_images(batch["images"], "cpu"), refs, dropout_seed=0), refs)
    total.backward()
    got = _flatten(state_dict_to_flax({n: p.grad.numpy() for n, p in port.named_parameters()}))
    assert set(got) == set(want)
    for path in want:
        scale = float(np.abs(want[path]).max())
        # the key projection's bias has no gradient (softmax ignores a shift
        # of every score in a row): both sides give rounding noise there
        floor = 1e-7 if path.endswith(("k/bias", "qkv/bias")) else 0.0
        err = float(np.abs(got[path] - want[path]).max())
        assert err <= 1e-4 * scale + floor, (path, err, scale)


def test_train_step_matches_train_step_fn(setup):
    """Two whole steps: forward, loss, backward, clip and both AdamW groups.
    The warmup makes the first update's rate 0, so the second update is
    the one that moves the parameters, by Adam's ``lr * g / (|g| + eps)``.
    Where the gradient is below ten times eps, that ratio turns the f32
    rounding of the gradient (about 1e-9 here) into up to 2 % of lr, so
    those elements are held to lr / 10 and every other one to 1e-6."""
    jcfg, cfg, vocab, params = setup
    batch = _batch(cfg, 7, vocab)
    jm = JModel(jcfg, vocab)
    jc, pc = _criteria(cfg)
    tx = make_optimizer(jcfg, 10)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JState(step=jnp.asarray(0, jnp.int32), params=jp, opt_state=tx.init(jp), tx=tx)
    jstep = jax.jit(train_step_fn(jm, jc))
    state = create_train_state(cfg, MolNexTRModel(cfg, vocab), 10, seed=3, device="cpu")
    for _ in range(2):
        jstate, jmetrics = jstep(jstate, _jax_batch(batch), jax.random.PRNGKey(0))
        metrics = train_step(cfg, pc, state, batch, seed=0)
        assert set(metrics) == set(jmetrics)
        for name in jmetrics:
            np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    assert state.step == int(jstate.step) == 2

    def loss_fn(p):  # the gradient of both updates (the first moved nothing)
        refs = jwire.as_model_refs(_jax_batch(batch["refs"]))
        out = jm.apply(p, jwire.as_model_images(jnp.asarray(batch["images"])), refs,
                       deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        return jc(out, refs)[0]

    grads = _flatten(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(jp)))
    lr = jcfg.train.encoder_lr
    assert jcfg.train.decoder_lr == lr
    start = _flatten(params)
    got = _flatten(model_to_flax_params(state.model))
    want = _flatten(jax.tree_util.tree_map(np.asarray, jstate.params))
    moved = max(float(np.abs(want[path] - start[path]).max()) for path in want)
    assert moved > 0.5 * lr, moved
    for path in want:
        tol = np.where(np.abs(grads[path]) >= 10 * 1e-8, 1e-6, lr / 10)
        err = np.abs(got[path] - want[path])
        assert (err <= tol).all(), (path, float(err.max()))


def test_dispatch_steps_average_single_steps(setup):
    """multi_train_step over K batches is K train steps, metrics averaged;
    the eval step leaves the model's mode as it was."""
    jcfg, cfg, vocab, params = setup
    _, pc = _criteria(cfg)
    batches = [_batch(cfg, 20 + i, vocab) for i in range(2)]
    a = create_train_state(cfg, MolNexTRModel(cfg, vocab), 10, seed=3, device="cpu")
    b = create_train_state(cfg, MolNexTRModel(cfg, vocab), 10, seed=3, device="cpu")
    singles = [train_step(cfg, pc, a, bt, seed=1) for bt in batches]
    multi = multi_train_step(cfg, pc, b, batches, seed=1)
    assert a.step == b.step == 2
    for name in multi:
        np.testing.assert_allclose(float(multi[name]),
                                   np.mean([float(s[name]) for s in singles]), rtol=1e-6)
    for (_, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p, q)
    ev = eval_step(cfg, pc, b.model, batches[0])
    assert b.model.training and np.isfinite(float(ev["loss"]))


# ---------------------------------------------------------------------------
# dropout, remat, and the Swin path choice
# ---------------------------------------------------------------------------


def _dropout_model(remat):
    jcfg = _jcfg(dropout=0.2, remat=remat)
    cfg = _port_cfg(jcfg)
    vocab = _vocab(cfg)
    return cfg, vocab, _port_model(cfg, vocab, seeded_flax_params(cfg, vocab, 4))


def _loss_and_grads(cfg, vocab, model, batch, seed):
    _, pc = _criteria(cfg)
    for p in model.parameters():
        p.grad = None
    refs = pwire.as_model_refs(batch["refs"], "cpu")
    total, _ = pc(model(pwire.as_model_images(batch["images"], "cpu"), refs, dropout_seed=seed),
                  refs)
    total.backward()
    return total.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_equals_no_remat_with_dropout():
    """torch.utils.checkpoint recomputes each block and layer in the backward
    pass; the seeded masks are redrawn the same, so the gradients match."""
    cfg, vocab, plain = _dropout_model(remat=False)
    cfg_r, _, remat = _dropout_model(remat=True)
    batch = _batch(cfg, 8, vocab)
    l0, g0 = _loss_and_grads(cfg, vocab, plain, batch, seed=11)
    l1, g1 = _loss_and_grads(cfg_r, vocab, remat, batch, seed=11)
    assert l0 == l1
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=1e-7, msg=name)


def test_dropout_reproducible_from_its_seed():
    cfg, vocab, model = _dropout_model(remat=False)
    batch = _batch(cfg, 9, vocab)
    images = pwire.as_model_images(batch["images"], "cpu")
    refs = pwire.as_model_refs(batch["refs"], "cpu")
    with torch.no_grad():
        a = model(images, refs, dropout_seed=1)[FMT]
        b = model(images, refs, dropout_seed=1)[FMT]
        c = model(images, refs, dropout_seed=2)[FMT]
        model.eval()
        d = model(images, refs)[FMT]
    assert torch.equal(a, b)
    assert not torch.allclose(a, c) and not torch.allclose(a, d)
    sites = [m.site for m in model.modules() if type(m).__name__ == "Dropout"]
    assert sorted(sites) == list(range(len(sites))) and len(sites) > 10
    model.train()
    with pytest.raises(ValueError, match="dropout_seed"):
        model(images, refs)


def test_train_mode_swin_never_calls_the_kernels(setup, monkeypatch):
    """The training forward and backward take the module path; eval mode
    takes K1 and K2 (here their plain versions, on CPU tensors)."""
    jcfg, cfg, vocab, params = setup
    calls = []

    def refuse(*args, **kwargs):
        raise AssertionError("a train-mode forward reached a fused kernel")

    monkeypatch.setattr(port_swin, "fused_window_attention", refuse)
    monkeypatch.setattr(port_swin, "fused_ln_mlp", refuse)
    model = _port_model(cfg, vocab, params)
    batch = _batch(cfg, 10, vocab)
    _loss_and_grads(cfg, vocab, model, batch, seed=0)
    assert all(p.grad is not None for p in model.encoder.parameters())
    from molnextr_tpu_torch.ops import swin_fused as sf

    monkeypatch.setattr(port_swin, "fused_window_attention",
                        lambda *a: calls.append("k1") or sf.fused_window_attention(*a))
    monkeypatch.setattr(port_swin, "fused_ln_mlp",
                        lambda *a: calls.append("k2") or sf.fused_ln_mlp(*a))
    model.eval()
    with torch.no_grad():
        model.encode(pwire.as_model_images(batch["images"], "cpu"))
    assert calls.count("k1") == calls.count("k2") == sum(cfg.encoder.depths)


# ---------------------------------------------------------------------------
# heatmap head and wires
# ---------------------------------------------------------------------------


def test_heatmap_head_and_class_of_match():
    """Fine 6 x 6 from a coarse 4 x 4: a ratio that is not an integer, where
    nearest-exact and plain nearest sample different cells."""
    rng = np.random.RandomState(12)
    fine = rng.randn(2, 6, 6, 24).astype(np.float32)
    coarse = rng.randn(2, 4, 4, 40).astype(np.float32)
    head = AtomHeatmapHead(24, 40)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1))
    jparams = {"params": {name: {leaf: getattr(getattr(head, name), leaf).detach().numpy()
                                 for leaf in ("kernel", "bias")}
                          for name in ("fine", "coarse", "out")}}
    want = JHeatmap().apply(jparams, jnp.asarray(fine), jnp.asarray(coarse))
    with torch.no_grad():
        got = head(torch.from_numpy(fine), torch.from_numpy(coarse))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    symbols = ["C", "c", "N", "[nH]", "O", "[O-]", "S", "F", "Cl", "Br", "[13C]", "I", "P",
               "B", "Si", "[Si]", "Na", "Fe", "Se", "Sn", "[Ac]", "R", "OMe", "*", "H", "cl"]
    assert [heatmap_class_of(s) for s in symbols] == [jax_heatmap_class_of(s) for s in symbols]


@pytest.mark.parametrize("channels", [1, 3])
def test_image_and_label_wires_match(channels):
    rng = np.random.RandomState(13 + channels)
    u8 = rng.randint(0, 256, (2, 16, 16, channels)).astype(np.uint8)
    np.testing.assert_allclose(pwire.as_model_images(u8, "cpu").numpy(),
                               np.asarray(jwire.as_model_images(jnp.asarray(u8))),
                               rtol=0, atol=1e-6)
    f32 = rng.randn(2, 16, 16, 3).astype(np.float32)
    np.testing.assert_array_equal(pwire.as_model_images(f32, "cpu").numpy(), f32)
    refs = {"edges": rng.randint(-100, 7, (2, 4, 4)).astype(np.int8),
            "atom_grid": rng.randint(-2, 12, (2, 3, 3)).astype(np.int8),
            FMT: rng.randint(0, 50, (2, 6)).astype(np.int32)}
    want = jwire.as_model_refs({k: jnp.asarray(v) for k, v in refs.items()})
    got = pwire.as_model_refs(refs, "cpu")
    for k in refs:
        assert got[k].dtype == torch.int64
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
