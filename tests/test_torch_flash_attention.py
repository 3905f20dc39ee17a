"""The decoder's causal flash attention (``ops/flash_attention.py``: K7, K8,
K9 and their plain version) and its route in the decoder, on the CPU,
against the JAX package and JAX's library kernel.

* The plain forward and its log-sum-exp against the library's
  ``mha_reference_no_custom_vjp(..., causal=True, sm_scale=d ** -0.5)``,
  the plain backward against ``jax.vjp`` of that function (its
  ``mha_reference`` raises for ``sm_scale != 1`` in the backward), float32
  within 1e-5 of each array's largest magnitude, at head widths 32, 16,
  24, 64, 128, 256, 384 and 512; the wrappers' zero columns up to the
  kernels' width (``at_native_width``) equal to the unpadded plain version
  exactly.
* The route (at head widths 32, 16, 64, 256 and 384): with ``use_flash_attention``
  and the route's device condition monkeypatched (on the CPU the JAX package does not take its flash path
  either), the port's decoder against the JAX decoder's masked path on
  non-PAD rows and its causal-only path on every row; the port's
  ``train_step`` and ``eval_step`` against ``train_step_fn`` /
  ``eval_step_fn`` with every dropout rate 0 (PAD rows carry no loss, so
  losses and gradients agree).
* The route declines wherever the JAX package's ``MHA._can_flash`` does,
  shown by a spy on the dispatcher, and the kernels' wrappers refuse a head
  width or length they do not take (meta tensors): d above 128 but no
  multiple of 128 (as JAX's library kernel does), T not a multiple of 64,
  a grid past 2^31 - 1 blocks; every multiple of 128 is taken.

The kernels themselves run on the card only: ``tests/test_torch_cuda.py``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference_no_custom_vjp

from molnextr_tpu.config import DecoderConfig as JDecoderConfig
from molnextr_tpu.config import tiny_test_config as jax_tiny_config
from molnextr_tpu.models.model import MolNexTRModel as JModel
from molnextr_tpu.train import losses as jlosses
from molnextr_tpu.train.step import eval_step_fn, train_step_fn
from molnextr_tpu.train.state import TrainState as JState
from molnextr_tpu.train.state import make_optimizer
from molnextr_tpu_torch import ops
from molnextr_tpu_torch.config import Config, DecoderConfig
from molnextr_tpu_torch.models import decoder as dm
from molnextr_tpu_torch.models.heads import HEATMAP_ELEMENTS
from molnextr_tpu_torch.models.model import MolNexTRModel
from molnextr_tpu_torch.tokenization import get_tokenizer
from molnextr_tpu_torch.train import losses as plosses
from molnextr_tpu_torch.train.state import create_train_state
from molnextr_tpu_torch.train.step import eval_step, train_step
from molnextr_tpu_torch.weights import (
    _flatten, load_flax_params, seeded_flax_params, state_dict_to_flax,
)

torch.set_num_threads(2)
# the ops package exports the dispatcher under its module's name
fl = importlib.import_module("molnextr_tpu_torch.ops.flash_attention")

SCALE = 32 ** -0.5
REL = 1e-5  # float32, relative to the array's largest magnitude
FMT = "chartok_coords"
SHAPES = [(1, 1, 128), (2, 3, 128), (3, 8, 128), (1, 8, 256), (2, 2, 256), (3, 1, 256)]
# (b, h, t, d): SHAPES at the decoders' d 32 under their own ids, and two
# shapes at other widths JAX's library kernel takes: up to 128, and the
# multiples of 128 above (256 built, 384 and 512 streamed by the kernels)
WIDE_SHAPES = ([pytest.param(b, h, t, 32, id=f"{b}-{h}-{t}") for b, h, t in SHAPES]
               + [pytest.param(b, h, t, d, id=f"{b}-{h}-{t}-d{d}")
                  for d in (16, 24, 64, 128, 256, 384, 512)
                  for b, h, t in ((2, 3, 128), (1, 2, 256))])


def _qkv(b, h, t, seed, d=32):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, t, d).astype(np.float32) for _ in range(4)]  # q, k, v, cotangent


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _library(q, k, v, residuals=False):
    return mha_reference_no_custom_vjp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                       None, causal=True, sm_scale=q.shape[-1] ** -0.5,
                                       save_residuals=residuals)


# ---------------------------------------------------------------------------
# the plain version against the library's reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,t,d", WIDE_SHAPES)
def test_plain_forward_and_lse_match_library_reference(b, h, t, d):
    q, k, v, _ = _qkv(b, h, t, b * 100 + h * 10 + t + d - 32, d)
    scale = d ** -0.5
    out, lse = fl.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), scale)
    want, l, m = _library(q, k, v, residuals=True)
    _close(out.numpy(), want)
    _close(lse.numpy(), np.asarray(m) + np.log(np.asarray(l)))
    # the dispatcher on CPU tensors: the plain forward
    _close(ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                               sm_scale=scale).numpy(), want)


@pytest.mark.parametrize("b,h,t,d", WIDE_SHAPES)
def test_plain_backward_matches_jax_vjp(b, h, t, d):
    q, k, v, do = _qkv(b, h, t, b * 100 + h * 10 + t + 1 + d - 32, d)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda *a: _library(*a), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    # the library's formulas, written out
    o, lse = fl.flash_attention_reference(tq, tk, tv, scale)
    di = (o * tdo).sum(-1)
    dk, dv = fl.flash_attention_bwd_dkv_reference(tq, tk, tv, tdo, lse, di, scale)
    dq = fl.flash_attention_bwd_dq_reference(tq, tk, tv, tdo, lse, di, scale)
    for got, w in zip((dq, dk, dv), want):
        _close(got.numpy(), w)
    # the autograd function on CPU tensors
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    grads = torch.autograd.grad(ops.flash_attention(*leaves, sm_scale=scale), leaves, tdo)
    for got, w in zip(grads, want):
        _close(got.numpy(), w)


@pytest.mark.parametrize("b,h,t", [(2, 3, 128), (1, 8, 256)])
def test_plain_backward_equals_autograd_of_the_forward(b, h, t):
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(b, h, t, 7))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(fl.flash_attention_reference(*leaves, SCALE)[0], leaves, do)
    o, lse = fl.flash_attention_reference(q, k, v, SCALE)
    di = (o * do).sum(-1)
    got = (fl.flash_attention_bwd_dq_reference(q, k, v, do, lse, di, SCALE),
           *fl.flash_attention_bwd_dkv_reference(q, k, v, do, lse, di, SCALE))
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy())


def test_dispatcher_under_checkpoint_and_bf16_autocast():
    """Under ``torch.utils.checkpoint(use_reentrant=False)`` the gradients
    equal the plain call's; under bf16 autocast bf16 inputs give bf16
    outputs and gradients (the plain version computes in float32)."""
    from torch.utils.checkpoint import checkpoint

    q, k, v, do = (torch.from_numpy(x) for x in _qkv(2, 2, 128, 5))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ops.flash_attention(*leaves, sm_scale=SCALE), leaves, do)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = checkpoint(lambda *a: ops.flash_attention(*a, sm_scale=SCALE), *leaves,
                     use_reentrant=False)
    got = torch.autograd.grad(out, leaves, do)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    leaves = [x.bfloat16().requires_grad_() for x in (q, k, v)]
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = ops.flash_attention(*leaves, sm_scale=SCALE)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, leaves, do.bfloat16())
    assert all(g.dtype == torch.bfloat16 for g in grads)
    ref = fl.flash_attention_reference(*(x.float() for x in leaves), SCALE)[0]
    assert (out.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Meta tensors: no data, the shape checks alone.  Above 128 a head
    width that is no multiple of 128 is refused with JAX's library kernel's
    reason (129, 192, 255); every d up to 128 is taken, and every multiple
    of 128 above it (256, 384, 512, 1024, 2048), which runs at its own
    width: a width above 128 is never padded.  A grid of more than 2^31 - 1
    blocks (B H T / 64) is refused naming the limit."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, device="meta", dtype=dtype)

    lse = meta(1, 1, 128)  # and di
    library = "above 128 the head width must be a multiple of 128"
    for d in (129, 192, 255):
        with pytest.raises(ValueError, match=f"{library}, as JAX's library flash attention "
                                             f"requires, got {d}"):
            fl.flash_attention_fwd(*(meta(2, 2, 128, d),) * 3, SCALE)
        with pytest.raises(ValueError, match=f"{library}.*got {d}"):
            fl.flash_attention_bwd_dkv(*(meta(1, 1, 128, d),) * 4, lse, lse, SCALE)
        with pytest.raises(ValueError, match=f"{library}.*got {d}"):
            fl.flash_attention_bwd_dq(*(meta(1, 1, 128, d),) * 4, lse, lse, SCALE)
        with pytest.raises(ValueError, match=f"{library}.*got {d}"):
            fl.native_width(d)
    for d in (256, 384, 512, 1024, 2048):
        assert fl.native_width(d) == d
        fl._check("k7", *(meta(2, 2, 128, d),) * 3)
        fl._check("k8", *(meta(1, 1, 128, d),) * 4)
    with pytest.raises(ValueError, match=f"grid takes B H T / 64 up to {2 ** 31 - 1} blocks, "
                                         f"got {2 ** 25 * 33 * 2}"):
        fl.flash_attention_fwd(*(meta(2 ** 25, 33, 128, 512),) * 3, SCALE)
    with pytest.raises(ValueError, match="grid takes"):
        fl.flash_attention_bwd_dq(*(meta(2 ** 25, 33, 128, 32),) * 4, meta(2 ** 25, 33, 128),
                                  meta(2 ** 25, 33, 128), SCALE)
    with pytest.raises(ValueError, match="positive, got 0"):
        fl.flash_attention_fwd(*(meta(2, 2, 128, 0),) * 3, SCALE)
    with pytest.raises(ValueError, match="64-row tile"):
        fl.flash_attention_fwd(*(meta(2, 2, 96, 32),) * 3, SCALE)
    with pytest.raises(ValueError, match="64-row tile"):
        fl.flash_attention_bwd_dq(*(meta(2, 2, 32, 32),) * 4, meta(2, 2, 32), meta(2, 2, 32),
                                  SCALE)
    with pytest.raises(ValueError, match="64-row tile"):
        fl.flash_attention_fwd(*(meta(2, 2, 96, 256),) * 3, SCALE)
    assert [fl.native_width(d) for d in (1, 16, 32, 33, 48, 64, 65, 96, 128, 256, 384)] == [
        32, 32, 32, 64, 64, 64, 128, 128, 128, 256, 384]
    with pytest.raises(TypeError):
        fl.flash_attention_fwd(*(meta(2, 2, 128, 32, dtype=torch.float16),) * 3, SCALE)
    with pytest.raises(NotImplementedError):
        ops.flash_attention(*(torch.zeros(1, 1, 128, 32),) * 3, causal=False)


def test_operands_read_in_place_or_copied_as_the_kernels_need():
    """``_rows`` hands the kernels a (B, H, T, d) operand as it is where its
    tensor maps can read it (rows contiguous, the batch, head and row
    strides positive multiples of 16 bytes, the address 16-byte aligned),
    else a contiguous copy; ``_vec`` hands K8 lse and di contiguous and
    16-byte aligned, as its bulk copies read them."""
    qkv = torch.randn(2, 128, 3 * 8 * 32)
    q = qkv[..., :256].reshape(2, 128, 8, 32).transpose(1, 2)  # the decoder's head view
    assert fl._rows(q) is q
    for bad in (torch.randn(2, 8, 128, 33)[..., :32],  # 132-byte rows
                torch.randn(2, 1, 128, 32).expand(2, 8, 128, 32),  # head stride 0
                qkv.reshape(-1)[2:2 + 2 * 8 * 128 * 32].view(2, 8, 128, 32),  # 8 bytes off
                torch.randn(2, 8, 32, 128).transpose(-1, -2)):  # columns apart
        got = fl._rows(bad)
        assert got is not bad and got.is_contiguous() and got.data_ptr() % 16 == 0
        assert torch.equal(got, bad)
    lse = torch.randn(2, 8, 128)
    assert fl._vec("k", lse, q) is lse
    shifted = torch.randn(2 * 8 * 128 + 1)[1:].view(2, 8, 128)
    got = fl._vec("k", shifted, q)
    assert shifted.data_ptr() % 16 and got.data_ptr() % 16 == 0 and torch.equal(got, shifted)
    got = fl._vec("k", lse.transpose(0, 1).contiguous().transpose(0, 1), q)
    assert got.is_contiguous() and torch.equal(got, lse)


@pytest.mark.parametrize("d", [16, 24, 48])
def test_native_width_padding_is_exact(d):
    """A head width the kernels are not built for runs at the next one:
    ``at_native_width`` gives q, k, v (and do) zero columns and cuts the
    outputs back.  Through the plain versions in float32 that is the
    unpadded call exactly: o, lse, dk, dv and dq."""
    assert fl.native_width(d) > d
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(2, 3, 128, d, d))
    scale = d ** -0.5
    o, lse = fl.flash_attention_reference(q, k, v, scale)
    got = fl.at_native_width(fl.flash_attention_reference, (q, k, v), scale)
    assert got[0].shape == o.shape and torch.equal(got[0], o) and torch.equal(got[1], lse)
    di = (o * do).sum(-1)
    want = fl.flash_attention_bwd_dkv_reference(q, k, v, do, lse, di, scale)
    got = fl.at_native_width(fl.flash_attention_bwd_dkv_reference, (q, k, v, do), lse, di, scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    want = fl.flash_attention_bwd_dq_reference(q, k, v, do, lse, di, scale)
    got = fl.at_native_width(fl.flash_attention_bwd_dq_reference, (q, k, v, do), lse, di, scale)
    assert got.shape == want.shape and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the route in the decoder
# ---------------------------------------------------------------------------


@pytest.fixture
def spy(monkeypatch):
    """Counts the decoder's calls of the dispatcher."""
    calls = []
    real = dm.flash_attention

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(dm, "flash_attention", counted)
    return calls


@pytest.fixture
def on_card(monkeypatch):
    """The route's device condition held true for CPU tensors."""
    monkeypatch.setattr(dm, "flash_device", lambda x: True)


def _jcfg(layers=2, t=128, flash=True, dropout=0.0, hidden=64):
    c = jax_tiny_config()
    c.encoder = dataclasses.replace(c.encoder, drop_path_rate=dropout)
    c.decoder = JDecoderConfig(num_layers=layers, hidden_size=hidden, attn_heads=2, max_len=t,
                               hidden_dropout=dropout, attn_dropout=dropout, use_remat=True,
                               use_flash_attention=flash)
    return c


def _pair(jcfg, seed=0):
    cfg = Config.from_dict(jcfg.to_dict())
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    params = seeded_flax_params(cfg, vocab, seed)
    return cfg, vocab, params, JModel(jcfg, vocab, dtype=jnp.float32)


def _tokens(b, t, seed, pad_from=(None, 90, 40)):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(4, 60, size=(b, t)).astype(np.int32)
    tokens[:, 0] = 1
    for i, start in enumerate(pad_from[:b]):
        if start is not None:
            tokens[i, start:] = 0  # PAD only follows the sequence's end
    return tokens


# 2 heads of hidden 64 (d 32, the decoders' width), 32 (d 16, the tiny
# config's), 128 (d 64), 512 (d 256, the widest head the kernels are built
# for) and 768 (d 384, which they stream)
HIDDEN = [pytest.param(64, id="d32"), pytest.param(32, id="d16"), pytest.param(128, id="d64"),
          pytest.param(512, id="d256"), pytest.param(768, id="d384")]


@pytest.mark.parametrize("layers,hidden", [
    pytest.param(1, 64, id="1"), pytest.param(2, 64, id="2"),
    pytest.param(2, 32, id="2-d16"), pytest.param(2, 128, id="2-d64"),
    pytest.param(2, 512, id="2-d256"), pytest.param(2, 768, id="2-d384")])
def test_route_matches_jax_decoder(layers, hidden, spy, on_card):
    """Decoder.forward with the route taken: non-PAD rows equal the JAX
    decoder's (masked path, as it runs on the CPU); every row equals its
    causal-only path (no padding mask), which is what the route computes."""
    jcfg = _jcfg(layers, hidden=hidden)
    cfg, vocab, params, jm = _pair(jcfg, seed=layers)
    port = load_flax_params(MolNexTRModel(cfg, vocab), params).eval()
    tokens = _tokens(3, 128, layers)
    pad = tokens == 0
    memory = np.random.RandomState(9).randn(3, 4, hidden).astype(np.float32)

    def fwd(mdl, t, m, p):
        return mdl.decoders[FMT](t, m, p)

    masked = np.asarray(jm.apply(params, jnp.asarray(tokens), jnp.asarray(memory),
                                 jnp.asarray(pad), method=fwd))
    causal = np.asarray(jm.apply(params, jnp.asarray(tokens), jnp.asarray(memory), None,
                                 method=fwd))
    with torch.no_grad():
        got = port.decoders[FMT](torch.from_numpy(tokens).long(), torch.from_numpy(memory),
                                 torch.from_numpy(pad)).numpy()
    assert len(spy) == layers
    np.testing.assert_allclose(got[~pad], masked[~pad], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, causal, rtol=1e-4, atol=1e-4)
    assert np.abs(got[pad] - masked[pad]).max() > 1e-3  # PAD rows do differ


def _batch(cfg, vocab, seed):
    rng = np.random.RandomState(seed)
    s, k = cfg.data.input_size, cfg.data.max_atoms
    labels = _tokens(2, 128, seed, pad_from=(None, 70))
    labels[:, 1:] = np.where(labels[:, 1:] == 0, 0, rng.randint(3, vocab[FMT], (2, 127)))
    idx = np.full((2, k), -1, np.int32)
    idx[:, :4] = [2, 5, 7, 9]
    edges = np.full((2, k, k), -100, np.int8)
    edges[:, :4, :4] = rng.randint(0, 7, (2, 4, 4))
    g = s // cfg.train.aux_heatmap_stride
    grid = rng.randint(-1, len(HEATMAP_ELEMENTS) + 1, (2, g, g)).astype(np.int8)
    return {"images": rng.randint(0, 256, (2, s, s, 1)).astype(np.uint8),
            "refs": {FMT: labels, "atom_indices": idx, "edges": edges, "atom_grid": grid}}


def _criteria(cfg):
    tok = get_tokenizer(cfg.data)[FMT]
    cv = (tok.offset, tok.maxx, tok.maxy, tok.sep_xy)
    return (jlosses.Criterion(cfg.data.formats, 0.1, cv, 1.0),
            plosses.Criterion(cfg.data.formats, 0.1, cv, 1.0))


@pytest.mark.parametrize("hidden", HIDDEN)
def test_train_and_eval_steps_match_jax_steps(hidden, spy, on_card):
    """The port's train step (remat on, the route taken forward and in the
    recompute) and eval step against ``train_step_fn`` / ``eval_step_fn`` on
    the same converted weights, every dropout rate 0: loss within 1e-5,
    every gradient leaf within 1e-4 of its largest magnitude."""
    jcfg = _jcfg(hidden=hidden)
    cfg, vocab, params, jm = _pair(jcfg, seed=3)
    batch = _batch(cfg, vocab, 6)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jc, pc = _criteria(cfg)
    tx = make_optimizer(jcfg, 10)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JState(step=jnp.asarray(0, jnp.int32), params=jp, opt_state=tx.init(jp), tx=tx)
    _, jmetrics = jax.jit(train_step_fn(jm, jc))(jstate, jbatch, jax.random.PRNGKey(0))
    from molnextr_tpu.train import wire as jwire

    def loss_fn(p):
        refs = jwire.as_model_refs(jbatch["refs"])
        out = jm.apply(p, jwire.as_model_images(jbatch["images"]), refs, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jc(out, refs)[0]

    want = _flatten(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(jp)))
    state = create_train_state(cfg, MolNexTRModel(cfg, vocab), 10, seed=3, device="cpu")
    metrics = train_step(cfg, pc, state, batch, seed=0)
    assert len(spy) == 2 * cfg.decoder.num_layers  # the forward and the remat recompute
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    got = _flatten(state_dict_to_flax({n: p.grad.numpy()
                                       for n, p in state.model.named_parameters()}))
    assert set(got) == set(want)
    for path in want:
        scale = float(np.abs(want[path]).max())
        # the key projection's bias has no gradient (softmax ignores a shift
        # of every score in a row): both sides give rounding noise there
        floor = 1e-7 if path.endswith(("k/bias", "qkv/bias")) else 0.0
        err = float(np.abs(got[path] - want[path]).max())
        assert err <= 1e-4 * scale + floor, (path, err, scale)

    del spy[:]
    jeval = jax.jit(eval_step_fn(jm, jc))(params, jbatch)
    model = load_flax_params(MolNexTRModel(cfg, vocab), params)
    peval = eval_step(cfg, pc, model, batch)
    assert len(spy) == cfg.decoder.num_layers
    for name in jeval:
        np.testing.assert_allclose(float(peval[name]), float(jeval[name]), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _decoder(t=128, flash=True, attn_dropout=0.0):
    cfg = DecoderConfig(num_layers=2, hidden_size=64, attn_heads=2, max_len=max(t, 128),
                        hidden_dropout=0.0, attn_dropout=attn_dropout, use_flash_attention=flash)
    dec = dm.Decoder(cfg, 60)
    gen = torch.Generator().manual_seed(0)
    for p in dec.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.1
    return dec


def _run(dec, t=128, seed=None):
    tokens = torch.from_numpy(_tokens(2, t, 1, pad_from=(None, t - 20))).long()
    memory = torch.from_numpy(np.random.RandomState(2).randn(2, 4, 64).astype(np.float32))
    with torch.no_grad():
        return dec(tokens, memory, tokens == 0, dropout_seed=seed)


def test_route_taken_where_can_flash_accepts(spy, on_card):
    _run(_decoder().eval())
    _run(_decoder().train(), seed=5)  # training, attention dropout rate 0
    _run(_decoder(attn_dropout=0.1).eval())  # eval mode: dropout inactive
    _run(_decoder(t=256).eval(), t=256)
    assert len(spy) == 4 * 2
    # training with no dropout seed: the attention dropout is inactive (the
    # JAX package's "no dropout rng"); the port's other dropout sites refuse
    # such a forward, so the layer's condition is asked directly
    layer = _decoder(attn_dropout=0.1).train().layers[0]
    x = torch.zeros(2, 128, 64)
    assert layer.can_flash(x, None) and not layer.can_flash(x, 5)


@pytest.mark.parametrize("case", ["flag_off", "attn_dropout", "t480", "t64", "no_flash_env"])
def test_route_declines_where_can_flash_does(case, spy, on_card, monkeypatch):
    if case == "flag_off":
        _run(_decoder(flash=False).eval())
    elif case == "attn_dropout":
        _run(_decoder(attn_dropout=0.1).train(), seed=5)
    elif case == "t480":  # Config()'s max_len
        _run(_decoder(t=480).eval(), t=480)
    elif case == "t64":
        _run(_decoder(t=64).eval(), t=64)
    else:
        monkeypatch.setenv("MOLNEXTR_NO_FLASH", "1")
        _run(_decoder().eval())
    assert spy == []


def test_route_declines_a_cpu_tensor(spy):
    """Without the monkeypatch a CPU tensor never takes the route, as the
    JAX package on the CPU never takes its flash path."""
    out = _run(_decoder().eval())
    assert spy == []
    assert torch.isfinite(out).all()
