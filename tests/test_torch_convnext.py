"""The port's ConvNeXt backbone and DANet heads (CPU, float32) against the
JAX package's flax modules, on the same seeded parameters and numpy inputs.

The model is the tiny test config with a small ConvNeXt: depths 1/1/2/1,
dims 16-128, 64 px.  ``weights.seeded_flax_params`` draws every ``gamma``
(and DAHead's ``alpha`` and ``beta``) from U(0.5, 1.5), so no block or
attention is the identity; a test checks that.

Tolerances: the encoder, its stage maps and DAHead 1e-5 of the largest
magnitude (float32 convolutions and matmuls, summed in another order);
the training forward 1e-5; gradients 1e-4 of each leaf's largest magnitude
(as ``tests/test_torch_train.py``); greedy tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molnextr_tpu import checkpoint as jckpt
from molnextr_tpu.config import Config as JConfig
from molnextr_tpu.config import tiny_test_config as jax_tiny_config
from molnextr_tpu.decoding.greedy import greedy_decode as jax_greedy
from molnextr_tpu.models import danet as jdanet
from molnextr_tpu.models.model import MolNexTRModel as JModel
from molnextr_tpu.train import losses as jlosses
from molnextr_tpu.train import wire as jwire
from molnextr_tpu_torch import checkpoint as pckpt
from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.decoding.greedy import greedy_decode
from molnextr_tpu_torch.models import danet
from molnextr_tpu_torch.models.convnext import ConvNeXtEncoder
from molnextr_tpu_torch.models.model import MolNexTRModel
from molnextr_tpu_torch.tokenization import get_tokenizer
from molnextr_tpu_torch.train import losses as plosses
from molnextr_tpu_torch.train import wire as pwire
from molnextr_tpu_torch.weights import (
    _flatten, load_flax_params, model_to_flax_params, param_shapes, seeded_flax_params,
    seeded_tree, state_dict_to_flax,
)

torch.set_num_threads(2)

FMT = "chartok_coords"
TOL = 1e-5


def _jcfg(heatmap: float = 0.0):
    c = jax_tiny_config()
    c.encoder = dataclasses.replace(c.encoder, name="convnext_tiny_test",
                                    convnext_depths=(1, 1, 2, 1),
                                    convnext_dims=(16, 32, 64, 128), drop_path_rate=0.0)
    # dropout rates 0: the two frameworks draw different masks
    c.decoder = dataclasses.replace(c.decoder, hidden_dropout=0.0, attn_dropout=0.0)
    c.data = dataclasses.replace(c.data, input_size=64)
    c.train = dataclasses.replace(c.train, aux_heatmap_weight=heatmap)
    return c


def _setup(heatmap: float = 0.0, seed: int = 3):
    jcfg = _jcfg(heatmap)
    cfg = Config.from_dict(jcfg.to_dict())
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    params = seeded_flax_params(cfg, vocab, seed)
    return jcfg, cfg, vocab, params


def _close(got, want, tol=TOL, msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, (msg, err, scale)


def _images(n, size, seed):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def test_param_shapes_equal_flax_init():
    jcfg, cfg, vocab, _ = _setup(heatmap=1.0)
    from molnextr_tpu.train.loop import _dummy_init_batch
    from molnextr_tpu.tokenization import get_tokenizer as jax_tokenizer

    jm = JModel(jcfg, vocab)
    batch = _dummy_init_batch(jcfg, jax_tokenizer(jcfg.data))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch["images"],
                                            batch["refs"], deterministic=True))
    want = {k: tuple(v.shape) for k, v in _flatten(
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)).items()}
    got = {f"params/{k}": v for k, v in param_shapes(cfg, vocab).items()}
    assert got == want
    gammas = [v for k, v in _flatten(seeded_flax_params(cfg, vocab, 0)).items()
              if k.endswith("gamma")]
    assert len(gammas) == 5 and all(0.5 <= g.min() and g.max() <= 1.5 for g in gammas)


def test_encoder_and_hiddens_match_flax():
    jcfg, cfg, vocab, params = _setup()
    jm = JModel(jcfg, vocab)
    imgs = _images(2, 64, seed=1)
    feats, hiddens = jm.apply(params, jnp.asarray(imgs), method=lambda m, x: m.encoder(x, True))
    port = load_flax_params(MolNexTRModel(cfg, vocab), params).eval()
    assert isinstance(port.encoder, ConvNeXtEncoder) and port.encoder.dims == [16, 32, 64, 128]
    with torch.no_grad():
        tfeats, thiddens = port.encoder(torch.from_numpy(imgs))
    assert tuple(tfeats.shape) == (2, 4, 128)
    _close(tfeats.numpy(), feats, msg="features")
    assert [tuple(h.shape) for h in thiddens] == [h.shape for h in hiddens]
    for i, (g, w) in enumerate(zip(thiddens, hiddens)):
        _close(g.numpy(), w, msg=f"stage {i}")
    # the blocks are no identity: zeroing gamma moves the output
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith("gamma"):
                p.zero_()
        still = port.encoder(torch.from_numpy(imgs))[0]
    assert float((still - tfeats).abs().max()) > 1e-2


def test_encode_matches_and_bf16_runs():
    jcfg, cfg, vocab, params = _setup()
    jm = JModel(jcfg, vocab)
    imgs = _images(2, 64, seed=2)
    want = jm.apply(params, jnp.asarray(imgs), method=JModel.encode)
    port = load_flax_params(MolNexTRModel(cfg, vocab), params).eval()
    with torch.no_grad():
        got = port.encode(torch.from_numpy(imgs))
        _close(got.numpy(), want, msg="memory")
        port.to_dtype(torch.bfloat16)
        assert port.encoder.stem.kernel.dtype == torch.bfloat16
        assert port.encoder.s0_b0.gamma.dtype == torch.bfloat16
        assert port.encoder.s0_b0.norm.scale.dtype == torch.float32
        low = port.encode(torch.from_numpy(imgs))
    assert low.dtype == torch.bfloat16 and bool(torch.isfinite(low.float()).all())
    _close(low.float().numpy(), want, tol=5e-2, msg="bf16 memory")


def test_greedy_tokens_identical_to_jax():
    jcfg, cfg, vocab, params = _setup(seed=9)
    jm = JModel(jcfg, vocab)
    port = load_flax_params(MolNexTRModel(cfg, vocab), params).eval()
    tok = get_tokenizer(cfg.data)[FMT]
    tc, cm = tok.constraint_tables()
    imgs = _images(3, 64, seed=10)
    max_len, d = jcfg.decoder.max_len, jcfg.decoder.hidden_size
    memory = jm.apply(params, jnp.asarray(imgs), method=JModel.encode)
    jseq, _, _, _ = jax_greedy(
        lambda t, p, c: jm.apply(params, FMT, t, p, c, method=JModel.decode_step),
        lambda m: jm.apply(params, FMT, m, method=JModel.init_cache),
        memory, jnp.asarray(tc), jnp.asarray(cm), max_len, d,
    )
    with torch.no_grad():
        tmem = port.encode(torch.from_numpy(imgs))
        seq, _, _, _ = greedy_decode(
            lambda t, p, c: port.decode_step(FMT, t, p, c),
            lambda m: port.init_cache(FMT, m), tmem,
            torch.as_tensor(tc).long(), torch.as_tensor(cm), max_len, d,
            use_constraint=bool(tok.output_constraint),
        )
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))


def _batch(cfg, vocab, seed, n=2, t=14):
    rng = np.random.RandomState(seed)
    s, k = cfg.data.input_size, cfg.data.max_atoms
    labels = rng.randint(3, vocab[FMT], (n, t)).astype(np.int32)
    labels[:, 0] = 1
    labels[1, 10:] = 0
    idx = np.full((n, k), -1, np.int32)
    idx[:, :4] = [2, 5, 7, 9]
    edges = np.full((n, k, k), -100, np.int8)
    edges[:, :4, :4] = rng.randint(0, 7, (n, 4, 4))
    g = s // cfg.train.aux_heatmap_stride
    grid = rng.randint(-1, 12, (n, g, g)).astype(np.int8)  # -1 empty, 0-11 classes
    return {"images": rng.randint(0, 256, (n, s, s, 1)).astype(np.uint8),
            "refs": {FMT: labels, "atom_indices": idx, "edges": edges, "atom_grid": grid}}


def test_teacher_forced_loss_and_gradients_match_jax_grad():
    """The training forward (heatmap head on, at dims[1] and dims[-1]), the
    loss and every parameter's gradient against ``jax.grad``."""
    jcfg, cfg, vocab, params = _setup(heatmap=1.0, seed=4)
    batch = _batch(cfg, vocab, 6)
    tok = get_tokenizer(cfg.data)[FMT]
    cv = (tok.offset, tok.maxx, tok.maxy, tok.sep_xy)
    jc = jlosses.Criterion(cfg.data.formats, 0.1, cv, 1.0)
    pc = plosses.Criterion(cfg.data.formats, 0.1, cv, 1.0)
    jm = JModel(jcfg, vocab)

    def loss_fn(p):
        refs = jwire.as_model_refs(jax.tree_util.tree_map(jnp.asarray, batch["refs"]))
        out = jm.apply(p, jwire.as_model_images(jnp.asarray(batch["images"])), refs,
                       deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        return jc(out, refs)[0], out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = load_flax_params(MolNexTRModel(cfg, vocab), params).train()
    refs = pwire.as_model_refs(batch["refs"], "cpu")
    out = port(pwire.as_model_images(batch["images"], "cpu"), refs, dropout_seed=0)
    assert set(out) == set(jout) == {FMT, "edges", "heatmap"}
    for name in jout:
        np.testing.assert_allclose(out[name].detach().numpy(), np.asarray(jout[name]),
                                   rtol=TOL, atol=TOL, err_msg=name)
    total, _ = pc(out, refs)
    np.testing.assert_allclose(total.item(), float(jloss), rtol=TOL)
    total.backward()
    got = _flatten(state_dict_to_flax({n: p.grad.numpy() for n, p in port.named_parameters()}))
    want = _flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(got) == set(want)
    for path in want:
        scale = float(np.abs(want[path]).max())
        floor = 1e-7 if path.endswith(("k/bias", "qkv/bias")) else 0.0
        err = float(np.abs(got[path] - want[path]).max())
        assert err <= 1e-4 * scale + floor, (path, err, scale)


def test_bundle_round_trip_with_the_jax_package(tmp_path):
    """A ConvNeXt bundle the port writes is the bytes the JAX package writes
    for the same parameters, and each package loads the other's."""
    jcfg, cfg, vocab, params = _setup(heatmap=1.0, seed=5)
    port = load_flax_params(MolNexTRModel(cfg, vocab), params)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    pckpt.save_model(port_dir, cfg, port)
    tree = model_to_flax_params(port)
    jckpt.save_model(jax_dir, JConfig.from_dict(cfg.to_dict()), tree)
    with open(f"{port_dir}/params.msgpack", "rb") as a, open(f"{jax_dir}/params.msgpack", "rb") as b:
        assert a.read() == b.read()
    jc, jparams = jckpt.load_model(port_dir)
    pc, pparams = pckpt.load_model(jax_dir)
    assert jc.encoder.name == pc.encoder.name == "convnext_tiny_test"
    want = _flatten(params)
    for got in (_flatten(jparams), _flatten(pparams), _flatten(tree)):
        assert set(got) == set(want)
        for path in want:
            np.testing.assert_array_equal(np.asarray(got[path]), want[path])
    again = load_flax_params(MolNexTRModel(pc, vocab), pparams)
    for (n, a), (_, b) in zip(port.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), n


def test_full_width_convnext_matches_the_fixture():
    """ConvNeXt-B at full width and depth (``chip_smoke.convnext_config()``)
    in float32 on the CPU against ``fixtures/convnext.npz``, the JAX
    numbers the card is held to: memory bank and 8 greedy steps within the
    fixture's tolerances, tokens equal."""
    import json
    import os
    import sys

    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    import chip_smoke

    from molnextr_tpu_torch.data.transforms import device_normalize

    with np.load(os.path.join(root, "molnextr_tpu_torch", "fixtures", "convnext.npz")) as f:
        ref = {k: f[k] for k in f.files}
    meta = json.loads(str(ref["meta"]))
    cfg = chip_smoke.convnext_config()
    cfg.train.bf16 = False
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    port = load_flax_params(MolNexTRModel(cfg, vocab),
                            seeded_flax_params(cfg, vocab, meta["seed"])).eval()
    tok = get_tokenizer(cfg.data)[FMT]
    tc, cm = tok.constraint_tables()
    logps = []

    def step(t, p, c):
        logits, hidden, c = port.decode_step(FMT, t, p, c)
        logps.append(torch.log_softmax(logits, dim=-1))
        return logits, hidden, c

    with torch.no_grad():
        memory = port.encode(device_normalize(torch.from_numpy(ref["images"])))
        assert float((memory - torch.from_numpy(ref["memory"])).abs().max()) <= meta["memory_tol"]
        seq, _, _, _ = greedy_decode(step, lambda m: port.init_cache(FMT, m), memory,
                                     torch.as_tensor(tc).long(), torch.as_tensor(cm),
                                     ref["tokens"].shape[1], cfg.decoder.hidden_size,
                                     use_constraint=bool(tok.output_constraint))
    np.testing.assert_array_equal(seq[:, :ref["tokens"].shape[1]].numpy(), ref["tokens"])
    logp = torch.stack(logps, 1).numpy()
    assert float(np.abs(logp - ref["logp"]).max()) <= meta["logp_tol"]


def _flax_dahead_pair(c, out, seed):
    """A flax DAHead, a seeded tree of its ``init`` shapes, an input."""
    x = np.random.RandomState(seed + 1).randn(2, 6, 5, c).astype(np.float32)
    jhead = jdanet.DAHead(out)
    init = jhead.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 5, c)))
    shapes = {k[len("params/"):]: tuple(v.shape)
              for k, v in _flatten(jax.tree_util.tree_map(np.asarray, init)).items()}
    return jhead, seeded_tree(shapes, seed), x


@pytest.mark.parametrize("c,out", [(32, 7), (64, 16)])
def test_dahead_matches_flax(c, out):
    jhead, params, x = _flax_dahead_pair(c, out, seed=c)
    want = jhead.apply(params, jnp.asarray(x), deterministic=True)
    head = load_flax_params(danet.DAHead(c, out), params).eval()
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 6, 5, out)
    _close(got.numpy(), want, msg="DAHead")
    flat = _flatten(params)
    assert 0.5 <= float(flat["params/pam/alpha"]) <= 1.5
    assert 0.5 <= float(flat["params/cam/beta"]) <= 1.5
    back = _flatten(model_to_flax_params(head))
    for path, v in flat.items():
        np.testing.assert_array_equal(back[path], v)


def test_position_and_channel_attention_match_flax():
    rng = np.random.RandomState(11)
    x = rng.randn(2, 7, 6, 24).astype(np.float32)
    pam = jdanet.PositionAttention(24)
    shapes = {f"conv_{n}/kernel": (1, 1, 24, q) for n, q in (("b", 3), ("c", 3), ("d", 24))}
    shapes.update({f"conv_{n}/bias": (q,) for n, q in (("b", 3), ("c", 3), ("d", 24))})
    shapes["alpha"] = ()
    params = seeded_tree(shapes, 12)
    want = pam.apply(params, jnp.asarray(x))
    port = load_flax_params(danet.PositionAttention(24), params)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)).numpy(), want, msg="PositionAttention")
    cparams = seeded_tree({"beta": ()}, 13)
    want = jdanet.ChannelAttention().apply(cparams, jnp.asarray(x))
    port = load_flax_params(danet.ChannelAttention(), cparams)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got.numpy(), want, msg="ChannelAttention")
    assert float((got - torch.from_numpy(x)).abs().max()) > 1e-2  # beta is not 0
