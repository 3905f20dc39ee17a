"""The port's modules (CPU, float32) against the JAX package's, with the same
seeded parameters (``weights.seeded_flax_params``) and numpy inputs.

Tolerance 1e-4 for module stacks in float32: both sides accumulate in
float32, and the differences come from summation order and from the flax
module path's -1e9 shift mask where the port adds -100 as the fused path
does.  Token sequences must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molnextr_tpu.config import tiny_test_config as jax_tiny_config
from molnextr_tpu.decoding.greedy import greedy_decode as jax_greedy
from molnextr_tpu.models.heads import edge_prediction as jax_edge_prediction
from molnextr_tpu.models.heads import symmetrize_edge_probs as jax_symmetrize
from molnextr_tpu.models.model import MolNexTRModel as JModel
from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.decoding.greedy import greedy_decode
from molnextr_tpu_torch.models.heads import edge_prediction, symmetrize_edge_probs
from molnextr_tpu_torch.models.model import MolNexTRModel
from molnextr_tpu_torch.tokenization import get_tokenizer
from molnextr_tpu_torch.weights import load_flax_params, seeded_flax_params

torch.set_num_threads(2)

TOL = 1e-4
FMT = "chartok_coords"


def _pair(jcfg, seed=0):
    """(jax model, jax params, port model) sharing seeded weights."""
    cfg = Config.from_dict(jcfg.to_dict())
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    params = seeded_flax_params(cfg, vocab, seed)
    port = load_flax_params(MolNexTRModel(cfg, vocab), params).eval()
    return JModel(jcfg, vocab, dtype=jnp.float32), params, port


def _images(n, size, seed):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def test_decoder_teacher_forced_matches():
    jcfg = jax_tiny_config()
    jm, params, port = _pair(jcfg, seed=3)
    rng = np.random.RandomState(4)
    memory = rng.randn(2, 4, jcfg.decoder.hidden_size).astype(np.float32)
    tokens = rng.randint(4, 60, size=(2, 10)).astype(np.int32)
    tokens[:, 0] = 1
    pad = np.zeros((2, 10), bool)
    pad[1, 7:] = True

    def fwd(mdl, t, m, p):
        return mdl.decoders[FMT](t, m, p)

    want = jm.apply(params, jnp.asarray(tokens), jnp.asarray(memory), jnp.asarray(pad), method=fwd)
    with torch.no_grad():
        got = port.decoders[FMT](torch.from_numpy(tokens).long(), torch.from_numpy(memory),
                                 torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_decode_steps_match(kv_int8):
    """12 cached steps on forced tokens: logits and hidden states agree in
    both cache forms (the step-by-step check of test_kv_int8.py)."""
    jcfg = jax_tiny_config()
    jcfg.decoder = dataclasses.replace(jcfg.decoder, kv_int8=kv_int8)
    jm, params, port = _pair(jcfg, seed=5)
    rng = np.random.RandomState(6)
    memory = rng.randn(2, 4, jcfg.decoder.hidden_size).astype(np.float32)
    tokens = rng.randint(4, 60, size=(12, 2)).astype(np.int32)
    cache = jm.apply(params, FMT, jnp.asarray(memory), method=JModel.init_cache)
    jstep = jax.jit(lambda t, p, c: jm.apply(params, FMT, t, p, c, method=JModel.decode_step))
    with torch.no_grad():
        tcache = port.init_cache(FMT, torch.from_numpy(memory))
        assert set(tcache) == set(cache)
        for key in cache:
            assert tuple(tcache[key].shape) == cache[key].shape, key
        for step in range(12):
            logits, hidden, cache = jstep(jnp.asarray(tokens[step]), jnp.asarray(step), cache)
            tl, th, tcache = port.decode_step(FMT, torch.from_numpy(tokens[step]).long(), step, tcache)
            np.testing.assert_allclose(th.numpy(), np.asarray(hidden), rtol=TOL, atol=TOL)
            np.testing.assert_allclose(tl.numpy(), np.asarray(logits), rtol=TOL, atol=TOL)


def test_edge_head_and_symmetrize_match():
    jcfg = jax_tiny_config()
    jm, params, port = _pair(jcfg, seed=7)
    rng = np.random.RandomState(8)
    hid = rng.randn(2, 20, jcfg.decoder.hidden_size).astype(np.float32)
    idx = rng.randint(-1, 20, size=(2, jcfg.data.max_atoms)).astype(np.int32)
    want = jm.apply(params, jnp.asarray(hid), jnp.asarray(idx), method=JModel.predict_edges)
    with torch.no_grad():
        got = port.predict_edges(torch.from_numpy(hid), torch.from_numpy(idx).long())
    np.testing.assert_allclose(got["edges"].numpy(), np.asarray(want["edges"]), rtol=TOL, atol=TOL)
    prob = rng.rand(2, 6, 6, 7).astype(np.float32)
    np.testing.assert_array_equal(
        symmetrize_edge_probs(torch.from_numpy(prob)).numpy(),
        np.asarray(jax_symmetrize(jnp.asarray(prob))),
    )


def test_edge_prediction_matches():
    """Classes equal and probabilities within 1e-6 (f32) on seeded
    (B, K, K, 7) probabilities, ties included."""
    rng = np.random.RandomState(9)
    prob = rng.rand(3, 12, 12, 7).astype(np.float32)
    prob[0, :4, :4] = 0.5  # every class tied
    want_cls, want_p = jax_edge_prediction(jnp.asarray(prob))
    cls, p = edge_prediction(torch.from_numpy(prob))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(want_cls))
    np.testing.assert_allclose(p.numpy(), np.asarray(want_p), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kv_int8,min_len", [(True, 1), (False, 30)])
def test_greedy_decode_tokens_identical(kv_int8, min_len):
    jcfg = jax_tiny_config()
    jcfg.decoder = dataclasses.replace(jcfg.decoder, kv_int8=kv_int8)
    jm, params, port = _pair(jcfg, seed=9)
    tok = get_tokenizer(Config.from_dict(jcfg.to_dict()).data)[FMT]
    tc, cm = tok.constraint_tables()
    imgs = _images(3, jcfg.data.input_size, seed=10)
    max_len, d = jcfg.decoder.max_len, jcfg.decoder.hidden_size

    memory = jm.apply(params, jnp.asarray(imgs), method=JModel.encode)
    jseq, javg, jscores, _ = jax_greedy(
        lambda t, p, c: jm.apply(params, FMT, t, p, c, method=JModel.decode_step),
        lambda m: jm.apply(params, FMT, m, method=JModel.init_cache),
        memory, jnp.asarray(tc), jnp.asarray(cm), max_len, d, min_len=min_len, unroll=4,
    )
    with torch.no_grad():
        tmem = port.encode(torch.from_numpy(imgs))
        seq, avg, scores, _ = greedy_decode(
            lambda t, p, c: port.decode_step(FMT, t, p, c),
            lambda m: port.init_cache(FMT, m),
            tmem, torch.as_tensor(tc).long(), torch.as_tensor(cm), max_len, d,
            min_len=min_len, unroll=4,
        )
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(avg.numpy(), np.asarray(javg), rtol=TOL, atol=TOL)


def test_greedy_mask_labels_match():
    """MASK-label partial prediction: known tokens forced, MASK slots filled."""
    from molnextr_tpu_torch.tokenization import EOS_ID, MASK_ID, PAD_ID, SOS_ID

    jcfg = jax_tiny_config()
    jm, params, port = _pair(jcfg, seed=11)
    tok = get_tokenizer(Config.from_dict(jcfg.to_dict()).data)[FMT]
    tc, cm = tok.constraint_tables()
    imgs = _images(2, jcfg.data.input_size, seed=12)
    labels = np.full((2, 8), PAD_ID, np.int32)
    labels[:, :6] = [SOS_ID, MASK_ID, 40, MASK_ID, MASK_ID, EOS_ID]
    max_len, d = jcfg.decoder.max_len, jcfg.decoder.hidden_size
    memory = jm.apply(params, jnp.asarray(imgs), method=JModel.encode)
    jseq, _, _, _ = jax_greedy(
        lambda t, p, c: jm.apply(params, FMT, t, p, c, method=JModel.decode_step),
        lambda m: jm.apply(params, FMT, m, method=JModel.init_cache),
        memory, jnp.asarray(tc), jnp.asarray(cm), max_len, d, labels=jnp.asarray(labels),
    )
    with torch.no_grad():
        seq, _, _, _ = greedy_decode(
            lambda t, p, c: port.decode_step(FMT, t, p, c),
            lambda m: port.init_cache(FMT, m),
            port.encode(torch.from_numpy(imgs)), torch.as_tensor(tc).long(),
            torch.as_tensor(cm), max_len, d, labels=torch.from_numpy(labels),
        )
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    # output step s pairs with labels[:, s + 1]: step 1 is forced to 40,
    # step 4 to EOS, and the lanes stop there
    assert (seq[:, 1] == 40).all() and (seq[:, 4] == EOS_ID).all()
    assert (seq[:, 5:] == PAD_ID).all()


def test_greedy_sampling_uses_generator():
    """Temperature/top-k sampling draws from the given generator: the same
    seed gives the same tokens, and every pick is within the top k."""
    jcfg = jax_tiny_config()
    _, _, port = _pair(jcfg, seed=13)
    tok = get_tokenizer(Config.from_dict(jcfg.to_dict()).data)[FMT]
    tc, cm = tok.constraint_tables()
    mem = port.encode(torch.from_numpy(_images(2, jcfg.data.input_size, seed=14))).detach()

    def run(seed):
        with torch.no_grad():
            return greedy_decode(
                lambda t, p, c: port.decode_step(FMT, t, p, c),
                lambda m: port.init_cache(FMT, m),
                mem, torch.as_tensor(tc).long(), torch.as_tensor(cm),
                jcfg.decoder.max_len, jcfg.decoder.hidden_size,
                sampling_temp=1.0, keep_topk=3, generator=torch.Generator().manual_seed(seed),
            )[0]

    np.testing.assert_array_equal(run(0).numpy(), run(0).numpy())
    with pytest.raises(ValueError):
        greedy_decode(None, lambda m: {}, mem, None, None, 4, 4, sampling_temp=1.0, keep_topk=3)


def test_param_tree_covers_port_model():
    """Every port parameter comes from the flax tree, and the only flax
    leaves left over belong to the training-only heatmap head."""
    from molnextr_tpu_torch.weights import flax_to_state_dict

    cfg = Config.from_dict(jax_tiny_config().to_dict())
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    sd = flax_to_state_dict(seeded_flax_params(cfg, vocab, 0))
    names = {n for n, _ in MolNexTRModel(cfg, vocab).named_parameters()}
    assert names == set(sd)
    assert "heatmap_head" in seeded_flax_params(cfg, vocab, 0)["params"]
