"""The port's beam search (CPU, float32) against the JAX package's, with the
same seeded parameters (``weights.seeded_flax_params``) and numpy inputs,
in both cache forms; and against a small synthetic model whose beams end
early, to hold the loop's exit, ``min_len`` and tie order.

Sequences must be identical; scores and hidden states agree within 1e-5
(both sides accumulate in float32, in another order).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molnextr_tpu.config import tiny_test_config as jax_tiny_config
from molnextr_tpu.decoding.beam import beam_decode as jax_beam
from molnextr_tpu.inference import InferenceEngine as JEngine
from molnextr_tpu.models.model import MolNexTRModel as JModel
from molnextr_tpu.tokenization import get_tokenizer as jax_tokenizer
from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.decoding.beam import beam_decode, select_top_k
from molnextr_tpu_torch.decoding.greedy import greedy_decode
from molnextr_tpu_torch.inference import InferenceEngine
from molnextr_tpu_torch.models.model import MolNexTRModel
from molnextr_tpu_torch.tokenization import EOS_ID, PAD_ID, get_tokenizer
from molnextr_tpu_torch.weights import load_flax_params, seeded_flax_params

torch.set_num_threads(2)

TOL = 1e-5
FMT = "chartok_coords"


def _pair(kv_int8, seed=0):
    """(jax config, jax model, params, port config, port model) sharing
    seeded weights."""
    jcfg = jax_tiny_config()
    jcfg.decoder = dataclasses.replace(jcfg.decoder, kv_int8=kv_int8)
    cfg = Config.from_dict(jcfg.to_dict())
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    params = seeded_flax_params(cfg, vocab, seed)
    port = load_flax_params(MolNexTRModel(cfg, vocab), params).eval()
    return jcfg, JModel(jcfg, vocab, dtype=jnp.float32), params, cfg, port


def _images(n, size, seed):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def _tables(cfg):
    tc, cm = get_tokenizer(cfg.data)[FMT].constraint_tables()
    return tc, cm


def _run_both(kv_int8, beam, seed, min_len=1, unroll=4):
    jcfg, jm, params, cfg, port = _pair(kv_int8, seed)
    tc, cm = _tables(cfg)
    imgs = _images(2, jcfg.data.input_size, seed + 1)
    max_len, d = jcfg.decoder.max_len, jcfg.decoder.hidden_size
    memory = jm.apply(params, jnp.asarray(imgs), method=JModel.encode)
    want = jax_beam(
        lambda t, p, c: jm.apply(params, FMT, t, p, c, method=JModel.decode_step),
        lambda m: jm.apply(params, FMT, m, method=JModel.init_cache),
        memory, jnp.asarray(tc), jnp.asarray(cm), max_len, d, beam_size=beam,
        min_len=min_len, return_all=True,
    )
    with torch.no_grad():
        got = beam_decode(
            lambda t, p, c: port.decode_step(FMT, t, p, c),
            lambda m: port.init_cache(FMT, m),
            port.encode(torch.from_numpy(imgs)), torch.as_tensor(tc).long(),
            torch.as_tensor(cm), max_len, d, beam_size=beam, min_len=min_len,
            return_all=True, unroll=unroll,
        )
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _assert_same(got, want):
    seq, avg, scores, hiddens, all_seq, all_scores = got
    np.testing.assert_array_equal(seq, want[0])
    np.testing.assert_array_equal(all_seq, want[4])
    for g, w in ((avg, want[1]), (scores, want[2]), (hiddens, want[3]), (all_scores, want[5])):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("beam", [2, 3])
def test_beam_decode_matches_jax(kv_int8, beam):
    got, want = _run_both(kv_int8, beam, seed=20 + beam)
    _assert_same(got, want)
    assert got[4].shape == (2, beam, 24)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_beam_min_len_matches_jax(kv_int8):
    got, want = _run_both(kv_int8, 3, seed=30, min_len=12)
    _assert_same(got, want)
    assert not (got[4][:, :, :12] == EOS_ID).any()


@pytest.mark.parametrize("kv_int8", [False, True])
def test_beam1_equals_greedy(kv_int8):
    jcfg, _, _, cfg, port = _pair(kv_int8, seed=40)
    tc, cm = _tables(cfg)
    step = lambda t, p, c: port.decode_step(FMT, t, p, c)  # noqa: E731
    init = lambda m: port.init_cache(FMT, m)  # noqa: E731
    args = (torch.as_tensor(tc).long(), torch.as_tensor(cm), jcfg.decoder.max_len,
            jcfg.decoder.hidden_size)
    with torch.no_grad():
        memory = port.encode(torch.from_numpy(_images(3, jcfg.data.input_size, 41)))
        g_seq = greedy_decode(step, init, memory, *args)[0]
        b_seq = beam_decode(step, init, memory, *args, beam_size=1)[0]
    np.testing.assert_array_equal(b_seq.numpy(), g_seq.numpy())


# ---------------------------------------------------------------------------
# a synthetic model: logits from a table of (token, history), EOS rising
# with the position, so beams end at different steps before max_len
# ---------------------------------------------------------------------------

V, T, D, M = 40, 32, 4, 3


def _synthetic(xp, seed=0):
    """step_fn and init_cache_fn over numpy (``xp = jnp``) or torch. The
    cache holds the tokens written so far (in place for torch) and a
    per-image memory leaf, so a wrong reorder changes the logits."""
    rng = np.random.RandomState(seed)
    table = rng.randn(V, V).astype(np.float32) * 2
    proj = rng.randn(V).astype(np.float32)
    eos = np.zeros(V, np.float32)
    eos[EOS_ID] = 1.0
    table, proj, eos = map(torch.from_numpy if xp is torch else jnp.asarray, (table, proj, eos))

    def init(mem):
        n = mem.shape[0]
        if xp is torch:
            return {"self_k": torch.zeros(1, n, T), "mem_k": mem[None, :, :, 0]}
        return {"self_k": jnp.zeros((1, n, T)), "mem_k": mem[None, :, :, 0]}

    def step(tokens, pos, cache):
        if xp is torch:
            cache["self_k"][0, :, pos] = tokens.float()
            hist = cache["self_k"][0]
        else:
            cache = dict(cache, self_k=cache["self_k"].at[0, :, pos].set(tokens.astype(jnp.float32)))
            hist = cache["self_k"][0]
        h = xp.sin(hist.sum(-1) * 0.37) + cache["mem_k"][0].mean(-1)
        logits = table[tokens] + h[:, None] * proj[None] + (pos - 4.0) * eos[None]
        hidden = xp.stack([h, h * h, tokens * 1.0, h - 1.0], -1)
        return logits, hidden, cache

    return step, init


def _synthetic_tables():
    tc = np.zeros(V, np.int32)
    tc[10:20] = 1  # after a class-1 token, class-1 tokens are penalised
    cm = np.zeros((2, V), bool)
    cm[1, 10:20] = True
    return tc, cm


def _synthetic_run(beam, min_len=1, unroll=1, seed=0):
    tc, cm = _synthetic_tables()
    memory = np.random.RandomState(seed + 1).randn(3, M, D).astype(np.float32)
    step, init = _synthetic(torch, seed)
    with torch.no_grad():
        out = beam_decode(step, init, torch.from_numpy(memory), torch.from_numpy(tc).long(),
                          torch.from_numpy(cm), T, D, beam_size=beam, min_len=min_len,
                          return_all=True, unroll=unroll)
    jstep, jinit = _synthetic(jnp, seed)
    want = jax_beam(jstep, jinit, jnp.asarray(memory), jnp.asarray(tc), jnp.asarray(cm), T, D,
                    beam_size=beam, min_len=min_len, return_all=True, phased=False)
    return [o.numpy() for o in out], [np.asarray(w) for w in want]


@pytest.mark.parametrize("beam", [2, 4])
def test_synthetic_model_matches_jax_and_exits_early(beam):
    got, want = _synthetic_run(beam)
    _assert_same(got, want)
    # every beam ended well before max_len, so the loop's exit was taken
    assert (got[4][:, :, T // 2:] == PAD_ID).all()
    assert (got[4] == EOS_ID).any(axis=2).all()


@pytest.mark.parametrize("unroll", [3, 4])
def test_unroll_does_not_change_outputs(unroll):
    one, _ = _synthetic_run(4, unroll=1, seed=2)
    many, _ = _synthetic_run(4, unroll=unroll, seed=2)
    for a, b in zip(one, many):
        np.testing.assert_array_equal(a, b)


def test_synthetic_min_len():
    got, want = _synthetic_run(3, min_len=9, seed=3)
    _assert_same(got, want)
    first_eos = (got[4] == EOS_ID).argmax(axis=2)
    assert (first_eos >= 9).all() and (got[4] == EOS_ID).any(axis=2).all()


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_select_top_k_tie_order_matches_lax(k):
    """Rows full of equal values, -1e9 fills and equal maxima: the indices
    come back in ``jax.lax.top_k``'s order."""
    rng = np.random.RandomState(k)
    flat = rng.randint(0, 3, size=(6, 40)).astype(np.float32)
    flat[1] = 0.0
    flat[2, 5:] = -1e9
    flat[3, ::2] = 2.0
    flat[4] = -1e9 + rng.randint(0, 2, size=40)  # rounds to a handful of values
    flat[5, :4] = 7.0
    want_v, want_i = jax.lax.top_k(jnp.asarray(flat), k)
    got_v, got_i = select_top_k(torch.from_numpy(flat), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------------------
# the engine: n-best list and edges against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_int8", [False, True])
def test_engine_n_best_and_edges_match_jax(kv_int8):
    jcfg, jm, params, cfg, port = _pair(kv_int8, seed=50)
    jcfg.decode = dataclasses.replace(jcfg.decode, beam_size=3, n_best=3)
    cfg.decode = dataclasses.replace(cfg.decode, beam_size=3, n_best=3)
    imgs = _images(3, jcfg.data.input_size, 51)  # padded to 4 by both engines
    want = JEngine(jcfg, jax_tokenizer(jcfg.data), jm, params).predict_images(
        imgs, compute_confidence=True)
    got = InferenceEngine(cfg, get_tokenizer(cfg.data), port, device="cpu").predict_images(
        imgs, compute_confidence=True)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g["beams"]) == 3
        assert [b["smiles"] for b in g["beams"]] == [b["smiles"] for b in w["beams"]]
        np.testing.assert_allclose([b["score"] for b in g["beams"]],
                                   [b["score"] for b in w["beams"]], rtol=TOL, atol=TOL)
        assert g["beams"][0]["smiles"] == g[FMT]["smiles"]
        assert g[FMT]["smiles"] == w[FMT]["smiles"]
        assert g["edges"] == w["edges"]
        np.testing.assert_allclose(g[FMT]["average_token_score"],
                                   w[FMT]["average_token_score"], rtol=TOL, atol=TOL)


def test_engine_beam_without_n_best_has_no_list():
    _, _, _, cfg, port = _pair(True, seed=60)
    cfg.decode = dataclasses.replace(copy.deepcopy(cfg.decode), beam_size=2, n_best=1)
    preds = InferenceEngine(cfg, get_tokenizer(cfg.data), port, device="cpu").predict_images(
        _images(2, cfg.data.input_size, 61))
    assert len(preds) == 2 and all("beams" not in p and "edges" in p for p in preds)


def test_demo_n_best_identical_to_jax_fixture():
    """The trained demo bundle at beam 4 in float32: the n-best lists that
    ``chip_smoke.py`` holds the card to, here on the CPU."""
    import json
    import os

    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.checkpoint import load_model
    from molnextr_tpu_torch.data.transforms import stack_gray_batch

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    with np.load(os.path.join(root, "molnextr_tpu_torch", "fixtures", "demo.npz")) as f:
        images, meta = list(f["images"]), json.loads(str(f["meta"]))
    cfg, params = load_model(os.path.join(root, "examples", "demo_model"))
    cfg.train.bf16 = False
    cfg.decode.beam_size = cfg.decode.n_best = 4
    model = MolNexTR(cfg=cfg, params=params, device="cpu", num_workers=1)
    preds = model.engine.predict_images(stack_gray_batch(images, model.transform))
    want = meta["jax_f32_beam4"]
    assert [[b["smiles"] for b in p["beams"]] for p in preds] == want["smiles"]
    # 1e-4: the int8 KV cache's rounding flips a step where a value lies on
    # a rounding boundary in one framework and not the other (the dense
    # cache agrees within 3e-7 here)
    np.testing.assert_allclose([[b["score"] for b in p["beams"]] for p in preds], want["scores"],
                               rtol=1e-4, atol=1e-4)
