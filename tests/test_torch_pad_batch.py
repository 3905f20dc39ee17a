"""``InferenceEngine(..., pad_batch=False)`` against the JAX engine's: a
batch of 3 runs unpadded through the encoder, the decoder and the edge
head, float32 on the CPU, and gives the same tokens and edges."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molnextr_tpu.config import tiny_test_config as jax_tiny_config
from molnextr_tpu.inference import InferenceEngine as JEngine
from molnextr_tpu.models.model import MolNexTRModel as JModel
from molnextr_tpu.tokenization import get_tokenizer as jax_tokenizer
from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.inference import InferenceEngine
from molnextr_tpu_torch.models.model import MolNexTRModel
from molnextr_tpu_torch.tokenization import get_tokenizer
from molnextr_tpu_torch.weights import load_flax_params, seeded_flax_params

torch.set_num_threads(2)


def _engines(seed, beam=1, pad_batch=False):
    jcfg = jax_tiny_config()
    jcfg.decode = dataclasses.replace(jcfg.decode, beam_size=beam, n_best=1)
    cfg = Config.from_dict(jcfg.to_dict())
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    params = seeded_flax_params(cfg, vocab, seed)
    port = load_flax_params(MolNexTRModel(cfg, vocab), params).eval()
    jax_engine = JEngine(jcfg, jax_tokenizer(jcfg.data), JModel(jcfg, vocab, dtype=jnp.float32),
                         params, pad_batch=pad_batch)
    engine = InferenceEngine(cfg, get_tokenizer(cfg.data), port, device="cpu",
                             pad_batch=pad_batch)
    return jax_engine, engine, jcfg.data.input_size


def _images(n, size, seed):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def test_unpadded_batch_is_not_padded():
    _, engine, size = _engines(1)
    imgs = _images(3, size, 2)
    assert engine._pad_to_pow2(imgs) is imgs
    engine.pad_batch = True
    assert engine._pad_to_pow2(imgs).shape[0] == 4


@pytest.mark.parametrize("beam", [1, 2])
def test_predict_images_unpadded_matches_jax(beam):
    jax_engine, engine, size = _engines(10 + beam, beam)
    imgs = _images(3, size, 20 + beam)
    want = jax_engine.predict_images(imgs, compute_confidence=True)
    got = engine.predict_images(imgs, compute_confidence=True)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        fmt = engine.fmt
        assert g[fmt]["smiles"] == w[fmt]["smiles"]
        assert g[fmt]["indices"] == w[fmt]["indices"]
        assert g["edges"] == w["edges"]
        np.testing.assert_allclose(g[fmt]["average_token_score"], w[fmt]["average_token_score"],
                                   rtol=1e-5, atol=1e-5)


def test_predict_images_raw_unpadded_matches_jax():
    jax_engine, engine, size = _engines(30)
    imgs = _images(3, size, 31)
    want = jax_engine.predict_images_raw(imgs)
    got = engine.predict_images_raw(imgs)
    assert got["seq"].shape[0] == 3
    np.testing.assert_array_equal(got["seq"], want["seq"])
    np.testing.assert_array_equal(got["edges"], want["edges"])


def test_padded_and_unpadded_batches_agree():
    """The padding rows change nothing of the batch's own rows."""
    _, engine, size = _engines(40)
    imgs = _images(3, size, 41)
    unpadded = engine.predict_images_raw(imgs)
    engine.pad_batch = True
    padded = engine.predict_images_raw(imgs)
    np.testing.assert_array_equal(unpadded["seq"], padded["seq"])
    np.testing.assert_array_equal(unpadded["edges"], padded["edges"])
