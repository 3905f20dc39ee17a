"""The port's Swin encoder (CPU, float32) against the JAX package's, on the
flax module path and on the fused Pallas path in interpret mode, with the
same seeded parameters and numpy images.

Tolerance 1e-4: both sides accumulate in float32; the module path masks
shifted windows with -1e9 where the port adds -100, as the fused path does.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molnextr_tpu.config import Config as JConfig
from molnextr_tpu.config import tiny_test_config as jax_tiny_config
from molnextr_tpu.models.model import MolNexTRModel as JModel
from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.models.model import MolNexTRModel
from molnextr_tpu_torch.tokenization import get_tokenizer
from molnextr_tpu_torch.weights import load_flax_params, seeded_flax_params

torch.set_num_threads(2)

TOL = 1e-4
DEMO_CONFIG = os.path.join(os.path.dirname(__file__), "..", "examples", "demo_model", "config.json")


def _pair(jcfg, seed=0):
    cfg = Config.from_dict(jcfg.to_dict())
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    params = seeded_flax_params(cfg, vocab, seed)
    port = load_flax_params(MolNexTRModel(cfg, vocab), params).eval()
    return JModel(jcfg, vocab, dtype=jnp.float32), params, port


def _demo_jcfg():
    with open(DEMO_CONFIG) as f:
        return JConfig.from_json(f.read())


@pytest.mark.parametrize("which", ["tiny", "demo"])
def test_encoder_matches_module_and_fused_paths(which, monkeypatch):
    """tiny: stage 1 has ws >= res, so its shift is clamped to 0."""
    jcfg = jax_tiny_config() if which == "tiny" else _demo_jcfg()
    jm, params, port = _pair(jcfg, seed=1)
    imgs = np.random.RandomState(2).randn(2, jcfg.data.input_size, jcfg.data.input_size, 3)
    imgs = imgs.astype(np.float32)
    with torch.no_grad():
        got = port.encode(torch.from_numpy(imgs)).numpy()
    want = jm.apply(params, jnp.asarray(imgs), method=JModel.encode)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    monkeypatch.setenv("MOLNEXTR_FUSED_INTERPRET", "1")
    want_fused = jm.apply(params, jnp.asarray(imgs), method=JModel.encode)
    np.testing.assert_allclose(got, np.asarray(want_fused), rtol=TOL, atol=TOL)
