"""The port's reader of the reference ``.pth`` checkpoint against the JAX
package's (``molnextr_tpu/convert.py``), on a synthetic checkpoint with the
reference's names, saved by ``torch.save`` with its ``args`` as an
``argparse.Namespace``; the refusal of any other pickled global; and the
singleton's checkpoint cache.  No test touches the network.
"""

import argparse
import os

import numpy as np
import pytest
import torch

from molnextr_tpu.api import MolNexTR as JMolNexTR
from molnextr_tpu.config import tiny_test_config as jax_tiny_config
from molnextr_tpu.convert import load_torch_checkpoint as jax_load_torch_checkpoint
from molnextr_tpu_torch import api
from molnextr_tpu_torch.config import Config, tiny_test_config
from molnextr_tpu_torch.convert import load_torch_checkpoint
from molnextr_tpu_torch.data.transforms import stack_gray_batch
from molnextr_tpu_torch.tokenization import get_tokenizer

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(ROOT, "molnextr_tpu_torch", "fixtures")
FMT = "chartok_coords"


def synthetic_reference_ckpt(cfg, vocab_size):
    """Random tensors under the exact names the reference saves (timm Swin
    + ONMT decoder naming); a copy of ``tests/test_convert.py``'s."""
    rng = np.random.RandomState(0)

    def t(*shape):
        return rng.randn(*shape).astype(np.float32)

    enc = {}
    ed = cfg.encoder.embed_dim
    ps = cfg.encoder.patch_size
    enc["transformer.patch_embed.proj.weight"] = t(ed, 3, ps, ps)
    enc["transformer.patch_embed.proj.bias"] = t(ed)
    enc["transformer.patch_embed.norm.weight"] = t(ed)
    enc["transformer.patch_embed.norm.bias"] = t(ed)
    w = cfg.encoder.window_size
    for s, depth in enumerate(cfg.encoder.depths):
        dim = ed * 2 ** s
        h = cfg.encoder.num_heads[s]
        for j in range(depth):
            bp = f"transformer.layers.{s}.blocks.{j}."
            for ln in ("norm1", "norm2"):
                enc[bp + ln + ".weight"] = t(dim)
                enc[bp + ln + ".bias"] = t(dim)
            enc[bp + "attn.qkv.weight"] = t(3 * dim, dim)
            enc[bp + "attn.qkv.bias"] = t(3 * dim)
            enc[bp + "attn.proj.weight"] = t(dim, dim)
            enc[bp + "attn.proj.bias"] = t(dim)
            enc[bp + "attn.relative_position_bias_table"] = t((2 * w - 1) ** 2, h)
            enc[bp + "mlp.fc1.weight"] = t(4 * dim, dim)
            enc[bp + "mlp.fc1.bias"] = t(4 * dim)
            enc[bp + "mlp.fc2.weight"] = t(dim, 4 * dim)
            enc[bp + "mlp.fc2.bias"] = t(dim)
        if s < len(cfg.encoder.depths) - 1:
            dp = f"transformer.layers.{s}.downsample."
            enc[dp + "norm.weight"] = t(4 * dim)
            enc[dp + "norm.bias"] = t(4 * dim)
            enc[dp + "reduction.weight"] = t(2 * dim, 4 * dim)
    nf = cfg.encoder.num_features
    enc["transformer.norm.weight"] = t(nf)
    enc["transformer.norm.bias"] = t(nf)

    dec = {}
    D = cfg.decoder.hidden_size
    fmt = "chartok_coords"
    dec[f"decoder.{fmt}.enc_trans_layer.0.weight"] = t(D, nf)
    dec[f"decoder.{fmt}.enc_trans_layer.0.bias"] = t(D)
    dec[f"decoder.{fmt}.output_layer.weight"] = t(vocab_size, D)
    dec[f"decoder.{fmt}.output_layer.bias"] = t(vocab_size)
    dec[f"decoder.{fmt}.embeddings.make_embedding.emb_luts.0.weight"] = t(vocab_size, D)
    for i in range(cfg.decoder.num_layers):
        lp = f"decoder.{fmt}.decoder.transformer_layers.{i}."
        for ln in ("layer_norm_1", "layer_norm_2", "feed_forward.layer_norm"):
            dec[lp + ln + ".weight"] = t(D)
            dec[lp + ln + ".bias"] = t(D)
        for attn in ("self_attn", "context_attn"):
            for lin in ("linear_query", "linear_keys", "linear_values", "final_linear"):
                dec[f"{lp}{attn}.{lin}.weight"] = t(D, D)
                dec[f"{lp}{attn}.{lin}.bias"] = t(D)
        dec[lp + "feed_forward.w_1.weight"] = t(4 * D, D)
        dec[lp + "feed_forward.w_1.bias"] = t(4 * D)
        dec[lp + "feed_forward.w_2.weight"] = t(D, 4 * D)
        dec[lp + "feed_forward.w_2.bias"] = t(D)
    dec["decoder.{}.decoder.layer_norm.weight".format(fmt)] = t(D)
    dec["decoder.{}.decoder.layer_norm.bias".format(fmt)] = t(D)
    dec["decoder.edges.mlp.0.weight"] = t(D, 2 * D)
    dec["decoder.edges.mlp.0.bias"] = t(D)
    dec["decoder.edges.mlp.2.weight"] = t(7, D)
    dec["decoder.edges.mlp.2.bias"] = t(7)
    return {"encoder": enc, "decoder": dec}


ARGS = {"formats": f"{FMT},edges", "input_size": 32, "coord_bins": 8, "sep_xy": True}


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """The synthetic checkpoint as the reference writes it: torch tensors,
    the encoder under DDP's 'module.' prefix, args as a Namespace."""
    cfg = tiny_test_config()
    ckpt = synthetic_reference_ckpt(cfg, len(get_tokenizer(cfg.data)[FMT]))
    path = str(tmp_path_factory.mktemp("pth") / "ref.pth")
    torch.save({
        "encoder": {"module." + k: torch.from_numpy(v) for k, v in ckpt["encoder"].items()},
        "decoder": {k: torch.from_numpy(v) for k, v in ckpt["decoder"].items()},
        "args": argparse.Namespace(**ARGS),
    }, path)
    return path


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_tree_and_config_identical_to_jax(pth):
    jcfg, cfg = jax_tiny_config(), tiny_test_config()
    for c in (jcfg, cfg):  # values the checkpoint's args restore
        c.data.formats, c.data.input_size, c.data.coord_bins, c.data.sep_xy = (FMT,), 64, 4, False
    jcfg, jtree = jax_load_torch_checkpoint(pth, jcfg)
    cfg, tree = load_torch_checkpoint(pth, cfg)
    for c in (jcfg, cfg):
        assert (c.data.formats, c.data.input_size, c.data.coord_bins, c.data.sep_xy) == (
            (FMT, "edges"), 32, 8, True)
    want = {k: v for k, v in _flatten(jtree).items() if not k.startswith("params/heatmap_head/")}
    got = _flatten(tree)
    assert len(want) < len(_flatten(jtree)) and set(got) == set(want)
    for key, leaf in want.items():
        assert got[key].dtype == np.asarray(leaf).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(leaf), err_msg=key)


def test_model_from_pth_predicts_like_jax(pth):
    """``MolNexTR(model_path=<pth>)`` in both packages, float32: the same
    token sequences and SMILES on the demo renders."""
    with np.load(os.path.join(FIXTURES, "demo.npz")) as f:
        images = list(f["images"])
    jax_model = JMolNexTR(model_path=pth, cfg=jax_tiny_config(), num_workers=1)
    model = api.MolNexTR(model_path=pth, cfg=tiny_test_config(), device="cpu", num_workers=1)
    assert model.cfg.data.formats == (FMT, "edges") and not model.cfg.train.bf16
    jbatch = np.stack([jax_model.transform(image=im)["image"][..., :1] for im in images])
    want = jax_model.engine.predict_images_raw(jbatch)["seq"]
    batch = stack_gray_batch(images, model.transform)
    got = model.engine.decode(model.engine._pad_to_pow2(batch))[0][: len(images)]
    np.testing.assert_array_equal(got.numpy(), want)
    smiles = [p["predicted_smiles"] for p in model.predict_images(images, batch_size=8)]
    assert smiles == [p["predicted_smiles"] for p in jax_model.predict_images(images, batch_size=8)]


class NotAllowed:
    """A global that no reference checkpoint holds."""


def test_pth_with_other_global_is_refused(tmp_path):
    path = str(tmp_path / "bad.pth")
    torch.save({"encoder": {}, "decoder": {}, "args": argparse.Namespace(**ARGS),
                "extra": NotAllowed()}, path)
    with pytest.raises(ValueError, match="refused"):
        load_torch_checkpoint(path, tiny_test_config())
    with pytest.raises(ValueError, match="refused"):
        api.MolNexTR(model_path=path, cfg=tiny_test_config(), device="cpu")


class _Recorder:
    """Stands in for MolNexTR in the singleton: records how it was built."""

    calls = []

    def __init__(self, model_path=None, cfg=None, device="cuda"):
        self.calls.append({"model_path": model_path, "cfg": cfg})
        self.device = torch.device(device)


def test_singleton_uses_cached_checkpoint(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(api, "MolNexTR", _Recorder)
    monkeypatch.delenv("MOLNEXTR_MODEL_PATH", raising=False)
    monkeypatch.setenv("MOLNEXTR_CACHE", str(tmp_path))
    cached = tmp_path / "molnextr_best.pth"
    cached.write_bytes(b"")
    _Recorder.calls.clear()
    api.MolNexTRSingleton.reset()
    try:
        api.MolNexTRSingleton.get_instance(device="cpu")
        assert _Recorder.calls[-1]["model_path"] == str(cached)
        api.MolNexTRSingleton.reset()
        cached.unlink()
        with caplog.at_level("WARNING", logger="molnextr_tpu_torch"):
            api.MolNexTRSingleton.get_instance(device="cpu")
    finally:
        api.MolNexTRSingleton.reset()
    last = _Recorder.calls[-1]
    assert last["model_path"] is None and isinstance(last["cfg"], Config)
    assert str(cached) in caplog.text
    assert api.MolNexTRSingleton.get_device() == "CPU"


def test_cache_dir_default_and_override(tmp_path, monkeypatch):
    monkeypatch.delenv("MOLNEXTR_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert api.MolNexTRSingleton.cache_dir() == os.path.join(str(tmp_path), ".data", "molnextr")
    monkeypatch.setenv("MOLNEXTR_CACHE", str(tmp_path / "c"))
    assert api.MolNexTRSingleton.cache_dir() == str(tmp_path / "c")

