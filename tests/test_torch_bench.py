"""The port's bench scripts against the JAX package on the CPU.

``bench_torch.run`` against ``bench.py``'s ``infer`` composed from the JAX
package (encode, ``greedy_decode(min_len=max_len, phased=True)``,
``predict_edges`` on every atom slot), in both cache forms; the engine
decodes of ``scripts/bench_decode_torch.py`` against the JAX engine's
``_decode_jit`` at unrolls 1, 2 and 4.  Same seeded params (``weights.py``)
and numpy-seeded float32 inputs, ``tiny_test_config()`` widths at a decode
length of 160, so that the JAX decode's phased cache growth (128, then 256)
runs against the port's one buffer.  Tolerances: tokens equal, ``avg``
within 1e-5, edge logits within 1e-4.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molnextr_tpu.config import tiny_test_config as jax_tiny_config
from molnextr_tpu.decoding.greedy import greedy_decode as jax_greedy_decode
from molnextr_tpu.inference import InferenceEngine as JEngine
from molnextr_tpu.models.model import MolNexTRModel as JModel
from molnextr_tpu.tokenization import get_tokenizer as jax_tokenizer
from molnextr_tpu_torch import config as torch_config
from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.tokenization import get_tokenizer
from molnextr_tpu_torch.weights import seeded_flax_params

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import bench_torch  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "bench_decode_torch", os.path.join(ROOT, "scripts", "bench_decode_torch.py"))
bench_decode_torch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench_decode_torch)

DECODE_LEN, BATCH = 160, 2


def _jax_config(kv_int8=True, unroll=4):
    jcfg = jax_tiny_config()
    jcfg.decoder = dataclasses.replace(jcfg.decoder, max_len=DECODE_LEN, kv_int8=kv_int8)
    jcfg.decode = dataclasses.replace(jcfg.decode, unroll=unroll)
    return jcfg


def _params(cfg):
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    return vocab, seeded_flax_params(cfg, vocab, 0)  # what bench_torch.build_engine loads


def _images(seed, size):
    return np.random.RandomState(seed).randn(BATCH, size, size, 3).astype(np.float32)


def _jax_infer(jcfg, images):
    """``bench.py``'s ``infer`` on the seeded params."""
    cfg = Config.from_dict(jcfg.to_dict())
    vocab, params = _params(cfg)
    model = JModel(jcfg, vocab, dtype=jnp.float32)
    fmt = "chartok_coords"
    tc, cm = jax_tokenizer(jcfg.data)[fmt].constraint_tables()
    memory = model.apply(params, jnp.asarray(images), method=JModel.encode)
    seq, avg, _, hiddens = jax_greedy_decode(
        lambda t, p, c: model.apply(params, fmt, t, p, c, method=JModel.decode_step),
        lambda m: model.apply(params, fmt, m, method=JModel.init_cache),
        memory, jnp.asarray(tc), jnp.asarray(cm), jcfg.decoder.max_len,
        jcfg.decoder.hidden_size, min_len=jcfg.decoder.max_len, phased=True,
    )
    k = jcfg.data.max_atoms
    indices = jnp.tile(jnp.arange(k, dtype=jnp.int32)[None], (images.shape[0], 1))
    edges = model.apply(params, hiddens, indices, method=JModel.predict_edges)["edges"]
    return np.asarray(seq), np.asarray(avg), np.asarray(edges)


@pytest.mark.parametrize("kv_int8", [True, False])
def test_run_matches_jax_bench_infer(kv_int8, monkeypatch):
    jcfg = _jax_config(kv_int8)
    cfg = Config.from_dict(jax_tiny_config().to_dict())
    size = cfg.data.input_size
    drawn = []

    def draw(seed):
        drawn.append(seed)
        return torch.from_numpy(_images(seed, size))

    decodes = []
    engine_decode = bench_torch.InferenceEngine.decode

    def decode(self, images, min_len=None):
        decodes.append(min_len)
        return engine_decode(self, images, min_len=min_len)

    monkeypatch.setattr(bench_torch.InferenceEngine, "decode", decode)
    res = bench_torch.run(cfg, batch=BATCH, iters=2, decode_len=DECODE_LEN, kv_int8=kv_int8,
                          device="cpu", dtype=torch.float32, draw=draw)
    assert drawn == [0, 1, 2]  # a warm-up, then distinct inputs each timed run
    assert decodes == [DECODE_LEN] * 3  # the serving engine's decode, forced to full length
    assert cfg.decoder.max_len == jax_tiny_config().decoder.max_len  # the caller's cfg untouched
    assert res["kv_cache"] == ("int8" if kv_int8 else "dense")
    assert res["decode_steps"] == DECODE_LEN and res["batch"] == BATCH
    assert res["images_per_s"] > 0 and res["split"] is None
    seq, avg, edges = (t.numpy() for t in res["outputs"])
    want_seq, want_avg, want_edges = _jax_infer(jcfg, _images(2, size))
    assert seq.shape == (BATCH, DECODE_LEN) and edges.shape == want_edges.shape
    np.testing.assert_array_equal(seq, want_seq)
    assert (seq != 0).all()  # forced to full length: no PAD
    np.testing.assert_allclose(avg, want_avg, rtol=0, atol=1e-5)
    np.testing.assert_allclose(edges, want_edges, rtol=0, atol=1e-4)


def test_bench_config_keeps_the_default_cache_form():
    cfg = Config()
    assert bench_torch.bench_config(cfg, 480, None).decoder.kv_int8
    assert not bench_torch.bench_config(cfg, 480, False).decoder.kv_int8
    assert bench_torch.bench_config(cfg, 96, True).decoder.max_len == 96


def test_kv_int8_flag_defaults_as_bench_py(monkeypatch):
    """``MOLNEXTR_KV_INT8=1`` or unset: the config's default; the flags set it."""
    for env, want in (("1", True), ("0", None), ("", None)):
        monkeypatch.setenv("MOLNEXTR_KV_INT8", env)
        assert bench_torch.parser().parse_args([]).kv_int8 is want
    args = bench_torch.parser().parse_args(["--no-kv-int8"])
    assert args.kv_int8 is False and args.batch == 256 and args.iters == 3
    assert args.decode_len == 480 and args.device == "cuda"


@pytest.mark.parametrize("eos_bias", [0.0, 0.1])
def test_decode_sweep_matches_jax_engine(eos_bias, monkeypatch):
    """At ``eos_bias`` 0 the seeded tiny model never emits EOS in 160 steps;
    0.1 on the EOS logit's bias ends every row at step 49, so the decodes
    exit early, each at its own sync granularity."""
    seeded = bench_torch.seeded_flax_params

    def biased(cfg, vocab, seed):
        params = seeded(cfg, vocab, seed)
        bias = params["params"]["decoders_chartok_coords"]["output"]["bias"]
        bias[bench_decode_torch.EOS_ID] += eos_bias
        return params

    monkeypatch.setattr(bench_torch, "seeded_flax_params", biased)
    cfg = Config.from_dict(_jax_config().to_dict())
    size = cfg.data.input_size
    images = _images(7, size)
    res = bench_decode_torch.run(cfg, batch=BATCH, iters=1, unrolls=(1, 2, 4), device="cpu",
                                 dtype=torch.float32, draw=lambda seed: torch.from_numpy(images),
                                 log=lambda msg: None)
    assert res["max_len"] == DECODE_LEN and set(res["unrolls"]) == {1, 2, 4}
    assert res["best"] in (1, 2, 4)
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    params = biased(cfg, vocab, 0)
    steps = {u: r["steps"] for u, r in res["unrolls"].items()}
    if eos_bias:
        assert steps == {1: 50, 2: 50, 4: 52}
    else:
        assert steps == {1: DECODE_LEN, 2: DECODE_LEN, 4: DECODE_LEN}
    for unroll, r in res["unrolls"].items():
        jcfg = _jax_config(unroll=unroll)
        engine = JEngine(jcfg, jax_tokenizer(jcfg.data), JModel(jcfg, vocab, dtype=jnp.float32),
                         params)
        want = np.asarray(engine._decode_jit(params, jnp.asarray(images))[0])
        np.testing.assert_array_equal(r["seq"].numpy(), want, err_msg=f"unroll {unroll}")
        np.testing.assert_array_equal(r["seq"].numpy(), res["unrolls"][1]["seq"].numpy())
        assert r["steps"] == bench_decode_torch.steps_run(r["seq"], unroll, DECODE_LEN)
        assert r["ms_per_step_run"] == pytest.approx(r["ms_per_step"] * DECODE_LEN / r["steps"])


def test_steps_run_counts_the_sync_granularity():
    eos = bench_decode_torch.EOS_ID
    seq = torch.full((2, 12), 5)
    assert bench_decode_torch.steps_run(seq, 4, 12) == 12  # no row ended
    seq[0, 2] = eos
    assert bench_decode_torch.steps_run(seq, 4, 12) == 12  # row 1 never ended
    seq[1, 5] = eos
    assert bench_decode_torch.steps_run(seq, 1, 12) == 6
    assert bench_decode_torch.steps_run(seq, 4, 12) == 8
    seq[1, 5], seq[1, 11] = 5, eos
    assert bench_decode_torch.steps_run(seq, 4, 12) == 12


def _tiny_full():
    cfg = torch_config.tiny_test_config()
    cfg.data = dataclasses.replace(cfg.data, max_atoms=8)
    return cfg


def test_bench_main_last_line_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench_torch, "Config", _tiny_full)
    bench_torch.main(["--batch", "2", "--iters", "1", "--decode-len", "16", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "inference_images_per_sec_per_chip" and line["unit"] == "img/s"
    assert line["value"] > 0 and line["batch"] == 2 and line["kv_cache"] == "int8"
    assert line["decode_steps"] == 16 and line["device"] == "cpu" and line["card"] is None


def test_bench_decode_main_last_line_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench_decode_torch, "Config", _tiny_full)
    bench_decode_torch.main(["--batch", "2", "--iters", "1", "--unrolls", "1,4",
                             "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("config: batch 2, input 32, max_len 24")
    assert any(ln.startswith("encode leg: ") for ln in lines)
    assert sum(ln.startswith("unroll=") and " steps, " in ln and ln.endswith(" ms a step run]")
               for ln in lines) == 2
    last = lines[-1]
    assert last.startswith("BEST: unroll=") and last.endswith(" ms/step (cpu)")
    assert int(last.split("unroll=")[1].split()[0]) in (1, 4)


@pytest.mark.parametrize("main", [bench_torch.main, bench_decode_torch.main])
def test_scripts_need_cuda_unless_cpu_is_asked(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--batch", "1", "--iters", "1"])


@pytest.mark.parametrize("main", [bench_torch.main, bench_decode_torch.main])
def test_scripts_need_hopper(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda dev=None: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "A100")
    with pytest.raises(RuntimeError, match="sm_90a"):
        main(["--batch", "1", "--iters", "1"])


def test_encoder_kernels_refuse_rows_past_the_gemm_grid():
    """A batch whose Swin stage holds more than 65535 GEMM row blocks of 64
    rows raises from the wrapper, naming the limit, before any launch (meta
    tensors: shapes only).  At 384 px that is a batch of 456; 455 passes
    the check and reaches the device check."""
    from molnextr_tpu_torch.ops import swin_fused as sf

    def meta(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, dtype=dtype, device="meta")

    def window(batch, c=32, heads=2, ws=12, res=96):
        n = ws * ws
        return sf.fused_window_attention(
            meta(batch, res, res, c), meta(c, 3 * c), meta(3 * c, dtype=torch.float32),
            meta(c, c), meta(c, dtype=torch.float32), meta(c, dtype=torch.float32),
            meta(c, dtype=torch.float32), meta(heads, n, n, dtype=torch.float32), None, heads, ws)

    def mlp(rows, c):
        f32 = torch.float32
        return sf.fused_ln_mlp(meta(rows, c), meta(c, dtype=f32), meta(c, dtype=f32),
                               meta(c, 4 * c), meta(4 * c, dtype=f32), meta(4 * c, c),
                               meta(c, dtype=f32))

    with pytest.raises(ValueError, match="65535"):
        window(456)
    with pytest.raises(ValueError, match="65535"):
        mlp(65535 * 64 + 1, 256)  # two GEMMs
    for call in (lambda: window(455), lambda: mlp(65535 * 64, 256),
                 lambda: mlp(65535 * 64 + 1, 128)):  # C 128: the fused kernel, rows along x
        with pytest.raises((RuntimeError, AssertionError, ValueError)) as err:
            call()
        assert "65535" not in str(err.value)
