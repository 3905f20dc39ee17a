"""The drug-like recipe (``molnextr_tpu_torch/train/druglike.py``, the thin
``scripts/*_torch.py``) and the walkthroughs (``examples/*_torch.py``).

* ``build_config`` gives the JAX script's ``Config`` for its default flags
  and for ``--flagship``, ``--no-augment`` and ``--image-augment-only``;
* at a tiny width on the CPU (2 steps, a handful of SMILES), the recipe's
  ``main`` evaluates each epoch and writes a bundle that
  ``molnextr_tpu.checkpoint`` loads and the JAX package's evaluation scores;
* the prebuild writes an ``item_cache.pkl`` that a second run loads;
* both walkthroughs run with ``--device cpu`` on ``examples/demo_model``
  (``MOLNEXTR_MODEL_PATH``) and print ``CC(C)O`` for ``demo_0.png``.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from molnextr_tpu_torch.train import druglike

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BUNDLE = os.path.join(ROOT, "examples", "demo_model")
DEMO_PNG = os.path.join(ROOT, "molnextr_tpu_torch", "fixtures", "demo_0.png")
TINY = ["--corpus", "6", "--valid", "3", "--epochs", "1", "--steps-per-epoch", "2",
        "--batch-size", "3", "--input-size", "96", "--embed-dim", "8", "--no-augment"]


@pytest.fixture(scope="module")
def jax_script():
    """``scripts/train_druglike.py``, loaded with the malloc variables set so
    that it does not re-execute the interpreter."""
    os.environ.setdefault("MALLOC_MMAP_THRESHOLD_", "1073741824")
    spec = importlib.util.spec_from_file_location(
        "jax_train_druglike", os.path.join(ROOT, "scripts", "train_druglike.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("flags", [[], ["--flagship"], ["--no-augment"], ["--image-augment-only"],
                                   ["--flagship", "--no-augment"],
                                   ["--batch-size", "128", "--embed-dim", "96", "--epochs", "3",
                                    "--dispatch", "4", "--workers", "2", "--input-size", "256"]])
def test_build_config_is_the_jax_scripts(jax_script, flags):
    want = jax_script.build_config(jax_script.make_parser().parse_args(flags))
    got = druglike.build_config(druglike.make_parser().parse_args(flags + ["--device", "cpu"]))
    assert json.loads(got.to_json()) == json.loads(want.to_json())


def test_parser_keeps_the_jax_flags_and_defaults(jax_script):
    jax_args = vars(jax_script.make_parser().parse_args([]))
    port_args = vars(druglike.make_parser().parse_args([]))
    assert port_args.pop("device") == "cuda"
    assert port_args == jax_args
    assert (jax_args["corpus"], jax_args["valid"], jax_args["input_size"], jax_args["embed_dim"],
            jax_args["batch_size"], jax_args["epochs"]) == (60000, 384, 192, 64, 256, 30)


def test_flagship_refuses_a_batch_that_is_not_a_multiple_of_64():
    with pytest.raises(ValueError, match="multiple of 64"):
        druglike.build_config(druglike.make_parser().parse_args(["--flagship",
                                                                 "--batch-size", "96"]))


def test_recipe_writes_a_bundle_the_jax_package_loads_and_scores(tmp_path):
    from molnextr_tpu.checkpoint import load_model as jax_load
    from molnextr_tpu.data.dataset import Sample as JaxSample
    from molnextr_tpu.inference import InferenceEngine as JaxEngine
    from molnextr_tpu.models.model import MolNexTRModel as JaxModel
    from molnextr_tpu.tokenization import get_tokenizer as jax_tokenizer
    from molnextr_tpu.train.loop import evaluate_model as jax_evaluate

    save = str(tmp_path / "run")
    state = druglike.main(TINY + ["--save-path", save, "--device", "cpu"])
    assert state.step == 2
    with open(os.path.join(save, "metrics.jsonl")) as f:
        epoch = json.loads(f.readline())
    assert epoch["step"] == 2 and np.isfinite(epoch["train_loss"])
    assert {"valid_canon_smiles", "valid_graph"} <= set(epoch)  # the per-epoch evaluate_model ran
    with open(os.path.join(save, "corpus_valid.txt")) as f:
        valid = f.read().split("\n")
    assert len(valid) == 3
    bundle = os.path.join(save, "ckpt_best")
    jcfg, jparams = jax_load(bundle)
    assert (jcfg.encoder.embed_dim, jcfg.data.input_size, jcfg.decoder.num_layers) == (8, 96, 4)
    jcfg.train.bf16 = False
    jcfg.decoder.max_len = 24  # a short decode: the scores, not the molecules, are checked
    jtok = jax_tokenizer(jcfg.data)
    jmodel = JaxModel(jcfg, {k: len(t) for k, t in jtok.items()})
    scores = jax_evaluate(jcfg, jmodel, jparams, jtok, [JaxSample(s) for s in valid],
                          num_workers=0, engine=JaxEngine(jcfg, jtok, jmodel, jparams))
    assert scores["n"] == 3 and 0.0 <= scores["canon_smiles"] <= 1.0


def test_prebuild_writes_an_item_cache_a_second_run_loads(tmp_path, capsys):
    save = str(tmp_path / "cache")
    path = druglike.prebuild_main(TINY + ["--save-path", save])
    assert path == os.path.join(save, "item_cache.pkl") and os.path.exists(path)
    assert "saved 6 items" in capsys.readouterr().out
    assert druglike.prebuild_main(TINY + ["--save-path", save]) == path
    assert "cache already complete: 6 items" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="not item-cacheable"):
        druglike.prebuild_main(TINY[:-1] + ["--save-path", save])  # augmenting


def _walkthrough(name, *args):
    env = dict(os.environ, MOLNEXTR_MODEL_PATH=BUNDLE)
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples", name), *args,
                          "--device", "cpu"], cwd=str(ROOT), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_predict_walkthrough_reads_demo_0():
    out = _walkthrough("predict_example_torch.py", DEMO_PNG)
    assert "SMILES: CC(C)O" in out and "device: CPU" in out


def test_visualize_walkthrough(tmp_path):
    from molnextr_tpu_torch.data.png import read_png

    out = _walkthrough("visualize_example_torch.py", "x", str(tmp_path / "a.png"),
                       "--image", DEMO_PNG)
    assert "pred: CC(C)O" in out
    out = _walkthrough("visualize_example_torch.py", "CC(C)O", str(tmp_path / "b.png"))
    assert "gold: CC(C)O" in out and "pred: " in out
    assert read_png(str(tmp_path / "b.png")).shape == (384, 768, 3)
