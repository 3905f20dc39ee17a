"""The port's twins of the repo's tools, and its package roots, on the CPU
against the JAX package:

* the roots: every name that ``molnextr_tpu`` and ``molnextr_tpu.data``
  export resolves in ``molnextr_tpu_torch`` and ``molnextr_tpu_torch.data``
  to the port's counterpart; the root imports no torch, and its lazy
  ``get_predictions`` reads the demo image;
* ``train/overfit_chiral.py``: its ``Config``, chiral set, ``train_loop``
  call and ``corpus_valid.txt`` bytes are ``scripts/overfit_chiral.py``'s
  (the JAX script's ``train_loop`` replaced in this process); a tiny run
  writes a bundle the JAX package loads, with the JAX evaluation's keys;
* ``diagnostics.py``: ``ab_int8``, ``diagnose_errors`` (beam 2) and
  ``diagnose_chirality`` on a float32 copy of the demo bundle at n 8 give
  the JAX scripts' reports (and ``diagnose_chirality`` prints their lines),
  with the dense arm on the plain dense attention and the int8 arm on the
  plain int8 one;
* the thin ``scripts/*_torch.py`` and the ``.sh`` twins.

The scoring pools run serially here (a forked child of a process running
JAX's threads may deadlock).
"""

import ast
import importlib.util
import json
import multiprocessing
import os
import random
import runpy
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import molnextr_tpu_torch
from molnextr_tpu_torch import benchmarks, diagnostics
from molnextr_tpu_torch.train import overfit_chiral

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SCRIPTS = os.path.join(ROOT, "scripts")
BUNDLE = os.path.join(ROOT, "examples", "demo_model")
DEMO_PNG = os.path.join(ROOT, "molnextr_tpu_torch", "fixtures", "demo_0.png")
TINY = ["--k", "2", "--epochs", "2", "--eval-every", "1", "--embed-dim", "8"]
# the chirality diagnosis' corpus: chiral and achiral molecules the demo
# bundle's 128 px renders hold
CHIRAL_CORPUS = ["C[C@H](N)C(=O)O", "CC(C)O", "C[C@@H](O)CC", "CCOC"]
N = 8


class SerialPool:
    """``multiprocessing.Pool``'s ``map``/``starmap`` in this process."""

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, items, chunksize=None):
        return [fn(x) for x in items]

    def starmap(self, fn, items, chunksize=None):
        return [fn(*x) for x in items]


@pytest.fixture(autouse=True)
def serial_pools(monkeypatch):
    monkeypatch.setattr(multiprocessing, "Pool", SerialPool)


def _jax_script(name):
    os.environ.setdefault("MALLOC_MMAP_THRESHOLD_", "1073741824")  # no re-exec
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax(monkeypatch, name, argv):
    """The JAX script's ``main()`` on ``argv`` (its ``sys.argv``), seeded."""
    module = _jax_script(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    random.seed(0)
    np.random.seed(0)
    module.main()


def _run_port(fn, argv):
    random.seed(0)
    np.random.seed(0)
    return fn(argv + ["--device", "cpu"])


# -- the package roots --------------------------------------------------------

def _root_names(path):
    """Top-level names an ``__init__.py`` binds (imports, defs, assignments)."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {a.asname or a.name.split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names - {"annotations"}


def test_roots_export_what_the_jax_roots_export():
    import molnextr_tpu
    import molnextr_tpu.data

    import molnextr_tpu_torch.data
    from molnextr_tpu_torch import config
    from molnextr_tpu_torch.data import dataset, synthetic, transforms

    names = _root_names(molnextr_tpu.__file__)
    assert names == {"Config", "get_predictions", "MolNexTR", "__version__"}
    assert names <= _root_names(molnextr_tpu_torch.__file__)
    assert molnextr_tpu_torch.Config is config.Config
    assert molnextr_tpu_torch.__version__ == molnextr_tpu.__version__
    assert molnextr_tpu_torch.data.__all__ == molnextr_tpu.data.__all__
    port = {"DataLoader": dataset.DataLoader, "Sample": dataset.Sample,
            "TrainDataset": dataset.TrainDataset, "pad_batch": dataset.pad_batch,
            "generate_synthetic_image": synthetic.generate_synthetic_image,
            "get_transforms": transforms.get_transforms}
    for name in molnextr_tpu.data.__all__:
        assert getattr(molnextr_tpu_torch.data, name) is port[name], name
        assert getattr(molnextr_tpu.data, name).__name__ == port[name].__name__


def test_root_import_stays_light():
    out = subprocess.run([sys.executable, "-c",
                          "import sys, molnextr_tpu_torch\n"
                          "from molnextr_tpu_torch import Config, MolNexTR, get_predictions\n"
                          "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                          "('torch', 'numpy', 'jax', 'molnextr_tpu')))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_root_get_predictions_reads_demo_0(monkeypatch):
    from molnextr_tpu_torch.api import MolNexTRSingleton
    from molnextr_tpu_torch.chem import canonicalize_smiles

    monkeypatch.setenv("MOLNEXTR_MODEL_PATH", BUNDLE)
    MolNexTRSingleton.reset()
    try:
        res = molnextr_tpu_torch.get_predictions(DEMO_PNG, device="cpu")
        model = molnextr_tpu_torch.MolNexTR(model_path=BUNDLE, device="cpu", num_workers=1)
    finally:
        MolNexTRSingleton.reset()
    assert res["predicted_smiles"] == "CC(C)O" and res["device_info"] == "CPU"
    assert canonicalize_smiles(
        model.predict_image_files([DEMO_PNG])[0]["predicted_smiles"])[0] == "CC(C)O"


# -- the chiral overfit ----------------------------------------------------------

_POOLS = {}


def _memoized_corpus(monkeypatch, module):
    """``module.generate_corpus`` computed once per package and arguments
    (the overfit's pool of 4000 takes seconds)."""
    inner = module.generate_corpus

    def corpus(*args, **kwargs):
        key = (module.__name__, args, tuple(sorted(kwargs.items())))
        if key not in _POOLS:
            _POOLS[key] = inner(*args, **kwargs)
        return list(_POOLS[key])

    monkeypatch.setattr(module, "generate_corpus", corpus)


def _capture_train_loop(monkeypatch, module, calls):
    def fake(cfg, samples, **kwargs):
        calls.append((cfg, [s.smiles for s in samples],
                      [s.smiles for s in kwargs.pop("valid_samples")], kwargs))
        return types.SimpleNamespace(step=0)

    monkeypatch.setattr(module, "train_loop", fake)


@pytest.mark.parametrize("flags", [[], ["--k", "2", "--embed-dim", "8"]])
def test_overfit_is_the_jax_scripts(monkeypatch, tmp_path, flags):
    import molnextr_tpu.data.corpus as jax_corpus
    import molnextr_tpu.train.loop as jax_loop

    from molnextr_tpu_torch.data import corpus
    from molnextr_tpu_torch.train import loop

    _memoized_corpus(monkeypatch, jax_corpus)
    _memoized_corpus(monkeypatch, corpus)
    want, got = [], []
    _capture_train_loop(monkeypatch, jax_loop, want)
    _capture_train_loop(monkeypatch, loop, got)
    _run_jax(monkeypatch, "overfit_chiral", flags + ["--save-path", str(tmp_path / "jax")])
    report = overfit_chiral.main(flags + ["--save-path", str(tmp_path / "port"), "--device", "cpu"])
    (jcfg, jtrain, jvalid, jkw), (cfg, train, valid, kw) = want[0], got[0]
    assert cfg.train.save_path == str(tmp_path / "port")
    cfg.train.save_path = jcfg.train.save_path
    assert json.loads(cfg.to_json()) == json.loads(jcfg.to_json())
    args = overfit_chiral.make_parser().parse_args(flags + ["--save-path", str(tmp_path / "jax")])
    assert json.loads(overfit_chiral.build_config(args).to_json()) == json.loads(jcfg.to_json())
    assert train == valid == jtrain == jvalid == report["chiral"]
    assert len(train) == args.k and all("@" in s for s in train)
    assert kw.pop("device") == "cpu" and kw == jkw
    with open(tmp_path / "jax" / "corpus_valid.txt", "rb") as f:
        jax_bytes = f.read()
    with open(tmp_path / "port" / "corpus_valid.txt", "rb") as f:
        assert f.read() == jax_bytes
    defaults = vars(overfit_chiral.make_parser().parse_args([]))
    assert defaults == {"k": 4, "epochs": 400, "eval_every": 50, "embed_dim": 16,
                        "save_path": "output/chiral_proof", "resume": None, "device": "cuda"}


def test_overfit_run_writes_a_bundle_the_jax_package_loads(tmp_path):
    from molnextr_tpu.checkpoint import load_model as jax_load
    from molnextr_tpu.data.dataset import Sample as JaxSample
    from molnextr_tpu.inference import InferenceEngine as JaxEngine
    from molnextr_tpu.models.model import MolNexTRModel as JaxModel
    from molnextr_tpu.tokenization import get_tokenizer as jax_tokenizer
    from molnextr_tpu.train.loop import evaluate_model as jax_evaluate

    save = str(tmp_path / "run")
    report = overfit_chiral.main(TINY + ["--save-path", save, "--device", "cpu"])
    assert report["step"] == 2 and [r["epoch"] for r in report["epochs"]] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in report["epochs"])
    jcfg, jparams = jax_load(os.path.join(save, "ckpt_best"))
    assert (jcfg.encoder.embed_dim, jcfg.data.input_size, jcfg.decoder.max_len) == (8, 192, 256)
    jcfg.train.bf16 = False
    jcfg.decoder.max_len = 24  # a short decode: the keys, not the molecules, are checked
    jtok = jax_tokenizer(jcfg.data)
    jmodel = JaxModel(jcfg, {k: len(t) for k, t in jtok.items()})
    scores = jax_evaluate(jcfg, jmodel, jparams, jtok, [JaxSample(s) for s in report["chiral"]],
                          num_workers=0, engine=JaxEngine(jcfg, jtok, jmodel, jparams))
    for row in report["epochs"]:  # every epoch evaluated
        assert {k[len("valid_"):] for k in row if k.startswith("valid_")} == set(scores)
    assert scores["chiral_ratio"] == 1.0  # the K molecules are all chiral


# -- the diagnostics --------------------------------------------------------------

@pytest.fixture(scope="module")
def f32_bundle(tmp_path_factory):
    """``examples/demo_model`` with ``train.bf16`` false."""
    path = str(tmp_path_factory.mktemp("demo_f32") / "bundle")
    shutil.copytree(BUNDLE, path)
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    cfg["train"]["bf16"] = False
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    return path


def _without(report, key):
    return {k: ({kk: vv for kk, vv in v.items() if kk != key} if isinstance(v, dict) else v)
            for k, v in report.items() if k != key}


def _keep_smiles(monkeypatch, module, kept):
    """``module.suite_batch_inference`` keeping each call's SMILES."""
    inner = module.suite_batch_inference

    def kept_suite(*args, **kwargs):
        out = inner(*args, **kwargs)
        kept.append(list(out["_smiles"]))
        return out

    monkeypatch.setattr(module, "suite_batch_inference", kept_suite)


def test_ab_int8_is_the_jax_scripts(monkeypatch, tmp_path, f32_bundle):
    import molnextr_tpu.benchmarks as jax_benchmarks

    da = importlib.import_module("molnextr_tpu_torch.ops.decode_attention")
    out = str(tmp_path / "jax.json")
    jax_smiles, smiles = [], []
    _keep_smiles(monkeypatch, jax_benchmarks, jax_smiles)
    _run_jax(monkeypatch, "ab_int8_suites", ["--model_path", f32_bundle, "--n", str(N),
                                              "--output", out])
    with open(out) as f:
        want = json.load(f)
    _keep_smiles(monkeypatch, benchmarks, smiles)
    plain = {"dense": 0, "q8": 0}
    arms = []
    for key, name in (("dense", "decode_attention_layered_reference"),
                      ("q8", "decode_attention_layered_q8_reference")):
        inner = getattr(da, name)
        monkeypatch.setattr(da, name, lambda *a, _k=key, _f=inner, **kw: (
            plain.__setitem__(_k, plain[_k] + 1), _f(*a, **kw))[1])
    suite = benchmarks.suite_batch_inference

    def spied(*args, **kwargs):
        before = dict(plain)
        out = suite(*args, **kwargs)
        arms.append({k: plain[k] - before[k] for k in plain})
        return out

    monkeypatch.setattr(benchmarks, "suite_batch_inference", spied)
    got = _run_port(diagnostics.ab_int8, ["--model_path", f32_bundle, "--n", str(N)])
    assert json.loads(json.dumps(_without(got, "img_per_s"))) == _without(want, "img_per_s")
    assert set(got) == {"bf16", "int8", "smiles_agreement"} and got["bf16"]["n"] == N
    assert smiles == jax_smiles and len(smiles) == 2 and len(smiles[0]) == N
    assert arms[0]["dense"] > 0 and arms[0]["q8"] == 0  # "bf16": the dense cache
    assert arms[1]["q8"] > 0 and arms[1]["dense"] == 0  # "int8"


def test_diagnose_errors_is_the_jax_scripts(monkeypatch, tmp_path, f32_bundle):
    out = str(tmp_path / "jax.json")
    argv = ["--model_path", f32_bundle, "--n", str(N), "--beam", "2"]
    _run_jax(monkeypatch, "diagnose_errors", argv + ["--output", out])
    with open(out) as f:
        want = json.load(f)
    got = _run_port(diagnostics.diagnose_errors, argv)
    assert {k: v for k, v in got.items() if k != "img_per_s_greedy"} == \
        {k: v for k, v in want.items() if k != "img_per_s_greedy"}
    assert {"graph_exact", "token_exact", "either_exact", "both_exact", "graph_invalid",
            "token_invalid", "disagree_examples", "beam_token_top1", "beam_token_oracle",
            "beam_first_hit_rank_hist"} <= set(got)
    assert got["n"] == N and len(got["beam_first_hit_rank_hist"]) == 2


def test_diagnose_chirality_is_the_jax_scripts(monkeypatch, tmp_path, capsys, f32_bundle):
    corpus = str(tmp_path / "corpus_valid.txt")
    with open(corpus, "w") as f:
        f.write("\n".join(CHIRAL_CORPUS))
    argv = ["--bundle", f32_bundle, "--corpus", corpus]
    capsys.readouterr()
    _run_jax(monkeypatch, "diagnose_chirality", argv)
    want = capsys.readouterr().out
    got = _run_port(diagnostics.diagnose_chirality, argv)
    printed = capsys.readouterr().out
    assert printed == want
    lines = printed.splitlines()
    stage = {line.split(":", 1)[0]: ast.literal_eval(line.split(":", 1)[1].strip())
             for line in lines if line.startswith("stage ")}
    assert got["stage_a"] == stage["stage A (oracle)"] and got["stage_a"]["chiral"] == 1.0
    assert got["stage_d"] == stage["stage D (model)"]
    marks = [line for line in lines if line.startswith(("CHIRAL ", "       tokens="))]
    assert [(r["tokens_match"], r["edges_match"]) for r in got["rows"]] == [
        ("tokens=OK " in m, "edges=OK " in m) for m in marks]
    assert [r["gold"] for r in got["rows"] if r["chiral"]] == [
        m.split(" ")[-1] for m in marks if m.startswith("CHIRAL")]


# -- the scripts -----------------------------------------------------------------

@pytest.mark.parametrize("script,parser", [
    ("overfit_chiral_torch.py", overfit_chiral.make_parser),
    ("ab_int8_suites_torch.py", diagnostics.ab_int8_parser),
    ("diagnose_errors_torch.py", diagnostics.diagnose_errors_parser),
    ("diagnose_chirality_torch.py", diagnostics.diagnose_chirality_parser)])
def test_thin_scripts_take_the_jax_scripts_flags(monkeypatch, capsys, script, parser):
    monkeypatch.setattr(sys, "argv", [script, "--help"])
    with pytest.raises(SystemExit) as stop:
        runpy.run_path(os.path.join(SCRIPTS, script), run_name="__main__")
    assert stop.value.code == 0 and "--device" in capsys.readouterr().out
    jax_flags = {}  # the JAX script's flags and their defaults
    with open(os.path.join(SCRIPTS, script.replace("_torch", ""))) as f:
        for node in ast.walk(ast.parse(f.read())):
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
                kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                      if k.arg in ("default", "type", "required", "action")
                      and isinstance(k.value, ast.Constant)}
                jax_flags[node.args[0].value] = kw
    port = {a.option_strings[0]: a for a in parser()._actions if a.option_strings}
    port.pop("-h")
    assert port.pop("--device").default == "cuda"
    assert set(port) == set(jax_flags)
    for flag, want in jax_flags.items():
        assert port[flag].default == want.get("default", False if "action" in want else None)
        assert port[flag].required == want.get("required", False), flag


def _stub_run(tmp_path, script, binary):
    """Run ``script`` with ``binary`` a stub on PATH that records its argv."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(parents=True, exist_ok=True)
    log = tmp_path / f"{binary}.log"
    stub = bin_dir / binary
    stub.write_text(f'#!/bin/bash\necho "$@" >> {log}\n')
    stub.chmod(0o755)
    work = tmp_path / "work"
    (work / "data" / "real").mkdir(parents=True, exist_ok=True)
    for ds in ("CLEF", "USPTO"):
        (work / "data" / "real" / f"{ds}.csv").write_text("image_id,SMILES,file_path\n")
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}",
               SAVE_PATH=str(work / "out"), MODEL="m")
    out = subprocess.run(["bash", os.path.join(SCRIPTS, script), "--epochs", "2"] if "train" in
                         script else ["bash", os.path.join(SCRIPTS, script)], cwd=work, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    return log.read_text()


@pytest.mark.parametrize("name,binary", [("train", "molnextr-train"), ("eval", "molnextr-bench")])
def test_shell_twins_pass_the_same_flags(tmp_path, name, binary):
    port_binary = binary.replace("molnextr-", "molnextr-torch-")
    with open(os.path.join(SCRIPTS, f"{name}.sh")) as f:
        jax_text = f.read()
    with open(os.path.join(SCRIPTS, f"{name}_torch.sh")) as f:
        port_text = f.read()

    def body(text):  # the lines after the header comment
        lines = text.splitlines()
        return lines[next(i for i, line in enumerate(lines) if line.startswith("set ")):]

    assert body(port_text) == body(jax_text.replace(f"{binary} ", f"{port_binary} "))
    assert port_binary in port_text and f"{binary} " not in port_text
    jax_calls = _stub_run(tmp_path / "jax", f"{name}.sh", binary)
    port_calls = _stub_run(tmp_path / "port", f"{name}_torch.sh", port_binary)
    assert port_calls.replace(str(tmp_path / "port"), "") == \
        jax_calls.replace(str(tmp_path / "jax"), "") != ""
