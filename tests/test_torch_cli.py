"""The port's console entry points (CPU) against the JAX package's.

* predict: ``molnextr_tpu_torch.predict.main`` and ``molnextr_tpu.predict.main``
  on a float32 copy of the demo bundle and PNG files of the demo renders:
  SMILES, molfiles, atoms and bonds equal; confidences within 1e-4 (both
  run the same float32 model, summing in another order; a confidence is a
  product of up to 30 probabilities).
* evaluate: both ``evaluate_cli.main`` on the same CSV files (ids, missing
  rows, empty and NA cells, ids written as ``007``): the same printed
  scores; ``utils.read_csv`` types cells as ``pandas.read_csv`` does.
* train: ``molnextr_tpu_torch.train.main`` for 2 steps of the tiny test
  config on ``--device cpu``; the bundle it writes loads in the JAX package.
"""

import json
import math
import os

import numpy as np
import pandas as pd
import pytest
import torch

from molnextr_tpu import checkpoint as jckpt
from molnextr_tpu import evaluate_cli as jeval
from molnextr_tpu import predict as jpredict
from molnextr_tpu_torch import checkpoint as pckpt
from molnextr_tpu_torch import evaluate_cli as peval
from molnextr_tpu_torch import predict as ppredict
from molnextr_tpu_torch.config import tiny_test_config
from molnextr_tpu_torch.data.png import write_png
from molnextr_tpu_torch.train import main as train_main
from molnextr_tpu_torch.utils import read_csv

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BUNDLE = os.path.join(ROOT, "examples", "demo_model")
FIXTURES = os.path.join(ROOT, "molnextr_tpu_torch", "fixtures")
CONF_TOL = 1e-4


@pytest.fixture(scope="module")
def f32_bundle_and_images(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("predict")
    cfg, params = pckpt.load_model(BUNDLE)
    cfg.train.bf16 = False
    bundle = str(tmp / "bundle_f32")
    pckpt.save_model(bundle, cfg, params)
    with np.load(os.path.join(FIXTURES, "demo.npz")) as f:
        images = f["images"]
    paths = [os.path.join(FIXTURES, "demo_0.png")]
    for i, img in enumerate(images[1:3]):  # 3 files: below both packages' pool threshold
        paths.append(str(tmp / f"demo_{i + 1}.png"))
        write_png(paths[-1], img)
    return bundle, paths, tmp


def _run_predict(main, bundle, paths, out, extra):
    main(paths + ["--model_path", bundle, "--output", str(out)] + extra)
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("extra", [["--molfile", "--confidence"], ["--atoms_bonds"]])
def test_predict_cli_matches_jax(f32_bundle_and_images, extra):
    bundle, paths, tmp = f32_bundle_and_images
    want = _run_predict(jpredict.main, bundle, paths, tmp / "jax.json", extra)
    got = _run_predict(ppredict.main, bundle, paths, tmp / "port.json",
                       extra + ["--device", "cpu", "--batch_size", "2"])
    assert len(got) == len(want) == len(paths)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        conf_g, conf_w = g.pop("confidence", None), w.pop("confidence", None)
        if conf_w is not None:
            assert abs(conf_g - conf_w) <= CONF_TOL, (conf_g, conf_w)
        assert g == json.loads(json.dumps(w))


def _eval_both(capsys, argv):
    outs = []
    for main in (jeval.main, peval.main):
        main(argv + ["--num_workers", "1"])
        text = capsys.readouterr().out
        head, _, body = text.partition("{")
        outs.append((head.strip(), json.loads("{" + body)))
    return outs


def _write(path, text):
    path.write_text(text)
    return str(path)


GOLD = """image_id,SMILES,note
1,CCO,a
2,c1ccccc1,
3,CC(=O)O,b
7,,c
5,C[C@H](N)C(=O)O,d
6,C/C=C/C,e
"""
PRED_BY_ID = """image_id,SMILES
3,CC(=O)O
007,CCO.Cl
1,OCC
2,NA
6,C/C=C\\C
5,C[C@@H](N)C(=O)O
"""
PRED_BY_ROW = """SMILES,score
OCC,0.5
c1ccccc1,
,0.1
"""


@pytest.mark.parametrize("flags", [[], ["--keep_main"], ["--tanimoto"]])
def test_evaluate_cli_matches_jax(tmp_path, capsys, flags):
    gold = _write(tmp_path / "gold.csv", GOLD)
    for pred_text in (PRED_BY_ID, PRED_BY_ROW):
        pred = _write(tmp_path / "pred.csv", pred_text)
        (jhead, jscores), (phead, pscores) = _eval_both(
            capsys, ["--gold_file", gold, "--pred_file", pred] + flags)
        assert phead == jhead
        assert pscores == jscores
    assert "different lengths" in phead  # the second pair: 3 rows against 6


def test_read_csv_types_cells_as_pandas(tmp_path):
    path = _write(tmp_path / "t.csv",
                  "a,b,c,d,e,f\n1,1.5,x,,007,NA\n2,,7,,12,3\n-3,2e3,None,,,n/a\n")
    got, want = read_csv(path), pd.read_csv(path)
    assert list(got) == list(want.columns)
    for name in want.columns:
        for g, w in zip(got[name], want[name]):
            if isinstance(w, float) and math.isnan(w):
                assert isinstance(g, float) and math.isnan(g), (name, g)
            else:
                assert g == w and isinstance(g, str) == isinstance(w, str), (name, g, w)


def test_train_cli_two_steps_on_cpu(tmp_path):
    cfg = tiny_test_config()
    cfg_path = _write(tmp_path / "cfg.json", cfg.to_json())
    train = _write(tmp_path / "train.csv", "SMILES\nCCO\nc1ccccc1\nCC(=O)O\nCCN\nCCC\nCO\n")
    valid = _write(tmp_path / "valid.csv", "SMILES,file_path\nCCO,\nCN,\n")
    save = tmp_path / "out"
    train_main(["--train_file", train, "--valid_file", valid, "--config", cfg_path,
                "--save_path", str(save), "--epochs", "1", "--steps_per_epoch", "2",
                "--batch_size", "2", "--num_workers", "0", "--seed", "3",
                "--device", "cpu"])
    with open(save / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 1 and lines[0]["step"] == 2
    assert math.isfinite(lines[0]["train_loss"]) and "valid_canon_smiles" in lines[0]
    bundles = [d for d in os.listdir(save) if d.startswith("ckpt_")]
    assert bundles
    jcfg, jparams = jckpt.load_model(str(save / bundles[0]))
    assert jcfg.encoder.name == cfg.encoder.name and jcfg.train.batch_size == 2
    pcfg, pparams = pckpt.load_model(str(save / bundles[0]))
    assert pcfg.train.epochs == 1 and "encoder" in pparams["params"]
