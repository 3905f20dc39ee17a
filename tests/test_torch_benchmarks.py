"""The port's benchmark suites (CPU) against the JAX package's.

* ``_synthetic_eval_set``: the same golds and pixels from the same seeds;
* ``suite_perturbed``: the images each package's suite hands its model
  (recorded by a stub model) are equal pixel for pixel, because the port
  perturbs with the module-level ``random``/``np.random`` state that
  ``_synthetic_eval_set`` leaves, as the JAX suite does;
* ``suite_dataset_eval`` on a CSV of PNG files: the images and golds each
  package reads;
* ``run_all`` on ``tiny_test_config`` (random weights, ``n`` 2): every
  suite returns the JAX suite's keys.  Accuracy is not compared: the two
  packages initialise random weights differently.

The suites' scoring pools run serially in these tests (``SerialPool``): a
forked child of a process running JAX's threads may deadlock.
"""

import json
import multiprocessing
import os
import sys

import numpy as np
import pytest
import torch

from molnextr_tpu import benchmarks as jb
from molnextr_tpu.config import tiny_test_config as jax_tiny_config
from molnextr_tpu_torch import benchmarks as pb
from molnextr_tpu_torch.config import Config, tiny_test_config
from molnextr_tpu_torch.data.png import write_png

torch.set_num_threads(2)

DEMO_PNG = os.path.join(os.path.dirname(pb.__file__), "fixtures", "demo_0.png")
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


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


class RecordingModel:
    """Stands in for ``MolNexTR``: records the images it is handed."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.images = []

    def predict_images(self, images, **kwargs):
        self.images += [np.array(im) for im in images]
        return [{"predicted_smiles": "C"} for _ in images]


@pytest.mark.parametrize("seed,size", [(0, 128), (3, 96)])
def test_synthetic_eval_set_equals_jax(seed, size):
    np.random.seed(11)
    want_imgs, want_golds = jb._synthetic_eval_set(5, seed=seed, size=size)
    np.random.seed(11)
    got_imgs, got_golds = pb._synthetic_eval_set(5, seed=seed, size=size)
    assert got_golds == want_golds and len(got_imgs) == 5
    for g, w in zip(got_imgs, want_imgs):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("size", [96, 384])
def test_perturbed_suite_images_equal_jax(size):
    from molnextr_tpu.config import Config as JConfig

    jcfg, cfg = JConfig(), Config()
    jcfg.data.input_size = cfg.data.input_size = size
    jmodel, pmodel = RecordingModel(jcfg), RecordingModel(cfg)
    np.random.seed(5)
    want = jb.suite_perturbed(jcfg, jmodel, n=6)
    np.random.seed(5)
    got = pb.suite_perturbed(cfg, pmodel, n=6)
    assert got == want
    assert len(pmodel.images) == len(jmodel.images) == 6
    for g, w in zip(pmodel.images, jmodel.images):
        assert g.shape == (size, size, 3) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


def test_dataset_eval_reads_the_csv_as_jax(tmp_path):
    rng = np.random.RandomState(0)
    rows = ["file_path,SMILES"]
    for i, smi in enumerate(["CCO", "c1ccccc1", "CC(=O)O"]):
        path = str(tmp_path / f"{i}.png")
        write_png(path, rng.randint(0, 256, (40 + i, 50, 3)).astype(np.uint8))
        rows.append(f"{path},{smi}")
    rows.append(f"{tmp_path / 'missing.png'},CCN")  # skipped by both
    csv = tmp_path / "set.csv"
    csv.write_text("\n".join(rows) + "\n")
    jmodel, pmodel = RecordingModel(None), RecordingModel(None)
    want = jb.suite_dataset_eval(jmodel, str(csv))
    got = pb.suite_dataset_eval(pmodel, str(csv))
    assert got == want and got["n"] == 3 and got["dataset"] == "set.csv"
    for g, w in zip(pmodel.images, jmodel.images):
        np.testing.assert_array_equal(g, w)


def test_run_all_suites_have_the_jax_keys():
    jax_report = jb.run_all(jax_tiny_config(), image_path=DEMO_PNG, n=2)
    port_report = pb.run_all(tiny_test_config(), image_path=DEMO_PNG, n=2, device="cpu")
    assert [s["suite"] for s in port_report] == [s["suite"] for s in jax_report]
    for got, want in zip(port_report, jax_report):
        assert set(got) == set(want), got["suite"]
    # chip_smoke.py phase suites gates the card's report on these keys
    assert chip_smoke.SUITE_KEYS == {s["suite"]: set(s) for s in jax_report}
    by_suite = {s["suite"]: s for s in port_report}
    assert by_suite["batch_greedy"]["n"] == 2 and by_suite["batch_beam"]["n"] == 8
    assert by_suite["perturbed"]["n"] == 16 and by_suite["train_throughput"]["img_per_s"] > 0
    json.dumps(port_report)


def test_bench_main_writes_the_report(tmp_path, monkeypatch):
    """``molnextr-torch-bench --tiny`` parses its flags into ``run_all``."""
    seen = {}

    def fake_run_all(cfg, params, **kw):
        seen.update(kw, cfg=cfg, params=params)
        return [{"suite": "x", "n": kw["n"]}]

    monkeypatch.setattr(pb, "run_all", fake_run_all)
    out = tmp_path / "r.json"
    pb.main(["--tiny", "--n", "4", "--equal-n", "--rerank", "--beam_size", "3",
             "--device", "cpu", "--output", str(out), "--eval_csv", "a.csv"])
    assert json.loads(out.read_text()) == [{"suite": "x", "n": 4}]
    assert seen["cfg"].encoder.name == "swin_tiny_test" and seen["params"] is None
    assert (seen["equal_n"], seen["rerank"], seen["beam_size"], seen["device"],
            seen["eval_csvs"]) == (True, True, 3, "cpu", ["a.csv"])
