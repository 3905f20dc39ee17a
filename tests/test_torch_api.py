"""The port's public API on the CPU: the trained demo bundle against the JAX
package's tokens and SMILES (committed in ``molnextr_tpu_torch/fixtures``
and regenerated by ``test_torch_fixtures.py``), the device rules of the
entry points, and the rule that the port imports nothing of JAX.
"""

import ast
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from molnextr_tpu_torch.api import MolNexTR, MolNexTRSingleton, get_predictions
from molnextr_tpu_torch.chem import canonicalize_smiles
from molnextr_tpu_torch.checkpoint import load_model
from molnextr_tpu_torch.data.transforms import stack_gray_batch
from molnextr_tpu_torch.inference import InferenceEngine

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BUNDLE = os.path.join(ROOT, "examples", "demo_model")
FIXTURES = os.path.join(ROOT, "molnextr_tpu_torch", "fixtures")
# the port's scripts and walkthroughs beside the JAX package's
PORT_SCRIPTS = [os.path.join(ROOT, "scripts", "train_druglike_torch.py"),
                os.path.join(ROOT, "scripts", "prebuild_item_cache_torch.py"),
                os.path.join(ROOT, "scripts", "overfit_chiral_torch.py"),
                os.path.join(ROOT, "scripts", "ab_int8_suites_torch.py"),
                os.path.join(ROOT, "scripts", "diagnose_errors_torch.py"),
                os.path.join(ROOT, "scripts", "diagnose_chirality_torch.py"),
                os.path.join(ROOT, "scripts", "bench_decode_torch.py"),
                os.path.join(ROOT, "scripts", "flash_variants_torch.py"),
                os.path.join(ROOT, "scripts", "flash_probe_torch.py"),
                os.path.join(ROOT, "bench_torch.py"),
                os.path.join(ROOT, "examples", "predict_example_torch.py"),
                os.path.join(ROOT, "examples", "visualize_example_torch.py")]
PORT_FILES = [os.path.join(ROOT, "chip_smoke.py")] + PORT_SCRIPTS + [
    os.path.join(d, f)
    for d, _, files in os.walk(os.path.join(ROOT, "molnextr_tpu_torch"))
    for f in files if f.endswith(".py")
]
# pandas too: the port does not import it (the CLIs read CSV with the csv module)
FORBIDDEN = ("jax", "jaxlib", "flax", "cv2", "PIL", "msgpack", "molnextr_tpu", "pandas")


@pytest.fixture(scope="module")
def demo():
    with np.load(os.path.join(FIXTURES, "demo.npz")) as f:
        return f["images"], json.loads(str(f["meta"]))


def _demo_model(bf16: bool):
    cfg, params = load_model(BUNDLE)
    cfg.train.bf16 = bf16
    return MolNexTR(cfg=cfg, params=params, device="cpu", num_workers=1)


def test_demo_f32_tokens_and_smiles_identical_to_jax(demo):
    images, meta = demo
    model = _demo_model(bf16=False)
    batch = stack_gray_batch(list(images), model.transform)
    seq = model.engine.decode(model.engine._pad_to_pow2(batch))[0][: len(images)]
    assert seq.tolist() == meta["jax_f32"]["tokens"]
    smiles = [p["predicted_smiles"] for p in model.predict_images(list(images), batch_size=8)]
    assert smiles == meta["jax_f32"]["smiles"]


def test_demo_bf16_hits(demo):
    images, meta = demo
    preds = _demo_model(bf16=True).predict_images(
        list(images), return_atoms_bonds=True, return_confidence=True, batch_size=8
    )
    hits = sum(canonicalize_smiles(p["predicted_smiles"])[0] == canonicalize_smiles(g)[0]
               for p, g in zip(preds, meta["gold"]))
    assert hits >= 4, [p["predicted_smiles"] for p in preds]
    for p in preds:
        assert set(p) >= {"predicted_smiles", "predicted_molfile", "atom_sets", "bond_sets",
                          "confidence"}
        assert 0.0 <= p["confidence"] <= 1.0


def test_get_predictions_on_png(monkeypatch):
    monkeypatch.setenv("MOLNEXTR_MODEL_PATH", BUNDLE)
    MolNexTRSingleton.reset()
    try:
        res = get_predictions(os.path.join(FIXTURES, "demo_0.png"), atoms_bonds=True,
                              predicted_molfile=True, device="cpu")
    finally:
        MolNexTRSingleton.reset()
    assert canonicalize_smiles(res["predicted_smiles"])[0] == canonicalize_smiles("CC(C)O")[0]
    assert res["device_info"] == "CPU" and res["prediction_time_seconds"] > 0
    assert {"atom_sets", "bond_sets", "predicted_molfile"} <= set(res)
    with pytest.raises(FileNotFoundError):
        MolNexTRSingleton.get_instance(model_path=os.path.join(FIXTURES, "missing"), device="cpu")


def test_singleton_refuses_a_changed_device(monkeypatch):
    """The fault the port had: after a CPU call, a default-device call ran on
    the cached CPU instance and reported ``"CPU"``.  Now it raises, naming
    both devices; after ``reset()`` the default call needs CUDA."""
    monkeypatch.setenv("MOLNEXTR_MODEL_PATH", BUNDLE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    png = os.path.join(FIXTURES, "demo_0.png")
    MolNexTRSingleton.reset()
    try:
        res = get_predictions(png, device="cpu")
        assert res["device_info"] == "CPU"
        with pytest.raises(ValueError, match="cached model is on cpu.*requested cuda"):
            get_predictions(png)
        with pytest.raises(ValueError, match="cpu.*cuda:1"):
            MolNexTRSingleton.get_instance(device="cuda:1")
        assert MolNexTRSingleton.get_instance(device=torch.device("cpu")).device.type == "cpu"
        MolNexTRSingleton.reset()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_predictions(png)
    finally:
        MolNexTRSingleton.reset()


def test_kv_int8_override_and_unported_options(monkeypatch):
    monkeypatch.setenv("MOLNEXTR_KV_INT8", "0")
    model = _demo_model(bf16=False)
    assert not model.cfg.decoder.kv_int8
    cache = model.model.init_cache(model.engine.fmt, torch.zeros(1, 4, 192))
    assert cache["self_k"].dtype == torch.float32 and "self_k_scale" not in cache
    model.cfg.decode.rerank = "roundtrip"  # ported: runs, with nothing to rerank here
    out = model.predict_images([np.full((32, 32, 3), 255, np.uint8)])
    assert set(out[0]) == {"predicted_smiles", "predicted_molfile"}
    with pytest.raises(FileNotFoundError):  # a .pth path is read as a reference checkpoint
        MolNexTR(model_path="model.pth", device="cpu")


# ---------------------------------------------------------------------------
# device rules: CUDA by default, the CPU only when asked, nothing falls back
# ---------------------------------------------------------------------------


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params = load_model(BUNDLE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MolNexTR(model_path=BUNDLE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(cfg, {}, None)
    MolNexTRSingleton.reset()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_predictions(os.path.join(FIXTURES, "demo_0.png"))
    assert MolNexTRSingleton._instance is None
    with pytest.raises(ValueError):
        MolNexTR(model_path=BUNDLE, device="mps")


def test_entry_points_need_hopper(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda dev=None: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "A100")
    with pytest.raises(RuntimeError, match="sm_90a"):
        MolNexTR(model_path=BUNDLE)


def test_kernel_wrappers_never_fall_back():
    """A wrapper takes its plain version only because its tensor lies on the
    CPU: a tensor anywhere else goes to the kernel, and here, with no card,
    the launch is refused instead of running the plain version."""
    from molnextr_tpu_torch import ops
    from molnextr_tpu_torch.ops import swin_fused as sf

    da = importlib.import_module("molnextr_tpu_torch.ops.decode_attention")

    def meta(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype, device="meta")

    c, n = 32, 16
    calls = [
        lambda: sf.fused_window_attention(meta(1, 8, 8, c), meta(c, 3 * c), meta(3 * c),
                                          meta(c, c), meta(c), meta(c), meta(c), meta(2, n, n),
                                          None, 2, 4),
        lambda: sf.fused_ln_mlp(meta(8, c), meta(c), meta(c), meta(c, 4 * c), meta(4 * c),
                                meta(4 * c, c), meta(c)),
        lambda: da.decode_attention_layered(meta(1, 2, 16), meta(2, 1, 2, 128, 16),
                                            meta(2, 1, 2, 128, 16), 3, 1),
        lambda: da.decode_attention_layered_q8(
            meta(1, 2, 16), meta(2, 1, 2, 128, 16, dtype=torch.int8), meta(2, 1, 2, 128, 1),
            meta(2, 1, 2, 128, 16, dtype=torch.int8), meta(2, 1, 2, 128, 1), 3, 1),
        lambda: ops.decode_attention(meta(1, 2, 16), meta(1, 2, 128, 16), meta(1, 2, 128, 16), 3),
        lambda: ops.cached_decode_attention(meta(1, 2, 16), meta(1, 2, 100, 16),
                                            meta(1, 2, 100, 16), 3),
        lambda: ops.folded_decode_attention(meta(2, 64), meta(2, 2, 128, 64),
                                            meta(2, 2, 128, 64), 3, 1, 2),
        lambda: ops.folded_decode_attention_bb(meta(2, 64), meta(2, 2, 128, 64),
                                               meta(2, 2, 128, 64), 3, 1, 2, bb=2),
        lambda: ops.cached_folded_attention(meta(2, 64), meta(2, 2, 100, 64),
                                            meta(2, 2, 100, 64), 3, 1, 2),
    ]
    for call in calls:
        with pytest.raises((RuntimeError, AssertionError, ValueError)):
            call()


# ---------------------------------------------------------------------------
# imports: nothing of JAX, flax, OpenCV, msgpack or molnextr_tpu
# ---------------------------------------------------------------------------


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_port_sources_import_nothing_forbidden():
    assert len(PORT_FILES) > 30
    scanned = {os.path.relpath(p, ROOT) for p in PORT_FILES}
    for name in ("train/__init__.py", "train/losses.py", "train/state.py", "train/step.py",
                 "train/wire.py", "train/loop.py", "data/dataset.py", "data/transforms.py",
                 "checkpoint.py", "data/png.py", "predict.py", "evaluate_cli.py",
                 "benchmarks.py", "models/convnext.py", "models/danet.py", "utils.py",
                 "data/image.py", "data/exif.py", "data/jpeg.py", "data/tiff.py",
                 "data/ccitt.py", "data/reaction.py", "native.py", "build_dir.py",
                 "data/bmp.py", "data/pnm.py", "data/gif.py", "data/sunras.py", "data/hdr.py",
                 "train/druglike.py", "train/overfit_chiral.py", "diagnostics.py"):
        assert os.path.join("molnextr_tpu_torch", name) in scanned, name
    assert all(os.path.exists(p) for p in PORT_SCRIPTS)
    bad = [
        (os.path.relpath(p, ROOT), m)
        for p in PORT_FILES for m in _imported_modules(p)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_port_imports_with_forbidden_modules_blocked():
    """Import every module of the port and the bench scripts, draw a
    molecule and rerank against it, and run the demo bundle through it, in a
    process where importing any forbidden module fails."""
    code = f"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {FORBIDDEN!r}:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import molnextr_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(molnextr_tpu_torch.__path__, 'molnextr_tpu_torch.')]
for m in mods:
    importlib.import_module(m)
assert set(['molnextr_tpu_torch.train.loop', 'molnextr_tpu_torch.data.dataset',
            'molnextr_tpu_torch.checkpoint', 'molnextr_tpu_torch.predict',
            'molnextr_tpu_torch.evaluate_cli', 'molnextr_tpu_torch.benchmarks',
            'molnextr_tpu_torch.models.convnext', 'molnextr_tpu_torch.models.danet',
            'molnextr_tpu_torch.data.image', 'molnextr_tpu_torch.data.jpeg',
            'molnextr_tpu_torch.data.tiff', 'molnextr_tpu_torch.data.reaction',
            'molnextr_tpu_torch.native', 'molnextr_tpu_torch.data.bmp',
            'molnextr_tpu_torch.data.pnm', 'molnextr_tpu_torch.data.gif',
            'molnextr_tpu_torch.data.sunras', 'molnextr_tpu_torch.data.hdr',
            'molnextr_tpu_torch.train.druglike', 'molnextr_tpu_torch.build_dir']) <= set(mods)
import importlib.util
for path in {[p for p in PORT_SCRIPTS if "bench" in os.path.basename(p)]!r}:
    spec = importlib.util.spec_from_file_location(path.rsplit('/', 1)[-1][:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import torch
torch.set_num_threads(2)
from molnextr_tpu_torch.api import MolNexTR
from molnextr_tpu_torch.data.png import read_png
from molnextr_tpu_torch.data.synthetic import generate_synthetic_image
from molnextr_tpu_torch.rerank import roundtrip_rerank
img = generate_synthetic_image('CC(C)O', mol_augment=False, default_option=True, size=128)[0]
print(roundtrip_rerank(img, ['CCO', 'CC(C)O'])[0])
from molnextr_tpu_torch.data.reaction import generate_reaction_image
assert generate_reaction_image('CCO>>CC=O')[3]
m = MolNexTR(model_path={BUNDLE!r}, device='cpu', num_workers=1)
forms = [{os.path.join(FIXTURES, 'forms', 'demo_0_420.jpg')!r},
         {os.path.join(FIXTURES, 'forms', 'demo_0_g4.tif')!r}]
assert len(set(p['predicted_smiles'] for p in m.predict_image_files(forms))) == 1
print(m.predict_image_files([{os.path.join(FIXTURES, 'demo_0.png')!r}])[0]['predicted_smiles'])
print(len(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    winner, smiles, count = out.stdout.split()[-3:]
    assert int(count) > 30 and canonicalize_smiles(smiles)[0] == canonicalize_smiles("CC(C)O")[0]
    assert canonicalize_smiles(winner)[0] == canonicalize_smiles("CC(C)O")[0]
