"""Public inference API of the PyTorch port.

Port of ``molnextr_tpu/api.py``: :class:`MolNexTR` (alias
:data:`molnextr`) with ``predict_image(s)``, ``predict_image_files`` and
``predict_final_results``; :class:`MolNexTRSingleton`; and
:func:`get_predictions`, returning the same result-dict schema
(predicted_smiles, atom_sets, bond_sets, predicted_molfile, device_info,
prediction_time_seconds).

Everything runs on ``device="cuda"`` (an H100-class, compute capability 9.x
card) unless the caller passes ``device="cpu"``.  Nothing falls back: no
device probe picks another device, and a failed prediction raises.
``model_path`` is a bundle directory or the reference's ``.pth``
checkpoint (read by ``convert.load_torch_checkpoint``).  With
``cfg.decode.rerank == "roundtrip"`` the predictions pass the round-trip
rerank of :mod:`molnextr_tpu_torch.rerank`, on the host.  Not ported yet:
the checkpoint's download (the singleton only looks in its cache).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.utils import logger

# Bond class names, index-aligned with the 7-way edge head.
BOND_TYPES = [
    "",
    "single",
    "double",
    "triple",
    "aromatic",
    "solid wedge",
    "dashed wedge",
]


class MolNexTR:
    """End-to-end image -> molecule predictor."""

    def __init__(self, model_path: Optional[str] = None, cfg: Optional[Config] = None,
                 params=None, device="cuda", num_workers: int = 16):
        from molnextr_tpu_torch.checkpoint import load_model
        from molnextr_tpu_torch.convert import load_torch_checkpoint
        from molnextr_tpu_torch.data.transforms import get_transforms
        from molnextr_tpu_torch.inference import InferenceEngine, resolve_device
        from molnextr_tpu_torch.models.model import MolNexTRModel
        from molnextr_tpu_torch.tokenization import get_tokenizer
        from molnextr_tpu_torch.weights import load_flax_params, seeded_flax_params

        device = resolve_device(device)
        if model_path is not None:
            if model_path.endswith((".pth", ".pt")):
                cfg, params = load_torch_checkpoint(model_path, cfg)
            else:
                cfg, params = load_model(model_path)
        if cfg is None:
            raise ValueError("need model_path or (cfg, params)")
        kv8 = os.environ.get("MOLNEXTR_KV_INT8", "")
        if kv8 in ("0", "1"):
            # runtime-only decode option: "0" selects the dense cache
            cfg.decoder = dataclasses.replace(cfg.decoder, kv_int8=kv8 == "1")
        self.cfg = cfg
        self.num_workers = num_workers
        self.tokenizers = get_tokenizer(cfg.data)
        vocab_sizes = {f: len(t) for f, t in self.tokenizers.items()}
        if params is None:
            # no bundle: seeded random weights, for smoke runs
            params = seeded_flax_params(cfg, vocab_sizes, seed=0)
        model = load_flax_params(MolNexTRModel(cfg, vocab_sizes), params)
        model.to_dtype(torch.bfloat16 if cfg.train.bf16 else torch.float32)
        self.model = model
        self.transform = get_transforms(cfg.data.input_size, augment=False, rotate=False,
                                        normalize=False)
        self.engine = InferenceEngine(cfg, self.tokenizers, model, device=device)

    @property
    def device(self) -> torch.device:
        return self.engine.device

    # -- prediction -------------------------------------------------------
    def predict_images(
        self,
        input_images: List[np.ndarray],
        return_atoms_bonds: bool = False,
        return_confidence: bool = False,
        batch_size: int = 16,
    ) -> List[Dict[str, Any]]:
        from molnextr_tpu_torch.chem.graph import convert_graph_to_smiles
        from molnextr_tpu_torch.data.transforms import stack_gray_batch

        predictions: List[Dict[str, Any]] = []
        for start in range(0, len(input_images), batch_size):
            batch = stack_gray_batch(input_images[start : start + batch_size], self.transform)
            predictions += self.engine.predict_images(batch, compute_confidence=return_confidence)

        fmt = self.engine.fmt
        node_coords = [p[fmt]["coords"] for p in predictions]
        node_symbols = [p[fmt]["symbols"] for p in predictions]
        edges = [p["edges"] for p in predictions]
        smiles_list, molblock_list, _ = convert_graph_to_smiles(
            node_coords, node_symbols, edges,
            images=input_images, num_workers=self.num_workers,
        )

        if self.cfg.decode.rerank == "roundtrip":
            # round-trip verification (rerank.py): candidates are the graph
            # view (rank 0), the raw token view and any beam n-best strings;
            # a challenger replaces rank 0 only when its re-render
            # confidently matches the input's ink
            from molnextr_tpu_torch.rerank import roundtrip_rerank, smiles_to_molblock

            for i, pred in enumerate(predictions):
                cands = [smiles_list[i], pred[fmt]["smiles"]]
                cands += [b["smiles"] for b in pred.get("beams", [])]
                winner, _ = roundtrip_rerank(input_images[i], cands)
                if winner is not None:
                    smiles_list[i] = winner
                    molblock_list[i] = smiles_to_molblock(winner)

        outputs: List[Dict[str, Any]] = []
        for smiles, molfile, pred in zip(smiles_list, molblock_list, predictions):
            d: Dict[str, Any] = {
                "predicted_smiles": smiles,
                "predicted_molfile": molfile,
            }
            if return_atoms_bonds:
                coords = pred[fmt]["coords"]
                symbols = pred[fmt]["symbols"]
                atom_list = []
                for i, (symbol, coord) in enumerate(zip(symbols, coords)):
                    ad = {
                        "atom_number": f"{i}",
                        "atom_symbol": symbol,
                        "coords": (round(coord[0], 3), round(coord[1], 3)),
                    }
                    if return_confidence:
                        ad["confidence"] = pred[fmt]["atom_scores"][i]
                    atom_list.append(ad)
                d["atom_sets"] = atom_list
                bond_list = []
                # the edge head scores at most min(len(indices), max_atoms)
                # atoms; a malformed decode can emit more symbols than
                # scored atoms, so the loop is bounded by the matrix
                n = min(len(symbols), len(pred.get("edges", [])))
                for i in range(n - 1):
                    for j in range(i + 1, n):
                        bt = int(pred["edges"][i][j])
                        if bt != 0:
                            bd = {
                                "atom_number": f"{i}",
                                "bond_type": BOND_TYPES[bt],
                                "endpoints": (i, j),
                            }
                            if return_confidence:
                                bd["confidence"] = pred["edge_scores"][i][j]
                            bond_list.append(bd)
                d["bond_sets"] = bond_list
            if return_confidence:
                d["confidence"] = pred.get("overall_score")
            outputs.append(d)
        return outputs

    def predict_image(self, image, return_atoms_bonds=False, return_confidence=False):
        return self.predict_images(
            [image], return_atoms_bonds=return_atoms_bonds,
            return_confidence=return_confidence,
        )[0]

    def predict_image_files(self, image_files: List[str], return_atoms_bonds=False,
                            return_confidence=False, batch_size: int = 16):
        from molnextr_tpu_torch.data.image import imread

        images = []
        for path in image_files:
            image = imread(path)
            if image is None:  # cv2.imread's None in the JAX package
                raise FileNotFoundError(path)
            images.append(image)
        return self.predict_images(
            images,
            return_atoms_bonds=return_atoms_bonds,
            return_confidence=return_confidence, batch_size=batch_size,
        )

    def predict_final_results(self, image_file: str, return_atoms_bonds=False,
                              return_confidence=False):
        return self.predict_image_files(
            [image_file], return_atoms_bonds=return_atoms_bonds,
            return_confidence=return_confidence,
        )[0]


# alias matching the reference class name
molnextr = MolNexTR


class MolNexTRSingleton:
    """Process-wide cached model on one device.

    The model comes from ``model_path`` or ``$MOLNEXTR_MODEL_PATH`` (a
    bundle directory or a ``.pth``), else from the released checkpoint at
    ``<cache_dir()>/molnextr_best.pth`` when that file is present; without
    any it is initialized with seeded random weights, as the JAX singleton
    initializes random ones.  The checkpoint's download is not ported.
    """

    _instance: Optional[MolNexTR] = None
    _device_name: str = "unknown"

    @classmethod
    def cache_dir(cls) -> str:
        """Checkpoint cache directory: ``$MOLNEXTR_CACHE``, else
        ``~/.data/molnextr`` (the reference's pystow layout)."""
        return os.environ.get(
            "MOLNEXTR_CACHE", os.path.join(os.path.expanduser("~"), ".data", "molnextr")
        )

    @classmethod
    def get_instance(cls, model_path: Optional[str] = None, device="cuda") -> MolNexTR:
        if cls._instance is None:
            if model_path is not None and not os.path.exists(model_path):
                raise FileNotFoundError(f"model_path does not exist: {model_path}")
            path = model_path or os.environ.get("MOLNEXTR_MODEL_PATH")
            cached = os.path.join(cls.cache_dir(), "molnextr_best.pth")
            if not (path and os.path.exists(path)) and os.path.exists(cached):
                path = cached
            if path and os.path.exists(path):
                logger.info(f"loading model from {path}")
                inst = MolNexTR(model_path=path, device=device)
            else:
                logger.warning(
                    f"no model bundle and no checkpoint at {cached}; initializing seeded "
                    "random weights (set MOLNEXTR_MODEL_PATH for real predictions)"
                )
                inst = MolNexTR(cfg=Config(), device=device)
            dev = inst.device
            cls._device_name = (
                f"CUDA ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else "CPU"
            )
            logger.info(f"using device: {cls._device_name}")
            cls._instance = inst
        return cls._instance

    @classmethod
    def get_device(cls):
        return cls._device_name

    @classmethod
    def reset(cls):
        cls._instance = None


def get_predictions(
    imagepath: str,
    atoms_bonds: bool = False,
    smiles: bool = True,
    predicted_molfile: bool = False,
    device="cuda",
) -> Dict[str, Any]:
    """One-call prediction API on a PNG file."""
    t0 = time.perf_counter()
    model = MolNexTRSingleton.get_instance(device=device)
    predictions = model.predict_final_results(imagepath, return_atoms_bonds=atoms_bonds)
    result: Dict[str, Any] = {}
    if smiles:
        result["predicted_smiles"] = predictions["predicted_smiles"]
    if atoms_bonds:
        result["atom_sets"] = predictions["atom_sets"]
        result["bond_sets"] = predictions["bond_sets"]
    if predicted_molfile:
        result["predicted_molfile"] = predictions["predicted_molfile"]
    result["device_info"] = MolNexTRSingleton.get_device()
    result["prediction_time_seconds"] = time.perf_counter() - t0
    if not (smiles or atoms_bonds or predicted_molfile):
        return predictions
    return result
