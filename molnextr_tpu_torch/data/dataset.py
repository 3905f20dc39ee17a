"""Training/eval datasets and static-shape batching.

Port of ``molnextr_tpu/data/dataset.py``: ``TrainDataset`` builds one
tokenized example per sample (a synthetic render through
``data/synthetic.py``, or a PNG file through ``data/png.py``), the
augmenting transforms of ``data/transforms.py``, the labels of every format,
the edge matrix and the auxiliary heatmap's atom grid; ``pad_batch`` pads a
batch to static shapes on the uint8/int8 wire; ``DataLoader`` runs the
dataset inline, in a producer thread or in a process pool.

Random numbers: the transforms draw from the dataset's ``random.Random``
and ``np.random.RandomState`` instances (``rng``/``np_rng``, seeded from
``cfg.train.seed`` unless given).  The renderer, like the JAX package's,
draws from the module-level ``random`` and ``np.random``; pool workers seed
both, and their own instances, from the loader's seed.
"""

from __future__ import annotations

import hashlib
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import random
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.data.png import read_png
from molnextr_tpu_torch.data.synthetic import generate_synthetic_image
from molnextr_tpu_torch.data.transforms import Compose, get_transforms
from molnextr_tpu_torch.models.heads import heatmap_class_of
from molnextr_tpu_torch.tokenization import PAD_ID
from molnextr_tpu_torch.utils import FORMAT_INFO

EDGE_IGNORE = -100


@dataclass
class Sample:
    """One raw example: either a SMILES to render, or an image file."""

    smiles: str
    image_path: Optional[str] = None
    coords: Optional[np.ndarray] = None  # pre-labeled pseudo coords


def _normalize_keypoints(kps: np.ndarray, h: int, w: int) -> np.ndarray:
    out = kps.astype(np.float32).copy()
    out[:, 0] = np.clip(out[:, 0] / max(w, 1), 0, 1)
    out[:, 1] = np.clip(out[:, 1] / max(h, 1), 0, 1)
    return out


def read_image(path: str) -> np.ndarray:
    """RGB uint8 of an image file: a missing file is a white 256 x 256
    placeholder (as ``cv2.imread`` returning None is in the JAX package);
    a file that is not a PNG raises ``ValueError``."""
    if not os.path.exists(path):
        return np.full((256, 256, 3), 255, np.uint8)
    return read_png(path)


class TrainDataset:
    """Map-style dataset; ``__getitem__`` builds one fully tokenized example,
    or None when it cannot (``pad_batch`` drops those)."""

    def __init__(self, cfg: Config, samples: Sequence[Sample], tokenizers: Dict[str, Any],
                 split: str = "train", dynamic: bool = True,
                 rng: Optional[random.Random] = None,
                 np_rng: Optional[np.random.RandomState] = None):
        self.cfg = cfg
        self.samples = list(samples)
        self.tokenizers = tokenizers
        self.split = split
        self.dynamic = dynamic and split == "train"
        self.rng = random.Random(cfg.train.seed) if rng is None else rng
        self.np_rng = np.random.RandomState(cfg.train.seed) if np_rng is None else np_rng
        augment = cfg.data.augment and split == "train"
        clutter = cfg.data.clutter_augment and split == "train"
        self.transform: Compose = get_transforms(
            cfg.data.input_size, augment=augment, rotate=augment and cfg.data.rotate,
            dataset=cfg.data.dataset_name, normalize=False, clutter=clutter,
        )
        self.formats = [f for f in cfg.data.formats if f != "edges"]
        self.with_edges = "edges" in cfg.data.formats
        self._render_cache: Dict[int, Any] = {}
        # with no molecular or image augmentation and the default render
        # style, a built item is a pure function of its sample: cache it whole
        self._item_cacheable = (
            cfg.data.render_cache and self.dynamic and not augment and not clutter
            and not cfg.data.mol_augment and not cfg.data.shuffle_nodes
            and cfg.data.default_style and cfg.data.mask_ratio == 0.0
        )
        self._item_cache: Dict[int, Any] = {}

    def __len__(self) -> int:
        return len(self.samples)

    # -- persistent item cache --------------------------------------------
    def _cache_fingerprint(self) -> str:
        d = self.cfg.data
        key = "|".join(s.smiles or str(s.image_path) for s in self.samples)
        key += f"::{d.input_size}:{sorted(d.formats)}:{d.mask_ratio}"
        key += f":{d.continuous_coords}:{self.cfg.train.aux_heatmap_weight}"
        key += f":{self.cfg.train.aux_heatmap_stride}:{self.cfg.decoder.max_len}"
        # every flag that changes rendered pixels or labels is keyed
        key += f":{d.include_condensed}:{d.shuffle_nodes}:{d.default_style}"
        key += f":{d.mol_augment}:{d.augment}:{d.rotate}"
        return hashlib.sha1(key.encode()).hexdigest()

    def item_cache_complete(self) -> bool:
        return self._item_cacheable and len(self._item_cache) == len(self.samples)

    def save_item_cache(self, path: str) -> bool:
        """Write the fully populated item cache to ``path`` (pickle)."""
        if not self.item_cache_complete():
            return False
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"fingerprint": self._cache_fingerprint(), "items": self._item_cache},
                        f, protocol=5)
        os.replace(tmp, path)
        return True

    def load_item_cache(self, path: str) -> bool:
        """Adopt a cache this program saved, if it matches this corpus and
        config."""
        if not self._item_cacheable or not os.path.exists(path):
            return False
        try:
            with open(path, "rb") as f:
                blob = pickle.load(f)
        except (OSError, pickle.UnpicklingError, EOFError):
            return False
        if blob.get("fingerprint") != self._cache_fingerprint():
            return False
        items = blob.get("items")
        if not isinstance(items, dict) or len(items) != len(self.samples):
            return False
        self._item_cache = items
        return True

    def __getitem__(self, idx: int) -> Optional[Dict[str, Any]]:
        if self._item_cacheable:
            item = self._item_cache.get(idx)
            if item is not None:
                return item
        try:
            item = self._build(self.samples[idx], idx)
        except Exception:  # a sample that cannot be built is dropped, as in the JAX package
            return None
        if self._item_cacheable and item is not None:
            self._item_cache[idx] = item
            self._render_cache.pop(idx, None)
        return item

    def _render(self, idx: int, sample: Sample):
        """Synthetic render of sample ``idx``, cached with ``render_cache``."""
        if self.cfg.data.render_cache:
            cached = self._render_cache.get(idx)
            if cached is not None:
                return cached
        rendered = generate_synthetic_image(
            sample.smiles, mol_augment=self.cfg.data.mol_augment,
            default_option=self.cfg.data.default_style,
            shuffle_nodes=self.cfg.data.shuffle_nodes,
            include_condensed=self.cfg.data.include_condensed, size=self.cfg.data.input_size,
        )
        if self.cfg.data.render_cache:
            img, smiles, graph, ok = rendered
            if ok and graph:
                graph = {
                    "coords": np.asarray(graph["coords"], np.float32),
                    "symbols": tuple(graph["symbols"]),
                    "edges": np.asarray(graph["edges"], np.int8),
                    "num_atoms": int(graph.get("num_atoms", len(graph["symbols"]))),
                }
                rendered = (img, smiles, graph, ok)
            self._render_cache[idx] = rendered
        return rendered

    def _atom_grid(self, coords01, symbols, img_size: int) -> np.ndarray:
        """Per-cell class grid of the auxiliary heatmap: -1 no atom, -2 an
        unlabeled sample, else a ``HEATMAP_ELEMENTS`` class (the last atom
        in a cell wins)."""
        g = img_size // self.cfg.train.aux_heatmap_stride
        if coords01 is None or symbols is None:
            return np.full((g, g), -2, np.int8)
        grid = np.full((g, g), -1, np.int8)
        for (x, y), sym in zip(np.asarray(coords01), symbols):
            if not (0.0 <= x <= 1.0 and 0.0 <= y <= 1.0):
                continue
            grid[min(int(y * g), g - 1), min(int(x * g), g - 1)] = heatmap_class_of(sym)
        return grid

    def _build(self, sample: Sample, idx: int = -1) -> Optional[Dict[str, Any]]:
        if self.dynamic and sample.image_path is None:
            img, smiles, graph, ok = self._render(idx, sample)
            if not ok or not graph:
                return None
            if self.cfg.data.render_cache:
                img = img.copy()  # the noise transforms must not write into the cache
            keypoints = np.asarray(graph["coords"], np.float32)
            symbols = graph["symbols"]
            edges = graph["edges"]
        else:
            if sample.image_path is None:
                return None
            img = read_image(sample.image_path)
            smiles = sample.smiles
            if sample.coords is not None:
                keypoints = np.asarray(sample.coords, np.float32).copy()
                h, w = img.shape[:2]
                keypoints[:, 0] *= w
                keypoints[:, 1] *= h
            else:
                keypoints = np.zeros((0, 2), np.float32)
            symbols = None
            edges = None

        out = self.transform(image=img, keypoints=keypoints, rng=self.rng, np_rng=self.np_rng)
        image = out["image"]
        if image.dtype != np.uint8:
            image = image.astype(np.float32)
        kps = out["keypoints"]
        h, w = image.shape[:2]
        coords01 = _normalize_keypoints(kps, h, w) if len(kps) else None

        item: Dict[str, Any] = {"image": image, "smiles": smiles}
        if self.cfg.train.aux_heatmap_weight > 0:
            item["atom_grid"] = self._atom_grid(coords01, symbols, h)
        for fmt in self.formats:
            tok = self.tokenizers[fmt]
            max_len = min(FORMAT_INFO[fmt]["max_len"], self.cfg.decoder.max_len)
            # samples without coordinate labels train with fully masked
            # coordinate slots
            mask_ratio = self.cfg.data.mask_ratio if coords01 is not None else 1.0
            labels, indices = tok.smiles_to_sequence(smiles, coords01, mask_ratio=mask_ratio)
            item[fmt] = labels[:max_len]
            item[f"{fmt}_indices"] = [i for i in indices if i < max_len]
        if self.cfg.data.continuous_coords:
            item["coords"] = coords01 if coords01 is not None else np.zeros((0, 2), np.float32)
        if self.with_edges and edges is not None:
            item["edges"] = np.asarray(edges, np.int8)
        return item


def aux_train_dataset(cfg: Config, synthetic_samples: Sequence[Sample],
                      aux_samples: Sequence[Sample], tokenizers: Dict[str, Any]) -> TrainDataset:
    """Synthetic renders plus real images with pre-labeled coordinates."""
    return TrainDataset(cfg, list(synthetic_samples) + list(aux_samples), tokenizers,
                        split="train")


def pad_batch(items: List[Optional[Dict[str, Any]]], formats: Sequence[str], max_len: int,
              max_atoms: int) -> Dict[str, Any]:
    """Static-shape collate: labels padded to ``max_len``, atom indices,
    edges and coordinates to ``max_atoms``; a 3-channel uint8 batch ships
    one grey channel, edges and the atom grid ship as int8."""
    items = [x for x in items if x is not None]
    if not items:
        return {}
    b = len(items)
    img = np.stack([x["image"] for x in items])
    if img.dtype == np.uint8 and img.ndim == 4 and img.shape[-1] == 3:
        img = np.ascontiguousarray(img[..., :1])
    refs: Dict[str, Any] = {}
    primary = None
    for fmt in formats:
        if fmt == "edges":
            continue
        labels = np.full((b, max_len), PAD_ID, np.int32)
        for i, x in enumerate(items):
            seq = x[fmt][:max_len]
            labels[i, : len(seq)] = seq
        refs[fmt] = labels
        if fmt in ("chartok_coords", "atomtok_coords"):
            primary = fmt
    indices = np.zeros((b, max_atoms), np.int32)
    num_atoms = np.zeros((b,), np.int32)
    if primary is not None:
        for i, x in enumerate(items):
            idxs = x.get(f"{primary}_indices", [])[:max_atoms]
            indices[i, : len(idxs)] = idxs
            num_atoms[i] = len(idxs)
    refs["atom_indices"] = indices
    refs["num_atoms"] = num_atoms
    if any("coords" in x for x in items):
        coords = np.full((b, max_atoms, 2), -1.0, np.float32)
        for i, x in enumerate(items):
            c = x.get("coords")
            if c is not None and len(c):
                kk = min(len(c), max_atoms)
                coords[i, :kk] = c[:kk]
        refs["coords"] = coords
    if all("atom_grid" in x for x in items):
        refs["atom_grid"] = np.stack([x["atom_grid"] for x in items])
    if "edges" in formats:
        edges = np.full((b, max_atoms, max_atoms), EDGE_IGNORE, np.int8)
        for i, x in enumerate(items):
            e = x.get("edges")
            if e is None:
                continue
            k = min(e.shape[0], max_atoms, int(num_atoms[i]) or e.shape[0])
            edges[i, :k, :k] = e[:k, :k]
        refs["edges"] = edges
    return {"images": img, "refs": refs, "smiles": [x["smiles"] for x in items]}


# -- process-pool workers -------------------------------------------------------

_WORKER: Dict[str, TrainDataset] = {}


def _worker_init(cfg_json: str, samples: List[Sample], split: str, seed: int) -> None:
    from molnextr_tpu_torch.tokenization import get_tokenizer

    s = (seed + os.getpid()) % 2**31
    random.seed(s)  # the renderer's generators
    np.random.seed(s)
    cfg = Config.from_json(cfg_json)
    _WORKER["ds"] = TrainDataset(cfg, samples, get_tokenizer(cfg.data), split=split,
                                 rng=random.Random(s), np_rng=np.random.RandomState(s))


def _worker_get(idx: int):
    return _WORKER["ds"][idx]


class DataLoader:
    """Batches over a ``TrainDataset``: ``num_workers=0`` builds them in a
    thread (``prefetch > 0``) or inline, ``num_workers > 0`` in a process
    pool started with ``spawn``."""

    def __init__(self, dataset: TrainDataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 0, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        cfg = dataset.cfg
        fmt = next(f for f in cfg.data.formats if f != "edges")
        self.max_len = min(FORMAT_INFO[fmt]["max_len"], cfg.decoder.max_len)
        self.max_atoms = cfg.data.max_atoms

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> List[int]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        return order

    def _chunks(self, order: List[int]) -> List[List[int]]:
        chunks = [order[s : s + self.batch_size] for s in range(0, len(order), self.batch_size)]
        if self.drop_last:
            chunks = [c for c in chunks if len(c) == self.batch_size]
        return chunks

    def _collate(self, items) -> Dict[str, Any]:
        return pad_batch(items, self.dataset.cfg.data.formats, self.max_len, self.max_atoms)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        chunks = self._chunks(self._order())
        if self.num_workers > 0:
            yield from self._iter_pool(chunks)
        elif self.prefetch > 0:
            yield from self._iter_threaded(chunks)
        else:
            for chunk in chunks:
                batch = self._collate([self.dataset[i] for i in chunk])
                if batch:
                    yield batch

    def _iter_threaded(self, chunks) -> Iterator[Dict[str, Any]]:
        """A producer thread renders and transforms the next batches (numpy
        releases the interpreter lock) while the caller runs its step."""
        stop = threading.Event()
        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(self.prefetch, 1))
        errors: List[Exception] = []

        def producer():
            try:
                for chunk in chunks:
                    if stop.is_set():
                        return
                    batch = self._collate([self.dataset[i] for i in chunk])
                    if batch:
                        q.put(batch)
            except Exception as e:  # handed to the consumer, which re-raises
                errors.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                yield batch
        finally:
            stop.set()
            while True:  # drain so a blocked producer sees the stop flag
                try:
                    q.get_nowait()
                except queue_mod.Empty:
                    break
            t.join(timeout=30)
        if errors:
            raise errors[0]

    def _iter_pool(self, chunks) -> Iterator[Dict[str, Any]]:
        ds = self.dataset
        ctx = mp.get_context("spawn")
        with ctx.Pool(self.num_workers, initializer=_worker_init,
                      initargs=(ds.cfg.to_json(), ds.samples, ds.split,
                                self.seed + self.epoch)) as pool:
            it = iter(chunks)
            inflight = []
            for _ in range(max(self.prefetch, 1)):
                chunk = next(it, None)
                if chunk is not None:
                    inflight.append(pool.map_async(_worker_get, chunk))
            while inflight:
                res = inflight.pop(0)
                chunk = next(it, None)
                if chunk is not None:
                    inflight.append(pool.map_async(_worker_get, chunk))
                batch = self._collate(res.get())
                if batch:
                    yield batch
