"""Model bundles and train snapshots, without flax or the msgpack package.

Port of ``molnextr_tpu/checkpoint.py``.

* A **model bundle** is a directory with ``config.json`` and
  ``params.msgpack``, the bytes ``flax.serialization.to_bytes`` writes:
  msgpack maps of str keys (sorted, as the JAX package's ``tree_map`` leaves
  them) whose leaves are ext type 1 (an ndarray packed as the msgpack tuple
  ``(shape, dtype name, raw C-order bytes)``) or ext type 3 (a numpy scalar,
  packed the same way).  :func:`msgpack_restore` decodes that subset (plus
  flax's chunked-array dicts for leaves over 1 GiB) and :func:`msgpack_dumps`
  writes it, so each package reads the other's bundles.  As in the JAX
  package, float16 leaves are promoted to float32 and the decode knobs
  ``kv_int8``, ``unroll`` and ``rerank`` are reset to the current defaults
  on load.
* A **train snapshot** (``CheckpointManager``) is a bundle plus
  ``train_meta.json`` (step, epoch, score) and ``opt_state.pt``, the port's
  own optimizer state (``torch.save``; read back with ``weights_only``), with
  the best/all/last retention, the rolling ``ckpt_last`` and the atomic
  ``.tmp``/``.old`` swap of the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from molnextr_tpu_torch.config import Config, DecodeConfig, DecoderConfig

MODEL_CONFIG = "config.json"
MODEL_PARAMS = "params.msgpack"
BEST_SCORES = "best_valid.json"
OPT_STATE = "opt_state.pt"
TRAIN_META = "train_meta.json"

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return self.take(self.unpack("BHI"[b - 0xC4]))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack("BHI"[b - 0xC7])
            return self._ext(self.unpack("b"), self.take(n))
        if b == 0xCA:
            return self.unpack("f")
        if b == 0xCB:
            return self.unpack("d")
        if 0xCC <= b <= 0xCF:
            return self.unpack("BHIQ"[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return self.unpack("bhiq"[b - 0xD0])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack("b")
            return self._ext(code, self.take(1 << (b - 0xD4)))
        if b in (0xD9, 0xDA, 0xDB):
            return self.take(self.unpack("BHI"[b - 0xD9])).decode("utf-8")
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack("HI"[b - 0xDC]))]
        if b in (0xDE, 0xDF):
            return self._map(self.unpack("HI"[b - 0xDE]))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    @staticmethod
    def _ext(code: int, payload: bytes) -> Any:
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        inner = _Reader(payload)
        shape, name, buf = inner.value()
        if isinstance(name, bytes):
            name = name.decode()
        if name == "bfloat16":  # no numpy dtype: widen the top 16 bits to f32
            bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
            arr = bits.view(np.float32).reshape(shape)
        else:
            arr = np.frombuffer(buf, np.dtype(name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """Decode flax-serialized msgpack bytes into a tree of numpy arrays."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError("msgpack: trailing bytes after the top-level object")
    return _unchunk(tree)


def _promote_f16(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _promote_f16(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype == np.float16:
        return tree.astype(np.float32)
    return tree


# -- writer ---------------------------------------------------------------------

_MAX_LEAF_BYTES = 1 << 30  # flax chunks larger leaves; the port writes none


def _pack_uint(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    for code, fmt, limit in ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16), (0xCE, "I", 1 << 32)):
        if n < limit:
            return bytes([code]) + struct.pack(">" + fmt, n)
    return b"\xcf" + struct.pack(">Q", n)


def _pack_sized(n: int, fix: Optional[Tuple[int, int]], codes: Tuple[int, int, int]) -> bytes:
    """The header of a str/bin/map of length ``n``: fix form when it fits."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, limit in zip(codes, "BHI", (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(">" + fmt, n)
    raise ValueError("msgpack: object too large")


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _pack_sized(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + b


def _pack_ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixed[n]]) if n in fixed else _pack_sized(n, None, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code)


def _pack_ndarray(arr: np.ndarray, out: List[bytes]) -> None:
    if arr.nbytes > _MAX_LEAF_BYTES:
        raise ValueError("msgpack: leaves over 1 GiB are not written")
    data = np.ascontiguousarray(arr).tobytes("C")
    out.append(_pack_sized(3, (0x90, 16), (None, 0xDC, 0xDD)))
    out.append(_pack_sized(arr.ndim, (0x90, 16), (None, 0xDC, 0xDD)))
    out.extend(_pack_uint(d) for d in arr.shape)
    out.append(_pack_str(arr.dtype.name))
    out.append(_pack_sized(len(data), None, (0xC4, 0xC5, 0xC6)))
    out.append(data)


def _pack(tree: Any, out: List[bytes]) -> None:
    if isinstance(tree, dict):
        out.append(_pack_sized(len(tree), (0x80, 16), (None, 0xDE, 0xDF)))
        for k in sorted(tree):
            out.append(_pack_str(str(k)))
            _pack(tree[k], out)
    elif isinstance(tree, (np.ndarray, np.generic)):
        payload: List[bytes] = []
        _pack_ndarray(np.asarray(tree), payload)
        code = _EXT_NPSCALAR if isinstance(tree, np.generic) else _EXT_NDARRAY
        out.append(_pack_ext_header(code, sum(len(b) for b in payload)))
        out.extend(payload)
    else:
        raise TypeError(f"msgpack: cannot write {type(tree).__name__}")


def msgpack_dumps(tree: Dict[str, Any]) -> bytes:
    """A nested dict of numpy arrays -> the bytes ``flax.serialization.to_bytes``
    writes for it after the JAX package's ``tree_map(np.asarray, ...)``."""
    out: List[bytes] = []
    _pack(tree, out)
    return b"".join(out)


def save_model(path: str, cfg: Config, params) -> str:
    """Write a model bundle; ``params`` is a flax-layout tree of arrays or a
    port model (``weights.model_to_flax_params``)."""
    if isinstance(params, torch.nn.Module):
        from molnextr_tpu_torch.weights import model_to_flax_params

        params = model_to_flax_params(params)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, MODEL_CONFIG), "w") as f:
        f.write(cfg.to_json())
    with open(os.path.join(path, MODEL_PARAMS), "wb") as f:
        f.write(msgpack_dumps(_as_numpy(params)))
    return path


def _as_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def load_model(path: str) -> Tuple[Config, Any]:
    """Read a bundle directory -> (Config, numpy parameter tree)."""
    with open(os.path.join(path, MODEL_CONFIG)) as f:
        cfg = Config.from_json(f.read())
    with open(os.path.join(path, MODEL_PARAMS), "rb") as f:
        params = _promote_f16(msgpack_restore(f.read()))
    # decode knobs are runtime choices, not part of the saved model
    cfg.decoder.kv_int8 = DecoderConfig.kv_int8
    cfg.decode.unroll = DecodeConfig.unroll
    cfg.decode.rerank = DecodeConfig.rerank
    return cfg, params


# -- train snapshots ---------------------------------------------------------------


class CheckpointManager:
    """best/all/last retention over train snapshots of a ``train.state.TrainState``."""

    def __init__(self, save_path: str, mode: str = "best"):
        if mode not in ("best", "all", "last"):
            raise ValueError(f"save mode must be best, all or last, got {mode!r}")
        self.save_path = save_path
        self.mode = mode
        os.makedirs(save_path, exist_ok=True)
        self._best: Optional[float] = None
        p = os.path.join(save_path, BEST_SCORES)
        if os.path.exists(p):
            with open(p) as f:
                self._best = json.load(f).get("best_score")

    def _snapshot_dir(self, tag: str) -> str:
        return os.path.join(self.save_path, f"ckpt_{tag}")

    def save(self, cfg: Config, state, epoch: int, score: Optional[float] = None) -> Optional[str]:
        """Snapshot by policy; returns the path written, or None.  ``best``
        also keeps a rolling ``ckpt_last``, written every epoch, of which
        ``ckpt_best`` is a copy on improving epochs."""
        is_best = score is not None and (self._best is None or score > self._best)
        if self.mode == "best":
            last = self._snapshot_dir("last")
            self._write_snapshot(last, cfg, state, epoch, score)
            if not is_best:
                return None
            path = self._snapshot_dir("best")
            if os.path.exists(path):
                shutil.rmtree(path)
            shutil.copytree(last, path)
        else:
            path = self._snapshot_dir(f"ep{epoch}" if self.mode == "all" else "last")
            self._write_snapshot(path, cfg, state, epoch, score)
        if is_best:
            self._best = score
            with open(os.path.join(self.save_path, BEST_SCORES), "w") as f:
                json.dump({"best_score": score, "epoch": epoch}, f)
        return path

    def _write_snapshot(self, path: str, cfg: Config, state, epoch: int,
                        score: Optional[float]) -> None:
        """Stage in ``path + '.tmp'``, then swap in by renames, so a kill at
        any point leaves the old or the new snapshot whole."""
        from molnextr_tpu_torch.weights import model_to_flax_params

        params = model_to_flax_params(state.model)
        opt = {k: v.detach().cpu() if torch.is_tensor(v) else v
               for k, v in state.optimizer.state_dict().items()}
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        save_model(tmp, cfg, params)
        with open(os.path.join(tmp, TRAIN_META), "w") as f:
            json.dump({"step": int(state.step), "epoch": epoch, "score": score}, f)
        torch.save(opt, os.path.join(tmp, OPT_STATE))
        old = path + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(tmp, path)
        if os.path.exists(old):
            shutil.rmtree(old)

    def restore(self, state, tag: str = "best"):
        """Load snapshot ``tag`` into ``state`` (parameters, optimizer state,
        step) -> (state, meta).  Every file is read and checked before
        ``state`` changes, so a snapshot that fails leaves it as it was."""
        from molnextr_tpu_torch.weights import check_flax_params, load_flax_params

        path = self._snapshot_dir(tag)
        _cfg, params = load_model(path)
        opt = torch.load(os.path.join(path, OPT_STATE), map_location="cpu", weights_only=True)
        with open(os.path.join(path, TRAIN_META)) as f:
            meta = json.load(f)
        step = int(meta["step"])
        check_flax_params(state.model, params)
        state.optimizer.check_state_dict(opt)
        load_flax_params(state.model, params)
        state.optimizer.load_state_dict(opt)
        state.step = step
        return state, meta
