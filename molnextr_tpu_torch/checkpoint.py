"""Model bundles: ``config.json`` + ``params.msgpack`` read without flax or
the msgpack package.

Port of ``molnextr_tpu/checkpoint.py::load_model``.  The bundle's
parameters were written by ``flax.serialization.to_bytes``: msgpack maps of
str keys whose leaves are ext type 1 (an ndarray packed as the msgpack
tuple ``(shape, dtype name, raw C-order bytes)``) or ext type 3 (a numpy
scalar, packed the same way).  :func:`msgpack_restore` decodes exactly that
subset (plus flax's chunked-array dicts for leaves over 1 GiB) into numpy.
As in the JAX package, float16 leaves are promoted to float32 and the
decode knobs ``kv_int8``, ``unroll`` and ``rerank`` are reset to the
current defaults on load.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Tuple

import numpy as np

from molnextr_tpu_torch.config import Config, DecodeConfig, DecoderConfig

MODEL_CONFIG = "config.json"
MODEL_PARAMS = "params.msgpack"

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
