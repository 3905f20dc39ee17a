"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``) and
loaded with :mod:`ctypes`.  Builds happen at first use, into
``ops/_build/<hash>/`` where the hash covers every source and the compiler
flags, so a changed source rebuilds and an unchanged one is reused.  All
sources are compiled together, one ``nvcc`` process each, started at once.

Nothing here falls back: a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# kernel library name -> C functions and their ctypes signatures
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "swin_fused": {
        "mnx_fused_window_attention": [_I] + [_P] * 12 + [_I] * 14 + [_P],
        "mnx_fused_ln_mlp": [_I] + [_P] * 9 + [_I] * 9 + [_P],
    },
    "decode_attention": {
        "mnx_decode_attention_layered": [_I, _I] + [_P] * 6 + [_I] * 9 + [_P],
    },
    "folded_attention": {
        "mnx_folded_decode_attention": [_I] + [_P] * 4 + [_I] * 9 + [_P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}  # library name -> nvcc's -Xptxas -v report


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        if fname.endswith((".cu", ".cuh")):
            h.update(fname.encode())
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build_all() -> float:
    """Compile every library that is not built yet; returns the seconds
    spent.  One nvcc per source, all running at once."""
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = None
    procs = {}
    for name in SIGNATURES:
        target = os.path.join(out_dir, f"lib{name}.so")
        if os.path.exists(target):
            continue
        nvcc = nvcc or find_nvcc()
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            target,
        )
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, target)
    return time.perf_counter() - t0


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all()
    path = os.path.join(BUILD_ROOT, _source_hash(), f"lib{name}.so")
    lib = ctypes.CDLL(path)
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
