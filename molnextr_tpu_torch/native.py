"""The native substructure matcher: ``native_src/matcher.cpp`` through ctypes.

``chem/match.py::find_substructures`` calls :func:`find_substructures_native`
on the synthetic-data hot loop (the abbreviation collapse matches about 165
patterns a sample).  It returns the matches of the Python search, in the
same order.

The library is built at first use with ``g++ -O3 -std=c++17 -fPIC
-shared`` into ``<root>/<hash>/``, the hash covering the source and the
flags, where ``<root>`` is ``native_src/_build`` unless ``build_dir.py``
picks ``$MOLNEXTR_BUILD_DIR`` or the per-user cache; it is written under a temporary name and renamed into
place, so processes of a spawn pool that start the build together do not
clobber each other.  ``MOLNEXTR_NO_NATIVE=1`` (the JAX package's switch)
selects the Python search.  A failed build or load raises, with the
compiler's output: nothing falls back quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, List, Optional

import numpy as np

from molnextr_tpu_torch.build_dir import build_root

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native_src")
BUILD_ROOT = os.path.join(SRC_DIR, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
LIB_NAME = "libmolnextr_native.so"

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_SYMBOLS: Dict[str, int] = {}  # atom symbol -> id passed to the C side


def enabled() -> bool:
    """False when ``MOLNEXTR_NO_NATIVE`` is set (to anything but empty)."""
    return not os.environ.get("MOLNEXTR_NO_NATIVE")


def build(src: str = os.path.join(SRC_DIR, "matcher.cpp"), root: Optional[str] = None) -> str:
    """Compile ``src`` unless its library is built; returns the library's path.
    ``root`` defaults to :func:`build_dir.build_root`'s choice."""
    if root is None:
        root = build_root(BUILD_ROOT, "native")
    with open(src, "rb") as f:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + f.read()).hexdigest()[:16]
    target = os.path.join(root, digest, LIB_NAME)
    if os.path.exists(target):
        return target
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, src]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"the native matcher cannot be built ({' '.join(cmd)}): {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src}:\n{proc.stderr}")
    os.replace(tmp, target)
    return target


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.mnx_find_substructures.restype = ctypes.c_int
    return lib


def get_lib() -> ctypes.CDLL:
    """The matcher's library, built and loaded on first use."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = load(build())
    return _LIB


def _symbol_id(symbol: str) -> int:
    sid = _SYMBOLS.get(symbol)
    if sid is None:
        sid = _SYMBOLS[symbol] = len(_SYMBOLS) + 1
    return sid


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _graph_arrays(mol) -> Dict:
    """A Mol as the C side's CSR arrays, neighbours in ``Mol.neighbors``
    order; cached on the Mol under (atoms, live bonds)."""
    n = mol.num_atoms()
    key = (n, len(mol.bonds) - mol.bonds.count(None))
    cached = getattr(mol, "_native_arrays", None)
    if cached is not None and cached["key"] == key:
        return cached
    cols = np.zeros((6, n), np.int32)
    for i, a in enumerate(mol.atoms):
        cols[:, i] = (_symbol_id(a.symbol), a.charge, 1 if a.aromatic else 0, a.explicit_h,
                      mol.total_h(i), 1 if a.alias else 0)
    off, nbr, order = [0], [], []
    for i in range(n):
        for b in mol.bonds_of(i):
            nbr.append(b.other(i))
            order.append(b.order)
        off.append(len(nbr))
    arrays = {"key": key, "n": n, "cols": cols,
              "off": np.asarray(off, np.int32), "nbr": np.asarray(nbr or [0], np.int32),
              "ord": np.asarray(order or [0], np.int32)}
    # the rows of ``cols`` are views into it, which the dict keeps alive
    arrays["ptrs"] = tuple(_ptr(cols[k]) for k in range(6)) + tuple(
        _ptr(arrays[k]) for k in ("off", "nbr", "ord"))
    mol._native_arrays = arrays
    return arrays


def find_substructures_native(mol, pattern, attachment_free: Optional[Dict[int, int]] = None,
                              max_matches: int = 64) -> List[Dict[int, int]]:
    """``find_substructures``' search in C++ (same matches, same order)."""
    lib = get_lib()
    g, p = _graph_arrays(mol), _graph_arrays(pattern)
    np_ = p["n"]
    if np_ == 0 or np_ > g["n"]:
        return []
    free = attachment_free or {}
    af = (ctypes.c_int32 * np_)(*[free.get(k, 0) for k in range(np_)])
    out = (ctypes.c_int32 * (max_matches * np_))()
    found = lib.mnx_find_substructures(g["n"], *g["ptrs"], np_, *p["ptrs"], af, out, max_matches)
    flat = out[: found * np_]
    return [dict(enumerate(flat[m * np_ : (m + 1) * np_])) for m in range(found)]
