"""Where the port writes what it compiles at first use: the native matcher
(``native.py``) and the CUDA kernels (``ops/_build.py``).

:func:`build_root` picks, in this order:

1. ``$MOLNEXTR_BUILD_DIR/<name>`` when ``MOLNEXTR_BUILD_DIR`` is set;
2. the module's own directory inside the package (``default``) when it can
   be created and written, as in a checkout or a user's site-packages;
3. ``$XDG_CACHE_HOME/molnextr_tpu_torch/<name>``, else
   ``~/.cache/molnextr_tpu_torch/<name>``, for a package that sits where its
   user cannot write (a system site-packages, a read-only image layer).

It raises ``RuntimeError`` naming every directory it tried when none can be
written.  The choice changes only where a library lands: the same sources
are built with the same flags, under the same hash keys.
"""

from __future__ import annotations

import os
from typing import List


def _writable(path: str) -> bool:
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return False
    return os.access(path, os.W_OK | os.X_OK)


def _user_cache_dir() -> str:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(base, "molnextr_tpu_torch")


def build_root(default: str, name: str) -> str:
    """The directory that builds of ``name`` go under (module doc)."""
    override = os.environ.get("MOLNEXTR_BUILD_DIR")
    tried: List[str] = []
    candidates = ([os.path.join(override, name)] if override
                  else [default, os.path.join(_user_cache_dir(), name)])
    for path in candidates:
        if _writable(path):
            return path
        tried.append(path)
    raise RuntimeError(f"no writable build directory for {name}: tried {', '.join(tried)}; "
                       "set MOLNEXTR_BUILD_DIR to a directory you can write")
