"""Where the built kernel library is kept (the counterpart of
``lyssandra_tpu.utils.compile_cache``, which turns on JAX's persistent
compilation cache).

The port compiles its CUDA kernels once per source state into one shared
library, named by a hash of the sources and flags, under a directory that
outlives the process: ``lyssandra_tpu_torch/_build/`` by default.
``enable_compile_cache`` points that directory elsewhere, for example at a
disk shared between runs.  Call it before the first kernel launch: a
library already loaded stays the one in use.
"""

from __future__ import annotations

import os
from pathlib import Path

from lyssandra_tpu_torch import _build


def enable_compile_cache(path: str | None = None) -> str:
    """Build and look up the kernel library under ``path`` (created if
    missing; default ``lyssandra_tpu_torch/_build``).  Returns the
    resolved path."""
    target = Path(os.path.expanduser(path)) if path else _build.DEFAULT_DIR
    target = target.resolve()
    target.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = target
    return str(target)


def cache_enabled() -> bool:
    """True when ``enable_compile_cache`` has set a directory other than
    the default (which caches the library too)."""
    return _build.BUILD_DIR.resolve() != _build.DEFAULT_DIR.resolve()
