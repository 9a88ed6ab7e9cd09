"""The port's persistent build cache, the counterpart of the reference's
XLA compilation cache (``launch/cache.py``, DESIGN.md §13).

What a restarted port process would compile again is its kernel library:
``kernels.tt_contract.build()`` runs ``nvcc`` on ``kernels/csrc`` into
``<build dir>/<source hash>/libtt_kernels.so`` unless that file exists.
The build directory defaults to ``build/`` at the repository root (which
git ignores); :func:`enable_compile_cache` points it at a durable
directory, so that a second process with the same sources builds nothing.
The cold-start probe (``launch.serve --first-token``) checks exactly that
with :func:`cache_entries` (``--assert-cache-hits``).

Call it before the first kernel load: a process that has loaded its
library keeps it.  CUDA graphs cannot be persisted: every process captures
its own at their first use.
"""
from __future__ import annotations

import os
import pathlib

from repro_torch.kernels import tt_contract

ENV_VAR = "REPRO_COMPILE_CACHE"


def enable_compile_cache(path: str | None = None) -> str | None:
    """Build and load the kernel library under ``path`` (default:
    ``$REPRO_COMPILE_CACHE``; a no-op returning None when neither is set).
    Returns the directory in use.  Raises when this process already loaded
    its library from another directory."""
    path = path or os.environ.get(ENV_VAR)
    if not path:
        return None
    path = os.path.abspath(path)
    if tt_contract.library_loaded() and \
            pathlib.Path(path) != tt_contract.BUILD_DIR:
        raise RuntimeError(f"the kernel library was already loaded from "
                           f"{tt_contract.BUILD_DIR}: enable the build cache "
                           f"before the first kernel load")
    os.makedirs(path, exist_ok=True)
    tt_contract.BUILD_DIR = pathlib.Path(path)
    return path


def cache_entries(path: str | None) -> int:
    """The kernel libraries built under ``path`` (one per source hash).
    Unchanged across a run: that run built nothing."""
    if not path or not os.path.isdir(path):
        return 0
    return sum(1 for _ in pathlib.Path(path).glob(
        f"*/{tt_contract.LIBRARY_NAME}"))
