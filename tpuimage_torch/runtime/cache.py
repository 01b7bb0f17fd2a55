"""Where the compiled libraries are kept (counterpart of
``tpuimage.runtime.cache``).

tpuimage's cache keeps XLA's compiled programs across processes. The
port's compiled artefacts are the two libraries it builds at first use:
the CUDA kernels' (``ops.kernels.build``, nvcc) and the host library's
(``native``, g++). Both are named by a digest of their sources and flags
and are built into ``tpuimage_torch/_build/`` unless this module points
them elsewhere; each build reads its directory when it builds. The CLIs
call :func:`maybe_enable_compile_cache`, which acts only when
``TPUIMAGE_XLA_CACHE`` is set (to a directory, or to ``1`` for
``~/.cache/tpuimage-torch-build``), so a deployment's environment carries
over from tpuimage unchanged; the library never turns it on by itself.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

DEFAULT_DIR = "~/.cache/tpuimage-torch-build"


def enable_compile_cache(cache_dir: Optional[str] = None) -> str:
    """Build and load both libraries in ``cache_dir`` (created if missing),
    so later processes reuse them. Must run before the first build: once a
    library is loaded it raises RuntimeError."""
    from tpuimage_torch import native
    from tpuimage_torch.ops import kernels

    if kernels._lib is not None or native._lib is not None:
        raise RuntimeError("enable_compile_cache must run before the first build: "
                           "a compiled library is already loaded")
    cache_dir = os.path.expanduser(cache_dir or DEFAULT_DIR)
    os.makedirs(cache_dir, exist_ok=True)
    kernels.BUILD_DIR = Path(cache_dir)
    native.BUILD_DIR = Path(cache_dir)
    return cache_dir


def maybe_enable_compile_cache() -> Optional[str]:
    """Honor ``TPUIMAGE_XLA_CACHE`` (unset/empty/0 = off; 1 = default
    location; anything else = explicit directory)."""
    val = os.environ.get("TPUIMAGE_XLA_CACHE", "")
    if val in ("", "0"):
        return None
    return enable_compile_cache(None if val == "1" else val)
