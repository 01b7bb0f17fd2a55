"""Native (C++) host-side helpers of the quad fit, loaded via ctypes.

``contours.cpp`` is built at first use with ``g++ -O3 -shared`` into
``tpuimage_torch/_build/`` (named by a digest of the source and flags);
every consumer keeps a pure-numpy fallback, so the package works where
no compiler is present.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "contours.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# no -ffast-math and no FMA contraction: plain IEEE double ops, as the
# numpy fallbacks compute
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _build() -> Optional[Path]:
    digest = hashlib.sha1(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD_DIR / f"libtpuimage_torch_host_{digest}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                           capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0:
        return None
    os.replace(tmp, so)
    return so


def load_native() -> Optional[ctypes.CDLL]:
    """The loaded library, built if needed; None when it cannot be built
    (consumers then take their numpy fallbacks)."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is None and not _failed:
            so = _build()
            if so is None:
                _failed = True
                return None
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:     # built elsewhere, not loadable here
                _failed = True
                return None
            i64, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
            lib.tpuimage_trace_contours.restype = i64
            lib.tpuimage_trace_contours.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), i64, i64, p64, i64, p64, i64]
            lib.tpuimage_draw_segments.restype = None
            lib.tpuimage_draw_segments.argtypes = [
                ctypes.POINTER(ctypes.c_double), i64,
                ctypes.POINTER(ctypes.c_uint8), i64, i64, ctypes.c_double]
            _lib = lib
    return _lib
