"""Native (C++) host-side helpers, loaded via ctypes: the quad fit's
contour walk, segment rasterizer and convex hull (``contours.cpp``), the Haar
cascade's level evaluator (``haar.cpp``) and the PNG reader's row
reconstruction (``png.cpp``).

The sources are built at first use with ``g++ -O3 -shared`` into one
library in ``BUILD_DIR`` (``tpuimage_torch/_build/`` unless
``runtime.cache`` points it elsewhere; named by a digest of the sources
and flags); every consumer keeps a pure-numpy fallback, so the package
works where no compiler is present.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRCS = [Path(__file__).resolve().parent / name
         for name in ("contours.cpp", "haar.cpp", "png.cpp")]
# read when the library is built; runtime.cache may point it elsewhere first
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def _flags() -> list:
    """No -ffast-math and no FMA contraction: plain IEEE double ops, as the
    numpy fallbacks compute. -mavx2 where the CPU has it enables haar.cpp's
    4-window path, whose lanes are IEEE ops like the scalar ones."""
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]
    try:
        with open("/proc/cpuinfo") as f:
            if " avx2 " in f.read().replace("\n", " "):
                flags.append("-mavx2")
    except OSError:
        pass
    return flags

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _build() -> Optional[Path]:
    flags = _flags()
    digest = hashlib.sha1(" ".join(flags).encode()
                          + b"".join(src.read_bytes() for src in _SRCS)).hexdigest()[:16]
    so = BUILD_DIR / f"libtpuimage_torch_host_{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run(["g++", *flags, *map(str, _SRCS), "-o", str(tmp)],
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
            f64p = ctypes.POINTER(ctypes.c_double)
            lib.tpuimage_hull.restype = i64
            lib.tpuimage_hull.argtypes = [f64p, i64, f64p]
            i32p, f32p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
            lib.tpuimage_haar_level.restype = i64
            lib.tpuimage_haar_level.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), i64, i64, i64, i64, i64,
                i32p, f32p, i32p, f32p, f32p, f32p, i32p, i64,
                i32p, ctypes.POINTER(ctypes.c_double), i32p, i64]
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.tpuimage_png_unfilter.restype = None
            lib.tpuimage_png_unfilter.argtypes = [u8p, u8p, i64, i64, i64, u8p]
            _lib = lib
    return _lib
