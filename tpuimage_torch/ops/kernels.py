"""Hand-written Hopper kernels: build, ctypes bindings, wrappers, counters.

The CUDA sources in ``tpuimage_torch/csrc`` are compiled at first use by
``nvcc -gencode arch=compute_90a,code=sm_90a`` into one shared library
with a plain C interface under ``tpuimage_torch/_build/`` (named by a
digest of the sources and flags, so an edited source rebuilds), then
loaded with ``ctypes``. Nothing is built or imported when this module is
imported.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output, and then:

- on a CPU tensor runs the kernel's plain PyTorch version (``*_ref``);
- on a CUDA tensor launches the kernel on the current stream, raises if
  the launcher reports a CUDA error, and adds one to its launch count.

There is no fallback from a failed build or launch to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# nvcc's output of the last build (ptxas register / shared-memory report)
build_log = ""

# kernel name -> launches since the last reset_launch_counts()
_launches: Dict[str, int] = {"hist256": 0, "hough_votes": 0}


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of tpuimage_torch cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build() -> Path:
    """Compile csrc/*.cu into the shared library (once per source digest)
    and return its path."""
    global build_log
    srcs = _sources()
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for s in sorted(CSRC.glob("*.cu*")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so = BUILD_DIR / f"libtpuimage_torch_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    build_log = r.stdout + r.stderr
    so.with_suffix(".log").write_text(build_log)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{build_log}")
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.tpuimage_hist256.argtypes = [p, p, ll, ll, p]
            lib.tpuimage_hist256.restype = i
            lib.tpuimage_hough_votes.argtypes = [p, p, p, p, p, p,
                                                 i, i, i, i, i, p]
            lib.tpuimage_hough_votes.restype = i
            _lib = lib
    return _lib


def _check(x: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _device_of(*xs: torch.Tensor) -> torch.device:
    devs = {x.device for x in xs}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


# ---------------------------------------------------------------------------
# hist256: (B, N) uint8 -> (B, 256) int32
# ---------------------------------------------------------------------------

def hist256_batch_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch 256-bin histograms of each row of a (B, N) uint8."""
    b = x.shape[0]
    off = torch.arange(b, device=x.device, dtype=torch.int64)[:, None] * 256
    flat = (x.to(torch.int64) + off).reshape(-1)
    return torch.bincount(flat, minlength=b * 256).reshape(b, 256).to(torch.int32)


def hist256_batch(x: torch.Tensor) -> torch.Tensor:
    """256-bin histograms of each row of a (B, N) uint8 tensor -> (B, 256)
    int32 exact counts (replaces tpuimage's ``hist256_batch_pallas``)."""
    _check(x, "hist256_batch", torch.uint8, 2)
    dev = _device_of(x)
    if dev.type == "cpu":
        return hist256_batch_ref(x)
    b, n = x.shape
    out = torch.zeros((b, 256), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.tpuimage_hist256(x.data_ptr(), out.data_ptr(), b, n,
                                  torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "hist256")
    _launches["hist256"] += 1
    return out


# ---------------------------------------------------------------------------
# hough_votes: per-image coordinate lists -> (B, numrho, T) int32
# ---------------------------------------------------------------------------

_REF_THETA_CHUNK = 30   # thetas per step of the plain version (bounds its memory)


def hough_votes_ref(xs: torch.Tensor, ys: torch.Tensor, counts: torch.Tensor,
                    cos_t: torch.Tensor, sin_t: torch.Tensor, numrho: int,
                    shift: int) -> torch.Tensor:
    """Plain PyTorch Hough votes: for image b, edge e < counts[b] and
    theta t, one vote at ``rint(fma(x, cos[t], f32(y*sin[t]))) + shift``.

    The fma is formed exactly: the f64 product of an integer coordinate
    and an f32 cosine is exact, so one f32 rounding of the f64 sum is the
    correctly rounded fma that tpuimage's XLA path computes."""
    b, k = xs.shape
    t = cos_t.shape[0]
    dev = xs.device
    valid = torch.arange(k, device=dev)[None, :] < counts.to(torch.int64)[:, None]
    x64 = xs.to(torch.float64)[:, :, None]
    yf = ys.to(torch.float32)[:, :, None]
    out = torch.zeros((b, t, numrho), dtype=torch.int64, device=dev)
    bvalid = valid[:, :, None]
    bidx = torch.arange(b, device=dev)[:, None, None]
    for t0 in range(0, t, _REF_THETA_CHUNK):
        t1 = min(t0 + _REF_THETA_CHUNK, t)
        c = cos_t[t0:t1].to(torch.float64)[None, None, :]
        ys_s = (yf * sin_t[t0:t1][None, None, :]).to(torch.float64)
        r = torch.round((x64 * c + ys_s).to(torch.float32)).to(torch.int64) + shift
        tj = torch.arange(t0, t1, device=dev)[None, None, :]
        flat = ((bidx * t + tj) * numrho + r).expand(b, k, t1 - t0)
        flat = flat[bvalid.expand(b, k, t1 - t0)]
        out.view(-1).index_add_(0, flat, torch.ones_like(flat))
    return out.transpose(1, 2).contiguous().to(torch.int32)


def hough_votes(xs: torch.Tensor, ys: torch.Tensor, counts: torch.Tensor,
                cos_t: torch.Tensor, sin_t: torch.Tensor, numrho: int,
                shift: int) -> torch.Tensor:
    """Hough vote accumulators (replaces tpuimage's ``hough_votes_pallas``).

    xs, ys: (B, K) int32 edge coordinates, the first counts[b] of row b
    valid; counts: (B,) int32; cos_t, sin_t: (T,) float32. Returns
    (B, numrho, T) int32 exact vote counts."""
    for name, a in (("xs", xs), ("ys", ys)):
        _check(a, name, torch.int32, 2)
    _check(counts, "counts", torch.int32, 1)
    _check(cos_t, "cos_t", torch.float32, 1)
    _check(sin_t, "sin_t", torch.float32, 1)
    if ys.shape != xs.shape or counts.shape[0] != xs.shape[0] \
            or sin_t.shape != cos_t.shape:
        raise ValueError("hough_votes: inconsistent shapes "
                         f"{tuple(xs.shape)} {tuple(ys.shape)} "
                         f"{tuple(counts.shape)} {tuple(cos_t.shape)}")
    dev = _device_of(xs, ys, counts, cos_t, sin_t)
    if dev.type == "cpu":
        return hough_votes_ref(xs, ys, counts, cos_t, sin_t, numrho, shift)
    b, k = xs.shape
    t = cos_t.shape[0]
    out = torch.empty((b, numrho, t), dtype=torch.int32, device=dev)
    if b == 0 or t == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.tpuimage_hough_votes(
            xs.data_ptr(), ys.data_ptr(), counts.data_ptr(), cos_t.data_ptr(),
            sin_t.data_ptr(), out.data_ptr(), b, k, numrho, t, shift,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "hough_votes")
    _launches["hough_votes"] += 1
    return out
