"""Hand-written Hopper kernels: build, ctypes bindings, wrappers, counters.

The CUDA sources in ``tpuimage_torch/csrc`` are compiled at first use by
``nvcc -gencode arch=compute_90a,code=sm_90a``, one nvcc process per
source, all started together, and linked into one shared library with a
plain C interface under ``tpuimage_torch/_build/`` (named by a digest of
the sources and flags, so an edited source rebuilds), then loaded with
``ctypes``. Nothing is built or imported when this module is imported.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output, and then:

- on a CPU tensor runs the kernel's plain PyTorch version (``*_ref``);
- on a CUDA tensor launches the kernel on the current stream, raises if
  the launcher reports a CUDA error, and adds one to its launch count.

There is no fallback from a failed build or launch to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from tpuimage_torch.core.borders import pad2d
from tpuimage_torch.core.dtypes import descale, saturate_u8
from tpuimage_torch.ops.arith import divide_u8, max_u8, subtract_u8
from tpuimage_torch.ops.filters import (gaussian_blur_u8_plain, gaussian_kernel_q8,
                                        get_gaussian_kernel)
from tpuimage_torch.ops.morphology import (MORPH_RECT, dilate, erode, morph_blackhat_plain,
                                           morph_close, structuring_element)
from tpuimage_torch.ops.threshold import adaptive_threshold, threshold_binary

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# nvcc's output of the last build (ptxas register / shared-memory report)
build_log = ""

# kernel name -> launches since the last reset_launch_counts(); read and
# written under _lock, since scan_stream launches kernels from its worker
# threads too
_launches: Dict[str, int] = {"hist256": 0, "hough_votes": 0, "rgb_to_lab": 0,
                             "clahe_apply": 0, "gray_erode3": 0,
                             "binary_close3": 0, "gaussian_blur_u8": 0,
                             "gauss_chain": 0, "blackhat_rect": 0,
                             "inkmask_weighted": 0, "bilateral": 0,
                             "rank_extract": 0}


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        for k in _launches:
            _launches[k] = 0


def _count(name: str) -> None:
    with _lock:
        _launches[name] += 1


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
    and return its path. Each source gets its own nvcc process; all run
    at once, then one more links the objects."""
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
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    procs = []
    try:
        for s, o in zip(srcs, objs):
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = [], []
        for s, p in zip(srcs, procs):
            out, _ = p.communicate(timeout=_NVCC_TIMEOUT_S)
            logs.append(f"== nvcc {s.name}\n{out}")
            if p.returncode != 0:
                failed.append(s.name)
        if not failed:
            r = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                               capture_output=True, text=True, timeout=_NVCC_TIMEOUT_S)
            logs.append(f"== nvcc -shared\n{r.stdout}{r.stderr}")
            if r.returncode != 0:
                failed.append("link")
        build_log = "\n".join(logs)
        so.with_suffix(".log").write_text(build_log)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
        os.replace(tmp, so)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
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
            lib.tpuimage_rgb_to_lab.argtypes = [p, p, p, ll, p]
            lib.tpuimage_rgb_to_lab.restype = i
            lib.tpuimage_clahe_apply.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
            lib.tpuimage_clahe_apply.restype = i
            lib.tpuimage_gray_erode3.argtypes = [p, p, p, i, i, i, p]
            lib.tpuimage_gray_erode3.restype = i
            lib.tpuimage_binary_close3.argtypes = [p, p, p, p, i, i, i, p]
            lib.tpuimage_binary_close3.restype = i
            lib.tpuimage_gauss_sep.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
            lib.tpuimage_gauss_sep.restype = i
            lib.tpuimage_gauss_sep_scratch.argtypes = [i, i, i, i]
            lib.tpuimage_gauss_sep_scratch.restype = ll
            lib.tpuimage_divide_table.argtypes = [p, p]
            lib.tpuimage_divide_table.restype = i
            lib.tpuimage_blackhat_rect.argtypes = [p, p, p, i, i, i, i, i, p]
            lib.tpuimage_blackhat_rect.restype = i
            lib.tpuimage_blackhat_rect_scratch.argtypes = [i, i, i, i, i]
            lib.tpuimage_blackhat_rect_scratch.restype = ll
            lib.tpuimage_inkmask_weighted.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
            lib.tpuimage_inkmask_weighted.restype = i
            lib.tpuimage_inkmask_scratch.argtypes = [i, i, i, i]
            lib.tpuimage_inkmask_scratch.restype = ll
            lib.tpuimage_bilateral.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
            lib.tpuimage_bilateral.restype = i
            lib.tpuimage_rank_extract.argtypes = [p, p, p, ll, ll, ll, ll, ll, ll, ll, ll, i, p]
            lib.tpuimage_rank_extract.restype = i
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


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


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
    if b == 0 or n == 0:
        return torch.zeros((b, 256), dtype=torch.int32, device=dev)
    out = torch.empty((b, 256), dtype=torch.int32, device=dev)   # the kernel writes every count
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.tpuimage_hist256(x.data_ptr(), out.data_ptr(), b, n, _stream(dev))
    _raise_on(rc, "hist256")
    _count("hist256")
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
            sin_t.data_ptr(), out.data_ptr(), b, k, numrho, t, shift, _stream(dev))
    _raise_on(rc, "hough_votes")
    _count("hough_votes")
    return out


# ---------------------------------------------------------------------------
# rgb_to_lab: (..., 3) uint8 RGB -> (..., 3) uint8 Lab
# ---------------------------------------------------------------------------

LAB_GAMMA_N = 256      # sRGB gamma table entries
LAB_CBRT_N = 3072      # cube-root table entries
LAB_TABLES_LEN = LAB_GAMMA_N + LAB_CBRT_N + 9
_LAB_SHIFT, _LAB_SHIFT2 = 12, 15
_LAB_L_SCALE = (116 * 255 + 50) // 100
_LAB_L_SHIFT = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)


def pack_lab_tables(gamma: np.ndarray, cbrt: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """The one int32 table the kernel and its plain version take: gamma
    (256) | cube root (3072) | the 3x3 fixed-point sRGB -> XYZ
    coefficients, row-major."""
    if gamma.shape != (LAB_GAMMA_N,) or cbrt.shape != (LAB_CBRT_N,) or coeffs.shape != (3, 3):
        raise ValueError("pack_lab_tables: expected (256,), (3072,) and (3, 3)")
    return np.concatenate([gamma, cbrt, coeffs.reshape(-1)]).astype(np.int32)


def rgb_to_lab_ref(img: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch OpenCV 8-bit RGB -> Lab: the gather form of tpuimage's
    XLA path; ``tables`` as :func:`pack_lab_tables` lays it out."""
    gamma = tables[:LAB_GAMMA_N]
    cbrt = tables[LAB_GAMMA_N:LAB_GAMMA_N + LAB_CBRT_N]
    coef = tables[LAB_GAMMA_N + LAB_CBRT_N:].tolist()
    r, g, b = (gamma[img[..., c].to(torch.int64)] for c in range(3))

    def fchan(row):
        idx = descale(r * coef[3 * row] + g * coef[3 * row + 1]
                      + b * coef[3 * row + 2], _LAB_SHIFT)
        return cbrt[idx.clamp(0, LAB_CBRT_N - 1).to(torch.int64)]

    fx, fy, fz = fchan(0), fchan(1), fchan(2)
    lum = descale(_LAB_L_SCALE * fy + _LAB_L_SHIFT, _LAB_SHIFT2)
    a = descale(500 * (fx - fy) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    bb = descale(200 * (fy - fz) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    return saturate_u8(torch.stack([lum, a, bb], dim=-1))


def rgb_to_lab(img: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """OpenCV 8-bit Lab of a (..., 3) uint8 RGB tensor (replaces
    tpuimage's ``rgb_to_lab_pallas``); ``tables`` as
    :func:`pack_lab_tables` lays it out, on the same device."""
    if img.dtype != torch.uint8:
        raise TypeError(f"rgb_to_lab: expected torch.uint8, got {img.dtype}")
    if img.dim() < 1 or img.shape[-1] != 3:
        raise ValueError(f"rgb_to_lab: expected (..., 3), got {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("rgb_to_lab: tensor must be contiguous")
    _check(tables, "tables", torch.int32, 1)
    if tables.shape[0] != LAB_TABLES_LEN:
        raise ValueError(f"tables: expected {LAB_TABLES_LEN} entries, got {tables.shape[0]}")
    dev = _device_of(img, tables)
    if dev.type == "cpu":
        return rgb_to_lab_ref(img, tables)
    out = torch.empty_like(img)
    n_pix = img.numel() // 3
    if n_pix == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.tpuimage_rgb_to_lab(img.data_ptr(), out.data_ptr(),
                                     tables.data_ptr(), n_pix, _stream(dev))
    _raise_on(rc, "rgb_to_lab")
    _count("rgb_to_lab")
    return out


# ---------------------------------------------------------------------------
# clahe_apply: (B, H, W) uint8 + per-image tile LUTs -> (B, H, W) uint8
# ---------------------------------------------------------------------------

def _blend_pairs(m: torch.Tensor):
    """Rows of a (n, T) blend matrix -> the first tile with a nonzero
    weight, the next tile (the same one at the last tile), and their
    weights, the second 0 where both are the same tile (the kernel's
    ``blend_pair``)."""
    n_t = m.shape[1]
    cols = torch.arange(n_t, device=m.device).expand_as(m)
    t1 = torch.where(m != 0, cols, torch.full_like(cols, n_t)).amin(dim=1)
    t1 = torch.where(t1 == n_t, torch.zeros_like(t1), t1)
    t2 = (t1 + 1).clamp(max=n_t - 1)
    w1 = m.gather(1, t1[:, None])[:, 0]
    w2 = torch.where(t2 != t1, m.gather(1, t2[:, None])[:, 0], torch.zeros_like(w1))
    return t1, t2, w1, w2


def clahe_apply_ref(gray: torch.Tensor, luts: torch.Tensor, R: torch.Tensor,
                    C: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch CLAHE apply: each pixel blends its four tile LUT
    values in f32, rows (R) first and then columns (C), each product and
    sum rounded on its own, then cvRound and clamp."""
    b, h, w = gray.shape
    tx = luts.shape[2]
    r1, r2, wr1, wr2 = _blend_pairs(R)
    c1, c2, wc1, wc2 = _blend_pairs(C.t())
    flat = luts.reshape(b, -1).to(torch.float32)
    v = gray.to(torch.int64).reshape(b, -1)

    def lut(rt, ct):
        base = ((rt[:, None] * tx + ct[None, :]) * 256).reshape(1, -1)
        return flat.gather(1, base + v).reshape(b, h, w)

    wr1, wr2 = wr1[:, None], wr2[:, None]
    in1 = lut(r1, c1) * wr1 + lut(r2, c1) * wr2
    in2 = lut(r1, c2) * wr1 + lut(r2, c2) * wr2
    return saturate_u8(in1 * wc1 + in2 * wc2)


def clahe_apply(gray: torch.Tensor, luts: torch.Tensor, R: torch.Tensor,
                C: torch.Tensor) -> torch.Tensor:
    """CLAHE apply (replaces tpuimage's ``clahe_apply_pallas``).

    gray: (B, H, W) uint8; luts: (B, ty, tx, 256) uint8 tile LUTs; R:
    (H, ty) and C: (tx, W) float32 blend matrices (``clahe_blend_matrix``).
    Returns (B, H, W) uint8."""
    _check(gray, "gray", torch.uint8, 3)
    _check(luts, "luts", torch.uint8, 4)
    _check(R, "R", torch.float32, 2)
    _check(C, "C", torch.float32, 2)
    b, h, w = gray.shape
    ty, tx = luts.shape[1], luts.shape[2]
    if luts.shape != (b, ty, tx, 256) or R.shape != (h, ty) or C.shape != (tx, w):
        raise ValueError("clahe_apply: inconsistent shapes "
                         f"{tuple(gray.shape)} {tuple(luts.shape)} "
                         f"{tuple(R.shape)} {tuple(C.shape)}")
    dev = _device_of(gray, luts, R, C)
    if dev.type == "cpu":
        return clahe_apply_ref(gray, luts, R, C)
    if luts.data_ptr() % 16:
        raise ValueError("clahe_apply: luts must be 16-byte aligned")
    out = torch.empty_like(gray)
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.tpuimage_clahe_apply(gray.data_ptr(), luts.data_ptr(), R.data_ptr(),
                                      C.data_ptr(), out.data_ptr(), b, h, w, ty, tx,
                                      _stream(dev))
    _raise_on(rc, "clahe_apply")
    _count("clahe_apply")
    return out


# ---------------------------------------------------------------------------
# morph_seq stencils: gray_erode3 and binary_close3 on (B, H, W) planes
# ---------------------------------------------------------------------------

_SE3 = structuring_element(MORPH_RECT, 3)


def gray_erode3_ref(rgb: torch.Tensor):
    """Plain PyTorch ``rgb_to_gray`` and its 3x3 rect erosion."""
    from tpuimage_torch.ops.color import rgb_to_gray
    gray = rgb_to_gray(rgb)
    return gray, erode(gray, _SE3)


def gray_erode3(rgb: torch.Tensor):
    """(B, H, W, 3) uint8 RGB -> (gray, eroded), both (B, H, W) uint8:
    morph_seq steps 1-2 (replaces tpuimage's ``gray_erode3_pallas``)."""
    _check(rgb, "rgb", torch.uint8, 4)
    if rgb.shape[-1] != 3:
        raise ValueError(f"gray_erode3: expected (B, H, W, 3), got {tuple(rgb.shape)}")
    dev = _device_of(rgb)
    if dev.type == "cpu":
        return gray_erode3_ref(rgb)
    b, h, w, _ = rgb.shape
    gray = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    eroded = torch.empty_like(gray)
    if gray.numel() == 0:
        return gray, eroded
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.tpuimage_gray_erode3(rgb.data_ptr(), gray.data_ptr(), eroded.data_ptr(),
                                      b, h, w, _stream(dev))
    _raise_on(rc, "gray_erode3")
    _count("gray_erode3")
    return gray, eroded


def binary_close3_ref(eroded: torch.Tensor, thresh: torch.Tensor):
    """Plain PyTorch ``threshold_binary`` (strict >) and its 3x3 rect
    closing."""
    binary = threshold_binary(eroded, thresh[:, None, None])
    return binary, morph_close(binary, _SE3)


def binary_close3(eroded: torch.Tensor, thresh: torch.Tensor):
    """(B, H, W) uint8 and (B,) float32 thresholds -> (binary, closed),
    both (B, H, W) uint8: morph_seq steps 3-4 (replaces tpuimage's
    ``binary_close3_pallas``)."""
    _check(eroded, "eroded", torch.uint8, 3)
    _check(thresh, "thresh", torch.float32, 1)
    if thresh.shape[0] != eroded.shape[0]:
        raise ValueError(f"binary_close3: {thresh.shape[0]} thresholds for "
                         f"{eroded.shape[0]} planes")
    dev = _device_of(eroded, thresh)
    if dev.type == "cpu":
        return binary_close3_ref(eroded, thresh)
    b, h, w = eroded.shape
    binary = torch.empty_like(eroded)
    closed = torch.empty_like(eroded)
    if binary.numel() == 0:
        return binary, closed
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.tpuimage_binary_close3(eroded.data_ptr(), thresh.data_ptr(),
                                        binary.data_ptr(), closed.data_ptr(),
                                        b, h, w, _stream(dev))
    _raise_on(rc, "binary_close3")
    _count("binary_close3")
    return binary, closed


# ---------------------------------------------------------------------------
# the post-warp chain on (B, H, W) uint8 planes: gaussian_blur_u8 and
# gauss_chain (one CUDA template, csrc/gauss_sep.cu), blackhat_rect and
# inkmask_weighted. Each kernel has a tiled form and, for windows too wide
# for a block's shared memory, a split form that passes through device
# scratch; the C side says how many bytes of it a call needs.
# ---------------------------------------------------------------------------

GAUSS_CHAIN_MODES = ("divide", "subtract", "sub", "adaptive")
_GAUSS_MODE_IDS = {"none": 0, "divide": 1, "subtract": 2, "sub": 3, "adaptive": 4}
_SE_INK = structuring_element(MORPH_RECT, (2, 2))


def _scratch(dev: torch.device, nbytes: int) -> Optional[int]:
    """The address of ``nbytes`` of device scratch for a split form, or
    None (a null pointer) for the tiled form. The caching allocator keeps
    the buffer in stream order, so it may be dropped once launched."""
    return torch.empty(nbytes, dtype=torch.uint8, device=dev).data_ptr() if nbytes else None


def q8_taps_are_weights(taps: np.ndarray) -> bool:
    """Whether the Gaussian kernels may take these Q8.8 taps: >= 0 and
    summing to 256. Then every partial sum of both passes is an integer of
    at most 255 * 65536 < 2**24 (exact in f32 in any order), a row sum fits
    16 bits, and a tap that does not fit a byte is 256 with every other tap
    0, which the tensor-core form treats as the shift it is."""
    return bool(taps.min() >= 0 and int(taps.sum()) == 256)


@functools.lru_cache(maxsize=None)
def _gauss_taps(ksize: int, sigma: float, kind: str, device: str) -> torch.Tensor:
    """The kernel's taps on ``device``, made once per (ksize, sigma, kind,
    device): OpenCV's Q8.8 integers (``kind="q8"``) or the f32 taps of
    the adaptive mean (``"f32"``), so a call copies nothing to the card."""
    if kind == "q8":
        taps = gaussian_kernel_q8(ksize, sigma).astype(np.int32)
        if not q8_taps_are_weights(taps):
            raise ValueError(f"gaussian taps (ksize {ksize}, sigma {sigma}) are not "
                             "non-negative Q8.8 weights summing to 256")
        return torch.from_numpy(taps).to(device)
    taps = get_gaussian_kernel(ksize, sigma).astype(np.float32)
    if not np.array_equal(taps, taps[::-1]):
        raise ValueError("the adaptive mean's taps must be symmetric")
    return torch.from_numpy(taps).to(device)


def _check_ksize(name: str, ksize: int) -> None:
    if not (ksize >= 1 and ksize % 2 == 1):
        raise ValueError(f"{name}: ksize must be odd and positive, got {ksize}")


def _gauss_launch(name: str, x: torch.Tensor, ksize: int, sigma: float, mode: str,
                  idelta: int) -> torch.Tensor:
    dev = x.device
    b, h, w = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    taps = _gauss_taps(ksize, float(sigma), "f32" if mode == "adaptive" else "q8", str(dev))
    lib = _load()
    with torch.cuda.device(dev):
        scratch = _scratch(dev, lib.tpuimage_gauss_sep_scratch(b, h, w, ksize))
        rc = lib.tpuimage_gauss_sep(x.data_ptr(), taps.data_ptr(), out.data_ptr(), scratch,
                                    b, h, w, ksize, _GAUSS_MODE_IDS[mode], idelta,
                                    _stream(dev))
    _raise_on(rc, name)
    _count(name)
    return out


def gaussian_blur_u8_ref(x: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """Plain PyTorch cv2.GaussianBlur 8u, reflect-101 border
    (``filters.gaussian_blur_u8``'s plain form)."""
    return gaussian_blur_u8_plain(x, ksize, sigma)


def gaussian_blur_u8(x: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """cv2.GaussianBlur 8u of each plane of a (B, H, W) uint8 tensor with
    the reflect-101 border and an odd ksize (replaces tpuimage's
    ``gaussian_blur_u8_pallas``)."""
    _check(x, "gaussian_blur_u8", torch.uint8, 3)
    _check_ksize("gaussian_blur_u8", ksize)
    if _device_of(x).type == "cpu":
        return gaussian_blur_u8_ref(x, ksize, sigma)
    return _gauss_launch("gaussian_blur_u8", x, ksize, sigma, "none", 0)


def gauss_chain_ref(x: torch.Tensor, ksize: int, mode: str, C: float = 0.0) -> torch.Tensor:
    """Plain PyTorch Gaussian and its consumer: the Q8.8 blur, then
    ``divide_u8(x, blur, 255)``, ``subtract_u8(x, blur)`` or
    ``subtract_u8(blur, x)``; or ``adaptive_threshold(x, 255, "gaussian",
    ksize, C)``."""
    if mode == "adaptive":
        return adaptive_threshold(x, 255, "gaussian", ksize, C)
    blur = gaussian_blur_u8_ref(x, ksize)
    if mode == "divide":
        return divide_u8(x, blur, scale=255)
    if mode == "subtract":
        return subtract_u8(x, blur)
    if mode == "sub":
        return subtract_u8(blur, x)
    raise ValueError(f"gauss_chain: unknown mode {mode!r}")


def gauss_chain(x: torch.Tensor, ksize: int, mode: str, C: float = 0.0) -> torch.Tensor:
    """A Gaussian of each plane of a (B, H, W) uint8 tensor fused with the
    post-warp stage that consumes it (replaces tpuimage's
    ``gauss_chain_pallas``). ``mode``: "divide" / "subtract" (illumination)
    and "sub" (ink background) on the Q8.8 blur with a reflect-101 border;
    "adaptive" is cv2.adaptiveThreshold GAUSSIAN_C with block ``ksize``,
    constant ``C`` and a replicate border."""
    _check(x, "gauss_chain", torch.uint8, 3)
    _check_ksize("gauss_chain", ksize)
    if mode not in GAUSS_CHAIN_MODES:
        raise ValueError(f"gauss_chain: mode must be one of {GAUSS_CHAIN_MODES}, got {mode!r}")
    if _device_of(x).type == "cpu":
        return gauss_chain_ref(x, ksize, mode, C)
    return _gauss_launch("gauss_chain", x, ksize, 0.0, mode,
                         math.ceil(C) if mode == "adaptive" else 0)


def divide_table(device) -> torch.Tensor:
    """(256, 256) uint8: the divide epilogue of every (num, den) pair,
    ``[num, den]``. On a card it is computed by the gauss_chain kernel's
    own device function, in a launch of its own that no counter counts;
    on the CPU by ``divide_u8``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        v = torch.arange(256, dtype=torch.int32).to(torch.uint8)
        return divide_u8(v[:, None].expand(256, 256), v[None, :].expand(256, 256), scale=255)
    out = torch.empty((256, 256), dtype=torch.uint8, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.tpuimage_divide_table(out.data_ptr(), _stream(dev))
    _raise_on(rc, "divide_table")
    return out


def blackhat_rect_ref(x: torch.Tensor, kw: int, kh: int) -> torch.Tensor:
    """Plain PyTorch ``close(x) - x`` with a kw x kh rect (the log-step
    form of ``morphology.morph_blackhat``)."""
    return morph_blackhat_plain(x, structuring_element(MORPH_RECT, (kw, kh)))


def blackhat_rect(x: torch.Tensor, kw: int, kh: int) -> torch.Tensor:
    """cv2.MORPH_BLACKHAT of each plane of a (B, H, W) uint8 tensor with a
    full kw x kh rectangle, both odd (replaces tpuimage's
    ``blackhat_rect_pallas``)."""
    _check(x, "blackhat_rect", torch.uint8, 3)
    if not all(k >= 1 and k % 2 == 1 for k in (kw, kh)):
        raise ValueError(f"blackhat_rect: kw and kh must be odd and positive, got {kw}x{kh}")
    dev = _device_of(x)
    if dev.type == "cpu":
        return blackhat_rect_ref(x, kw, kh)
    b, h, w = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        scratch = _scratch(dev, lib.tpuimage_blackhat_rect_scratch(b, h, w, kw, kh))
        rc = lib.tpuimage_blackhat_rect(x.data_ptr(), out.data_ptr(), scratch, b, h, w, kw, kh,
                                        _stream(dev))
    _raise_on(rc, "blackhat_rect")
    _count("blackhat_rect")
    return out


def inkmask_weighted_ref(sub_raw: torch.Tensor, bh_raw: torch.Tensor, adapt: torch.Tensor,
                         t_sub: torch.Tensor, t_bh: torch.Tensor, iters: int):
    """Plain PyTorch ink-mask epilogue: ``threshold_binary`` (strict >) of
    both raw planes, their max, ``iters`` 2x2 dilations, then
    ``where(mask == 0, 255, adapt)``."""
    mask = max_u8(threshold_binary(sub_raw, t_sub[:, None, None]),
                  threshold_binary(bh_raw, t_bh[:, None, None]))
    if iters > 0:
        mask = dilate(mask, _SE_INK, iterations=iters)
    return mask, torch.where(mask == 0, torch.full_like(adapt, 255), adapt)


def inkmask_weighted(sub_raw: torch.Tensor, bh_raw: torch.Tensor, adapt: torch.Tensor,
                     t_sub: torch.Tensor, t_bh: torch.Tensor, iters: int = 1):
    """(ink_mask, weighted), both (B, H, W) uint8, from the raw ink and
    blackhat planes, the adaptive binary and one float32 threshold per
    image for each raw plane (replaces tpuimage's
    ``inkmask_weighted_pallas``). iters: the 2x2 dilations, >= 0."""
    for name, a in (("sub_raw", sub_raw), ("bh_raw", bh_raw), ("adapt", adapt)):
        _check(a, name, torch.uint8, 3)
    _check(t_sub, "t_sub", torch.float32, 1)
    _check(t_bh, "t_bh", torch.float32, 1)
    if bh_raw.shape != sub_raw.shape or adapt.shape != sub_raw.shape \
            or t_sub.shape[0] != sub_raw.shape[0] or t_bh.shape != t_sub.shape:
        raise ValueError("inkmask_weighted: inconsistent shapes "
                         f"{tuple(sub_raw.shape)} {tuple(bh_raw.shape)} {tuple(adapt.shape)} "
                         f"{tuple(t_sub.shape)} {tuple(t_bh.shape)}")
    if iters < 0:
        raise ValueError(f"inkmask_weighted: iters must be >= 0, got {iters}")
    dev = _device_of(sub_raw, bh_raw, adapt, t_sub, t_bh)
    if dev.type == "cpu":
        return inkmask_weighted_ref(sub_raw, bh_raw, adapt, t_sub, t_bh, iters)
    b, h, w = sub_raw.shape
    mask = torch.empty_like(sub_raw)
    weighted = torch.empty_like(sub_raw)
    if mask.numel() == 0:
        return mask, weighted
    lib = _load()
    with torch.cuda.device(dev):
        scratch = _scratch(dev, lib.tpuimage_inkmask_scratch(b, h, w, iters))
        rc = lib.tpuimage_inkmask_weighted(sub_raw.data_ptr(), bh_raw.data_ptr(),
                                           adapt.data_ptr(), t_sub.data_ptr(), t_bh.data_ptr(),
                                           mask.data_ptr(), weighted.data_ptr(), scratch,
                                           b, h, w, iters, _stream(dev))
    _raise_on(rc, "inkmask_weighted")
    _count("inkmask_weighted")
    return mask, weighted


# ---------------------------------------------------------------------------
# bilateral: (B, H, W) or (B, H, W, 3) uint8 -> the same, cv2.bilateralFilter
# ---------------------------------------------------------------------------

def color_weight_table(n: int, gauss_color: float, device) -> torch.Tensor:
    """(n,) float32 colour weights ``exp(d * d * gauss_color)`` for the
    integer distances d = 0..n-1, in f32 on ``device``: the expression
    tpuimage's tap loop evaluates per tap, evaluated once per distance."""
    d = torch.arange(n, dtype=torch.float32, device=device)
    return torch.exp(d * d * float(np.float32(gauss_color)))


def bilateral_ref(img: torch.Tensor, taps: torch.Tensor, space_w: torch.Tensor,
                  color_lut: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain PyTorch cv2.bilateralFilter 8u of each image of a (B, H, W)
    or (B, H, W, 3) uint8 batch, reflect-101 border: per tap (dy, dx) in
    table order, ``w = color_lut[|diff|] * space_w[t]`` (the L1 distance
    over the channels for colour), ``num += view * w``, ``den += w``, each
    product and sum rounded on its own; then ``cvRound(num / den)``."""
    color = img.dim() == 4
    planes = img.movedim(-1, -3) if color else img        # (B, [C,] H, W)
    h, w = planes.shape[-2], planes.shape[-1]
    r = radius
    padded = pad2d(planes, r, r, r, r)
    center = planes.to(torch.int32)
    num = torch.zeros(planes.shape, dtype=torch.float32, device=img.device)
    den = torch.zeros(img.shape[:3], dtype=torch.float32, device=img.device)
    for (dy, dx), sw in zip(taps.tolist(), space_w.tolist()):
        view = padded[..., r + dy:r + dy + h, r + dx:r + dx + w]
        diff = (view.to(torch.int32) - center).abs()
        if color:
            diff = diff.sum(dim=-3)
        wgt = color_lut[diff.to(torch.int64)] * sw
        num = num + view.to(torch.float32) * (wgt[:, None] if color else wgt)
        den = den + wgt
    out = saturate_u8(num / (den[:, None] if color else den))
    return out.movedim(-3, -1).contiguous() if color else out


def bilateral(img: torch.Tensor, taps: torch.Tensor, space_w: torch.Tensor,
              color_lut: torch.Tensor, radius: int) -> torch.Tensor:
    """cv2.bilateralFilter 8u of each image of a (B, H, W) gray or
    (B, H, W, 3) colour uint8 batch (replaces tpuimage's
    ``bilateral_gray_pallas``, and its scan form for colour).

    taps: (T, 2) int32 (dy, dx) offsets, each within ``radius``, in the
    order the sums run; space_w: (T,) float32 space weights; color_lut:
    float32 colour weights of the distances 0..255 (gray) or 0..765
    (colour), :func:`color_weight_table`. All on the image's device."""
    if img.dtype != torch.uint8:
        raise TypeError(f"bilateral: expected torch.uint8, got {img.dtype}")
    if img.dim() not in (3, 4) or (img.dim() == 4 and img.shape[-1] != 3):
        raise ValueError(f"bilateral: expected (B, H, W) or (B, H, W, 3), got "
                         f"{tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("bilateral: tensor must be contiguous")
    _check(taps, "taps", torch.int32, 2)
    _check(space_w, "space_w", torch.float32, 1)
    _check(color_lut, "color_lut", torch.float32, 1)
    chans = 3 if img.dim() == 4 else 1
    if taps.shape[1] != 2 or space_w.shape[0] != taps.shape[0] or radius < 0:
        raise ValueError(f"bilateral: taps {tuple(taps.shape)}, space_w "
                         f"{tuple(space_w.shape)}, radius {radius}")
    if color_lut.shape[0] < 255 * chans + 1:
        raise ValueError(f"bilateral: color_lut needs {255 * chans + 1} entries, "
                         f"got {color_lut.shape[0]}")
    dev = _device_of(img, taps, space_w, color_lut)
    if dev.type == "cpu":
        return bilateral_ref(img, taps, space_w, color_lut, radius)
    out = torch.empty_like(img)
    if out.numel() == 0:
        return out
    b, h, w = img.shape[:3]
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.tpuimage_bilateral(img.data_ptr(), taps.data_ptr(), space_w.data_ptr(),
                                    color_lut.data_ptr(), out.data_ptr(), b, h, w, chans,
                                    radius, taps.shape[0], color_lut.shape[0], _stream(dev))
    _raise_on(rc, "bilateral")
    _count("bilateral")
    return out


# ---------------------------------------------------------------------------
# rank_extract: exclusive per-band edge ranks -> each band's edge positions
# ---------------------------------------------------------------------------

def rank_extract_ref(rank: torch.Tensor, mask: torch.Tensor, kk: int) -> torch.Tensor:
    """Plain PyTorch ``ci[rank[p, b], b] = p`` for every position p of
    band b where the mask is set and ``rank < kk``, over zeros:
    (N, nb) -> (kk, nb) int32."""
    n, nb = rank.shape
    ci = torch.zeros((kk, nb), dtype=torch.int32, device=rank.device)
    keep = mask & (rank < kk)
    p, b = torch.nonzero(keep, as_tuple=True)
    ci[rank[p, b].to(torch.int64), b] = p.to(torch.int32)
    return ci


def rank_extract(rank: torch.Tensor, mask: torch.Tensor, kk: int) -> torch.Tensor:
    """Sort-free edge compaction (replaces tpuimage's
    ``rank_extract_pallas``): rank (N, nb) int32 is each position's
    exclusive edge rank within its band: the mask's exclusive cumsum along
    the band, which the kernel relies on (where positions are contiguous
    it reads rank once per 512 positions and counts the set bytes from
    there); mask (N, nb) bool the edges.
    Returns ci (kk, nb) int32, the position of band b's k-th edge at
    ``ci[k, b]``; edges of rank >= kk are dropped, and ``ci`` is 0 past a
    band's count. Both inputs may have any strides (a page-major (B, P)
    plane goes in transposed, as (P, B) with nb = B bands). On the card,
    where positions are the mask's fast axis, ci is the (kk, nb) view of
    band-major storage (``ci.t()`` is contiguous), so that each band's
    slots are written as runs."""
    if rank.dtype != torch.int32:
        raise TypeError(f"rank: expected torch.int32, got {rank.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask: expected torch.bool, got {mask.dtype}")
    if rank.dim() != 2 or mask.shape != rank.shape:
        raise ValueError(f"rank_extract: rank {tuple(rank.shape)} and mask "
                         f"{tuple(mask.shape)} must be the same (N, nb)")
    if kk < 0 or rank.shape[0] >= 2 ** 31:
        raise ValueError(f"rank_extract: kk {kk}, N {rank.shape[0]}")
    dev = _device_of(rank, mask)
    if dev.type == "cpu":
        return rank_extract_ref(rank, mask, kk)
    n, nb = rank.shape
    if kk == 0 or nb == 0 or n == 0:
        return torch.zeros((kk, nb), dtype=torch.int32, device=dev)
    # the kernel writes every slot
    if mask.stride(0) == 1:
        ci = torch.empty((nb, kk), dtype=torch.int32, device=dev).t()
    else:
        ci = torch.empty((kk, nb), dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.tpuimage_rank_extract(rank.data_ptr(), mask.data_ptr(), ci.data_ptr(), n, nb,
                                       rank.stride(0), rank.stride(1), mask.stride(0),
                                       mask.stride(1), ci.stride(0), ci.stride(1), kk,
                                       _stream(dev))
    _raise_on(rc, "rank_extract")
    _count("rank_extract")
    return ci
