"""Time several builds of the separable Gaussian against each other.

    python -m tpuimage_torch.tools.time_gauss_sep [--source OTHER.cu ...]
        [--ksize 83 255] [--mode none sub adaptive]

Builds ``csrc/gauss_sep.cu`` and every ``--source`` (another version of
that file with the same C interface, say an earlier commit's from ``git
show``) into a library of its own, calls ``tpuimage_gauss_sep`` of each on
the same 8 seeded A4 planes (1200x849) for every (ksize, mode), holds the
output exact against the plain version, and prints the card's name and
power limit and one line per case: each build's ms, the median of 10
samples of 20 back-to-back calls, taken in turns (a, b, .., b, a), the
lower of the two kept. Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tpuimage_torch.ops import kernels

PLANES = (8, 1200, 849)


def _build(src: Path, out: Path) -> ctypes.CDLL:
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(out), str(src)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(out))


def _ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 20)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[], type=Path)
    ap.add_argument("--ksize", nargs="+", type=int, default=[43, 51, 83, 127, 255])
    ap.add_argument("--mode", nargs="+", default=["none", "sub"],
                    choices=sorted(kernels._GAUSS_MODE_IDS))
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = [kernels.CSRC / "gauss_sep.cu", *args.source]
    libs = [_build(s, kernels.BUILD_DIR / f"time_gauss_sep_{i}.so") for i, s in enumerate(sources)]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, PLANES, dtype=np.uint8)).to(dev)
    out = torch.empty_like(x)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = ctypes.c_void_p
    for k in args.ksize:
        for mode in args.mode:
            taps = kernels._gauss_taps(k, 0.0, "f32" if mode == "adaptive" else "q8", str(dev))
            want = (kernels.gaussian_blur_u8_ref(x, k) if mode == "none"
                    else kernels.gauss_chain_ref(x, k, mode, 3.0))
            idelta = 3 if mode == "adaptive" else 0
            calls = []
            for lib in libs:
                lib.tpuimage_gauss_sep_scratch.restype = ctypes.c_longlong
                n = lib.tpuimage_gauss_sep_scratch(*PLANES, k)
                scratch = torch.empty(max(n, 1), dtype=torch.uint8, device=dev)

                def call(lib=lib, scratch=scratch, n=n):
                    rc = lib.tpuimage_gauss_sep(
                        p(x.data_ptr()), p(taps.data_ptr()), p(out.data_ptr()),
                        p(scratch.data_ptr() if n else 0), *PLANES, k,
                        kernels._GAUSS_MODE_IDS[mode], idelta, stream)
                    if rc:
                        raise RuntimeError(f"tpuimage_gauss_sep: cuda error {rc}")
                out.zero_()
                call()
                if not torch.equal(out, want):
                    raise AssertionError(f"k={k} {mode}: a build differs from the plain version")
                calls.append(call)
            there = [_ms(c) for c in calls]
            back = [_ms(c) for c in reversed(calls)][::-1]
            print(f"k={k} {mode}: " + "; ".join(
                f"{s.name if i == 0 else s} {min(a, b):.4f} ms"
                for i, (s, a, b) in enumerate(zip(sources, there, back))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
