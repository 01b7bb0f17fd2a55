#!/usr/bin/env python3
"""Drive tpuimage_torch's DocScanner serving path once on one CUDA card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):

1. device and build: the card's name and power limit, the torch and CUDA
   versions, and the nvcc build of tpuimage_torch/csrc/*.cu;
2. each kernel against its plain PyTorch version on the card, at the
   slice's shapes (exact equality), with median CUDA-event times of both;
3. the main path: ``scan_batch`` on 8 synthetic 1600x1200 photos (7
   documents, one with tilted text, and one with no page), with the
   kernels' launch counters reset just before and read just after;
4. card against host: two of those requests again on the CPU.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the per-kernel JSON record. nvcc's full output is kept beside the
built library in tpuimage_torch/_build/.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N_REQUESTS = 8
PHOTO = (1600, 1200)      # height x width: a phone photo held upright
PAGE = (1200, 849)        # A4 portrait at GUI_DOCUMENT_CONFIG.scale_long
BINARY_TOL = 0.002        # share of binary pixels card and host may differ on


def _nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of fn() in ms, after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _compare(name, kernel_fn, plain_fn) -> dict:
    out = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{name}: {tuple(out.shape)} {out.dtype} vs "
                             f"{tuple(ref.shape)} {ref.dtype}")
    err = int((out.to(torch.int64) - ref.to(torch.int64)).abs().max())
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max |diff| {err})")
    rec = {"max_abs_err": err, "ms": _cuda_ms(kernel_fn), "plain_ms": _cuda_ms(plain_fn)}
    print(f"{name}: shape {tuple(out.shape)} exact; kernel {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from tpuimage_torch import synth
    from tpuimage_torch.ops import edges, hough, kernels
    from tpuimage_torch.ops.color import rgb_to_gray
    from tpuimage_torch.pipelines import docscan

    dev = torch.device("cuda")
    cfg = docscan.GUI_DOCUMENT_CONFIG

    # --- 1. device and build ------------------------------------------------
    smi = _nvidia_smi()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    so = kernels.build()
    kernels._load()
    print(f"build: {so.name} in {time.perf_counter() - t0:.2f} s")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())

    # --- 2. kernels against their plain versions, at the slice's shapes -----
    pages = np.stack([synth.page(100 + i, *PAGE, tilt_deg=(3.0 if i % 2 else 0.0),
                                 rules=(3 if i % 2 else 0)) for i in range(N_REQUESTS)])
    pages_d = torch.from_numpy(pages).to(dev)
    stretched = docscan._illumination(rgb_to_gray(pages_d), cfg)
    sub_raw, bh_raw = docscan._ink_planes(stretched, cfg)
    n = PAGE[0] * PAGE[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    planes = torch.cat([torch.stack([sub_raw, bh_raw], dim=1).reshape(2 * N_REQUESTS, n),
                        torch.randint(0, 256, (1, n), generator=gen, device=dev,
                                      dtype=torch.uint8),
                        torch.full((1, n), 255, dtype=torch.uint8, device=dev)])
    records = {"hist256": _compare(
        f"hist256 (sub_raw/bh_raw planes of {N_REQUESTS} A4 pages + random + constant)",
        lambda: kernels.hist256_batch(planes), lambda: kernels.hist256_batch_ref(planes))}

    weighted = docscan._pre_deskew_stages(pages_d, cfg)["weighted"]
    deskew_edges = edges.canny(weighted, cfg.canny_low, cfg.canny_high)
    photos = [synth.document_photo(200 + i, *PHOTO) for i in range(N_REQUESTS)]
    photo_edges = edges.canny(rgb_to_gray(torch.from_numpy(np.stack(photos)).to(dev)),
                              cfg.canny_low, cfg.canny_high)
    cos_np, sin_np = hough.hough_tables()
    cos_t, sin_t = torch.from_numpy(cos_np).to(dev), torch.from_numpy(sin_np).to(dev)
    hough_recs = []
    for what, e in (("deskew", deskew_edges), ("localize", photo_edges)):
        h, w = e.shape[-2:]
        numrho = (h + w) * 2 + 1
        xs, ys, counts, _ = hough.compact_edges(e, hough.default_max_edges(h, w))
        args = (xs, ys, counts, cos_t, sin_t, numrho, (numrho - 1) // 2)
        hough_recs.append(_compare(
            f"hough_votes ({what}: {N_REQUESTS} edge maps {h}x{w}, "
            f"{int(counts.max())} edges max)",
            lambda: kernels.hough_votes(*args), lambda: kernels.hough_votes_ref(*args)))
    records["hough_votes"] = {
        "max_abs_err": max(r["max_abs_err"] for r in hough_recs),
        "ms": hough_recs[0]["ms"], "plain_ms": hough_recs[0]["plain_ms"],
        "localize_ms": hough_recs[1]["ms"], "localize_plain_ms": hough_recs[1]["plain_ms"]}
    del planes, weighted, deskew_edges, photo_edges

    # --- 3. the main path ----------------------------------------------------
    tilted = 1
    inputs = [synth.document_photo(300 + i, *PHOTO,
                                   tilt_deg=3.0 if i == tilted else 0.0,
                                   rules=3 if i == tilted else 0,
                                   with_page=i != N_REQUESTS - 1)
              for i in range(N_REQUESTS)]
    docscan.scan_batch(inputs, cfg, device=dev)          # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    results = docscan.scan_batch(inputs, cfg, device=dev)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"scan_batch launches: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the main path never launched {name}")
    for i, r in enumerate(results):
        if "binary" not in r:
            raise AssertionError(f"request {i} failed: {r}")
        want = (PAGE[0], PHOTO[1] * PAGE[0] // PHOTO[0]) if r["use_whole"] else PAGE
        if r["binary"].shape != want or r["binary"].dtype != np.uint8:
            raise AssertionError(f"request {i}: binary {r['binary'].shape} "
                                 f"{r['binary'].dtype}, expected {want} uint8")
        print(f"request {i}: use_whole={r['use_whole']} binary={r['binary'].shape} "
              f"deskew_angle={r['deskew_angle']} overflow={r['deskew_overflow']} "
              f"ink={float((r['binary'] < 128).mean()):.4f}")
    if not any(r["deskew_angle"] != 0.0 for r in results):
        raise AssertionError("no page was deskewed: the rotation never ran")
    if not results[-1]["use_whole"] or any(r["use_whole"] for r in results[:-1]):
        raise AssertionError("expected exactly the page-less photo to be use_whole")

    runs, phases = [], []
    for _ in range(3):
        t = [time.perf_counter()]
        st = docscan._scan_localize(inputs, cfg, dev)
        t.append(time.perf_counter())
        docscan._scan_warp(st, cfg)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        docscan._scan_postwarp(st, cfg)
        t.append(time.perf_counter())
        docscan._scan_results(st)
        t.append(time.perf_counter())
        runs.append((t[-1] - t[0]) * 1e3 / N_REQUESTS)
        phases.append([(b - a) * 1e3 for a, b in zip(t, t[1:])])
    best = phases[int(np.argsort(runs)[1])]
    print(f"scan_batch: {statistics.median(runs):.2f} ms/request (median of 3, warm, "
          f"batch {N_REQUESTS}); runs {[round(r, 2) for r in runs]}")
    print("phases ms (median run): " + ", ".join(
        f"{k} {v:.2f}" for k, v in zip(("localize+quadfit", "warp", "postwarp", "results"),
                                       best)))
    stack = torch.from_numpy(np.stack(inputs)).to(dev)
    loc_ms = _cuda_ms(lambda: docscan._localize_device_batch(
        stack, cfg.canny_low, cfg.canny_high), reps=3)
    pw_ms = _cuda_ms(lambda: docscan.docscan_post_warp_batch(pages_d, cfg), reps=5)
    print(f"localize device part: {loc_ms:.2f} ms per batch of {N_REQUESTS} photos "
          f"(the rest of localize+quadfit is the host quad fit)")
    print(f"docscan_post_warp_batch: {pw_ms:.2f} ms per batch of {N_REQUESTS} A4 pages = "
          f"{N_REQUESTS * PAGE[0] * PAGE[1] / 1e3 / pw_ms:.1f} MP/s")
    del stack

    # --- 4. card against host -----------------------------------------------
    pick = [0, tilted]
    host = docscan.scan_batch([inputs[i] for i in pick], cfg, device="cpu")
    for i, h in zip(pick, host):
        c = results[i]
        if c["use_whole"] != h["use_whole"] or c["deskew_angle"] != h["deskew_angle"]:
            raise AssertionError(f"request {i}: card {c['use_whole']}/{c['deskew_angle']} "
                                 f"vs host {h['use_whole']}/{h['deskew_angle']}")
        if (c["quad"] is None) != (h["quad"] is None) or (
                c["quad"] is not None and np.abs(c["quad"] - h["quad"]).max() > 0.5):
            raise AssertionError(f"request {i}: quads differ {c['quad']} vs {h['quad']}")
        frac = float((c["binary"] != h["binary"]).mean())
        if frac >= BINARY_TOL:
            raise AssertionError(f"request {i}: {frac:.5f} of binary pixels differ")
        print(f"card vs host, request {i}: quad/angle/use_whole equal, "
              f"{frac:.6f} of binary pixels differ (limit {BINARY_TOL})")
    torch.cuda.synchronize()
    jax_side = [m for m in sys.modules if m.split(".")[0] in ("jax", "tpuimage")]
    if jax_side:
        raise AssertionError(f"the port imported the JAX side: {jax_side[:5]}")

    sources = {"hist256": ("tpuimage_torch/csrc/hist256.cu",
                           "tpuimage/ops/pallas_kernels.py:1660"),
               "hough_votes": ("tpuimage_torch/csrc/hough_votes.cu",
                               "tpuimage/ops/pallas_kernels.py:598")}
    kernel_line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **records[name]}
        for name, (src, rep) in sources.items()]}
    print(smi)
    print(json.dumps(kernel_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
