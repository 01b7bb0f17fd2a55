"""Time several builds of one kernel source against each other.

    python -m tpuimage_torch.tools.time_kernel_builds
        {bilateral,blackhat_rect,clahe_apply,gauss_sep,hist256,inkmask,lab,
         morph3,rank_extract}
        [--source OTHER.cu ...] [--timed-only OTHER.cu ...]
        [--ksize 83 255] [--mode none sub adaptive] [--iters 1 8]

Builds ``csrc/<kernel>.cu`` and every other version of that file given
(the same C interface: an earlier commit's from ``git show``, or a copy
with one part taken away or one constant changed) into a library of its
own, all nvcc processes at once, and calls each on the kernel's inputs at
the paths' shapes:

- gauss_sep: 8 seeded random A4 planes (1200x849), every ``--ksize`` x
  ``--mode``;
- hist256: the sub_raw / blackhat planes of 8 A4 pages with a random and a
  constant row, as chip_smoke.py phase 2 makes them, the 512 CLAHE tile
  rows of 8 night scenes, 8 eroded morph_seq planes;
- blackhat_rect: the 8 stretched A4 planes at the ink mask's rectangle;
- bilateral: the gray planes of chip_smoke.py's 8 photos of 1600x1200 at
  DocScanner's d 9, 75/75, and 2 colour photos of 1280x853 at face's d -1,
  30/10 (radius 15);
- rank_extract: the Canny edge maps of the 8 A4 pages after the
  pre-deskew stages (deskew) and of the 8 photos (localize), each page one
  band of the page-major plane through ``hough.exclusive_rank``, as
  ``hough.compact_edges`` hands them over;
- inkmask: the sub_raw / blackhat / adaptive planes of the 8 A4 pages and
  their Otsu thresholds, as chip_smoke.py phase 2 makes them, at every
  ``--iters`` (default the GUI preset's 1);
- morph3: binary_close3 on the 8 eroded morph_seq planes (963 high, 1280
  wide) and their Otsu thresholds, gray_erode3 on the 8 RGB photos;
- clahe_apply: the L planes of 8 median-filtered night scenes of 1280x853
  with the night path's 8x8 tile LUTs (clip limit 2) and blend matrices,
  as chip_smoke.py phase 7 makes them;
- lab: rgb_to_lab on those 8 median-filtered night scenes (the night
  path's and landscape's shape), with the packed tables of
  ``color.lab_tables_on``.

The tree's build and every ``--source`` are held exact against the plain
version (one that differs is named, left untimed, and the tool exits 1); a
``--timed-only`` build (one that no longer computes the function, say
without its loads) is only timed. Prints the card's name and
power limit and one line per case: each build's ms for one call, the
median of 10 samples of 20 back-to-back eager calls, and in parentheses
its device time, the median of 5 replays of a CUDA graph of 20 calls;
both taken in turns (a, b, .., b, a), the lower of the two kept. For
inkmask, morph3, clahe_apply and lab a third time follows in brackets: the same graph with
its calls rotated over copies of the inputs and outputs that total more
than the H100's 50 MB L2, so that each call reads device memory. A hist256
or rank_extract call zeroes its output first in every build (the first
designs need it). Needs a card and nvcc.
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

from tpuimage_torch import synth
from tpuimage_torch.ops import bilateral, color, edges, histogram, hough, kernels, median
from tpuimage_torch.ops.color import rgb_to_gray
from tpuimage_torch.pipelines import docscan, night

N = 8
PAGE, NIGHT, MORPH, PHOTO = (1200, 849), (853, 1280), (963, 1280), (1600, 1200)
KERNELS = ("bilateral", "blackhat_rect", "clahe_apply", "gauss_sep", "hist256", "inkmask",
           "lab", "morph3", "rank_extract")
L2_BYTES = 50 << 20
_p = ctypes.c_void_p


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


def _graph_ms(fn, *more) -> float:
    """The device time of one call: the median of 5 replays of a CUDA
    graph of 20 calls, captured on the current stream (no launch cost);
    with ``more`` calls (the same on copies of the data), the 20 go round
    all of them."""
    fns = (fn, *more)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.current_stream()):
        for i in range(20):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 20)
    return statistics.median(times)


def _build_all(jobs) -> list:
    """nvcc every (source, library) at once; load the libraries."""
    procs = [subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
                               "-shared", "-o", str(out), str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for src, out in jobs]
    for (src, _), proc in zip(jobs, procs):
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    return [ctypes.CDLL(str(out)) for _, out in jobs]


def _raise_on(rc: int, fn: str) -> None:
    if rc:
        raise RuntimeError(f"{fn}: cuda error {rc}")


def _pages(dev) -> torch.Tensor:
    return torch.from_numpy(np.stack([
        synth.page(100 + i, *PAGE, tilt_deg=(3.0 if i % 2 else 0.0), rules=(3 if i % 2 else 0))
        for i in range(N)])).to(dev)


def _gauss_cases(args, dev, stream):
    shape = (N, *PAGE)
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)).to(dev)
    out = torch.empty_like(x)
    for k in args.ksize:
        for mode in args.mode:
            taps = kernels._gauss_taps(k, 0.0, "f32" if mode == "adaptive" else "q8", str(dev))
            want = (kernels.gaussian_blur_u8_ref(x, k) if mode == "none"
                    else kernels.gauss_chain_ref(x, k, mode, 3.0))

            def bind(lib, k=k, mode=mode, taps=taps):
                lib.tpuimage_gauss_sep_scratch.restype = ctypes.c_longlong
                n = lib.tpuimage_gauss_sep_scratch(*shape, k)
                scratch = torch.empty(max(n, 1), dtype=torch.uint8, device=dev)
                return lambda: _raise_on(lib.tpuimage_gauss_sep(
                    _p(x.data_ptr()), _p(taps.data_ptr()), _p(out.data_ptr()),
                    _p(scratch.data_ptr() if n else 0), *shape, k,
                    kernels._GAUSS_MODE_IDS[mode], 3 if mode == "adaptive" else 0, stream),
                    "tpuimage_gauss_sep")

            yield f"k={k} {mode}", out, want, bind


def _hist_cases(args, dev, stream):
    cfg = docscan.GUI_DOCUMENT_CONFIG
    sub_raw, bh_raw = docscan._ink_planes(docscan._illumination(rgb_to_gray(_pages(dev)), cfg),
                                          cfg)
    n = PAGE[0] * PAGE[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    planes = torch.cat([torch.stack([sub_raw, bh_raw], dim=1).reshape(2 * N, n),
                        torch.randint(0, 256, (1, n), generator=gen, device=dev,
                                      dtype=torch.uint8),
                        torch.full((1, n), 255, dtype=torch.uint8, device=dev)])
    tiles = histogram.clahe_tiles(_night_lum(dev), night.TILES, night.TILES)[0]
    docs = torch.from_numpy(np.stack([synth.document_photo(500 + i, *MORPH)
                                      for i in range(N)])).to(dev)
    eroded = kernels.gray_erode3(docs)[1].reshape(N, -1)
    for label, x in (("18 A4 rows", planes), (f"{tiles.shape[0]} CLAHE tile rows", tiles),
                     ("8 eroded planes", eroded)):
        out = torch.empty((x.shape[0], 256), dtype=torch.int32, device=dev)

        def bind(lib, x=x, out=out):
            lib.tpuimage_hist256.argtypes = [_p, _p, ctypes.c_longlong, ctypes.c_longlong, _p]

            def call():
                out.zero_()
                _raise_on(lib.tpuimage_hist256(x.data_ptr(), out.data_ptr(), *x.shape, stream),
                          "tpuimage_hist256")
            return call

        yield label, out, kernels.hist256_batch_ref(x), bind


def _blackhat_cases(args, dev, stream):
    cfg = docscan.GUI_DOCUMENT_CONFIG
    x = docscan._illumination(rgb_to_gray(_pages(dev)), cfg)
    kh, kw = docscan.blackhat_se(cfg).shape
    out = torch.empty_like(x)

    def bind(lib):
        lib.tpuimage_blackhat_rect_scratch.restype = ctypes.c_longlong
        nb = lib.tpuimage_blackhat_rect_scratch(*x.shape, kw, kh)
        scratch = torch.empty(max(nb, 1), dtype=torch.uint8, device=dev)
        return lambda: _raise_on(lib.tpuimage_blackhat_rect(
            _p(x.data_ptr()), _p(out.data_ptr()), _p(scratch.data_ptr() if nb else 0),
            *x.shape, kw, kh, stream), "tpuimage_blackhat_rect")

    yield f"8 A4 planes {kw}x{kh}", out, kernels.blackhat_rect_ref(x, kw, kh), bind


def _photos(dev) -> torch.Tensor:
    """chip_smoke.py's main-path photos: 7 pages (the second with tilted
    text and ruled lines) and one photo with no page."""
    return torch.from_numpy(np.stack([
        synth.document_photo(300 + i, *PHOTO, tilt_deg=3.0 if i == 1 else 0.0,
                             rules=3 if i == 1 else 0, with_page=i != N - 1)
        for i in range(N)])).to(dev)


def _bilateral_cases(args, dev, stream):
    face = torch.from_numpy(np.stack([synth.document_photo(260 + i, *NIGHT)
                                      for i in range(2)])).to(dev)
    for label, x, (d, sc, ss) in ((f"{N} gray photos d=9", rgb_to_gray(_photos(dev)), (9, 75, 75)),
                                  ("2 colour photos d=-1 30/10", face, (-1, 30, 10))):
        chans = 3 if x.dim() == 4 else 1
        radius, taps, space_w, lut = bilateral.tables_on(d, sc, ss, chans, dev)
        out = torch.empty_like(x)

        def bind(lib, x=x, out=out, chans=chans, a=(radius, taps, space_w, lut)):
            radius, taps, space_w, lut = a
            return lambda: _raise_on(lib.tpuimage_bilateral(
                _p(x.data_ptr()), _p(taps.data_ptr()), _p(space_w.data_ptr()),
                _p(lut.data_ptr()), _p(out.data_ptr()), *x.shape[:3], chans, radius,
                taps.shape[0], lut.shape[0], stream), "tpuimage_bilateral")

        yield (f"{label} ({taps.shape[0]} taps)", out,
               kernels.bilateral_ref(x, taps, space_w, lut, radius), bind)


def _rank_cases(args, dev, stream):
    cfg = docscan.GUI_DOCUMENT_CONFIG
    deskew = edges.canny(docscan._pre_deskew_stages(_pages(dev), cfg)["weighted"],
                         cfg.canny_low, cfg.canny_high)
    localize = edges.canny(rgb_to_gray(_photos(dev)), cfg.canny_low, cfg.canny_high)
    for label, e in ((f"{N} deskew maps", deskew), (f"{N} localize maps", localize)):
        b, h, w = e.shape
        flat = e.reshape(b, h * w) > 0
        rank, counts = hough.exclusive_rank(flat)
        kk = max(int(torch.clamp(counts, max=hough.default_max_edges(h, w)).max()), 1)
        rank_t, mask_t = rank.t(), flat.t()
        out = torch.empty((b, kk), dtype=torch.int32, device=dev).t()   # as the wrapper lays it out

        def bind(lib, rank_t=rank_t, mask_t=mask_t, out=out, kk=kk):
            ll = ctypes.c_longlong
            lib.tpuimage_rank_extract.argtypes = [_p, _p, _p, ll, ll, ll, ll, ll, ll, ll, ll,
                                                  ctypes.c_int, _p]

            def call():
                out.zero_()
                _raise_on(lib.tpuimage_rank_extract(
                    rank_t.data_ptr(), mask_t.data_ptr(), out.data_ptr(), *mask_t.shape,
                    *rank_t.stride(), *mask_t.stride(), *out.stride(), kk, stream),
                    "tpuimage_rank_extract")
            return call

        yield (f"{label} {h}x{w}, kk {kk}", out, kernels.rank_extract_ref(rank_t, mask_t, kk),
               bind)


class Rotated:
    """A case's binder that also binds copies of its data, enough that the
    calls' data exceeds the L2 cache: ``bind(lib)`` for the checked call,
    ``bind.copies(lib)`` for the calls on the copies (made at first use).
    ``make(lib, i)`` binds the call on copy i (0: the checked data)."""

    def __init__(self, make, nbytes: int):
        self.make, self.n = make, L2_BYTES // nbytes + 1

    def __call__(self, lib):
        return self.make(lib, 0)

    def copies(self, lib):
        return [self.make(lib, i) for i in range(1, self.n + 1)]


def _ink_cases(args, dev, stream):
    cfg = docscan.GUI_DOCUMENT_CONFIG
    stretched = docscan._illumination(rgb_to_gray(_pages(dev)), cfg)
    sub_raw, bh_raw = docscan._ink_planes(stretched, cfg)
    hists = kernels.hist256_batch(torch.stack([sub_raw, bh_raw], dim=1).reshape(2 * N, -1))
    hists = hists.reshape(N, 2, 256)
    t_sub = docscan._raw_otsu_threshold(hists[:, 0], cfg.mask_thresh_offset)
    t_bh = docscan._raw_otsu_threshold(hists[:, 1], cfg.mask_thresh_offset)
    adapt = kernels.gauss_chain(stretched, docscan.adaptive_block(cfg), "adaptive", cfg.C)
    planes = torch.stack([sub_raw, bh_raw, adapt])
    for it in args.iters:
        out = torch.empty((2, *sub_raw.shape), dtype=torch.uint8, device=dev)
        want = torch.stack(kernels.inkmask_weighted_ref(sub_raw, bh_raw, adapt, t_sub, t_bh, it))
        data = {}

        def make(lib, i, it=it, out=out):
            if i not in data:
                data[i] = (planes, out) if i == 0 else (planes.clone(), torch.empty_like(out))
            (s, b, a), (m, wt) = data[i]
            lib.tpuimage_inkmask_scratch.restype = ctypes.c_longlong
            nb = lib.tpuimage_inkmask_scratch(*s.shape, it)
            scratch = torch.empty(max(nb, 1), dtype=torch.uint8, device=dev)
            return lambda: _raise_on(lib.tpuimage_inkmask_weighted(
                _p(s.data_ptr()), _p(b.data_ptr()), _p(a.data_ptr()), _p(t_sub.data_ptr()),
                _p(t_bh.data_ptr()), _p(m.data_ptr()), _p(wt.data_ptr()),
                _p(scratch.data_ptr() if nb else 0), *s.shape, it, stream),
                "tpuimage_inkmask_weighted")

        yield (f"8 A4 planes iters {it}", out, want,
               Rotated(make, planes.numel() + out.numel()))


def _morph3_cases(args, dev, stream):
    docs = torch.from_numpy(np.stack([synth.document_photo(500 + i, *MORPH)
                                      for i in range(N)])).to(dev)
    eroded = kernels.gray_erode3(docs)[1]
    thresh = histogram.otsu_from_hist(kernels.hist256_batch(eroded.reshape(N, -1)))
    for label, x, want, fn in (
            (f"binary_close3 8 eroded planes {MORPH[0]} high {MORPH[1]} wide", eroded,
             kernels.binary_close3_ref(eroded, thresh), "tpuimage_binary_close3"),
            (f"gray_erode3 8 RGB photos {MORPH[0]} high {MORPH[1]} wide", docs,
             kernels.gray_erode3_ref(docs), "tpuimage_gray_erode3")):
        out = torch.empty((2, *eroded.shape), dtype=torch.uint8, device=dev)
        data = {}

        def make(lib, i, x=x, out=out, fn=fn):
            if i not in data:
                data[i] = (x, out) if i == 0 else (x.clone(), torch.empty_like(out))
            xi, o = data[i]
            extra = (_p(thresh.data_ptr()),) if fn == "tpuimage_binary_close3" else ()
            return lambda: _raise_on(getattr(lib, fn)(
                _p(xi.data_ptr()), *extra, _p(o[0].data_ptr()), _p(o[1].data_ptr()),
                *eroded.shape, stream), fn)

        yield label, out, torch.stack(want), Rotated(make, x.numel() + out.numel())


def _night_filtered(dev) -> torch.Tensor:
    """The 8 median-filtered night scenes (the night path's rgb_to_lab input)."""
    scenes = torch.from_numpy(np.stack([synth.night_scene(400 + i, *NIGHT)
                                        for i in range(N)])).to(dev)
    return median.median_blur(scenes, 3, channels_last=True).contiguous()


def _night_lum(dev) -> torch.Tensor:
    """The L planes of the 8 median-filtered night scenes (the night path's
    CLAHE input)."""
    return kernels.rgb_to_lab(_night_filtered(dev), color.lab_tables_on(dev))[..., 0].contiguous()


def _clahe_cases(args, dev, stream):
    lum = _night_lum(dev)
    tiles, th, tw = histogram.clahe_tiles(lum, night.TILES, night.TILES)
    luts = histogram.tile_luts_from_counts(kernels.hist256_batch(tiles), night.CLIP_LIMIT,
                                           th * tw).reshape(N, night.TILES, night.TILES, 256)
    R, C = histogram.blend_matrices_on(*NIGHT, th, tw, night.TILES, night.TILES, dev)
    out = torch.empty_like(lum)
    data = {}

    def make(lib, i):
        if i not in data:
            data[i] = ((lum, luts, out) if i == 0
                       else (lum.clone(), luts.clone(), torch.empty_like(out)))
        g, lt, o = data[i]
        return lambda: _raise_on(lib.tpuimage_clahe_apply(
            _p(g.data_ptr()), _p(lt.data_ptr()), _p(R.data_ptr()), _p(C.data_ptr()),
            _p(o.data_ptr()), N, *NIGHT, night.TILES, night.TILES, stream),
            "tpuimage_clahe_apply")

    yield (f"8 L planes {NIGHT[1]}x{NIGHT[0]}, {night.TILES}x{night.TILES} tile LUTs", out,
           kernels.clahe_apply_ref(lum, luts, R, C),
           Rotated(make, lum.numel() + luts.numel() + out.numel()))


def _lab_cases(args, dev, stream):
    rgb = _night_filtered(dev)
    tables = color.lab_tables_on(dev)
    out = torch.empty_like(rgb)
    data = {}

    def make(lib, i):
        if i not in data:
            data[i] = (rgb, out) if i == 0 else (rgb.clone(), torch.empty_like(out))
        lib.tpuimage_rgb_to_lab.argtypes = [_p, _p, _p, ctypes.c_longlong, _p]
        x, o = data[i]
        return lambda: _raise_on(lib.tpuimage_rgb_to_lab(
            _p(x.data_ptr()), _p(o.data_ptr()), _p(tables.data_ptr()), x.numel() // 3, stream),
            "tpuimage_rgb_to_lab")

    yield (f"8 median-filtered night scenes {NIGHT[1]}x{NIGHT[0]}", out,
           kernels.rgb_to_lab_ref(rgb, tables), Rotated(make, rgb.numel() + out.numel()))


_CASES = {"bilateral": _bilateral_cases, "blackhat_rect": _blackhat_cases,
          "clahe_apply": _clahe_cases, "gauss_sep": _gauss_cases, "hist256": _hist_cases,
          "inkmask": _ink_cases, "lab": _lab_cases, "morph3": _morph3_cases,
          "rank_extract": _rank_cases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=KERNELS)
    ap.add_argument("--source", action="append", default=[], type=Path,
                    help="another version of the source, held exact")
    ap.add_argument("--timed-only", action="append", default=[], type=Path,
                    help="another version that need not compute the function")
    ap.add_argument("--ksize", nargs="+", type=int, default=[43, 51, 83, 127, 255],
                    help="gauss_sep only")
    ap.add_argument("--mode", nargs="+", default=["none", "sub"],
                    choices=sorted(kernels._GAUSS_MODE_IDS), help="gauss_sep only")
    ap.add_argument("--iters", nargs="+", type=int,
                    default=[docscan.GUI_DOCUMENT_CONFIG.ink_dilate_iters], help="inkmask only")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    base = kernels.CSRC / f"{args.kernel}.cu"
    builds = ([(base.name, base, True)] + [(str(s), s, True) for s in args.source]
              + [(str(s), s, False) for s in args.timed_only])
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = _build_all([(src, kernels.BUILD_DIR / f"time_{args.kernel}_{i}.so")
                       for i, (_, src, _) in enumerate(builds)])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    # every call on one side stream, which a CUDA graph can capture
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        return _run(args, builds, libs, dev, _p(side.cuda_stream))


def _times(call, more):
    """(eager ms, device ms, device ms rotated over copies or None)."""
    return _ms(call), _graph_ms(call), _graph_ms(call, *more) if more is not None else None


def _run(args, builds, libs, dev, stream) -> int:
    rc = 0
    for label, out, want, bind in _CASES[args.kernel](args, dev, stream):
        timed = []
        for (name, _, exact), lib in zip(builds, libs):
            call = bind(lib)
            out.zero_()
            call()
            torch.cuda.synchronize()
            if exact and not torch.equal(out, want):
                diff = int((out.to(torch.int64) - want.to(torch.int64)).abs().max())
                print(f"{label}: build {name} differs from the plain version (max |diff| "
                      f"{diff}), not timed", flush=True)
                rc = 1
                continue
            timed.append((name, call, bind.copies(lib) if isinstance(bind, Rotated) else None))
        there = [_times(c, more) for _, c, more in timed]
        back = [_times(c, more) for _, c, more in reversed(timed)][::-1]
        print(f"{args.kernel} {label}: " + "; ".join(
            f"{name} {min(a[0], b[0]):.4f} ms ({min(a[1], b[1]):.4f})"
            + (f" [{min(a[2], b[2]):.4f}]" if more is not None else "")
            for (name, _, more), a, b in zip(timed, there, back)), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
