#!/usr/bin/env python3
"""Drive tpuimage_torch's paths once on one CUDA card: DocScanner's
serving paths (scan_batch, scan_stream) and its one-document path
(process_document), the night paths (gray and RGB), morph_seq,
landscape (the GUI route and the degrade / restore evaluation), face
(both tails of enhance_face), and classify and route (the heuristic
classifiers, CLIP ViT-B/32 and the label router over the four
enhancement paths), the notebook's pipelines and presets, and the CLIs
on PNG files.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It prints each check, the kernel rows (a kernel's times against its plain
version, a library call and the card's bound) and the times of the paths
no cell of the benchmark (``portbench/``) runs. A path a cell times from
host memory to host memory (scan_batch, docscan_post_warp_batch and
_pre_deskew_stages, landscape_gui, night_rgb) is run and checked here,
not timed.

Phases (any failure raises and the exit code is non-zero):

1. device and build: the card's name and power limit, the torch and CUDA
   versions, and the nvcc build of tpuimage_torch/csrc/*.cu;
2. DocScanner's kernels against their plain PyTorch versions on the card,
   at the paths' shapes (exact equality), with the median CUDA-event
   time of one call of each from runs of 20 eager calls (5 or 2 for the
   slower plain versions; the kernel's also from replays of a CUDA graph
   of 20 calls, its time without the host's launch cost, as ``graph_ms``),
   the least time the card could take (bound) and the share of it the
   graph time reaches, and, where PyTorch has one
   call or a short composition of calls for
   the same function, its time: hist256 and hough_votes; rank_extract on
   the same edge maps (each page one band, and tpuimage's 128-band
   layout; its bound the mask's bytes and the slots'; library: the same
   slots from torch.nonzero and an index put), beside the earlier
   nonzero compaction's time and compact_edges' whole device time (the
   profiler's kernel time of one call: the scan, the kernel, the
   coordinates); hough_votes' library: torch.bincount over the flat
   (image, rho, theta) bins, rho computed in the same call; the post-warp
   chain's gauss_chain (divide k=43, sub k=51, adaptive block 31; library
   for the first two: two cudnn conv2d passes and the epilogue's ops),
   gaussian_blur_u8 (k=43 and 51, and the wide 83 and 255), blackhat_rect
   (9x19; library: max_pool2d, 2-D or separable, the faster) and
   inkmask_weighted (library: compares, max_pool2d, where) on 8 synthetic
   A4 pages of 1200x849, the divide
   epilogue on all 65,536 pairs, and the split forms of the four kernels
   (windows too wide for their tiles: ksize 257, a 129x255 rectangle, 9
   dilations), exact but not timed; inkmask_weighted and binary_close3 on
   planes 1-3 bytes off a word boundary, widths 1-9 and 849, one row and
   one column, thresholds from -1 to 300 and NaN (``MASK_EDGE_*``), exact;
   bilateral on 8 gray photos of 1600x1200 (the preprocess, d 9, 75/75),
   one 12 MP gray photo, 8 colour images of 1280x853 (d 9, 100/75) and
   face's d -1, 30/10 (radius 15) on 2 colour images; hough_votes and the separable Gaussian
   (gauss_chain, gaussian_blur_u8) also on inputs chosen to break them
   (``synth.hough_stress_cases``, ``synth.BLUR_STRESS_SHAPES``; exact, not
   timed); inkmask_weighted also from a CUDA graph whose calls go round
   copies of the inputs that exceed the L2 cache (``rotated_graph_ms``;
   the four kernels of phase 7 likewise); hough_votes on random
   coordinates of the same lengths (its floor without runs of equal
   bins); Canny's two kernels, which replace no TPU
   kernel (``canny_pre`` and one hysteresis check), on the deskew's 8
   weighted pages and on 8 document photos of 1920x1080 (the benchmark's
   localize shape), exact and timed beside their plain versions, and the
   whole ``canny`` against the plain versions' loop;
3. the main path: ``scan_batch`` on 8 synthetic 1600x1200 photos (7
   documents, one with tilted text, and one with no page), with the
   kernels' launch counters reset just before and read just after, and
   each request's result checked; then ``_pre_deskew_stages`` on the 8
   pages with torch's sync debug mode set to error (a read back to the
   host fails); then the ``filters.gaussian_blur_u8`` op
   (cv2.GaussianBlur, which no stage of ``scan_batch`` calls) on the 8
   gray pages, counted as a path of its own;
4. card against host: two of those requests again on the CPU, and
   ``_pre_deskew_stages`` with ``thresh_method="mean"`` on 2 of the pages;
5. ``process_document`` on two of the photos (a quad page and the
   page-less one; in memory, no stage files: the path without its file
   I/O), counted, timed per document and held against the host;
6. ``scan_stream`` over 4 batches of the 8 photos (counted), timed in
   turns against a loop of ``scan_batch`` calls and against the stream
   without its threads (img/s), and ``scan_batch(pipeline_chunk=4)``,
   all equal to ``scan_batch``'s results; then
   ``scan_batch(fallback_common_shape=True)`` on the page-less photo
   against the host;
7. the night and morph_seq kernels against their plain versions, at the
   slices' shapes: rgb_to_lab and clahe_apply on 8 synthetic night scenes
   of 1280x853 (the reference's nightview.png), hist256 on their 512 CLAHE
   tile rows and on morph_seq's eroded planes, gray_erode3 and
   binary_close3 on 8 RGB document photos of 963x1280 (its sample.jpg;
   library: their erosion / closing as max_pool2d, 2-D or separable);
   rgb_to_lab, clahe_apply, gray_erode3 and binary_close3 also with
   ``rotated_graph_ms``; rgb_to_lab also on
   1-17 pixels and one past the batch, inputs 0-15 bytes past a 16-byte
   boundary, exact;
8. the paths: ``night_rgb_batch``, ``night_gray_batch`` and
   ``morphseq_batch`` on those inputs, each with the counters reset just
   before and read just after; the last two also timed (MP/s) with a
   profiled window (device busy time against the CUDA-event time,
   kernels per call, the top kernels);
9. card against host: two images of each path again on the CPU;
10. landscape on 8 synthetic daylight scenes of 1280x853
   (``synth.landscape_scene``, the size of phase 7's scenes): the kernels
   at its shapes (rgb_to_lab on the bilateral output, gaussian_blur_u8 at
   ksize 7 on the 24 planes of the sharpening, bilateral d 11 100/100 of
   the restore), then ``landscape_gui`` and ``landscape_eval_batch`` (noise
   from a seeded generator), each with the counters reset just before and
   read just after; the evaluation also MP/s, a profiled window and the
   peak device memory;
   card against host on 2 images; ``median_blur`` at ksize 5 and 7 and
   ``nlm_denoise_colored`` on one scene, timed once (not on the preset's
   path);
11. face on 4 synthetic portraits of 853x1280 (``synth.portrait``, with
   their eye boxes): the kernels at its shapes first, exact against their
   plain versions and timed (bilateral d 5, 20/20 on the portraits;
   gaussian_blur_u8 k 5 and 9 on each channel, k 21 on the skin masks,
   sigma 3 on L; rgb_to_lab, hist256 and clahe_apply on 8 eye regions of
   31-61 px at 4x4 tiles, one launch each); then ``enhance_face`` for
   (gaussian, script), (gaussian, gui) and (impulse, script), the noise
   classified and the eyes given, each with the counters reset just
   before and read just after, ms a portrait, MP/s, a profiled window and
   the peak device memory; the legacy NLM branch on one portrait and the
   Haar eye detector (native, on the host) timed once; card against host
   on 2 portraits of each combination;
12. classify and route on ``synth.scene_mix``: 8 images, 2 night scenes,
   2 landscape scenes (1280x853), 2 portraits and 2 document photos
   (853x1280): the cue program's kernels at its shapes first (hist256,
   rank_extract and hough_votes on each shape group's stack at the cue
   budget, and on two tall, narrow photos of 200x1600, where the budget
   is its 128 * h term), exact against their plain versions and timed,
   and the cue program card = host; then ``classify_weighted_batch`` and
   ``classify_priority_batch`` on the mix with the counters reset just
   before and read just after, their labels, the ms a batch beside the
   host's Haar face pass and a profiled window; CLIP ViT-B/32 built from
   ``synth.clip_state_dict`` (~151M seeded values) with the four prompts'
   text features from ``SimpleTokenizer(merges=synth.prompt_merges())``,
   ``predict_batch`` on 32 images of each shape and on 1 (images/s, peak
   device memory); ``enhance_for_label`` on all 8 (every route on the
   card, counted), then ``classify_and_enhance`` on each image (images/s,
   the routes taken, counted); card against host on all 8: labels and
   probabilities equal, CLIP probabilities within 1e-4 with the argmax
   equal, each route within its card-vs-host contract (3 levels on <
   0.1%; the binary page < 0.2% of pixels);
13. the notebook's pipelines and presets: its four kernels at its
   shapes first, exact against their plain versions and timed
   (gaussian_blur_u8 k 3 channel-last on 8 ``synth.shadowed_scene``s of
   1280x853, k 5 on the gray of a 1200x1600 document photo, sigma 1 on a
   1200x1600 ``synth.white_page``; rgb_to_lab on the scenes; hist256 on
   their CLAHE tiles and their L planes; clahe_apply at clip 2, 3 and
   4); then, each with the counters reset just before and read just
   after, ms a call, MP/s, the peak device memory and a profiled window:
   ``enhance_shadow_batch`` for each of the four presets on the 8 scenes,
   ``apply_categorization_preset`` with every stage on (each highlight
   curve) and ``apply_enhancement_preset`` (equalisation; CLAHE with sky
   protection) on the 8 scenes, modules 1 and 3-6 on one scene (module 2,
   the NLM, timed once), the document restoration's device core on the
   page (``_enhance_core``, Richardson-Lucy at 15 iterations,
   ``_segment_and_final``); ``auto_categorize`` on the scenes, a night
   scene and the page; card against host for every output (the presets'
   and appliers' first two scenes, DOCUMENT's first; the NLM's outputs
   within NLM_TOL, each later stage on the card's previous one equal);
14. the CLIs on PNG files: a 1200x1600 document photo, a 1280x963
   morph_seq photo, 8 night and 8 landscape scenes of 1280x853 and
   ``scene_mix(0)`` written as PNG; ``io/png.py``'s encode and decode of
   the photo timed (and PIL's, where it imports); where PIL imports, the
   face CLI (``--noise-type gaussian``; its output is a JPEG) first; then,
   with PIL's import made to fail, so that every file goes through
   ``io/png.py`` as on a machine without PIL, the five PNG CLIs: each
   ``main(argv)`` run twice (cold, then warm; one warm run since phase 15
   joined, to keep the script within half its time limit), the launch
   counters reset just before each run and read just after: morphseq,
   night ``--mode rgb`` and ``--mode gray`` with ``--histograms`` (one
   call a scene), landscape on the folder (``--seed 0``), docscan
   ``--gui-preset --profile``, classify on the mix; any ``FAILED`` line
   fails; each run's wall ms an image split into reading files, writing
   files (after a synchronize) and the rest (device work and host glue),
   MP/s, launches; every written PNG against the same entry point called
   in memory on the card (equal), night rgb and docscan on one input each
   also with ``--device cpu`` (card vs host as phases 9 and 5); then the
   build cache: the built libraries copied into a fresh directory and
   ``python -m tpuimage_torch.cli.morphseq`` run in a new process with
   ``TPUIMAGE_XLA_CACHE`` there, PIL hidden and no compiler on its PATH
   or under its CUDA_HOME: it must load the kernels' library from there
   and write the same files; the cold process's wall time;
15. the sharded runtime (``runtime/mesh.py``, ``runtime/spatial.py``) on
   a mesh of 4 shards on the one card, and on distinct cards where there
   are several (the count is printed): ``docscan_post_warp_spatial``
   under the GUI config on 8 A4 pages of 849x1200, on one 600-dpi A4 page
   of 4960x7016 (35 MP), on a tilted page (the rotation runs) and under
   the default config (the close runs), every stage equal to
   ``docscan_post_warp`` on the card, and on two A4 pages to the host's;
   ``docscan_post_warp_spatial_batch`` on a (data 2, space 2) mesh over
   the 8 pages, tilted and flat mixed; ``night_gray_spatial`` and
   ``night_rgb_spatial`` on 8 night scenes of 1280x856, equal to the
   unsharded composition, and ``lab_to_rgb(impl="lut")`` card = host on
   the whole 256^3 Lab grid; ``scan_batch(mesh=)`` on the 8 photos and on
   11 (the pad runs), ``scan_stream(mesh=)`` over 4 batches and
   ``process_document(space_mesh=)`` on 2 photos, each equal to its
   unsharded call. The sharded deskew takes tpuimage's edge budget a
   shard, so where the unsharded default budget overflows (the 35 MP page,
   the page-less photo's desk) the unsharded run it is held to gets a
   budget of every pixel; the default run's overflow is printed. Each path is counted (counters reset just before a
   call and read just after) and printed beside its unsharded run: ms a
   page (CUDA events, median of 3), launches, host reads (torch's sync
   debug warnings), the bytes of the halo exchanges, gathers and
   reductions, and the peak device memory;
16. the forms repaired when the port was closed, and its last public
   names, each card = host, the paths but the post-warp timed beside the
   card's name and power limit: the f64 cos / sin rounded to f32 at the
   81 quarter degrees in +-10, ``rotate_pages`` at all 81 on a 300x212
   crop and on 8 A4 pages, ``docscan_post_warp_batch`` under
   ``DocScanConfig()`` on them (every page rotated); PORTRAIT and the
   every-stage categorisation preset on 8 scenes of 1280x853 (counted);
   the Retinex's log on every 16th f32 of [1, 257] and the Retinex on a
   crop; ``canny(l2_gradient=True)`` on the 8 deskew maps and
   ``hough_lines(return_overflow=True)`` at a budget that overflows and
   one that does not (rank_extract and hough_votes counted, the flags
   equal the host's); ``warp_perspective_batch`` with a 127.5 border and
   a replicate one; ``otsu_threshold`` (counted);
17. the CLAHE apply in cv2's order and the batch warp in tpuimage's
   jitted form, on the repository's whole images: the ``clahe_apply``
   kernel equal to its plain version and to a numpy transcription of
   cv2's blend (``_clahe_cv2_order``) on the L of
   ``outputs/scan_02_quad.png`` and the gray of ``scan_03_warped.png`` at
   8x8 tiles (clip 2, 3, 40) and on eye regions of a portrait at 4x4
   (clip 0.2), each CLAHE card = host (counted: one launch a call);
   ``warp_perspective_batch`` of the photo through DocScanner's own quad
   (to its 1600-high page) and a skewed map, at the borders constant 0,
   replicate and constant 127.5, card = host.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the per-kernel JSON record (the twelve ported kernels and Canny's
two, each launched on some path). nvcc's full output is kept beside the
built library in tpuimage_torch/_build/.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from portbench import peaks

HERE = os.path.dirname(os.path.abspath(__file__))
N_REQUESTS = 8
PHOTO = (1600, 1200)      # height x width: a phone photo held upright
PAGE = (1200, 849)        # A4 portrait at GUI_DOCUMENT_CONFIG.scale_long
CELL_PHOTO = (1080, 1920)  # the benchmark's document photos, height x width
BINARY_TOL = 0.002        # share of binary pixels card and host may differ on
NIGHT = (853, 1280)       # nightview.png, height x width
MORPH = (963, 1280)       # sample.jpg, height x width
PHONE_PHOTO = (4032, 3024)  # a 12 MP phone photo, height x width
NIGHT_RGB_TOL = (3, 0.001)  # card vs host night_rgb: max levels, share of values
NLM_TOL = (2, 1e-4)         # card vs host NLM (its f32 exp): max levels, share of values
# the kernels _pre_deskew_stages launches, besides hist256
PRE_DESKEW_KERNELS = ("gauss_chain", "blackhat_rect", "inkmask_weighted")
WIDE_BLUR_KSIZES = (83, 255)   # the ends of the sliding-window form's Q8.8 range
L2_BYTES = 50 << 20            # the H100's L2 cache
# the byte-mask kernels (inkmask_weighted, binary_close3) read rows as
# aligned words: widths 1-9, one row, one column and DocScanner's 849, each
# plane starting 1-3 bytes past a word boundary, thresholds around and
# outside the byte range, iters in both of inkmask_weighted's forms
MASK_EDGE_SHAPES = tuple((2, 37, w) for w in range(1, 10)) + ((2, 70, 849), (1, 1, 849),
                                                              (1, 1200, 1))
MASK_EDGE_THRESHOLDS = (-1.0, -0.5, 0.0, 117.5, 254.0, 255.0, 300.0, float("nan"))
MASK_EDGE_ITERS = (0, 1, 8, 9)
LANDSCAPE_SHARPEN_KSIZE = 7    # GaussianBlur((0, 0), sigma 1) on bytes
PATH_STATS_TOL = (1e-4, 1e-3)  # card vs host: PSNR relative, SSIM absolute
FACE = (1280, 853)             # a portrait photo, height x width
N_FACE = 4
FACE_COMBOS = (("gaussian", "script"), ("gaussian", "gui"), ("impulse", "script"))
NARROW = (1600, 200)           # a tall, narrow photo: the cue's edge budget is 128 * h
CLIP_TOL = 1e-4                # card vs host: CLIP probabilities, absolute
# the cue program's kernels, and those of the four routes (all but morph_seq's)
CLASSIFY_KERNELS = ("hist256", "rank_extract", "hough_votes")
ROUTE_KERNELS = ("hist256", "rank_extract", "hough_votes", "rgb_to_lab", "clahe_apply",
                 "bilateral", "gaussian_blur_u8", "gauss_chain", "blackhat_rect",
                 "inkmask_weighted")
# the CLIs' paths (phase 14): the kernels the table in PERF.md gives each
CLI_KERNELS = {"morphseq": ("gray_erode3", "hist256", "binary_close3"),
               "night rgb": ("rgb_to_lab", "hist256", "clahe_apply"),
               "night gray": ("hist256", "clahe_apply"),
               "landscape": ("bilateral", "gaussian_blur_u8", "rgb_to_lab", "hist256",
                             "clahe_apply"),
               "docscan": ("bilateral", "rank_extract", "hough_votes", "gauss_chain",
                           "blackhat_rect", "hist256", "inkmask_weighted"),
               "classify": ROUTE_KERNELS,
               "face": ("hist256", "bilateral", "gaussian_blur_u8", "rgb_to_lab",
                        "clahe_apply")}


def _nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int = 10, calls: int = 1) -> float:
    """Median CUDA-event time of one call of fn in ms, after one warm
    call: each of ``reps`` samples times ``calls`` calls back to back, so
    that with calls > 1 the card's queue stays full and the host's launch
    overhead hides behind the device work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _wall_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of one call of fn in ms, after one warm call,
    each call ended by a synchronize: for paths whose host work (Haar,
    contours, fetches) the card's events do not see."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _graph_ms(fn, reps: int = 5, calls: int = 20) -> float:
    """Median CUDA-event time of one call of fn, from replays of a CUDA
    graph that holds ``calls`` calls: the card's time for a kernel without
    the host's cost of launching it, which exceeds the device time of the
    fastest kernels (``_cuda_ms`` of eager calls then reads the host). For
    the record beside the eager time, not instead of it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm: caches, the build, tables
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def _rotated_graph_ms(make_fn, inputs, reps: int = 5, calls: int = 20) -> float:
    """``_graph_ms`` with the graph's calls going round copies of the
    inputs (a tuple of tensors) that total more than the L2 cache, so that
    each call reads its inputs from device memory: ``make_fn(copy)`` gives
    the call on one copy."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    copies = [inputs] + [tuple(t.clone() for t in inputs)
                         for _ in range(L2_BYTES // nbytes + 1)]
    fns = [make_fn(c) for c in copies]
    turn = iter(range(10 ** 9))
    ms = _graph_ms(lambda: fns[next(turn) % len(fns)](), reps, calls)
    del fns, copies
    return ms


def _rotated(name: str, rec: dict, make_fn, inputs) -> None:
    """Add ``rotated_graph_ms`` (``_rotated_graph_ms``) to a kernel's
    record and print it beside the graph time on one copy."""
    rec["rotated_graph_ms"] = _rotated_graph_ms(make_fn, inputs)
    print(f"{name}: {rec['rotated_graph_ms']:.4f} ms from a CUDA graph whose calls go round "
          f"copies of the inputs > 50 MB ({rec['graph_ms']:.4f} ms on one copy); "
          f"{100 * rec['bound_ms'] / rec['rotated_graph_ms']:.1f}% of the bound")


def _at_offset(shape, offset: int, seed: int, dev) -> torch.Tensor:
    """A (B, H, W) uint8 plane on the card whose data starts ``offset``
    bytes past a word boundary: random bytes with runs of 0 and 255."""
    n = int(np.prod(shape))
    flat = np.random.default_rng(seed).integers(0, 256, n + offset, dtype=np.uint8)
    flat[offset::7] = 0
    flat[offset + 3::11] = 255
    x = torch.from_numpy(flat).to(dev)[offset:].view(shape)
    if x.data_ptr() % 4 != offset % 4:
        raise AssertionError("the plane does not start where it was asked to")
    return x


def _profile(fn, reps: int = 3):
    """One warm profiled window of ``reps`` calls of fn: (device kernel
    time per call in ms, kernels per call, the 3 kernels and the 3 aten
    ops with the most device time, each as (name, ms per call))."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            n += 1
    ops = {a.key: a.self_device_time_total for a in prof.key_averages()
           if a.key.startswith("aten::")}

    def top(d):
        return [(k[:60], v / reps / 1e3) for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:3]]

    return sum(by_name.values()) / reps / 1e3, n / reps, top(by_name), top(ops)


def _print_profile(what: str, wall_ms: float, fn) -> None:
    dev_ms, n, kernels, ops = _profile(fn)
    print(f"{what} profile: device busy {dev_ms:.3f} ms of {wall_ms:.3f} ms "
          f"({100 * dev_ms / wall_ms:.0f}%), {n:.0f} kernels per call; top kernels: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in kernels)
          + "; top ops: " + "; ".join(f"{k} {v:.3f} ms" for k, v in ops))


def _bound(nbytes: float, ops: float, ops_per_s: float = peaks.ALU_OPS_PER_S) -> dict:
    """The least time the card could take (``peaks.bound``) as a kernel
    record's ``bound_ms`` and ``bound_by``."""
    secs, by = peaks.bound(nbytes, ops, ops_per_s)
    return {"bound_ms": secs * 1e3, "bound_by": by}


def _hist256_bound(rows: torch.Tensor) -> dict:
    """Each byte read once and counted once, 256 int32 counts per row written."""
    return _bound(rows.numel() + rows.shape[0] * 256 * 4, rows.numel())


def _launched(path: str, counts: dict, needed) -> dict:
    """Print a path's launch counts and fail unless each of its kernels
    launched."""
    print(f"{path} launches: {counts}")
    for name in needed:
        if counts[name] <= 0:
            raise AssertionError(f"{path} never launched {name}")
    return counts


def _exact(name, kernel_fn, plain_fn):
    """Hold a kernel's output (a tensor or a tuple of them) against its
    plain version's: exact. Returns the outputs and the max |diff| (0)."""
    outs, refs = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    err = 0
    for out, ref in zip(outs, refs, strict=True):
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise AssertionError(f"{name}: {tuple(out.shape)} {out.dtype} vs "
                                 f"{tuple(ref.shape)} {ref.dtype}")
        err = max(err, int((out.to(torch.int64) - ref.to(torch.int64)).abs().max()))
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max |diff| {err})")
    return outs, err


def _compare(name, kernel_fn, plain_fn, bound: dict, library_fns=(),
             plain_calls: int = 20, library_output: int = 0) -> dict:
    """``_exact``, then times the kernel and its plain version and returns
    the kernel's record. ``library_fns``, where PyTorch has one call (or a
    short composition of its calls) for the same function, must each give
    the kernel's output number ``library_output`` too; the fastest is the
    library yardstick. A plain version that takes tens of ms a call is
    timed over ``plain_calls``."""
    outs, err = _exact(name, kernel_fn, plain_fn)
    library = []
    for fn in library_fns:
        if not torch.equal(fn().to(torch.int64), outs[library_output].to(torch.int64)):
            raise AssertionError(f"{name}: a library yardstick computes another function")
        library.append(_cuda_ms(fn, reps=5, calls=20))
    rec = {"max_abs_err": err, "ms": _cuda_ms(kernel_fn, reps=5, calls=20),
           "plain_ms": _cuda_ms(plain_fn, reps=5 if plain_calls > 2 else 3, calls=plain_calls),
           **bound, "library_ms": min(library) if library else None,
           "graph_ms": _graph_ms(kernel_fn)}
    print(f"{name}: shape {tuple(outs[0].shape)} exact; kernel {rec['ms']:.4f} ms "
          f"({rec['graph_ms']:.4f} ms from a CUDA graph), plain {rec['plain_ms']:.4f} ms, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
          f"the graph time at {100 * rec['bound_ms'] / rec['graph_ms']:.1f}% of it)"
          + (f", library {' / '.join(f'{t:.4f}' for t in library)} ms" if library else ""))
    return rec


def _face_clahe_kernels(what: str, planes, clip: float, grid: int, key: str,
                        records: dict) -> None:
    """hist256 and clahe_apply on each (1, H, W) L plane at ``grid`` x
    ``grid`` tiles, as ``histogram.clahe`` calls them: each kernel exact
    against its plain version and timed, one launch a plane; then the whole
    CLAHE on the card equal to the host's."""
    from tpuimage_torch.ops import histogram, kernels
    tiles = [histogram.clahe_tiles(p, grid, grid) for p in planes]
    rec = _compare(
        f"hist256 {what}",
        lambda: tuple(kernels.hist256_batch(t) for t, _, _ in tiles),
        lambda: tuple(kernels.hist256_batch_ref(t) for t, _, _ in tiles),
        _bound(sum(t.numel() + t.shape[0] * 1024 for t, _, _ in tiles),
               sum(t.numel() for t, _, _ in tiles)))
    _sub_record(records["hist256"], key, rec)
    args = []
    for p, (t, th, tw) in zip(planes, tiles):
        luts = histogram.tile_luts_from_counts(kernels.hist256_batch(t), clip, th * tw)
        r, c = histogram.blend_tables_on(p.shape[1], p.shape[2], th, tw, grid, grid,
                                           p.device)
        args.append((p, luts.reshape(1, grid, grid, 256), r, c))
    n = sum(a[0].numel() for a in args)
    rec = _compare(
        f"clahe_apply {what}",
        lambda: tuple(kernels.clahe_apply(*a) for a in args),
        lambda: tuple(kernels.clahe_apply_ref(*a) for a in args),
        _bound(sum(2 * a[0].numel() + a[1].numel() + 4 * (a[2].numel() + a[3].numel())
                   for a in args), 9 * n))
    _sub_record(records["clahe_apply"], key, rec)
    for p in planes:
        if not torch.equal(histogram.clahe(p, clip, grid, grid).cpu(),
                           histogram.clahe(p.cpu(), clip, grid, grid)):
            raise AssertionError(f"CLAHE {what} {tuple(p.shape)}: card and host differ")


def _sub_record(rec: dict, what: str, sub: dict) -> None:
    """Fold the record of one more shape or mode of a kernel into its
    record under ``what``."""
    rec["max_abs_err"] = max(rec["max_abs_err"], sub["max_abs_err"])
    rec.update({f"{what}_{k}": sub[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                "graph_ms", "compact_edges_device_ms")
                if sub.get(k) is not None})


def _compact_edges_nonzero(edges: torch.Tensor, k: int):
    """The port's edge compaction before rank_extract (torch.nonzero and
    index scatters), kept here only to time it beside the kernel's form."""
    b, h, w = edges.shape
    flat = edges.reshape(b, h * w) > 0
    true_counts = flat.sum(dim=1)
    counts = torch.clamp(true_counts, max=k)
    kk = max(int(counts.max()) if b else 0, 1)
    rows, idx = torch.nonzero(flat, as_tuple=True)
    starts = torch.cumsum(true_counts, 0) - true_counts
    pos = torch.arange(rows.shape[0], device=edges.device) - starts[rows]
    keep = pos < k
    rows, idx, pos = rows[keep], idx[keep], pos[keep]
    xs = torch.zeros((b, kk), dtype=torch.int32, device=edges.device)
    ys = torch.zeros((b, kk), dtype=torch.int32, device=edges.device)
    xs[rows, pos] = (idx % w).to(torch.int32)
    ys[rows, pos] = torch.div(idx, w, rounding_mode="floor").to(torch.int32)
    return xs, ys, counts.to(torch.int32), true_counts > k


def _rank_extract_nonzero(mask: torch.Tensor, kk: int) -> torch.Tensor:
    """rank_extract's slots from the mask alone by torch.nonzero and an
    index put (the compaction of ``_compact_edges_nonzero``): the library
    yardstick, used nowhere in the port."""
    b, p = torch.nonzero(mask.t(), as_tuple=True)      # band-major, positions ascending
    counts = mask.sum(dim=0)
    r = torch.arange(b.shape[0], device=mask.device) - (torch.cumsum(counts, 0) - counts)[b]
    keep = r < kk
    ci = torch.zeros((kk, mask.shape[1]), dtype=torch.int32, device=mask.device)
    ci[r[keep], b[keep]] = p[keep].to(torch.int32)
    return ci


def _hough_bincount(xs, ys, counts, cos_t, sin_t, numrho: int, shift: int) -> torch.Tensor:
    """hough_votes as torch.bincount over the flat (image, rho, theta) bins,
    rho = rint(fma(x, cos, f32(y sin))) + shift computed in the same call
    (the fma exact through f64): the library yardstick."""
    b, k = xs.shape
    t = cos_t.shape[0]
    valid = torch.arange(k, device=xs.device)[None, :] < counts[:, None]
    img = torch.arange(b, device=xs.device)[:, None].expand(b, k)[valid]
    x, y = xs[valid].to(torch.float64)[:, None], ys[valid].to(torch.float32)[:, None]
    rho = torch.round((x * cos_t.double()[None, :] + (y * sin_t[None, :]).double())
                      .to(torch.float32)).to(torch.int64) + shift
    flat = (img[:, None] * numrho + rho) * t + torch.arange(t, device=xs.device)[None, :]
    return torch.bincount(flat.reshape(-1), minlength=b * numrho * t).view(b, numrho, t)


def _rank_planes(edges: torch.Tensor, k: int, tpu_layout: bool = False):
    """rank_extract's inputs for a (B, H, W) edge batch as compact_edges
    makes them: each image's flat plane one band, given as the (H*W, B)
    view of the page-major plane, and K. With ``tpu_layout``, the first
    image as tpuimage lays it out: position-major (N, 128), N padded to a
    multiple of 512, with its per-band budget."""
    b, h, w = edges.shape
    if tpu_layout:
        n_over_b = -(-h * w // 128)
        n_pad = n_over_b + (-n_over_b) % 512
        flat = torch.zeros(n_pad * 128, dtype=torch.bool, device=edges.device)
        flat[:h * w] = edges[0].reshape(-1) > 0
        mask = flat.reshape(n_pad, 128)
        pi = mask.to(torch.int32)
        return (torch.cumsum(pi, dim=0, dtype=torch.int32) - pi, mask,
                min(max(1, k // 128), n_over_b))
    from tpuimage_torch.ops.hough import exclusive_rank
    flat = edges.reshape(b, h * w) > 0
    rank, counts = exclusive_rank(flat)
    return rank.t(), flat.t(), max(int(torch.clamp(counts, max=k).max()), 1)


def _rank_bound(mask: torch.Tensor, kk: int) -> dict:
    """The least bytes the function needs: every mask byte read once and
    the kk x nb int32 slots written once (rank is the mask's exclusive
    cumsum, so a design may derive it and read none of it)."""
    return _bound(mask.numel() + 4 * kk * mask.shape[1], 0)


def _bilateral_bound(img: torch.Tensor, ntaps: int) -> dict:
    """Each byte read and written once; per pixel and tap, gray: |diff|,
    the table lookup, two multiplies and two adds (6); colour: three
    |diff| and their two adds, the lookup, the weight's multiply, and per
    channel a multiply and an add, then the weights' add (14)."""
    n_px = img.numel() // (3 if img.dim() == 4 else 1)
    return _bound(2 * img.numel(), (14 if img.dim() == 4 else 6) * ntaps * n_px)


def _card_vs_host(what: str, c: dict, h: dict) -> None:
    """One request's result on the card against the host's: use_whole and
    the deskew angle equal, quads within 0.5 px, < BINARY_TOL of the binary
    page's pixels different."""
    if c["use_whole"] != h["use_whole"] or c["deskew_angle"] != h["deskew_angle"]:
        raise AssertionError(f"{what}: card {c['use_whole']}/{c['deskew_angle']} "
                             f"vs host {h['use_whole']}/{h['deskew_angle']}")
    if (c["quad"] is None) != (h["quad"] is None) or (
            c["quad"] is not None and np.abs(c["quad"] - h["quad"]).max() > 0.5):
        raise AssertionError(f"{what}: quads differ {c['quad']} vs {h['quad']}")
    if c["binary"].shape != h["binary"].shape:
        raise AssertionError(f"{what}: binary {c['binary'].shape} vs {h['binary'].shape}")
    frac = float((c["binary"] != h["binary"]).mean())
    if frac >= BINARY_TOL:
        raise AssertionError(f"{what}: {frac:.5f} of binary pixels differ")
    print(f"card vs host, {what}: quad/angle/use_whole equal, {frac:.6f} of binary pixels "
          f"differ (limit {BINARY_TOL})")


def _doc_request(r: dict) -> dict:
    """process_document's result in scan_batch's per-request form."""
    return {"use_whole": r["use_whole"], "quad": r["quad"],
            "deskew_angle": float(r["stages"]["deskew_angle"]),
            "binary": r["binary"].cpu().numpy()}


def _same_result(a: dict, b: dict) -> bool:
    if set(a) != set(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if x is None or y is None or not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


def _pool_max(x: torch.Tensor, kh: int, kw: int, separable: bool) -> torch.Tensor:
    """The max over a kh x kw window (kw, kh odd) of each plane of a float
    (B, H, W) tensor, clipped to the plane (``max_pool2d`` pads with -inf):
    one 2-D ``max_pool2d``, or a (kh, 1) and a (1, kw) one."""
    pool = torch.nn.functional.max_pool2d
    if separable:
        return pool(pool(x, (kh, 1), 1, (kh // 2, 0)), (1, kw), 1, (0, kw // 2))
    return pool(x, (kh, kw), 1, (kh // 2, kw // 2))


def _pool_close(x: torch.Tensor, kh: int, kw: int, separable: bool) -> torch.Tensor:
    """close = erode(dilate(x)) with a kh x kw rectangle and the kernels'
    borders (0 for the dilation, 255 for the erosion: the window clipped to
    the plane) as ``max_pool2d`` calls."""
    return -_pool_max(-_pool_max(x, kh, kw, separable), kh, kw, separable)


def _conv_blur_u8(padded: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """cv2.GaussianBlur 8u as PyTorch's own convolution: two 1-D f32
    ``conv2d`` passes over the reflect-padded plane (TF32 off, so the
    integer sums are exact), then the Q16.16 rounding."""
    k = taps.shape[0]
    v = torch.nn.functional.conv2d(padded, taps.view(1, 1, k, 1))
    acc = torch.nn.functional.conv2d(v, taps.view(1, 1, 1, k))
    return torch.clamp(torch.floor((acc + 32768.0) * (1.0 / 65536.0)), 0, 255
                       ).to(torch.uint8)[:, 0]


def _path_run(name: str, fn, needed, launches: dict, n_px: int, reps: int = 3):
    """One path on the card: a warm call, one counted call (its launches
    added to ``launches``), then ms a call (CUDA events, median of
    ``reps``), MP/s, the peak device memory and a profiled window (the
    busy share). Returns the counted call's output."""
    fn()
    torch.cuda.synchronize()
    from tpuimage_torch.ops import kernels
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    for k_, v in _launched(name, kernels.launch_counts(), needed).items():
        launches[k_] += v
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    ms = _cuda_ms(fn, reps=reps, calls=1)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"{name}: {ms:.3f} ms a call = {n_px / 1e3 / ms:.1f} MP/s (CUDA events, warm, median "
          f"of {reps}, input on the card); device memory: peak {peak_mb - base_mb:.1f} MiB "
          f"above the {base_mb:.1f} MiB held before the calls")
    _print_profile(name, ms, fn)
    return out


def _card_equals_host(what: str, card: torch.Tensor, host: torch.Tensor,
                      tol=(0, 0.0)) -> None:
    """A card output against the same call on the host: at most ``tol``
    (levels, share of values); (0, 0) is equality."""
    card = card.cpu()
    if card.shape != host.shape or card.dtype != host.dtype:
        raise AssertionError(f"{what}: card {tuple(card.shape)} {card.dtype} vs host "
                             f"{tuple(host.shape)} {host.dtype}")
    if card.is_floating_point():
        err = float((card - host).abs().max()) if card.numel() else 0.0
        if err > tol[0]:
            raise AssertionError(f"{what}: card vs host max |diff| {err}")
        print(f"card vs host, {what}: max |diff| {err:.3g} (limit {tol[0]})")
        return
    diff = (card.to(torch.int32) - host.to(torch.int32)).abs()
    n_diff = int((diff > 0).sum())
    worst = int(diff.max()) if diff.numel() else 0
    if worst > tol[0] or (n_diff > 0 and n_diff >= tol[1] * diff.numel()):
        raise AssertionError(f"{what}: {n_diff} of {diff.numel()} values differ, by up to {worst}")
    print(f"card vs host, {what}: {n_diff} of {diff.numel()} values differ, max |diff| {worst}")


def _notebook_phase(dev, tables, records: dict, launches: dict, cudnn_tf32: bool) -> None:
    """Phase 13: the notebook's shadow pipeline, the preset appliers,
    modules 1-6 and the document restoration's device core on the card
    (the module docstring, item 13)."""
    from tpuimage_torch import synth
    from tpuimage_torch.core.borders import pad2d
    from tpuimage_torch.ops import color, histogram, kernels, restore
    from tpuimage_torch.ops.filters import gaussian_kernel_q8
    from tpuimage_torch.pipelines import docrestore, modules, shadow
    from tpuimage_torch.presets import apply as preset_apply
    from tpuimage_torch.presets.loader import CategorizationPreset, EnhancementPreset

    scenes = np.stack([synth.shadowed_scene(1300 + i, *NIGHT) for i in range(N_REQUESTS)])
    scenes_d = torch.from_numpy(scenes).to(dev)
    n_sc = N_REQUESTS * NIGHT[0] * NIGHT[1]
    doc = synth.white_page(1390, *PHOTO)                  # the 1200x1600 document
    doc_d = torch.from_numpy(doc).to(dev)
    doc_photo_d = torch.from_numpy(synth.document_photo(1391, *PHOTO)).to(dev)

    # 13.1 the four kernels at the slice's shapes, each exact against its plain version
    torch.backends.cudnn.allow_tf32 = False
    blur_inputs = (
        ("shadow_k3", f"k=3 channel-last, the unsharp's blur of the {N_REQUESTS} shadowed scenes "
         f"{NIGHT[1]}x{NIGHT[0]} ({3 * N_REQUESTS} planes)", scenes_d.movedim(-1, -3).reshape(-1, *NIGHT), 3, 0.0),
        ("persp_k5", "k=5 on the gray of a 1200x1600 document photo (the automatic "
         "perspective's blur)", color.rgb_to_gray(doc_photo_d)[None], 5, 0.0),
        ("doc_k7", "sigma 1 (k=7) channel-last on the 1200x1600 document (the docrestore "
         "unsharp's blur, 3 planes)", doc_d.movedim(-1, -3), 7, 1.0))
    for key, what, planes, k, sigma in blur_inputs:
        planes = planes.contiguous()
        n_p = planes.numel()
        padded = pad2d(planes.to(torch.float32), k // 2, k // 2, k // 2, k // 2)[:, None]
        taps = torch.from_numpy(gaussian_kernel_q8(k, sigma).astype(np.float32)).to(dev)
        rec = _compare(f"gaussian_blur_u8 notebook {what}; library: two cudnn conv2d 1-D passes "
                       "+ rounding",
                       lambda: kernels.gaussian_blur_u8(planes, k, sigma),
                       lambda: kernels.gaussian_blur_u8_ref(planes, k, sigma),
                       _bound(2 * n_p + 4 * k, 2 * 2 * k * n_p, peaks.INT8_TENSOR_OPS_PER_S),
                       [lambda: _conv_blur_u8(padded, taps)])
        _sub_record(records["gaussian_blur_u8"], f"notebook_{key}", rec)
        del padded
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    rec = _compare(f"rgb_to_lab notebook ({N_REQUESTS} shadowed scenes {NIGHT[1]}x{NIGHT[0]})",
                   lambda: kernels.rgb_to_lab(scenes_d, tables),
                   lambda: kernels.rgb_to_lab_ref(scenes_d, tables),
                   _bound(6 * n_sc + 4 * tables.numel(), 47 * n_sc))
    _sub_record(records["rgb_to_lab"], "notebook", rec)
    lum = color.rgb_to_lab(scenes_d)[..., 0].contiguous()
    tiles, th, tw = histogram.clahe_tiles(lum, 8, 8)
    offset_tiles = (tiles.to(torch.int64) + 256 * torch.arange(tiles.shape[0], device=dev)[:, None]
                    ).reshape(-1)
    rec = _compare(f"hist256 notebook CLAHE tiles ({tiles.shape[0]} tiles of the scenes' L)",
                   lambda: kernels.hist256_batch(tiles), lambda: kernels.hist256_batch_ref(tiles),
                   _hist256_bound(tiles),
                   [lambda: torch.bincount(offset_tiles, minlength=tiles.shape[0] * 256
                                           ).view(tiles.shape[0], 256)])
    _sub_record(records["hist256"], "notebook_clahe", rec)
    rows = lum.reshape(N_REQUESTS, -1)
    offset_rows = (rows.to(torch.int64) + 256 * torch.arange(N_REQUESTS, device=dev)[:, None]
                   ).reshape(-1)
    rec = _compare(f"hist256 notebook equalize_hist ({N_REQUESTS} L planes {NIGHT[1]}x{NIGHT[0]})",
                   lambda: kernels.hist256_batch(rows), lambda: kernels.hist256_batch_ref(rows),
                   _hist256_bound(rows),
                   [lambda: torch.bincount(offset_rows, minlength=N_REQUESTS * 256
                                           ).view(N_REQUESTS, 256)])
    _sub_record(records["hist256"], "notebook_equalize", rec)
    del offset_tiles, offset_rows
    counts = kernels.hist256_batch(tiles)
    R, C = histogram.blend_tables_on(NIGHT[0], NIGHT[1], th, tw, 8, 8, dev)
    for clip in (2, 3, 4):
        luts = histogram.tile_luts_from_counts(counts, clip, th * tw).reshape(-1, 8, 8, 256)
        rec = _compare(f"clahe_apply notebook clip {clip} ({N_REQUESTS} L planes "
                       f"{NIGHT[1]}x{NIGHT[0]}, 8x8 tiles)",
                       lambda: kernels.clahe_apply(lum, luts, R, C),
                       lambda: kernels.clahe_apply_ref(lum, luts, R, C),
                       _bound(2 * lum.numel() + luts.numel() + 4 * (R.numel() + C.numel()),
                              9 * lum.numel()))
        _sub_record(records["clahe_apply"], f"notebook_clip{clip}", rec)
    del lum, tiles, rows, counts

    # 13.2 the shadow pipeline, each preset on the 8 scenes; the categories
    shadow_card = {}
    for name, preset in shadow.PRESETS.items():
        needed = ("rgb_to_lab", "hist256", "clahe_apply") if preset.use_clahe else ()
        needed += ("gaussian_blur_u8",) if preset.use_unsharp else ()
        final, mask = _path_run(f"enhance_shadow_batch {name} ({N_REQUESTS} scenes "
                                f"{NIGHT[1]}x{NIGHT[0]})",
                                lambda: shadow.enhance_shadow_batch(scenes_d, preset), needed,
                                launches, n_sc)
        covered = float((mask > 0.5).float().mean())
        if final.shape != scenes_d.shape or not 0.02 < covered < 0.98 or \
                not bool((final != scenes_d).any()):
            raise AssertionError(f"shadow {name}: {tuple(final.shape)}, mask covers {covered:.3f}")
        print(f"enhance_shadow_batch {name}: the mask covers {covered:.3f} of the scenes")
        shadow_card[name] = (final[:2].cpu(), mask[:2].cpu())
        del final, mask
    night_scene = synth.night_scene(1395, *NIGHT)
    labels = [shadow.auto_categorize(scenes_d[i]) for i in range(N_REQUESTS)]
    labels += [shadow.auto_categorize(night_scene), shadow.auto_categorize(doc)]
    print(f"auto_categorize: the {N_REQUESTS} scenes {labels[:-2]}, a night scene {labels[-2]}, "
          f"the document {labels[-1]}")
    if labels[-2] != "NIGHT" or labels[-1] != "DOCUMENT" or "GENERAL" not in labels[:-2]:
        raise AssertionError(f"auto_categorize: {labels}")
    ms = _wall_ms(lambda: [shadow.auto_categorize(scenes_d[i]) for i in range(N_REQUESTS)])
    print(f"auto_categorize: {ms / N_REQUESTS:.3f} ms an image (host clock, the cues fetched)")

    # 13.3 the preset appliers on the scenes
    every = CategorizationPreset(
        name="every", group="g", brightness_mode="gamma", brightness_gamma=0.9,
        linear_boost_beta=4.0, contrast_mode="clahe", clahe_clip=2.0, saturation_mult=1.2,
        saturation_cap=0.5, gray_world=True, chroma_boost_cb=1.1, chroma_boost_cr=1.05,
        highlight_compression="sqrt", local_contrast=True, lc_radius=2.0, lc_amount=0.6,
        lc_threshold=1.0, invert=True)
    cat_fn, enh_fn = preset_apply.apply_categorization_preset, preset_apply.apply_enhancement_preset
    appliers = [(f"apply_categorization_preset every stage, {curve} curve", cat_fn,
                 dataclasses.replace(every, highlight_compression=curve),
                 ("rgb_to_lab", "hist256", "clahe_apply"))
                for curve in ("sqrt", "log", "mild_sqrt")]
    appliers += [("apply_enhancement_preset equalisation", enh_fn,
                  EnhancementPreset(name="eq", group="g", contrast_alpha=1.1,
                                    hist_method="equalization"), ("rgb_to_lab", "hist256")),
                 ("apply_enhancement_preset CLAHE with sky protection", enh_fn,
                  EnhancementPreset(name="sky", group="g", hist_method="clahe", clahe_clip=2.2,
                                    sky_protection_power=2.0, blend_strength=0.55),
                  ("rgb_to_lab", "hist256", "clahe_apply"))]
    applier_card = {}
    for what, fn, preset, needed in appliers:
        out = _path_run(f"{what} ({N_REQUESTS} scenes)", lambda fn=fn, p=preset: fn(scenes_d, p),
                        needed, launches, n_sc)
        applier_card[what] = out[:2].cpu()

    # 13.4 modules 1-6 on one scene
    one = scenes_d[0]
    module_calls = (
        ("module1_enhance", lambda x, **kw: modules.module1_enhance(x, **kw),
         ("rgb_to_lab", "hist256", "clahe_apply", "gaussian_blur_u8")),
        ("module3_transform (rotate 12, scale 0.8, translate (25, -15))",
         lambda x, **kw: modules.module3_transform(x, 12.0, 0.8, (25, -15), **kw), ()),
        ("module4_segment", lambda x, **kw: modules.module4_segment(x, **kw), ()),
        ("module5_color YCrCb", lambda x, **kw: modules.module5_color(x, "YCRCB", **kw),
         ("rgb_to_lab", "hist256", "clahe_apply")),
        ("module6_features", lambda x, **kw: modules.module6_features(x, **kw)["edge_map"], ()))
    module_card = {}
    for what, fn, needed in module_calls:
        module_card[what] = _path_run(f"{what} (1 scene {NIGHT[1]}x{NIGHT[0]})",
                                      lambda fn=fn: fn(one), needed, launches,
                                      NIGHT[0] * NIGHT[1]).cpu()
    feats = modules.module6_features(one)
    print("module6_features: " + ", ".join(f"{k} {float(v):.4f}" for k, v in feats.items()
                                           if k != "edge_map"))
    ms = _cuda_ms(lambda: modules.module2_restore(one), reps=1, calls=1)
    module_card["module2_restore"] = modules.module2_restore(one).cpu()
    print(f"module2_restore (median 3, NLM h 10) on 1 scene {NIGHT[1]}x{NIGHT[0]}: {ms:.1f} ms "
          "(one warm call)")

    # 13.5 the document restoration's device core on the 1200x1600 document
    n_doc = PHOTO[0] * PHOTO[1]
    den, cl, sharp = _path_run(f"docrestore _enhance_core (1 document {PHOTO[1]}x{PHOTO[0]})",
                               lambda: docrestore._enhance_core(doc_d),
                               ("rgb_to_lab", "hist256", "clahe_apply", "gaussian_blur_u8"),
                               launches, n_doc, reps=1)
    gray = color.rgb_to_gray(sharp)
    deblurred = _path_run(f"richardson_lucy_gray 15 iterations (1 gray {PHOTO[1]}x{PHOTO[0]})",
                          lambda: restore.richardson_lucy_gray(gray, 15), (), launches, n_doc)
    seg, final, doc_edges = _path_run(f"docrestore _segment_and_final (1 gray {PHOTO[1]}x{PHOTO[0]})",
                                      lambda: docrestore._segment_and_final(deblurred), (),
                                      launches, n_doc)
    text = float((seg < 128).float().mean())
    print(f"docrestore: text covers {text:.3f} of the page, {int((doc_edges > 0).sum())} edge "
          "pixels")
    if not 0.005 < text < 0.5:
        raise AssertionError(f"docrestore: the segmentation marks {text:.3f} as text")

    # 13.6 card against host: the same calls with device="cpu" (the presets'
    # and appliers' first two scenes, DOCUMENT's first, whose 641-tap Retinex
    # is ~12 s a scene on the host; module 2 and the core at their full size)
    for name, (final_c, mask_c) in shadow_card.items():
        k = 1 if name == "DOCUMENT" else 2
        final_h, mask_h = shadow.enhance_shadow_batch(scenes[:k], shadow.PRESETS[name],
                                                      device="cpu")
        _card_equals_host(f"enhance_shadow_batch {name} mask", mask_c[:k], mask_h)
        tol = (0, 0.0) if name in ("DOCUMENT", "NIGHT") else NIGHT_RGB_TOL
        _card_equals_host(f"enhance_shadow_batch {name}", final_c[:k], final_h, tol)
    for what, fn, preset, _ in appliers:
        _card_equals_host(what, applier_card[what], fn(scenes[:2], preset, device="cpu"),
                          NIGHT_RGB_TOL)
    one_h = scenes[0]
    for what, fn, _ in module_calls:
        _card_equals_host(what, module_card[what], fn(one_h, device="cpu"), NIGHT_RGB_TOL)
    _card_equals_host("module2_restore (its NLM's f32 exp)", module_card["module2_restore"],
                      modules.module2_restore(one_h, device="cpu"), NLM_TOL)
    feats_h = modules.module6_features(one_h, device="cpu")
    for k_, v in feats.items():
        if k_ != "edge_map":
            _card_equals_host(f"module6_features {k_}", v, feats_h[k_], (1e-3 * abs(float(v)), 0))
    # the core stage by stage: the NLM (its f32 exp) within NLM_TOL, each later
    # stage on the card's previous one equal
    _card_equals_host("docrestore _denoise (its NLM's f32 exp)", den,
                      docrestore._denoise(torch.from_numpy(doc)), NLM_TOL)
    _card_equals_host("docrestore _clahe_l", cl, docrestore._clahe_l(den.cpu()))
    _card_equals_host("docrestore _stretch_sharpen", sharp,
                      docrestore._stretch_sharpen(cl.cpu()))
    deblurred_h = restore.richardson_lucy_gray(gray.cpu(), 15)
    _card_equals_host("richardson_lucy_gray", deblurred, deblurred_h, (1, 0.001))
    for what, c, h in zip(("seg", "final", "edges"), (seg, final, doc_edges),
                          docrestore._segment_and_final(deblurred.cpu())):
        _card_equals_host(f"docrestore _segment_and_final {what}", c, h)
    del scenes_d, doc_d, doc_photo_d, den, cl, sharp, gray, deblurred, seg, final, doc_edges


class _IOClock:
    """Times the port's file reads and writes inside a CLI run: wraps
    ``imageio.load_image_rgb`` and ``imageio.save_image`` in every module of
    the port that holds them, each write after a synchronize (the device
    work a write waits on is not counted as writing; the copy to the host
    is). Used only to split a run's wall time."""

    def __init__(self):
        self.read = self.write = 0.0
        self._patched = []

    def __enter__(self):
        from tpuimage_torch.io import imageio
        load, save = imageio.load_image_rgb, imageio.save_image

        def timed_load(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return load(*args, **kwargs)
            finally:
                self.read += time.perf_counter() - t0

        def timed_save(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return save(*args, **kwargs)
            finally:
                self.write += time.perf_counter() - t0

        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("tpuimage_torch"):
                for name, orig, new in (("load_image_rgb", load, timed_load),
                                        ("save_image", save, timed_save)):
                    if getattr(mod, name, None) is orig:
                        setattr(mod, name, new)
                        self._patched.append((mod, name, orig))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._patched:
            setattr(mod, name, orig)


def _cli_run(cli: str, argvs) -> tuple:
    """One run of a CLI's main() over ``argvs`` (one call each), the
    launch counters reset just before and read just after: (wall s, read
    s, write s, launch counts, what it printed). Fails on a FAILED line."""
    import contextlib
    import importlib
    import io
    from tpuimage_torch.ops import kernels
    main = importlib.import_module(f"tpuimage_torch.cli.{cli}").main
    out = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    clock = _IOClock()
    t0 = time.perf_counter()
    with clock, contextlib.redirect_stdout(out):
        for argv in argvs:
            main(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    failed = [ln for ln in out.getvalue().splitlines() if "FAILED" in ln]
    if failed:
        raise AssertionError(f"{cli}: {failed}")
    return wall, clock.read, clock.write, counts, out.getvalue()


def _png_equal(what: str, path: str, tensor: torch.Tensor) -> None:
    from tpuimage_torch.io.png import read_png
    got, want = read_png(path), tensor.cpu().numpy()
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{what}: {os.path.basename(path)} differs from the in-memory "
                             f"result on the card")


@contextlib.contextmanager
def _without_pil():
    """PIL's import fails inside (its ``sys.modules`` entries set to None),
    as on a machine without PIL: the port's image I/O then takes
    ``io/png.py``."""
    saved = {m: sys.modules[m] for m in list(sys.modules) if m.split(".")[0] == "PIL"}
    for m in ("PIL", "PIL.Image", *saved):
        sys.modules[m] = None
    try:
        yield
    finally:
        for m in [m for m in sys.modules if m.split(".")[0] == "PIL"]:
            del sys.modules[m]
        sys.modules.update(saved)


def _cli_record(label: str, cli: str, argvs, imgs, launches: dict) -> dict:
    """Two runs of a CLI (cold, then warm), each launching its path's
    kernels; the warm run's ms an image split into reading, writing and
    the rest; the first run's launches added to ``launches``."""
    mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
    runs = [_cli_run(cli, argvs) for _ in range(2)]
    for r in runs:
        _launched(f"cli {label}", r[3], CLI_KERNELS[label])
    for k_, v in runs[0][3].items():
        launches[k_] += v
    n, warm = len(imgs), runs[1:]
    wall = statistics.mean(r[0] for r in warm)
    read = statistics.mean(r[1] for r in warm)
    write = statistics.mean(r[2] for r in warm)
    rec = {"images": n, "megapixels": mp, "cold_ms": runs[0][0] * 1e3,
           "warm_ms": [r[0] * 1e3 for r in warm], "ms_per_image": wall * 1e3 / n,
           "read_ms_per_image": read * 1e3 / n, "write_ms_per_image": write * 1e3 / n,
           "device_and_glue_ms_per_image": (wall - read - write) * 1e3 / n,
           "io_share": (read + write) / wall, "mp_per_s": mp / wall,
           "launches": {k_: v for k_, v in runs[0][3].items() if v}}
    print(f"cli {label}: {n} image(s), {mp:.3f} MP; cold {rec['cold_ms']:.1f} ms, warm "
          f"{rec['warm_ms'][0]:.1f} ms = "
          f"{rec['ms_per_image']:.1f} ms an image (reading {rec['read_ms_per_image']:.1f}, "
          f"device and glue {rec['device_and_glue_ms_per_image']:.1f}, writing "
          f"{rec['write_ms_per_image']:.1f}; I/O {rec['io_share']:.1%}), "
          f"{rec['mp_per_s']:.2f} MP/s (host clock, each run ended by a synchronize)")
    print("\n".join(f"  | {ln}" for ln in runs[-1][4].splitlines()[:12]))
    return rec


def _codec_ms(encode, decode, reps: int = 3) -> tuple:
    """Median host ms of one encode and one decode."""
    enc, dec = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        encode()
        enc.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        decode()
        dec.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(enc), statistics.median(dec)


def _cli_phase(dev, launches: dict) -> None:
    """Phase 14: the CLIs on PNG files (the module docstring, item 14)."""
    import shutil
    import tempfile
    from tpuimage_torch import synth
    from tpuimage_torch.io.png import read_png, write_png
    from tpuimage_torch.pipelines import face

    try:
        import PIL
        pil = f"PIL {PIL.__version__} imports here"
    except ImportError:
        PIL, pil = None, "PIL is absent here"
    print(f"{pil}; the PNG CLIs run with PIL's import made to fail, so that their files go "
          f"through tpuimage_torch/io/png.py as on a machine without PIL")
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        def j(*parts):
            return os.path.join(work, *parts)

        for sub in ("night", "land", "mix"):
            os.makedirs(j(sub))
        t0 = time.perf_counter()
        # inputs at zlib level 1: writing them is set-up, not a CLI's time
        doc = synth.document_photo(1400, *PHOTO)
        write_png(j("doc.png"), doc, 1)
        morph = synth.document_photo(1401, *MORPH)
        write_png(j("morph.png"), morph, 1)
        scenes = [synth.night_scene(1410 + i, *NIGHT) for i in range(N_REQUESTS)]
        lands = [synth.landscape_scene(1420 + i, *NIGHT) for i in range(N_REQUESTS)]
        for i in range(N_REQUESTS):
            write_png(j("night", f"s{i}.png"), scenes[i], 1)
            write_png(j("land", f"s{i}.png"), lands[i], 1)
        mix = synth.scene_mix(0)
        mix_files = [j("mix", f"{i}_{kind}.png") for i, (kind, _) in enumerate(mix)]
        for f, (_, rgb) in zip(mix_files, mix):
            write_png(f, rgb, 1)
        print(f"inputs made and written as PNG in {time.perf_counter() - t0:.1f} s")

        summary = {}
        enc, dec = _codec_ms(lambda: write_png(j("codec.png"), doc, 6),
                             lambda: read_png(j("codec.png")))
        summary["png_codec_1200x1600_rgb_ms"] = {"encode_zlib6": enc, "decode": dec}
        print(f"io/png.py on this host, the {PHOTO[1]}x{PHOTO[0]} RGB photo: encode at zlib 6 "
              f"{enc:.1f} ms, decode {dec:.1f} ms (median of 3; "
              f"{os.path.getsize(j('codec.png')) / 2 ** 20:.2f} MiB)")
        if PIL is not None:
            from PIL import Image
            enc, dec = _codec_ms(lambda: Image.fromarray(doc).save(j("codec_pil.png")),
                                 lambda: np.asarray(Image.open(j("codec_pil.png"))))
            summary["pil_1200x1600_rgb_ms"] = {"encode_default": enc, "decode": dec}
            print(f"PIL on this host, the same photo: encode (its default, zlib 6) {enc:.1f} "
                  f"ms, decode {dec:.1f} ms (median of 3)")
            portrait = synth.portrait(1402, *FACE)[0]
            write_png(j("portrait.png"), portrait, 1)
            summary["face"] = _cli_record(
                "face", "face", [[j("portrait.png"), "--out", j("o_face"), "--noise-type",
                                  "gaussian"]], [portrait], launches)
        else:
            print("face CLI not run: its enhanced_face.jpg is a JPEG, which needs PIL; "
                  "phase 11 drives enhance_face on the card")

        night_files = [j("night", f"s{i}.png") for i in range(N_REQUESTS)]
        specs = [
            ("morphseq", "morphseq", [[j("morph.png"), "--out", j("o_morph")]], [morph]),
            ("night rgb", "night", [[f, "--out", j("o_nrgb", str(i)), "--histograms"]
                                    for i, f in enumerate(night_files)], scenes),
            ("night gray", "night", [[f, "--out", j("o_ngray", str(i)), "--histograms",
                                      "--mode", "gray"] for i, f in enumerate(night_files)],
             scenes),
            ("landscape", "landscape", [[j("land"), "--out", j("o_land"), "--seed", "0"]], lands),
            ("docscan", "docscan", [[j("doc.png"), "--out", j("o_doc"), "--gui-preset",
                                     "--profile"]], [doc]),
            ("classify", "classify", [[*mix_files, "--out", j("o_mix")]],
             [rgb for _, rgb in mix]),
        ]
        with _without_pil():
            from tpuimage_torch.io import imageio
            if imageio._pil_image() is not None:
                raise AssertionError("PIL still imports: the PNG codec would not be used")
            for label, cli, argvs, imgs in specs:
                summary[label] = _cli_record(label, cli, argvs, imgs, launches)
            _cli_checks(dev, j, doc, morph, scenes, lands, mix, mix_files, summary)
        if PIL is not None:
            res = face.enhance_face(torch.from_numpy(portrait).to(dev), noise_type="gaussian")
            for k_ in ("skin_mask", "skin_enhanced", "features_popped"):
                _png_equal("cli face", j("o_face", f"face_{k_}.png"), res[k_])
            print("cli face: its three PNGs equal enhance_face called in memory on the card")
        print("cli phase: " + json.dumps(summary))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _cli_checks(dev, j, doc, morph, scenes, lands, mix, mix_files, summary: dict) -> None:
    """Phase 14's checks of the PNG CLIs' files: each against its entry
    point in memory on the card, two against the host, and the build
    cache in a new process."""
    import shutil
    from tpuimage_torch import native
    from tpuimage_torch.classify.router import classify_and_enhance
    from tpuimage_torch.io.png import read_png
    from tpuimage_torch.ops import histogram, kernels
    from tpuimage_torch.ops.color import rgb_to_gray
    from tpuimage_torch.pipelines import docscan, landscape, morphseq, night

    def on_card(a):
        return torch.from_numpy(a).to(dev)

    # every written file against the same entry point in memory on the card

    st_m = morphseq.morphseq_stages(on_card(morph))
    for fname, key in morphseq._STAGE_FILES:
        _png_equal("cli morphseq", j("o_morph", fname), st_m[key])
    _png_equal("cli morphseq", j("o_morph", "morphseq_closed.png"), st_m["step4_closed"])
    for i, rgb in enumerate(scenes):
        x = on_card(rgb)
        for sub, st in (("o_nrgb", night.night_rgb(x)),
                        ("o_ngray", night.night_gray(rgb_to_gray(x)))):
            for stage, t in st.items():
                _png_equal(f"cli night {sub}", j(sub, str(i), f"night_{stage}.png"), t)
                hist = np.loadtxt(j(sub, str(i), f"night_{stage}_hist.csv"), dtype=np.int64)
                g = t if t.dim() == 2 else rgb_to_gray(t)
                if hist.shape != (256,) or not np.array_equal(
                        hist, histogram.hist256(g).cpu().numpy()):
                    raise AssertionError(f"cli night {sub} {i}: the {stage} histogram CSV")
    gen = torch.Generator(device=dev).manual_seed(0)
    for i, rgb in enumerate(lands):
        res = landscape.landscape_eval_step(on_card(rgb), generator=gen)
        for k_ in ("enhanced", "degraded", "restored"):
            _png_equal("cli landscape", j("o_land", f"s{i}_{k_}.png"), res[k_])
    with open(j("o_land", "landscape_metrics.csv")) as fh:
        if len(fh.read().splitlines()) != N_REQUESTS + 1:
            raise AssertionError("cli landscape: the metrics CSV lacks rows")
    res = docscan.process_document(on_card(doc), out_dir=None,
                                   config=docscan.GUI_DOCUMENT_CONFIG)
    _png_equal("cli docscan", j("o_doc", "scan_03_warped.png"), res["warped"])
    for fname, key in docscan._STAGE_FILES:
        _png_equal("cli docscan", j("o_doc", fname), res["stages"][key])
    if len([f for f in os.listdir(j("o_doc")) if f.startswith("scan_")]) != 10:
        raise AssertionError(f"cli docscan: {sorted(os.listdir(j('o_doc')))}")
    for f, (_, rgb) in zip(mix_files, mix):
        label, _, out = classify_and_enhance(on_card(rgb))
        stem = os.path.splitext(os.path.basename(f))[0]
        _png_equal("cli classify", j("o_mix", f"{stem}_{label}_enhanced.png"), out)
    print("cli: every written PNG equals its entry point called in memory on the card")

    # card against host: night rgb on one scene, docscan on the photo, each CLI on the CPU
    _cli_run("night", [[j("night", "s0.png"), "--out", j("h_nrgb"), "--histograms",
                        "--device", "cpu"]])
    for stage in ("original", "filtered", "enhanced"):
        _card_equals_host(f"cli night rgb {stage} (files)",
                          torch.from_numpy(read_png(j("o_nrgb", "0", f"night_{stage}.png"))),
                          torch.from_numpy(read_png(j("h_nrgb", f"night_{stage}.png"))),
                          NIGHT_RGB_TOL if stage == "enhanced" else (0, 0.0))
    _cli_run("docscan", [[j("doc.png"), "--out", j("h_doc"), "--gui-preset",
                          "--device", "cpu"]])
    card_bin, host_bin = (read_png(j(d, "scan_08_clean.png")) for d in ("o_doc", "h_doc"))
    frac = float((card_bin != host_bin).mean()) if card_bin.shape == host_bin.shape else 1.0
    if frac >= BINARY_TOL:
        raise AssertionError(f"cli docscan card vs host: {frac} of binary pixels differ")
    print(f"card vs host, cli docscan scan_08_clean.png: {frac:.6f} of binary pixels differ "
          f"(limit {BINARY_TOL})")

    # the build cache: the built libraries copied into a fresh directory; a
    # new process with TPUIMAGE_XLA_CACHE there loads them, with no nvcc or
    # g++ to be found (a build would fail)
    cache_dir, empty = j("build_cache"), j("no_compilers")
    os.makedirs(cache_dir)
    os.makedirs(empty)
    native.load_native()
    for so in (kernels.build(), native._build()):
        shutil.copy2(so, cache_dir)
    before = sorted(os.listdir(cache_dir))
    code = ("import json, runpy, sys\n"
            "sys.modules['PIL'] = sys.modules['PIL.Image'] = None\n"
            "runpy.run_module('tpuimage_torch.cli.morphseq', run_name='__main__', "
            "alter_sys=True)\n"
            "from tpuimage_torch.ops import kernels\n"
            "print(json.dumps({'kernels_library': kernels._lib._name}))\n")
    env = dict(os.environ, TPUIMAGE_XLA_CACHE=cache_dir, CUDA_HOME=empty, PATH=empty,
               PYTHONPATH=HERE)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code, j("morph.png"), "--out", j("o_cached")],
                       env=env, cwd=HERE, capture_output=True, text=True, timeout=300)
    cold_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"cached-build process failed:\n{r.stdout}\n{r.stderr[-3000:]}")
    loaded = json.loads(r.stdout.strip().splitlines()[-1])["kernels_library"]
    if os.path.dirname(loaded) != cache_dir or sorted(os.listdir(cache_dir)) != before:
        raise AssertionError(f"cached-build process: loaded {loaded}, cache now "
                             f"{sorted(os.listdir(cache_dir))}")
    for fname, key in morphseq._STAGE_FILES:
        _png_equal("cli morphseq (cached build)", j("o_cached", fname), st_m[key])
    print(f"build cache: python -m tpuimage_torch.cli.morphseq in a new process with "
          f"TPUIMAGE_XLA_CACHE={os.path.basename(cache_dir)}/ loaded "
          f"{os.path.basename(loaded)} from there, no compiler on its PATH or CUDA_HOME; "
          f"the cold process took {cold_s:.2f} s (wall, interpreter start to exit)")
    summary["cached_build_cold_process_s"] = cold_s


MESH_SHARDS = 4                 # shards of the one-card mesh
BIG_PAGE = (7016, 4960)         # an A4 page scanned at 600 dpi, height x width
NIGHT_MESH = (856, 1280)        # night scenes whose height the 8 CLAHE tile rows divide
POST_WARP_KERNELS = ("gauss_chain", "blackhat_rect", "hist256", "inkmask_weighted",
                     "rank_extract", "hough_votes")


def _host_reads(fn):
    """fn's result and the number of synchronizing calls it made (reads
    back to the host), counted as torch's sync debug warnings."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _mesh_stats(fn, n_items: int, reps: int = 3):
    """A warm call, a counted call (its launches, host reads, collective
    bytes and peak device memory above what was held before it), then the
    ms an item (CUDA events, median of ``reps`` calls). Returns the
    counted call's output and the numbers."""
    from tpuimage_torch.ops import kernels
    from tpuimage_torch.runtime import mesh
    fn()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    mesh.reset_transfer_bytes()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, reads = _host_reads(fn)
    torch.cuda.synchronize()
    stats = {"launches": kernels.launch_counts(), "reads": reads,
             "bytes": mesh.transfer_bytes(),
             "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2 ** 20}
    stats["ms"] = _cuda_ms(fn, reps=reps) / n_items
    return out, stats


def _mesh_line(what: str, unit: str, s: dict, u: dict) -> None:
    print(f"{what}: sharded {s['ms']:.3f} vs unsharded {u['ms']:.3f} ms a {unit} (CUDA events, "
          f"median of 3); a call: launches {sum(s['launches'].values())} vs "
          f"{sum(u['launches'].values())}, host reads {s['reads']} vs {u['reads']}, bytes of "
          f"the halo exchanges {s['bytes']['ppermute']}, gathers {s['bytes']['all_gather']}, "
          f"reductions {s['bytes']['reduce']}; peak device memory {s['peak_mib']:.1f} vs "
          f"{u['peak_mib']:.1f} MiB above what was held before")


def _equal_stages(what: str, out: dict, ref: dict) -> None:
    """Every stage of a sharded run equal to the unsharded one's."""
    for k in ref:
        a, b = out[k], ref[k].to(out[k].device)
        if a.shape != b.shape or not torch.equal(a, b):
            n = int((a != b).sum()) if a.shape == b.shape else -1
            raise AssertionError(f"{what}: stage {k} differs from the unsharded run ({n} values)")


def _mesh_phase(dev, launches: dict) -> None:
    """Phase 15: the sharded runtime on the card (the module docstring,
    item 15)."""
    from tpuimage_torch import synth
    from tpuimage_torch.ops import color, edges, histogram, hough
    from tpuimage_torch.ops.median import median_blur
    from tpuimage_torch.pipelines import docscan, night
    from tpuimage_torch.runtime import mesh, spatial
    t0 = time.perf_counter()
    cfg = docscan.GUI_DOCUMENT_CONFIG
    n_cards = torch.cuda.device_count()
    space = mesh.make_mesh(MESH_SHARDS, ("space",), devices=[dev] * MESH_SHARDS)
    others = []
    if n_cards > 1:
        others.append(mesh.make_mesh(4 if n_cards >= 4 else 2, ("space",)))
    print(f"mesh phase: {n_cards} CUDA device(s); meshes {space}"
          + "".join(f", {m}" for m in others))

    def counted(path, stats, needed):
        for k, v in _launched(path, stats["launches"], needed).items():
            launches[k] += v

    # 15.1 the post-warp H-sharded, page by page, on the 8 A4 pages
    pages = torch.from_numpy(np.stack([
        synth.page(100 + i, *PAGE, tilt_deg=3.0 if i % 2 else 0.0, rules=3 if i % 2 else 0)
        for i in range(N_REQUESTS)])).to(dev)
    outs, s = _mesh_stats(lambda: [spatial.docscan_post_warp_spatial(p, cfg, space)
                                   for p in pages], N_REQUESTS)
    counted(f"docscan_post_warp_spatial, {N_REQUESTS} A4 pages", s, POST_WARP_KERNELS)
    refs, u = _mesh_stats(lambda: [docscan.docscan_post_warp(p, cfg) for p in pages],
                          N_REQUESTS)
    for i, (o, r) in enumerate(zip(outs, refs)):
        _equal_stages(f"A4 page {i}", o, r)
    _mesh_line(f"docscan_post_warp_spatial on {MESH_SHARDS} shards, A4 {PAGE[1]}x{PAGE[0]}",
               "page", s, u)
    for m in others:
        outs_m, s_m = _mesh_stats(lambda: [spatial.docscan_post_warp_spatial(p, cfg, m)
                                           for p in pages], N_REQUESTS)
        for i, (o, r) in enumerate(zip(outs_m, refs)):
            _equal_stages(f"A4 page {i} on {m}", o, r)
        _mesh_line(f"docscan_post_warp_spatial on {m.size} cards, A4 {PAGE[1]}x{PAGE[0]}",
                   "page", s_m, u)
    for i in range(2):
        _equal_stages(f"A4 page {i}, card against the host's unsharded run",
                      {k: v.cpu() for k, v in outs[i].items()},
                      docscan.docscan_post_warp(pages[i].cpu(), cfg))
    print(f"docscan_post_warp_spatial: every stage of the {N_REQUESTS} pages equal to "
          f"docscan_post_warp on the card (and on {len(others)} multi-card mesh(es)), "
          "and on 2 pages to the host's; angles "
          f"{[round(float(r['deskew_angle']), 3) for r in refs]}")

    # 15.2 the rotation and the close
    tilted = torch.from_numpy(synth.page(31, *PAGE, tilt_deg=4.0, rules=3)).to(dev)
    for what, page, c in (("tilted A4 page (the rotation)", tilted, cfg),
                          ("A4 page, default config (the close)", pages[0],
                           docscan.DocScanConfig())):
        ref = docscan.docscan_post_warp(page, c)
        if page is tilted and float(ref["deskew_angle"]) == 0.0:
            raise AssertionError("the tilted page's angle is 0: the rotation did not run")
        for m in [space] + others:
            _equal_stages(f"{what} on {m}", spatial.docscan_post_warp_spatial(page, c, m), ref)
        print(f"docscan_post_warp_spatial, {what}: every stage equal to the unsharded run "
              f"(angle {float(ref['deskew_angle']):.3f})")

    # 15.3 one 600-dpi A4 page, 35 MP
    big = torch.from_numpy(synth.page(7, *BIG_PAGE, tilt_deg=2.0, rules=3)).to(dev)
    # the unsharded program's default edge budget (at most 524,288 edges a
    # page) may not hold this page's edges, where each shard's own budget
    # does (tpuimage's rule): the sharded run is held to the unsharded one
    # with a budget of every pixel, as its overflow warning asks
    out, s = _mesh_stats(lambda: spatial.docscan_post_warp_spatial(big, cfg, space), 1)
    counted(f"docscan_post_warp_spatial, {BIG_PAGE[1]}x{BIG_PAGE[0]}", s, POST_WARP_KERNELS)
    whole = dataclasses.replace(cfg, deskew_max_edges=BIG_PAGE[0] * BIG_PAGE[1])
    ref, u = _mesh_stats(lambda: docscan.docscan_post_warp(big, whole), 1)
    default = docscan.docscan_post_warp(big, cfg)
    n_edges = int((edges.canny(ref["weighted"], cfg.canny_low, cfg.canny_high) > 0).sum())
    _equal_stages("the 35 MP page", out, ref)
    _mesh_line(f"docscan_post_warp_spatial on {MESH_SHARDS} shards, {BIG_PAGE[1]}x{BIG_PAGE[0]}",
               "page", s, u)
    for m in others:
        out_m, s_m = _mesh_stats(lambda: spatial.docscan_post_warp_spatial(big, cfg, m), 1)
        _equal_stages(f"the 35 MP page on {m}", out_m, ref)
        _mesh_line(f"docscan_post_warp_spatial on {m.size} cards, {BIG_PAGE[1]}x{BIG_PAGE[0]}",
                   "page", s_m, u)
        del out_m
    print(f"the 35 MP page ({n_edges} edges): every stage equal to the unsharded run with a "
          f"budget of every pixel (angle {float(ref['deskew_angle']):.3f}, overflow "
          f"{bool(out['deskew_overflow'])}); at its default budget of "
          f"{hough.default_max_edges(*BIG_PAGE)} edges the unsharded run's overflow is "
          f"{bool(default['deskew_overflow'])}, its angle "
          f"{float(default['deskew_angle']):.3f}")
    del big, out, ref, default

    # 15.4 the data x space batch form
    grid = mesh.make_mesh(4, ("data", "space"), (2, 2), devices=[dev] * 4)
    out, s = _mesh_stats(lambda: spatial.docscan_post_warp_spatial_batch(pages, cfg, grid),
                         N_REQUESTS)
    counted("docscan_post_warp_spatial_batch", s, POST_WARP_KERNELS)
    ref, u = _mesh_stats(lambda: docscan.docscan_post_warp_batch(pages, cfg), N_REQUESTS)
    _equal_stages("docscan_post_warp_spatial_batch", out, ref)
    angles = out["deskew_angle"].tolist()
    if all(a == 0.0 for a in angles) or all(a != 0.0 for a in angles):
        raise AssertionError(f"the batch does not mix tilted and flat pages: {angles}")
    _mesh_line(f"docscan_post_warp_spatial_batch on (data 2, space 2), {N_REQUESTS} A4 pages",
               "page", s, u)
    del pages, outs, refs, out, ref

    # 15.5 night, gray and RGB
    scenes = torch.from_numpy(np.stack([synth.night_scene(400 + i, *NIGHT_MESH)
                                        for i in range(N_REQUESTS)])).to(dev)
    gray = color.rgb_to_gray(scenes)
    out, s = _mesh_stats(lambda: spatial.night_gray_spatial(gray, space), N_REQUESTS)
    counted("night_gray_spatial", s, ("hist256", "clahe_apply"))
    ref, u = _mesh_stats(lambda: night.night_gray(gray), N_REQUESTS)
    _equal_stages("night_gray_spatial", out, ref)
    _mesh_line(f"night_gray_spatial, 8 scenes {NIGHT_MESH[1]}x{NIGHT_MESH[0]}", "scene", s, u)

    def night_rgb_lut(x):
        filt = median_blur(x, 3, channels_last=True).contiguous()
        lab = color.rgb_to_lab(filt)
        l_enh = histogram.clahe(lab[..., 0], clip_limit=night.CLIP_LIMIT, tiles_x=night.TILES,
                                tiles_y=night.TILES)
        return {"original": x, "filtered": filt, "enhanced": color.lab_to_rgb(
            torch.cat([l_enh[..., None], lab[..., 1:]], dim=-1), impl="lut")}

    out, s = _mesh_stats(lambda: spatial.night_rgb_spatial(scenes, space), N_REQUESTS)
    counted("night_rgb_spatial", s, ("rgb_to_lab", "hist256", "clahe_apply"))
    ref, u = _mesh_stats(lambda: night_rgb_lut(scenes), N_REQUESTS)
    _equal_stages("night_rgb_spatial", out, ref)
    for m in others:
        _equal_stages(f"night_rgb_spatial on {m}", spatial.night_rgb_spatial(scenes[:2], m),
                      night_rgb_lut(scenes[:2]))
    _mesh_line(f"night_rgb_spatial, 8 scenes {NIGHT_MESH[1]}x{NIGHT_MESH[0]}", "scene", s, u)
    lab_grid = torch.stack(torch.meshgrid(*[torch.arange(256, dtype=torch.uint8)] * 3,
                                          indexing="ij"), dim=-1).reshape(-1, 3)
    card = color.lab_to_rgb(lab_grid.to(dev), impl="lut").cpu()
    if not torch.equal(card, color.lab_to_rgb(lab_grid, impl="lut")):
        raise AssertionError("lab_to_rgb(impl='lut') differs card vs host")
    print("night_gray_spatial / night_rgb_spatial equal to the unsharded composition; "
          "lab_to_rgb(impl='lut') card = host on all 16,777,216 Lab triples")
    del scenes, gray, out, ref, lab_grid, card

    # 15.6 the entry points
    photos = [synth.document_photo(300 + i, *PHOTO, tilt_deg=3.0 if i == 1 else 0.0,
                                   rules=3 if i == 1 else 0, with_page=i != N_REQUESTS - 1)
              for i in range(N_REQUESTS)]
    data = mesh.make_mesh(MESH_SHARDS, devices=[dev] * MESH_SHARDS)
    for n_req in (N_REQUESTS, N_REQUESTS + 3):
        reqs = (photos + photos)[:n_req]
        res, s = _mesh_stats(lambda: docscan.scan_batch(reqs, cfg, mesh=data), n_req)
        counted(f"scan_batch(mesh=), {n_req} photos", s,
                POST_WARP_KERNELS)
        ref, u = _mesh_stats(lambda: docscan.scan_batch(reqs, cfg, device=dev), n_req)
        for i, (a, b) in enumerate(zip(res, ref, strict=True)):
            if not _same_result(a, b):
                raise AssertionError(f"scan_batch(mesh=) request {i} of {n_req} differs")
        _mesh_line(f"scan_batch(mesh=) over {MESH_SHARDS} shards, {n_req} photos "
                   f"{PHOTO[1]}x{PHOTO[0]}", "request", s, u)
    mesh.reset_transfer_bytes()
    from tpuimage_torch.ops import kernels
    kernels.reset_launch_counts()
    streamed = list(docscan.scan_stream([photos] * 4, cfg, mesh=data))
    torch.cuda.synchronize()
    for k, v in _launched("scan_stream(mesh=), 4 batches", kernels.launch_counts(),
                          POST_WARP_KERNELS).items():
        launches[k] += v
    base = docscan.scan_batch(photos, cfg, device=dev)
    for res in streamed:
        for i, (a, b) in enumerate(zip(res, base, strict=True)):
            if not _same_result(a, b):
                raise AssertionError(f"scan_stream(mesh=) request {i} differs")
    for i in (1, N_REQUESTS - 1):
        kernels.reset_launch_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("error")      # no overflow warning from the sharded run
            a = docscan.process_document(photos[i], out_dir=None, config=cfg, space_mesh=space)
        torch.cuda.synchronize()
        for k, v in _launched(f"process_document(space_mesh=), photo {i}",
                              kernels.launch_counts(),
                              ("bilateral",) + POST_WARP_KERNELS).items():
            launches[k] += v
        # the budget of every pixel, as for the 35 MP page: the page-less
        # photo's desk texture may overflow the unsharded default budget
        whole = dataclasses.replace(cfg, deskew_max_edges=PHOTO[0] * PHOTO[1])
        b = docscan.process_document(photos[i], out_dir=None, config=whole, device=dev)
        _equal_stages(f"process_document(space_mesh=) photo {i}", a["stages"], b["stages"])
    print(f"scan_batch(mesh=) on {N_REQUESTS} and {N_REQUESTS + 3} photos, scan_stream(mesh=) "
          "over 4 batches and process_document(space_mesh=) on 2 photos: each equal to its "
          "unsharded call")
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s")


# phase 16: every quarter degree in +-10, the deskew's range; a budget the
# A4 deskew maps overflow; the every-stage categorisation preset
CLOSURE_ANGLES = tuple(q / 4 for q in range(-40, 41))
OVERFLOW_BUDGET = 1000
EVERY_STAGE = dict(brightness_mode="gamma", brightness_gamma=0.9, linear_boost_beta=4.0,
                   contrast_mode="clahe", clahe_clip=2.0, saturation_mult=1.2,
                   saturation_cap=0.5, gray_world=True, chroma_boost_cb=1.1,
                   chroma_boost_cr=1.05, highlight_compression="sqrt", local_contrast=True,
                   lc_radius=2.0, lc_amount=0.6, lc_threshold=1.0, invert=True)


def _closure_phase(dev, launches: dict) -> None:
    """Phase 16: the forms repaired when the port was closed and its last
    public names, card against host (the module docstring, item 16)."""
    from tpuimage_torch import synth
    from tpuimage_torch.core.dtypes import xla_sum_f32
    from tpuimage_torch.ops import color, edges, geometry, histogram, hough, kernels
    from tpuimage_torch.ops.restore import _log_f32, single_scale_retinex
    from tpuimage_torch.pipelines import docscan, shadow
    from tpuimage_torch.presets import apply
    from tpuimage_torch.presets.loader import CategorizationPreset
    t0 = time.perf_counter()
    smi = _nvidia_smi()

    def timed(what: str, fn, n_px: int) -> None:
        ms = _cuda_ms(fn, reps=3, calls=1)
        print(f"{what}: {ms:.3f} ms a call = {n_px / 1e3 / ms:.1f} MP/s (CUDA events, warm, "
              f"median of 3, input on the card) [{smi}]")

    # 16.1 the deskew rotation: cos / sin in f64 rounded to f32 at every
    # quarter degree, the rotation at all 81 on a crop and at 8 angles on 8
    # A4 pages, then the post-warp (DocScanConfig(), the rotation runs)
    angles = torch.tensor(CLOSURE_ANGLES, dtype=torch.float32)
    rad = torch.deg2rad(torch.clamp(angles, -10.0, 10.0)).double()
    card_cs = torch.stack([torch.cos(rad.to(dev)), torch.sin(rad.to(dev))]).float().cpu()
    if not torch.equal(card_cs, torch.stack([torch.cos(rad), torch.sin(rad)]).float()):
        raise AssertionError("rotation: the card's f64 cos / sin rounded to f32 differ")
    print(f"card vs host, cos / sin in f64 rounded to f32 at the {len(angles)} quarter degrees "
          f"in +-10: equal")
    pages = np.stack([synth.page(1600 + i, *PAGE, tilt_deg=(-1) ** i * (1.5 + i), rules=4)
                      for i in range(N_REQUESTS)])
    crop = torch.from_numpy(np.repeat(pages[:1, 400:700, 300:512, 1], len(angles), 0))
    _card_equals_host(f"rotate_pages at the {len(angles)} quarter degrees in +-10 (300x212)",
                      geometry.rotate_pages(crop.to(dev), angles.to(dev), 10.0),
                      geometry.rotate_pages(crop, angles, 10.0))
    gray = torch.from_numpy(pages[..., 1].copy())
    eight = torch.tensor(CLOSURE_ANGLES[1::10][:N_REQUESTS])
    gray_d = gray.to(dev)
    _card_equals_host(f"rotate_pages on {N_REQUESTS} A4 pages at {eight.tolist()} degrees",
                      geometry.rotate_pages(gray_d, eight.to(dev), 10.0),
                      geometry.rotate_pages(gray, eight, 10.0))
    timed(f"rotate_pages, {N_REQUESTS} A4 pages", lambda: geometry.rotate_pages(
        gray_d, eight.to(dev), 10.0), gray.numel())
    cfg = docscan.DocScanConfig()
    pages_d = torch.from_numpy(pages).to(dev)
    post = docscan.docscan_post_warp_batch(pages_d, cfg)
    post_h = docscan.docscan_post_warp_batch(torch.from_numpy(pages), cfg)
    if not bool((post_h["deskew_angle"] != 0).all()):
        raise AssertionError(f"post-warp: a page was not rotated: {post_h['deskew_angle']}")
    for k in ("weighted", "deskew", "clean", "deskew_angle", "deskew_overflow"):
        _card_equals_host(f"docscan_post_warp_batch(DocScanConfig()) {k}, {N_REQUESTS} A4 "
                          f"pages", post[k], post_h[k])

    # 16.2 PORTRAIT and the every-stage preset on 8 scenes of 1280x853
    scenes = np.stack([synth.shadowed_scene(1700 + i, *NIGHT) for i in range(N_REQUESTS)])
    scenes_d = torch.from_numpy(scenes).to(dev)
    every = CategorizationPreset(name="every", group="g", **EVERY_STAGE)
    for what, fn in (("enhance_shadow_batch(PORTRAIT)",
                      lambda x: shadow.enhance_shadow_batch(x, shadow.PRESETS["PORTRAIT"])[0]),
                     ("apply_categorization_preset(every stage)",
                      lambda x: apply.apply_categorization_preset(x, every))):
        kernels.reset_launch_counts()
        card = fn(scenes_d)
        torch.cuda.synchronize()
        for k_, v in _launched(f"{what}, {N_REQUESTS} scenes", kernels.launch_counts(),
                               ("rgb_to_lab", "hist256", "clahe_apply")).items():
            launches[k_] += v
        _card_equals_host(f"{what}, {N_REQUESTS} scenes of {NIGHT[1]}x{NIGHT[0]}", card,
                          fn(torch.from_numpy(scenes)))
        timed(f"{what}, {N_REQUESTS} scenes", lambda: fn(scenes_d), scenes_d[..., 0].numel())

    # 16.3 the Retinex's log (XLA's CPU form) on every 16th f32 of its
    # domain [1, 257], then the Retinex on a 377x251 crop
    lo, hi = np.float32(1.0).view(np.uint32), np.float32(257.0).view(np.uint32)
    vals = torch.from_numpy(np.arange(lo, hi + 1, 16, dtype=np.uint32).view(np.float32))
    _card_equals_host(f"_log_f32 on {vals.numel()} f32 values in [1, 257]",
                      _log_f32(vals.to(dev)), _log_f32(vals))
    patch = torch.from_numpy(scenes[0, 100:351, 200:577].copy())
    _card_equals_host("single_scale_retinex (sigma 80), 251x377",
                      single_scale_retinex(patch.to(dev)), single_scale_retinex(patch))
    timed(f"single_scale_retinex (sigma 80), {N_REQUESTS} scenes",
          lambda: single_scale_retinex(scenes_d), scenes_d[..., 0].numel())

    # 16.4 canny(l2_gradient=True) and hough_lines(return_overflow=True) on
    # the pages' deskew maps, at a budget that overflows and one that does not
    maps = post["weighted"]
    l2 = edges.canny(maps, cfg.canny_low, cfg.canny_high, l2_gradient=True)
    l2_h = edges.canny(maps.cpu(), cfg.canny_low, cfg.canny_high, l2_gradient=True)
    _card_equals_host(f"canny(l2_gradient=True), {N_REQUESTS} A4 deskew maps", l2, l2_h)
    h, w = PAGE
    for budget in (OVERFLOW_BUDGET, h * w):
        kernels.reset_launch_counts()
        card = hough.hough_lines(l2, 150, max_edges=budget, return_overflow=True)
        torch.cuda.synchronize()
        for k_, v in _launched(f"hough_lines(return_overflow=True, max_edges={budget})",
                               kernels.launch_counts(), ("rank_extract", "hough_votes")).items():
            launches[k_] += v
        host = hough.hough_lines(l2_h, 150, max_edges=budget, return_overflow=True)
        for name, c, hh in zip(("lines", "valid", "overflow"), card, host):
            _card_equals_host(f"hough_lines max_edges={budget} {name}", c, hh)
        if bool(host[2].all()) != (budget == OVERFLOW_BUDGET) or \
                bool(host[2].any()) != (budget == OVERFLOW_BUDGET):
            raise AssertionError(f"hough_lines max_edges={budget}: overflow {host[2].tolist()}")
        timed(f"hough_lines(return_overflow=True, max_edges={budget}), {N_REQUESTS} A4 maps",
              lambda: hough.hough_lines(l2, 150, max_edges=budget, return_overflow=True),
              l2.numel())

    # 16.5 warp_perspective_batch with both borders, and otsu_threshold
    minv = torch.tensor([[[0.9, 0.12, -20.0], [-0.08, 1.1, 15.0], [1e-4, 2e-4, 1.0]],
                         [[1.2, -0.1, 10.0], [0.05, 0.8, -30.0], [-2e-4, 1e-4, 1.0]]])
    minv = minv.repeat(N_REQUESTS // 2, 1, 1)
    for border, value in (("constant", 127.5), ("replicate", 0.0)):
        warp = lambda x, m: geometry.warp_perspective_batch(  # noqa: E731
            x, m, h, w, border=border, border_value=value)
        _card_equals_host(f"warp_perspective_batch(border={border!r}, border_value={value}), "
                          f"{N_REQUESTS} A4 pages", warp(pages_d, minv.to(dev)),
                          warp(torch.from_numpy(pages), minv))
        timed(f"warp_perspective_batch(border={border!r}), {N_REQUESTS} A4 pages",
              lambda: warp(pages_d, minv.to(dev)), gray.numel())
    kernels.reset_launch_counts()
    otsu = torch.stack([histogram.otsu_threshold(g) for g in gray_d])
    torch.cuda.synchronize()
    for k_, v in _launched("otsu_threshold", kernels.launch_counts(), ("hist256",)).items():
        launches[k_] += v
    _card_equals_host(f"otsu_threshold, {N_REQUESTS} A4 pages' gray", otsu,
                      torch.stack([histogram.otsu_threshold(g) for g in gray]))

    # 16.6 XLA's f32 tree sum (the categorisation's and the gray world's
    # means): its serial levels one cumsum launch each on the card
    planes = torch.stack([scenes_d[..., 0], scenes_d[..., 2],
                          (scenes_d[..., 1] > 230).to(torch.uint8)], dim=-3)
    big = torch.from_numpy(np.random.default_rng(16).integers(
        200, 256, (1, 3000, 4000), dtype=np.uint8))
    for what, x in ((f"{N_REQUESTS}x3 planes of {NIGHT[1]}x{NIGHT[0]}", planes),
                    ("one plane of 4000x3000", big)):
        _card_equals_host(f"xla_sum_f32, {what}", xla_sum_f32(x.to(dev)), xla_sum_f32(x.cpu()))
    _card_equals_host(f"categorize_cues, {N_REQUESTS} scenes",
                      torch.stack(shadow.categorize_cues(scenes_d)),
                      torch.stack(shadow.categorize_cues(torch.from_numpy(scenes), device="cpu")))
    timed(f"categorize_cues, {N_REQUESTS} scenes", lambda: shadow.categorize_cues(scenes_d),
          scenes_d[..., 0].numel())
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")


def _clahe_cv2_order(gray: np.ndarray, luts: np.ndarray, th: int, tw: int) -> np.ndarray:
    """cv2's CLAHE blend (CLAHE_Interpolation_Body) transcribed in numpy
    f32, each op rounded on its own: one (H, W) uint8 plane and its (ty,
    tx, 256) tile LUTs -> the (H, W) uint8 output."""
    f = np.float32
    ty, tx = luts.shape[:2]

    def axis(n: int, tile: int, n_tiles: int):
        pf = np.arange(n, dtype=f) * (f(1.0) / f(tile)) - f(0.5)
        t1 = np.floor(pf).astype(np.int64)
        a = (pf - t1).astype(f)
        return np.maximum(t1, 0), np.minimum(t1 + 1, n_tiles - 1), f(1.0) - a, a

    y1, y2, ya1, ya = axis(gray.shape[0], th, ty)
    x1, x2, xa1, xa = axis(gray.shape[1], tw, tx)
    lut = luts.astype(f)
    g = gray.astype(np.int64)

    def at(ys, xs):
        return lut[ys[:, None], xs[None, :], g]

    res = ((at(y1, x1) * xa1 + at(y1, x2) * xa) * ya1[:, None]
           + (at(y2, x1) * xa1 + at(y2, x2) * xa) * ya[:, None])
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


def _exact_forms_phase(dev, launches: dict) -> None:
    """Phase 17: the CLAHE apply in cv2's order and the batch warp in
    tpuimage's jitted form on the repository's whole images (the module
    docstring, item 17)."""
    from tpuimage_torch import synth
    from tpuimage_torch.io import imageio
    from tpuimage_torch.ops import color, geometry, histogram, kernels
    from tpuimage_torch.pipelines import docscan
    t0 = time.perf_counter()
    photo = imageio.load_image_rgb(os.path.join(HERE, "outputs", "scan_02_quad.png"))
    page = imageio.load_image_rgb(os.path.join(HERE, "outputs", "scan_03_warped.png"))
    lum = color.rgb_to_lab(torch.from_numpy(photo).to(dev))[..., 0]
    planes = [("the photo's L", lum[None].contiguous(), 8, (2.0, 3.0, 40.0)),
              ("the A4 page's gray", color.rgb_to_gray(torch.from_numpy(page).to(dev))[None],
               8, (2.0, 3.0, 40.0))]
    img, eyes = synth.portrait(17)
    lab = color.rgb_to_lab(torch.from_numpy(img).to(dev))
    for x0, y0, w, h in eyes:
        planes.append((f"an eye region {w}x{h}", lab[None, y0:y0 + h, x0:x0 + w, 0].contiguous(),
                       4, (0.2,)))
    for h, w in synth.EYE_EDGE_SHAPES[:3]:
        planes.append((f"an eye region {w}x{h}", lab[None, 400:400 + h, 300:300 + w, 0]
                       .contiguous(), 4, (0.2,)))
    kernels.reset_launch_counts()
    n_direct = n_clahe = 0
    for what, p, grid, clips in planes:
        tiles, th, tw = histogram.clahe_tiles(p, grid, grid)
        counts = kernels.hist256_batch(tiles)
        rows, cols = histogram.blend_tables_on(p.shape[1], p.shape[2], th, tw, grid, grid, dev)
        for clip in clips:
            luts = histogram.tile_luts_from_counts(counts, clip, th * tw)
            luts = luts.reshape(1, grid, grid, 256)
            card = kernels.clahe_apply(p, luts, rows, cols)
            n_direct += 1
            plain = kernels.clahe_apply_ref(p, luts, rows, cols)
            cv2_order = _clahe_cv2_order(p[0].cpu().numpy(), luts[0].cpu().numpy(), th, tw)
            if not torch.equal(card, plain):
                raise AssertionError(f"clahe_apply on {what} clip {clip}: kernel and plain "
                                     f"version differ on {int((card != plain).sum())} pixels")
            apart = int((card[0].cpu().numpy() != cv2_order).sum())
            if apart:
                raise AssertionError(f"clahe_apply on {what} clip {clip}: {apart} pixels "
                                     f"differ from cv2's order")
            _card_equals_host(f"CLAHE clip {clip} at {grid}x{grid} on {what}",
                              histogram.clahe(p, clip, grid, grid),
                              histogram.clahe(p.cpu(), clip, grid, grid))
            n_clahe += 1
        print(f"clahe_apply on {what} ({tuple(p.shape[1:])}, {grid}x{grid} tiles, clip "
              f"{list(clips)}): kernel = plain version = cv2's order in numpy")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if counts["clahe_apply"] != n_direct + n_clahe:
        raise AssertionError(f"clahe_apply launched {counts['clahe_apply']} times for "
                             f"{n_direct} kernel calls and {n_clahe} CLAHE calls")
    # the launches of the CLAHE calls, not those held against the plain version
    launches["clahe_apply"] += n_clahe

    h, w = photo.shape[:2]
    (quad,) = docscan.localize_batch(photo[None], docscan.DocScanConfig(), device=dev)
    th, tw = docscan._warp_target_size(quad, "A4", 1600)
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    skew = src + np.float32([[-0.1, 0.15], [0.2, -0.1], [0.1, 0.2], [-0.15, -0.05]]) * [w, h]
    maps = ((docscan._inverse_homography(quad, th, tw), th, tw, "DocScanner's quad"),
            (np.linalg.inv(geometry.get_perspective_transform(src, skew)), 700, 500,
             "a skewed map"))
    photo_d = torch.from_numpy(photo).to(dev)[None]
    for minv, oh, ow, what in maps:
        m = torch.from_numpy(minv.astype(np.float32))[None]
        for border, value in (("constant", 0.0), ("replicate", 0.0), ("constant", 127.5)):
            _card_equals_host(f"warp_perspective_batch(border={border!r}, border_value={value}) "
                              f"of the photo through {what} to {oh}x{ow}",
                              geometry.warp_perspective_batch(photo_d, m.to(dev), oh, ow,
                                                              border, value),
                              geometry.warp_perspective_batch(photo_d.cpu(), m, oh, ow,
                                                              border, value))
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")


def _canny_rows(dev, cfg, weighted: torch.Tensor, records: dict) -> None:
    """canny_pre and one hysteresis check at the cells' shapes: localize's
    8 photos of 1920x1080 and the deskew's 8 weighted A4 pages, each kernel
    exact against its plain version and timed; then the whole ``canny``
    against the plain versions' loop, timed once each way."""
    from tpuimage_torch import synth
    from tpuimage_torch.ops import edges, kernels
    from tpuimage_torch.ops.color import rgb_to_gray
    photos = np.stack([synth.document_photo(400 + i, *CELL_PHOTO) for i in range(N_REQUESTS)])
    lo, hi = cfg.canny_low, cfg.canny_high
    for what, g in (("deskew", weighted),
                    ("localize", rgb_to_gray(torch.from_numpy(photos).to(dev)))):
        b, h, w = g.shape
        n = g.numel()
        pre = _compare(f"canny_pre ({what}: {b} planes {w}x{h})",
                       lambda g=g: kernels.canny_pre(g, lo, hi),
                       lambda g=g: kernels.canny_pre_ref(g, lo, hi),
                       _bound(3 * n, 40 * n), plain_calls=5)
        strong, weak = kernels.canny_pre(g, lo, hi)
        flags = torch.zeros(2, dtype=torch.int32, device=dev)
        check = _compare(f"canny_hysteresis ({what}: one check of {kernels.HYSTERESIS_STEPS} "
                         f"steps, {b} planes {w}x{h})",
                         lambda: kernels.hysteresis_check(strong, weak, flags, 0).view(torch.bool),
                         lambda: kernels.hysteresis_check_ref(strong, weak),
                         _bound(3 * n, 8 * 14 * n / 32), plain_calls=5)
        if what == "deskew":
            records["canny_pre"], records["canny_hysteresis"] = pre, check
        else:
            _sub_record(records["canny_pre"], what, pre)
            _sub_record(records["canny_hysteresis"], what, check)

        def plain_canny(g=g):
            s, wk = kernels.canny_pre_ref(g, lo, hi)
            for _ in range(h + w):
                new = kernels.hysteresis_check_ref(s, wk)
                if not bool((new != s).any()):
                    break
                s = new
            return s.to(torch.uint8) * 255
        _exact(f"canny ({what})", lambda g=g: edges.canny(g, lo, hi), plain_canny)
        ms = _cuda_ms(lambda g=g: edges.canny(g, lo, hi), reps=5, calls=5)
        print(f"canny ({what}: {b} planes {w}x{h}): {ms:.4f} ms a call (both kernels and "
              f"the flag reads), the plain versions' loop "
              f"{_cuda_ms(plain_canny, reps=3, calls=2):.4f} ms")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from tpuimage_torch import synth
    from tpuimage_torch.core.borders import pad2d
    from tpuimage_torch.ops import (arith, bilateral, color, edges, filters, histogram, hough,
                                    kernels, median, nlm)
    from tpuimage_torch.ops.color import rgb_to_gray
    from tpuimage_torch.ops.filters import gaussian_kernel_q8
    from tpuimage_torch.detect import haar
    from tpuimage_torch.pipelines import docscan, face, landscape, morphseq, night

    dev = torch.device("cuda")
    cfg = docscan.GUI_DOCUMENT_CONFIG

    # --- 1. device and build ------------------------------------------------
    print(f"[phase 1 at {time.perf_counter() - t_start:.1f} s]")
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
    print(f"[phase 2 at {time.perf_counter() - t_start:.1f} s]")
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
    offset_rows = (planes.to(torch.int64) + 256 * torch.arange(
        planes.shape[0], device=dev)[:, None]).reshape(-1)
    records = {"hist256": _compare(
        f"hist256 (sub_raw/bh_raw planes of {N_REQUESTS} A4 pages + random + constant)",
        lambda: kernels.hist256_batch(planes), lambda: kernels.hist256_batch_ref(planes),
        _hist256_bound(planes),
        [lambda: torch.bincount(offset_rows, minlength=planes.shape[0] * 256
                                ).view(planes.shape[0], 256)])}
    del offset_rows

    weighted = docscan._pre_deskew_stages(pages_d, cfg)["weighted"]
    deskew_edges = edges.canny(weighted, cfg.canny_low, cfg.canny_high)
    # the main path's 8 photos (phase 3), made once: their edge maps and
    # gray planes are the localize's and the preprocess's kernel inputs here
    tilted = 1
    inputs = [synth.document_photo(300 + i, *PHOTO,
                                   tilt_deg=3.0 if i == tilted else 0.0,
                                   rules=3 if i == tilted else 0,
                                   with_page=i != N_REQUESTS - 1)
              for i in range(N_REQUESTS)]
    photo_edges = edges.canny(rgb_to_gray(torch.from_numpy(np.stack(inputs)).to(dev)),
                              cfg.canny_low, cfg.canny_high)
    _canny_rows(dev, cfg, weighted, records)
    cos_np, sin_np = hough.hough_tables()
    cos_t, sin_t = torch.from_numpy(cos_np).to(dev), torch.from_numpy(sin_np).to(dev)
    hough_recs = []
    for what, e in (("deskew", deskew_edges), ("localize", photo_edges)):
        h, w = e.shape[-2:]
        numrho = (h + w) * 2 + 1
        xs, ys, counts, _ = hough.compact_edges(e, hough.default_max_edges(h, w))
        args = (xs, ys, counts, cos_t, sin_t, numrho, (numrho - 1) // 2)
        # each valid edge's two coordinates read, the accumulators written;
        # per vote y*sin, one fma (2) and the rounding
        edges_n, n_t = int(counts.sum()), cos_t.shape[0]
        bound = _bound(8 * edges_n + 4 * N_REQUESTS + 8 * n_t + 4 * N_REQUESTS * numrho * n_t,
                       4 * edges_n * n_t)
        hough_recs.append(_compare(
            f"hough_votes ({what}: {N_REQUESTS} edge maps {h}x{w}, "
            f"{int(counts.max())} edges max)",
            lambda: kernels.hough_votes(*args), lambda: kernels.hough_votes_ref(*args), bound,
            [lambda: _hough_bincount(*args)], plain_calls=5))
        # the same lengths at random coordinates: no run of neighbours
        # shares a bin, so what is left is the kernel's floor on its atomics
        gen_h = torch.Generator(device=dev).manual_seed(len(hough_recs))
        rand = (torch.randint(0, w, xs.shape, generator=gen_h, device=dev, dtype=torch.int32),
                torch.randint(0, h, xs.shape, generator=gen_h, device=dev, dtype=torch.int32))
        hough_recs[-1]["random_coords_ms"] = _cuda_ms(
            lambda: kernels.hough_votes(*rand, *args[2:]), reps=5, calls=20)
        print(f"hough_votes ({what}) on random coordinates of the same lengths: "
              f"{hough_recs[-1]['random_coords_ms']:.4f} ms")
    records["hough_votes"] = {
        **hough_recs[0], "max_abs_err": max(r["max_abs_err"] for r in hough_recs),
        "localize_ms": hough_recs[1]["ms"], "localize_plain_ms": hough_recs[1]["plain_ms"],
        "localize_bound_ms": hough_recs[1]["bound_ms"],
        "localize_random_coords_ms": hough_recs[1]["random_coords_ms"],
        "localize_library_ms": hough_recs[1]["library_ms"]}
    for name, xs_n, ys_n, counts_n, h, w in synth.hough_stress_cases():
        numrho = (h + w) * 2 + 1
        args = (*(torch.from_numpy(a).to(dev) for a in (xs_n, ys_n, counts_n)), cos_t, sin_t,
                numrho, (numrho - 1) // 2)
        _exact(f"hough_votes {name}", lambda: kernels.hough_votes(*args),
               lambda: kernels.hough_votes_ref(*args))
        print(f"hough_votes {name} ({xs_n.shape[0]} lists of up to {xs_n.shape[1]} edges, "
              f"counts {counts_n.tolist()[:6]}, {w}x{h}): exact")

    # rank_extract on the same maps, each page one band (compact_edges's
    # layout), and on tpuimage's position-major layout of one page
    rank_recs = {}
    for what, e, tpu in (("deskew", deskew_edges, False), ("localize", photo_edges, False),
                         ("tpu_layout", deskew_edges, True)):
        h, w = e.shape[-2:]
        rank, mask, kk = _rank_planes(e, hough.default_max_edges(h, w), tpu)
        rank_recs[what] = _compare(
            f"rank_extract ({what}: {'1 page as 128 bands' if tpu else f'{N_REQUESTS} pages'} "
            f"{h}x{w}, plane {tuple(mask.shape)}, kk {kk}, {int(mask.sum())} edges)",
            lambda rank=rank, mask=mask, kk=kk: kernels.rank_extract(rank, mask, kk),
            lambda rank=rank, mask=mask, kk=kk: kernels.rank_extract_ref(rank, mask, kk),
            _rank_bound(mask, kk), [lambda mask=mask, kk=kk: _rank_extract_nonzero(mask, kk)],
            plain_calls=5)
        if not tpu:
            k = hough.default_max_edges(h, w)
            new_ms = _cuda_ms(lambda e=e, k=k: hough.compact_edges(e, k), reps=5, calls=5)
            old_ms = _cuda_ms(lambda e=e, k=k: _compact_edges_nonzero(e, k), reps=5, calls=5)
            if not all(torch.equal(a, b) for a, b in zip(hough.compact_edges(e, k),
                                                         _compact_edges_nonzero(e, k))):
                raise AssertionError(f"compact_edges ({what}) differs from the nonzero form")
            dev_ms, n_k, top_k, _ = _profile(lambda e=e, k=k: hough.compact_edges(e, k))
            print(f"compact_edges ({what}): {new_ms:.4f} ms with rank_extract, "
                  f"{old_ms:.4f} ms in the earlier nonzero form (equal outputs; for the record); "
                  f"device time {dev_ms:.4f} ms in {n_k:.0f} kernels a call, the most: "
                  + "; ".join(f"{name} {t:.4f} ms" for name, t in top_k))
            rank_recs[what]["compact_edges_device_ms"] = dev_ms
    records["rank_extract"] = rank_recs["deskew"]
    for what in ("localize", "tpu_layout"):
        _sub_record(records["rank_extract"], what, rank_recs[what])
    del planes, weighted, deskew_edges, photo_edges, rank, mask

    # the post-warp chain's kernels on the 8 pages, at the path's sizes
    gray_d = rgb_to_gray(pages_d)
    n_px = N_REQUESTS * n
    ik, mk, ab = docscan.illum_ksize(*PAGE, cfg), docscan.mask_ksize(cfg), \
        docscan.adaptive_block(cfg)
    # per pass and pixel: Q8.8, whose taps are not symmetric, k products of
    # a byte with a byte and their adds, at the int8 tensor cores' rate;
    # adaptive 1 + 3r f32 operations (the centre product, then per pair its
    # add, the product and the accumulating add, in a pinned order)
    q8_bound = lambda k: _bound(2 * n_px + 4 * k, 2 * 2 * k * n_px,  # noqa: E731
                                peaks.INT8_TENSOR_OPS_PER_S)
    adaptive_bound = _bound(2 * n_px + 4 * ab, 2 * (1 + 3 * (ab // 2)) * n_px)
    # the library yardsticks' cudnn convolutions in f32, so their integer sums are exact
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    chain = {}
    for what, x, k, mode, C, bound in (("divide", gray_d, ik, "divide", 0.0, q8_bound(ik)),
                                        ("sub", stretched, mk, "sub", 0.0, q8_bound(mk)),
                                        ("adaptive", stretched, ab, "adaptive", cfg.C,
                                         adaptive_bound)):
        library = ()
        if mode != "adaptive":   # the f32 blur has no exact cudnn form
            padded = pad2d(x.to(torch.float32), k // 2, k // 2, k // 2, k // 2)[:, None]
            taps = torch.from_numpy(gaussian_kernel_q8(k).astype(np.float32)).to(dev)
            epilogue = ((lambda x, blur: arith.divide_u8(x, blur, scale=255)) if mode == "divide"
                        else (lambda x, blur: arith.subtract_u8(blur, x)))
            library = [lambda x=x, padded=padded, taps=taps, epilogue=epilogue:
                       epilogue(x, _conv_blur_u8(padded, taps))]
        chain[what] = _compare(
            f"gauss_chain {mode} k={k} ({N_REQUESTS} A4 planes {PAGE[1]}x{PAGE[0]}"
            + ("; library: two cudnn conv2d 1-D passes, rounding, the epilogue's ops)"
               if library else ")"),
            lambda x=x, k=k, mode=mode, C=C: kernels.gauss_chain(x, k, mode, C),
            lambda x=x, k=k, mode=mode, C=C: kernels.gauss_chain_ref(x, k, mode, C), bound,
            library)
        del library
    records["gauss_chain"] = chain["divide"]
    for what in ("sub", "adaptive"):
        _sub_record(records["gauss_chain"], what, chain[what])
    blur = {}
    for x, k in ((gray_d, ik), (stretched, mk)):
        padded = pad2d(x.to(torch.float32), k // 2, k // 2, k // 2, k // 2)[:, None]
        taps = torch.from_numpy(gaussian_kernel_q8(k).astype(np.float32)).to(dev)
        blur[k] = _compare(
            f"gaussian_blur_u8 k={k} ({N_REQUESTS} A4 planes {PAGE[1]}x{PAGE[0]}; library: "
            f"two cudnn conv2d 1-D passes + rounding)",
            lambda x=x, k=k: kernels.gaussian_blur_u8(x, k),
            lambda x=x, k=k: kernels.gaussian_blur_u8_ref(x, k), q8_bound(k),
            [lambda padded=padded, taps=taps: _conv_blur_u8(padded, taps)])
        del padded
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    # windows too wide for the tensor-core form's registers: the Q8.8 modes
    # in the sliding-window form
    for k in WIDE_BLUR_KSIZES:
        blur[k] = _compare(
            f"gaussian_blur_u8 k={k} ({N_REQUESTS} A4 planes {PAGE[1]}x{PAGE[0]})",
            lambda k=k: kernels.gaussian_blur_u8(stretched, k),
            lambda k=k: kernels.gaussian_blur_u8_ref(stretched, k), q8_bound(k), plain_calls=2)
    records["gaussian_blur_u8"] = blur[ik]
    for k in (mk, *WIDE_BLUR_KSIZES):
        _sub_record(records["gaussian_blur_u8"], f"k{k}", blur[k])
    bk_h, bk_w = docscan.blackhat_se(cfg).shape
    stretched_f = stretched.to(torch.float16)
    # four 1-D extremes of ~3 compares per pixel (van Herk), the subtract and clamp
    records["blackhat_rect"] = _compare(
        f"blackhat_rect {bk_w}x{bk_h} ({N_REQUESTS} stretched A4 planes; library: "
        "relu(-max_pool2d(-max_pool2d(x)) - x) on the planes in f16, 2-D / separable)",
        lambda: kernels.blackhat_rect(stretched, bk_w, bk_h),
        lambda: kernels.blackhat_rect_ref(stretched, bk_w, bk_h),
        _bound(2 * n_px, 14 * n_px),
        [lambda sep=sep: torch.relu(_pool_close(stretched_f, bk_h, bk_w, sep) - stretched_f)
         for sep in (False, True)])
    del stretched_f
    hists = kernels.hist256_batch(torch.stack([sub_raw, bh_raw], dim=1)
                                  .reshape(2 * N_REQUESTS, -1)).reshape(-1, 2, 256)
    t_sub = docscan._raw_otsu_threshold(hists[:, 0], cfg.mask_thresh_offset)
    t_bh = docscan._raw_otsu_threshold(hists[:, 1], cfg.mask_thresh_offset)
    adapt = kernels.gauss_chain(stretched, ab, "adaptive", cfg.C)
    it = cfg.ink_dilate_iters

    def inkmask_library():
        """The two thresholds and their max, ``iters`` 2x2 dilations (anchor
        at the window's lower right) as ``max_pool2d``, the select."""
        mask = torch.maximum(sub_raw > t_sub[:, None, None], bh_raw > t_bh[:, None, None]
                             ).to(torch.float16) * 255
        for _ in range(it):
            mask = torch.nn.functional.max_pool2d(mask, 2, 1, 1)[:, :PAGE[0], :PAGE[1]]
        torch.where(mask == 0, 255, adapt)      # the second output, timed with the first
        return mask

    # two compares and their or, 2 * iters maxima (separable), the select
    records["inkmask_weighted"] = _compare(
        f"inkmask_weighted iters={it} ({N_REQUESTS} A4 planes, thresholds "
        f"{t_sub.tolist()} / {t_bh.tolist()}; library: compares, max_pool2d, where)",
        lambda: kernels.inkmask_weighted(sub_raw, bh_raw, adapt, t_sub, t_bh, it),
        lambda: kernels.inkmask_weighted_ref(sub_raw, bh_raw, adapt, t_sub, t_bh, it),
        _bound(5 * n_px + 8 * N_REQUESTS, (4 + 2 * it) * n_px), [inkmask_library])
    _rotated("inkmask_weighted", records["inkmask_weighted"],
             lambda c: lambda: kernels.inkmask_weighted(*c, t_sub, t_bh, it),
             (sub_raw, bh_raw, adapt))
    if not torch.equal(kernels.divide_table(dev).cpu(), kernels.divide_table("cpu")):
        raise AssertionError("the divide epilogue differs from divide_u8 on the card")
    print("divide epilogue: all 65,536 (num, den) pairs equal divide_u8")
    # the split forms, for windows too wide for the kernels' tiles
    two = stretched[:2].contiguous()
    wide = (("gaussian_blur_u8 k=257", lambda: kernels.gaussian_blur_u8(two, 257),
             lambda: kernels.gaussian_blur_u8_ref(two, 257)),
            ("gauss_chain sub k=257", lambda: kernels.gauss_chain(two, 257, "sub"),
             lambda: kernels.gauss_chain_ref(two, 257, "sub")),
            ("gauss_chain adaptive k=257", lambda: kernels.gauss_chain(two, 257, "adaptive", 3.0),
             lambda: kernels.gauss_chain_ref(two, 257, "adaptive", 3.0)),
            ("blackhat_rect 129x255", lambda: kernels.blackhat_rect(two, 129, 255),
             lambda: kernels.blackhat_rect_ref(two, 129, 255)),
            ("inkmask_weighted iters=9",
             lambda: kernels.inkmask_weighted(sub_raw, bh_raw, adapt, t_sub, t_bh, 9),
             lambda: kernels.inkmask_weighted_ref(sub_raw, bh_raw, adapt, t_sub, t_bh, 9)))
    for what, kernel_fn, plain_fn in wide:
        _exact(what, kernel_fn, plain_fn)
        print(f"{what} (split form, 2 or 8 A4 planes): exact")
    # the byte-mask kernels at the edges: rows at every alignment
    n_cases = 0
    for shape in MASK_EDGE_SHAPES:
        planes = [_at_offset(shape, off, 100 * off + shape[2], dev) for off in (1, 2, 3)]
        for i in range(len(MASK_EDGE_THRESHOLDS)):
            t1, t2 = (torch.tensor([MASK_EDGE_THRESHOLDS[(k * i + j + k - 1) % 8]
                                    for j in range(shape[0])], device=dev) for k in (1, 3))
            _exact(f"binary_close3 {shape} at byte offset 1, thresholds {t1.tolist()}",
                   lambda: kernels.binary_close3(planes[0], t1),
                   lambda: kernels.binary_close3_ref(planes[0], t1))
            for iters in MASK_EDGE_ITERS:
                _exact(f"inkmask_weighted {shape} iters={iters} at byte offsets 1-3, "
                       f"thresholds {t1.tolist()} / {t2.tolist()}",
                       lambda: kernels.inkmask_weighted(*planes, t1, t2, iters),
                       lambda: kernels.inkmask_weighted_ref(*planes, t1, t2, iters))
            n_cases += 1 + len(MASK_EDGE_ITERS)
    print(f"binary_close3 / inkmask_weighted (iters {MASK_EDGE_ITERS}) on shapes "
          f"{MASK_EDGE_SHAPES}, planes 1-3 bytes off a word boundary, thresholds "
          f"{MASK_EDGE_THRESHOLDS}: {n_cases} cases exact")
    # the separable Gaussian on shapes and sizes chosen to break it, every mode
    n_cases = 0
    for shape in synth.BLUR_STRESS_SHAPES:
        x = torch.from_numpy(synth.blur_stress_planes(shape)).to(dev)
        for k in synth.BLUR_STRESS_KSIZES:
            _exact(f"gaussian_blur_u8 {shape} k={k}", lambda: kernels.gaussian_blur_u8(x, k),
                   lambda: kernels.gaussian_blur_u8_ref(x, k))
            for mode, C in synth.CHAIN_STRESS_MODES:
                _exact(f"gauss_chain {mode} C={C} {shape} k={k}",
                       lambda: kernels.gauss_chain(x, k, mode, C),
                       lambda: kernels.gauss_chain_ref(x, k, mode, C))
            n_cases += 1 + len(synth.CHAIN_STRESS_MODES)
    x = torch.from_numpy(synth.blur_stress_planes(synth.BLUR_STRESS_SHAPES[0])).to(dev)
    for k, sigma in ((3, 0.01), (5, 0.2), (43, 0.3)):     # (nearly) all 256 on one tap
        _exact(f"gaussian_blur_u8 k={k} sigma={sigma}",
               lambda: kernels.gaussian_blur_u8(x, k, sigma),
               lambda: kernels.gaussian_blur_u8_ref(x, k, sigma))
    print(f"gaussian_blur_u8 / gauss_chain on shapes {synth.BLUR_STRESS_SHAPES}, ksize "
          f"{synth.BLUR_STRESS_KSIZES}, every mode, and a centre tap of 256: "
          f"{n_cases + 3} cases exact")
    del gray_d, sub_raw, bh_raw, adapt, hists, two, x

    # bilateral: DocScanner's preprocess (8 gray photos, d 9, 75/75), one
    # 12 MP phone photo, landscape's GUI setting on colour (d 9, 100/75),
    # and face's d -1, 30/10 (radius 15), exact only
    gray_photos = rgb_to_gray(torch.from_numpy(np.stack(inputs)).to(dev))
    phone = rgb_to_gray(torch.from_numpy(synth.document_photo(250, *PHONE_PHOTO)).to(dev))[None]
    scenes_c = torch.from_numpy(np.stack([synth.document_photo(260 + i, *NIGHT)
                                          for i in range(N_REQUESTS)])).to(dev)
    bil = {}
    for what, x, (d, sc, ss) in (("preprocess", gray_photos, (9, 75.0, 75.0)),
                                 ("phone_12mp", phone, (9, 75.0, 75.0)),
                                 ("color", scenes_c, (9, 100.0, 75.0))):
        chans = 3 if x.dim() == 4 else 1
        radius, taps, space_w, lut = bilateral.tables_on(d, sc, ss, chans, dev)
        bil[what] = _compare(
            f"bilateral {what} d={d} {sc:g}/{ss:g} ({x.shape[0]} x {tuple(x.shape[1:])}, "
            f"{taps.shape[0]} taps)",
            lambda x=x, a=(taps, space_w, lut, radius): kernels.bilateral(x, *a),
            lambda x=x, a=(taps, space_w, lut, radius): kernels.bilateral_ref(x, *a),
            _bilateral_bound(x, taps.shape[0]), plain_calls=2)
    records["bilateral"] = bil["preprocess"]
    for what in ("phone_12mp", "color"):
        _sub_record(records["bilateral"], what, bil[what])
    face_pair = scenes_c[:2].contiguous()
    radius, taps, space_w, lut = bilateral.tables_on(-1, 30.0, 10.0, 3, dev)
    bil["face_r15"] = _compare(
        f"bilateral face d=-1 30/10 (2 colour images {NIGHT[1]}x{NIGHT[0]}, radius {radius}, "
        f"{taps.shape[0]} taps)",
        lambda: kernels.bilateral(face_pair, taps, space_w, lut, radius),
        lambda: kernels.bilateral_ref(face_pair, taps, space_w, lut, radius),
        _bilateral_bound(face_pair, taps.shape[0]), plain_calls=1)
    _sub_record(records["bilateral"], "face_r15", bil["face_r15"])
    del gray_photos, phone, scenes_c, face_pair

    # --- 3. the main path ----------------------------------------------------
    print(f"[phase 3 at {time.perf_counter() - t_start:.1f} s]")
    docscan.scan_batch(inputs, cfg, device=dev)          # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    results = docscan.scan_batch(inputs, cfg, device=dev)
    torch.cuda.synchronize()
    launches = _launched("scan_batch", kernels.launch_counts(),
                         ("hist256", "hough_votes", "rank_extract") + PRE_DESKEW_KERNELS)
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

    # _pre_deskew_stages reads nothing back to the host: any synchronizing
    # call (a device-to-host copy, .item(), nonzero) raises here
    pre_fn = lambda: docscan._pre_deskew_stages(pages_d, cfg)  # noqa: E731
    pre_fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pre_fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"_pre_deskew_stages on {N_REQUESTS} A4 pages ran under "
          "torch.cuda.set_sync_debug_mode('error'): no read back to the host")

    # the cv2.GaussianBlur op, a path of its own: what tpuimage's other
    # pipelines call (no stage of scan_batch does)
    gray_pages = rgb_to_gray(pages_d)
    filters.gaussian_blur_u8(gray_pages, ksize=ik)                 # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    blurred = filters.gaussian_blur_u8(gray_pages, ksize=ik)
    torch.cuda.synchronize()
    for k, v in _launched("filters.gaussian_blur_u8", kernels.launch_counts(),
                          ("gaussian_blur_u8",)).items():
        launches[k] += v
    if not torch.equal(blurred, kernels.gaussian_blur_u8_ref(gray_pages, ik)):
        raise AssertionError("filters.gaussian_blur_u8 differs from its plain version")
    print(f"filters.gaussian_blur_u8 k={ik}: {tuple(blurred.shape)} uint8, equal to the "
          "plain version")
    del gray_pages, blurred

    # --- 4. card against host -----------------------------------------------
    print(f"[phase 4 at {time.perf_counter() - t_start:.1f} s]")
    pick = [0, tilted]
    host = docscan.scan_batch([inputs[i] for i in pick], cfg, device="cpu")
    for i, h in zip(pick, host):
        _card_vs_host(f"request {i}", results[i], h)
    # the mean adaptive threshold (an integer box filter on plain tensor ops)
    mean_cfg = dataclasses.replace(cfg, thresh_method="mean")
    card_mean = docscan._pre_deskew_stages(pages_d[:2], mean_cfg)
    for k, v in docscan._pre_deskew_stages(pages_d[:2].cpu(), mean_cfg).items():
        if not torch.equal(card_mean[k].cpu(), v):
            raise AssertionError(f"_pre_deskew_stages thresh_method='mean': {k} differs "
                                 "card vs host")
    print("card vs host, _pre_deskew_stages with thresh_method='mean' on 2 A4 pages: every "
          "stage equal")
    del card_mean

    # --- 5. process_document: DocScanner's one-document path -----------------
    print(f"[phase 5 at {time.perf_counter() - t_start:.1f} s]")
    # in-memory photos and no out_dir: the path without its file I/O
    docs = [tilted, N_REQUESTS - 1]                      # a quad page and a use-whole one
    for i in docs:
        docscan.process_document(inputs[i], out_dir=None, config=cfg, device=dev)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    card_docs = [docscan.process_document(inputs[i], out_dir=None, config=cfg, device=dev)
                 for i in docs]
    torch.cuda.synchronize()
    for k, v in _launched("process_document", kernels.launch_counts(),
                          ("bilateral", "rank_extract", "hough_votes", "hist256")
                          + PRE_DESKEW_KERNELS).items():
        launches[k] += v
    doc_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        for i in docs:
            docscan.process_document(inputs[i], out_dir=None, config=cfg, device=dev)
        torch.cuda.synchronize()
        doc_ms.append((time.perf_counter() - t0) * 1e3 / len(docs))
    print(f"process_document: {statistics.median(doc_ms):.2f} ms per document (median of 3 "
          f"runs over {len(docs)} photos {PHOTO[1]}x{PHOTO[0]}, warm, host clock, photo in "
          f"host memory); runs {[round(m, 2) for m in doc_ms]}")
    for i, c in zip(docs, card_docs):
        h = docscan.process_document(inputs[i], out_dir=None, config=cfg, device="cpu")
        diff = np.abs(c["warped"].cpu().numpy().astype(np.int32)
                      - h["warped"].numpy().astype(np.int32))
        if diff.max() > 1 or (diff > 0).mean() >= 0.005:
            raise AssertionError(f"process_document {i}: warped differs by up to "
                                 f"{diff.max()} on {(diff > 0).mean():.5f} of values")
        _card_vs_host(f"process_document {i} (warped: {(diff > 0).mean():.6f} of values "
                      f"differ by <= 1)", _doc_request(c), _doc_request(h))

    # --- 6. scan_stream, pipeline_chunk and fallback_common_shape ----------
    print(f"[phase 6 at {time.perf_counter() - t_start:.1f} s]")
    # timed in turns on the host clock over the same 4 batches of 8: a loop
    # of scan_batch calls, the stream with its load and fetch threads, the
    # stream without them (prefetch=False), the loop again
    batches = [inputs] * 4
    list(docscan.scan_stream(batches[:2], cfg, device=dev))            # warm-up
    torch.cuda.synchronize()
    forms = {"scan_batch loop": lambda: [docscan.scan_batch(b, cfg, device=dev)
                                         for b in batches],
             "scan_stream": lambda: list(docscan.scan_stream(batches, cfg, device=dev)),
             "scan_stream prefetch=False": lambda: list(docscan.scan_stream(
                 batches, cfg, device=dev, prefetch=False))}
    stream_s = {k: [] for k in forms}
    outs = {}
    for name in ("scan_batch loop", "scan_stream", "scan_stream prefetch=False",
                 "scan_batch loop"):
        if name == "scan_stream":
            kernels.reset_launch_counts()
        t0 = time.perf_counter()
        outs[name] = forms[name]()
        torch.cuda.synchronize()
        stream_s[name].append(time.perf_counter() - t0)
        if name == "scan_stream" and len(stream_s[name]) == 1:
            for k, v in _launched("scan_stream", kernels.launch_counts(),
                                  ("rank_extract", "hough_votes", "hist256")
                                  + PRE_DESKEW_KERNELS).items():
                launches[k] += v
    chunked = docscan.scan_batch(inputs, cfg, device=dev, pipeline_chunk=4)
    for res in [r for out in outs.values() for r in out] + [chunked]:
        for i, (a, b) in enumerate(zip(res, results, strict=True)):
            if not _same_result(a, b):
                raise AssertionError(f"scan_stream / pipeline_chunk request {i} differs "
                                     "from scan_batch's")
    n_img = len(batches) * N_REQUESTS
    print(f"scan_stream and scan_batch over {len(batches)} batches of {N_REQUESTS} photos "
          f"{PHOTO[1]}x{PHOTO[0]} from host memory, host clock, in turns: " + "; ".join(
              f"{k} {', '.join(f'{n_img / t:.2f}' for t in v)} img/s"
              for k, v in stream_s.items())
          + "; every result equal to scan_batch's, as are scan_batch(pipeline_chunk=4)'s")
    fb = docscan.scan_batch([inputs[-1]], cfg, device=dev, fallback_common_shape=True)[0]
    fb_host = docscan.scan_batch([inputs[-1]], cfg, device="cpu", fallback_common_shape=True)[0]
    if fb.get("fallback_resized_to") != PAGE or fb["binary"].shape != PAGE:
        raise AssertionError(f"fallback_common_shape: {fb.get('fallback_resized_to')} "
                             f"{fb['binary'].shape}")
    _card_vs_host(f"scan_batch(fallback_common_shape=True), page-less photo resized to "
                  f"{PAGE}", fb, fb_host)
    del inputs, results, host, pages_d, card_docs, outs, chunked

    # --- 7. night and morph_seq kernels against their plain versions --------
    print(f"[phase 7 at {time.perf_counter() - t_start:.1f} s]")
    scenes = np.stack([synth.night_scene(400 + i, *NIGHT) for i in range(N_REQUESTS)])
    scenes_d = torch.from_numpy(scenes).to(dev)
    filtered = median.median_blur(scenes_d, 3, channels_last=True).contiguous()
    tables = color.lab_tables_on(dev)
    n_night = N_REQUESTS * NIGHT[0] * NIGHT[1]
    # per pixel: 3 rows of 3 MACs, descale and clamp; L, a, b; 3 saturations
    records["rgb_to_lab"] = _compare(
        f"rgb_to_lab ({N_REQUESTS} median-filtered night scenes {NIGHT[1]}x{NIGHT[0]})",
        lambda: kernels.rgb_to_lab(filtered, tables),
        lambda: kernels.rgb_to_lab_ref(filtered, tables),
        _bound(6 * n_night + 4 * tables.numel(), 47 * n_night))
    _rotated("rgb_to_lab", records["rgb_to_lab"],
             lambda c: lambda: kernels.rgb_to_lab(c[0], tables), (filtered,))
    # at the edges: 1-17 pixels and one past the batch, the input 0-15
    # bytes past a 16-byte boundary (the kernel reads aligned words)
    flat = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, 3 * (n_night + 1) + 16, dtype=np.uint8)).to(dev)
    n_cases = 0
    for n_pix in (*range(1, 18), n_night + 1):
        for off in range(16):
            x = flat[off:off + 3 * n_pix].view(n_pix, 3)
            if x.data_ptr() % 16 != (flat.data_ptr() + off) % 16:
                raise AssertionError("the input does not start where it was asked to")
            _exact(f"rgb_to_lab {n_pix} pixels at byte offset {off}",
                   lambda: kernels.rgb_to_lab(x, tables), lambda: kernels.rgb_to_lab_ref(x, tables))
            n_cases += 1
    print(f"rgb_to_lab on 1-17 and {n_night + 1} pixels, inputs 0-15 bytes past a 16-byte "
          f"boundary: {n_cases} cases exact")
    del flat, x
    lum = kernels.rgb_to_lab(filtered, tables)[..., 0].contiguous()
    tiles, th, tw = histogram.clahe_tiles(lum, night.TILES, night.TILES)
    clahe_hist = _compare(
        f"hist256 ({tiles.shape[0]} CLAHE tile rows of {th}x{tw})",
        lambda: kernels.hist256_batch(tiles), lambda: kernels.hist256_batch_ref(tiles),
        _hist256_bound(tiles))
    luts = histogram.tile_luts_from_counts(kernels.hist256_batch(tiles), night.CLIP_LIMIT,
                                           th * tw)
    luts = luts.reshape(N_REQUESTS, night.TILES, night.TILES, 256)
    R, C = histogram.blend_tables_on(*NIGHT, th, tw, night.TILES, night.TILES, dev)
    # per pixel: 6 multiplies and 3 adds
    records["clahe_apply"] = _compare(
        f"clahe_apply ({N_REQUESTS} L planes {NIGHT[1]}x{NIGHT[0]}, 8x8 tile LUTs)",
        lambda: kernels.clahe_apply(lum, luts, R, C),
        lambda: kernels.clahe_apply_ref(lum, luts, R, C),
        _bound(2 * n_night + luts.numel() + 4 * (R.numel() + C.numel()), 9 * n_night))
    _rotated("clahe_apply", records["clahe_apply"],
             lambda c: lambda: kernels.clahe_apply(*c, R, C), (lum, luts))
    del filtered, lum, tiles, luts

    docs = np.stack([synth.document_photo(500 + i, *MORPH) for i in range(N_REQUESTS)])
    docs_d = torch.from_numpy(docs).to(dev)
    n_morph = N_REQUESTS * MORPH[0] * MORPH[1]
    # per pixel: gray (3 MACs, round, shift) and 8 mins
    gray_f = kernels.gray_erode3(docs_d)[0].to(torch.float16)
    records["gray_erode3"] = _compare(
        f"gray_erode3 ({N_REQUESTS} RGB document photos {MORPH[1]}x{MORPH[0]}; library: the "
        "erosion of the gray planes as -max_pool2d(-x) in f16, 2-D / separable, no gray "
        "conversion)",
        lambda: kernels.gray_erode3(docs_d), lambda: kernels.gray_erode3_ref(docs_d),
        _bound(5 * n_morph, 15 * n_morph),
        [lambda sep=sep: -_pool_max(-gray_f, 3, 3, sep) for sep in (False, True)],
        library_output=1)
    _rotated("gray_erode3", records["gray_erode3"], lambda c: lambda: kernels.gray_erode3(*c),
             (docs_d,))
    eroded = kernels.gray_erode3(docs_d)[1]
    rows = eroded.reshape(N_REQUESTS, -1)
    morph_hist = _compare(
        f"hist256 ({N_REQUESTS} eroded planes {MORPH[1]}x{MORPH[0]})",
        lambda: kernels.hist256_batch(rows), lambda: kernels.hist256_batch_ref(rows),
        _hist256_bound(rows))
    thresh = histogram.otsu_from_hist(kernels.hist256_batch(rows))
    # per pixel: the compare, 8 maxes and 8 mins
    records["binary_close3"] = _compare(
        f"binary_close3 ({N_REQUESTS} eroded planes {MORPH[1]}x{MORPH[0]}, "
        f"Otsu thresholds {thresh.tolist()}; library: the threshold and max_pool2d in f16, "
        "2-D / separable)",
        lambda: kernels.binary_close3(eroded, thresh),
        lambda: kernels.binary_close3_ref(eroded, thresh),
        _bound(3 * n_morph + 4 * N_REQUESTS, 17 * n_morph),
        [lambda sep=sep: _pool_close((eroded > thresh[:, None, None]).to(torch.float16) * 255,
                                     3, 3, sep) for sep in (False, True)],
        library_output=1)
    _rotated("binary_close3", records["binary_close3"],
             lambda c: lambda: kernels.binary_close3(*c), (eroded, thresh))
    del gray_f
    rec = records["hist256"]
    rec["max_abs_err"] = max(rec["max_abs_err"], clahe_hist["max_abs_err"],
                             morph_hist["max_abs_err"])
    for what, r in (("clahe_tiles", clahe_hist), ("morphseq", morph_hist)):
        rec.update({f"{what}_ms": r["ms"], f"{what}_plain_ms": r["plain_ms"],
                    f"{what}_bound_ms": r["bound_ms"], f"{what}_graph_ms": r["graph_ms"]})
    del eroded, rows

    # --- 8. the night and morph_seq paths -----------------------------------
    print(f"[phase 8 at {time.perf_counter() - t_start:.1f} s]")
    gray_scenes = rgb_to_gray(torch.from_numpy(scenes)).numpy()
    gray_d = torch.from_numpy(gray_scenes).to(dev)
    paths = (("night_rgb", night.night_rgb_batch, scenes, scenes_d,
              ("rgb_to_lab", "clahe_apply", "hist256"), NIGHT),
             ("night_gray", night.night_gray_batch, gray_scenes, gray_d,
              ("clahe_apply", "hist256"), NIGHT),
             ("morph_seq", morphseq.morphseq_batch, docs, docs_d,
              ("gray_erode3", "binary_close3", "hist256"), MORPH))
    pick = [0, 1]
    card = {}
    for name, fn, x_np, x_d, needed, (h, w) in paths:
        fn(x_np)                                          # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = fn(x_np)                                    # an array: on the card by default
        torch.cuda.synchronize()
        for k, v in _launched(name, kernels.launch_counts(), needed).items():
            launches[k] += v
        for k, v in out.items():
            if v.device.type != "cuda" or v.dtype != torch.uint8 or \
                    tuple(v.shape[:3]) != (N_REQUESTS, h, w):
                raise AssertionError(f"{name} {k}: {v.device} {v.dtype} {tuple(v.shape)}")
        if name.startswith("night") and not (
                out["enhanced"].float().mean() > out["original"].float().mean()):
            raise AssertionError(f"{name}: CLAHE did not brighten the night scenes")
        if name == "morph_seq" and not bool(
                ((out["step4_closed"] == 0) | (out["step4_closed"] == 255)).all()):
            raise AssertionError("morph_seq: the closing is not binary")
        card[name] = {k: v[pick].cpu().numpy() for k, v in out.items()}
        del out
        if name == "night_rgb":        # timed host to host by the benchmark (night.lol_b8)
            continue
        ms = _cuda_ms(lambda: fn(x_d), reps=3, calls=5)
        print(f"{name}: {ms:.3f} ms per batch of {N_REQUESTS} {w}x{h} = "
              f"{N_REQUESTS * h * w / 1e3 / ms:.1f} MP/s (CUDA events, warm, median of 3 "
              f"runs of 5 calls, input on the card)")
        _print_profile(name, ms, lambda: fn(x_d))

    # --- 9. card against host ------------------------------------------------
    print(f"[phase 9 at {time.perf_counter() - t_start:.1f} s]")
    for name, fn, x_np, _, _, _ in paths:
        host = {k: v.numpy() for k, v in fn(x_np[pick], device="cpu").items()}
        for k, c in card[name].items():
            diff = np.abs(c.astype(np.int32) - host[k].astype(np.int32))
            n_diff = int((diff > 0).sum())
            if name == "night_rgb" and k == "enhanced":
                max_levels, max_share = NIGHT_RGB_TOL
                if diff.max() > max_levels or n_diff >= max_share * diff.size:
                    raise AssertionError(f"night_rgb enhanced: {n_diff} of {diff.size} "
                                         f"values differ, by up to {diff.max()}")
            elif n_diff:
                raise AssertionError(f"{name} {k}: {n_diff} pixels differ card vs host")
            print(f"card vs host, {name} {k} (images {pick}): {n_diff} of {diff.size} "
                  f"values differ, max |diff| {int(diff.max())}")

    # --- 10. landscape -----------------------------------------------------
    print(f"[phase 10 at {time.perf_counter() - t_start:.1f} s]")
    land = np.stack([synth.landscape_scene(600 + i, *NIGHT) for i in range(N_REQUESTS)])
    land_d = torch.from_numpy(land).to(dev)
    # the kernels at the path's shapes: rgb_to_lab on the bilateral output
    # (landscape_gui's CLAHE input), the sharpening's blur of the 24 planes
    # after the CLAHE, the restore's bilateral d 11 100/100
    denoised = landscape.denoise_image(land_d, "bilateral", 5, False)
    lab_rec = _compare(
        f"rgb_to_lab ({N_REQUESTS} bilateral-filtered landscape scenes {NIGHT[1]}x{NIGHT[0]})",
        lambda: kernels.rgb_to_lab(denoised, tables), lambda: kernels.rgb_to_lab_ref(denoised, tables),
        _bound(6 * n_night + 4 * tables.numel(), 47 * n_night))
    _sub_record(records["rgb_to_lab"], "landscape", lab_rec)
    contrast = landscape.enhance_contrast_clahe(denoised, 2.2, (8, 8), 2.0, 0.55)
    planes = contrast.movedim(-1, -3).reshape(-1, *NIGHT).contiguous()
    k = LANDSCAPE_SHARPEN_KSIZE
    n_planes = planes.numel()
    padded = pad2d(planes.to(torch.float32), k // 2, k // 2, k // 2, k // 2)[:, None]
    taps = torch.from_numpy(gaussian_kernel_q8(k, 1.0).astype(np.float32)).to(dev)
    torch.backends.cudnn.allow_tf32 = False
    blur7 = _compare(
        f"gaussian_blur_u8 k={k} sigma 1 ({planes.shape[0]} landscape planes "
        f"{NIGHT[1]}x{NIGHT[0]}; library: two cudnn conv2d 1-D passes + rounding)",
        lambda: kernels.gaussian_blur_u8(planes, k, 1.0),
        lambda: kernels.gaussian_blur_u8_ref(planes, k, 1.0),
        _bound(2 * n_planes + 4 * k, 2 * 2 * k * n_planes, peaks.INT8_TENSOR_OPS_PER_S),
        [lambda: _conv_blur_u8(padded, taps)])
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    _sub_record(records["gaussian_blur_u8"], f"landscape_k{k}", blur7)
    del padded, planes
    radius, btaps, space_w, lut = bilateral.tables_on(11, 100.0, 100.0, 3, dev)
    _exact(f"bilateral d=11 100/100 ({N_REQUESTS} landscape scenes, {btaps.shape[0]} taps)",
           lambda: kernels.bilateral(land_d, btaps, space_w, lut, radius),
           lambda: kernels.bilateral_ref(land_d, btaps, space_w, lut, radius))
    print(f"bilateral d=11 100/100 on {N_REQUESTS} landscape scenes: exact")
    del denoised, contrast

    # the degrade's noise, drawn once from a seeded generator: the same on the card and the host
    noise = torch.randn(land.shape, generator=torch.Generator().manual_seed(11))
    noise_d = noise.to(dev)
    land_paths = (
        ("landscape_gui", lambda x, nz, **kw: landscape.landscape_gui(x, **kw)),
        ("landscape_eval_batch",
         lambda x, nz, **kw: landscape.landscape_eval_batch(x, noise=nz, **kw)))
    needed = ("bilateral", "rgb_to_lab", "hist256", "clahe_apply", "gaussian_blur_u8")
    land_card = {}
    for name, fn in land_paths:
        fn(land, noise_d)                                     # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = fn(land, noise_d)                               # an array: on the card by default
        torch.cuda.synchronize()
        for k_, v in _launched(name, kernels.launch_counts(), needed).items():
            launches[k_] += v
        outs = out if isinstance(out, dict) else {"enhanced": out}
        for k_, v in outs.items():
            want = (N_REQUESTS,) if v.dim() == 1 else (N_REQUESTS, *NIGHT, 3)
            if v.device.type != "cuda" or tuple(v.shape) != want:
                raise AssertionError(f"{name} {k_}: {v.device} {v.dtype} {tuple(v.shape)}")
            if v.dim() == 1 and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{name} {k_}: {v.tolist()}")
        if not bool((outs["enhanced"] != torch.from_numpy(land).to(dev)).any()):
            raise AssertionError(f"{name}: the scenes came back unchanged")
        if isinstance(out, dict):
            print(f"{name}: PSNR enhanced {[round(v, 2) for v in out['psnr_enhanced'].tolist()]}, "
                  f"restored {[round(v, 2) for v in out['psnr_restored'].tolist()]}; SSIM "
                  f"enhanced {[round(v, 4) for v in out['ssim_enhanced'].tolist()]}, restored "
                  f"{[round(v, 4) for v in out['ssim_restored'].tolist()]}")
        land_card[name] = {k_: v[pick].cpu() for k_, v in outs.items()}
        del out, outs
        if name == "landscape_gui":    # timed host to host by the benchmark (landscape.*)
            continue
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2 ** 20
        ms = _cuda_ms(lambda: fn(land_d, noise_d), reps=3, calls=5)
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        print(f"{name}: {ms:.3f} ms per batch of {N_REQUESTS} {NIGHT[1]}x{NIGHT[0]} = "
              f"{N_REQUESTS * NIGHT[0] * NIGHT[1] / 1e3 / ms:.1f} MP/s (CUDA events, warm, median "
              f"of 3 runs of 5 calls, input on the card); device memory: peak "
              f"{peak_mb - base_mb:.1f} MiB above the {base_mb:.1f} MiB held before the calls")
        _print_profile(name, ms, lambda: fn(land_d, noise_d))
    # card against host, two scenes, the same noise on both
    host_x = land[pick]
    for name, fn in land_paths:
        host = fn(host_x, noise[pick], device="cpu")
        host = host if isinstance(host, dict) else {"enhanced": host}
        card_two = fn(torch.from_numpy(host_x).to(dev), noise_d[pick])
        card_two = card_two if isinstance(card_two, dict) else {"enhanced": card_two}
        for k_, h in host.items():
            c = card_two[k_].cpu()
            if h.dim() == 1:
                rel, tol_ssim = PATH_STATS_TOL
                tol = rel * h.abs() if k_.startswith("psnr") else torch.full_like(h, tol_ssim)
                if not bool(((c - h).abs() <= tol).all()):
                    raise AssertionError(f"{name} {k_}: card {c.tolist()} vs host {h.tolist()}")
                print(f"card vs host, {name} {k_}: {c.tolist()} vs {h.tolist()}")
                continue
            diff = (c.to(torch.int32) - h.to(torch.int32)).abs()
            n_diff = int((diff > 0).sum())
            max_levels, max_share = NIGHT_RGB_TOL
            if int(diff.max()) > max_levels or n_diff >= max_share * diff.numel():
                raise AssertionError(f"{name} {k_}: {n_diff} of {diff.numel()} values differ, "
                                     f"by up to {int(diff.max())}")
            print(f"card vs host, {name} {k_} (scenes {pick}): {n_diff} of {diff.numel()} values "
                  f"differ, max |diff| {int(diff.max())}")
        if name == "landscape_gui":
            # the batch run's two scenes equal this run's: one image's result
            # does not depend on the others in its batch
            if not torch.equal(land_card[name]["enhanced"], card_two["enhanced"].cpu()):
                raise AssertionError("landscape_gui: batch of 8 and batch of 2 differ")
    del host, card_two
    # the denoise options off the preset's path, timed once each
    for k_ in (5, 7):
        ms = _cuda_ms(lambda: median.median_blur(land_d, k_, channels_last=True), reps=1, calls=1)
        print(f"median_blur k={k_} on {N_REQUESTS} landscape scenes {NIGHT[1]}x{NIGHT[0]} "
              f"(channel-last, {k_ * k_} views, odd-even sort): {ms:.2f} ms (one warm call)")
    one = land_d[:1].contiguous()
    ms = _cuda_ms(lambda: nlm.nlm_denoise_colored(one, 10.0, 10.0), reps=1, calls=1)
    print(f"nlm_denoise_colored h 10 on 1 landscape scene {NIGHT[1]}x{NIGHT[0]} (search 21, "
          f"template 7): {ms:.1f} ms (one warm call)")
    del land_d, one, noise_d

    # --- 11. face ------------------------------------------------------------
    print(f"[phase 11 at {time.perf_counter() - t_start:.1f} s]")
    shots = {n: [synth.portrait(800 + 10 * j + i, *FACE, noise=n) for i in range(N_FACE)]
             for j, n in enumerate(synth.PORTRAIT_NOISE)}
    gauss_d = torch.from_numpy(np.stack([p[0] for p in shots["gaussian"]])).to(dev)
    n_face = N_FACE * FACE[0] * FACE[1]
    # the five kernels at face's shapes: the polish bilateral (d 5, 20/20)
    radius, btaps, space_w, lut = bilateral.tables_on(5, 20.0, 20.0, 3, dev)
    rec = _compare(
        f"bilateral face polish d=5 20/20 ({N_FACE} colour portraits {FACE[1]}x{FACE[0]}, "
        f"{btaps.shape[0]} taps)",
        lambda: kernels.bilateral(gauss_d, btaps, space_w, lut, radius),
        lambda: kernels.bilateral_ref(gauss_d, btaps, space_w, lut, radius),
        _bilateral_bound(gauss_d, btaps.shape[0]), plain_calls=2)
    _sub_record(records["bilateral"], "face_d5", rec)
    # the Gaussians: k 5 and 9 on each channel, k 21 on the skin masks, sigma 3 on L
    rgb_planes = gauss_d.movedim(-1, -3).reshape(-1, *FACE).contiguous()
    masks = face.get_refined_skin_mask(gauss_d)
    lum = color.rgb_to_lab(gauss_d)[..., 0].contiguous()
    torch.backends.cudnn.allow_tf32 = False
    for what, planes, k, sigma in (("k5_rgb", rgb_planes, 5, 0.0), ("k9_rgb", rgb_planes, 9, 0.0),
                                   ("k21_mask", masks, 21, 0.0), ("sigma3_l", lum, 19, 3.0)):
        n_p = planes.numel()
        padded = pad2d(planes.to(torch.float32), k // 2, k // 2, k // 2, k // 2)[:, None]
        taps = torch.from_numpy(gaussian_kernel_q8(k, sigma).astype(np.float32)).to(dev)
        rec = _compare(
            f"gaussian_blur_u8 face {what} k={k} ({planes.shape[0]} planes {FACE[1]}x{FACE[0]}; "
            "library: two cudnn conv2d 1-D passes + rounding)",
            lambda: kernels.gaussian_blur_u8(planes, k, sigma),
            lambda: kernels.gaussian_blur_u8_ref(planes, k, sigma),
            _bound(2 * n_p + 4 * k, 2 * 2 * k * n_p, peaks.INT8_TENSOR_OPS_PER_S),
            [lambda: _conv_blur_u8(padded, taps)])
        _sub_record(records["gaussian_blur_u8"], f"face_{what}", rec)
        del padded
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    del rgb_planes, masks, lum
    # one portrait through the path's full-size kernels, on the inputs the path gives
    # them: the glamour bilateral (radius 15) on the denoised portrait, rgb_to_lab and
    # the 8x8 CLAHE (clip 0.5) on the input of the tone stage
    pre = face.face_pre_eyes(gauss_d[0], "gaussian")
    combined = pre["denoised_combined"][None].contiguous()
    radius, btaps, space_w, lut = bilateral.tables_on(
        -1, face.BILATERAL_SIGMA_COLOR, face.BILATERAL_SIGMA_SPACE, 3, dev)
    rec = _compare(
        f"bilateral face glamour d=-1 30/10 (1 colour portrait {FACE[1]}x{FACE[0]}, "
        f"{btaps.shape[0]} taps)",
        lambda: kernels.bilateral(combined, btaps, space_w, lut, radius),
        lambda: kernels.bilateral_ref(combined, btaps, space_w, lut, radius),
        _bilateral_bound(combined, btaps.shape[0]), plain_calls=1)
    _sub_record(records["bilateral"], "face_portrait_r15", rec)
    popped = face.pixel_pop_eyes(pre["skin_enhanced"], shots["gaussian"][0][1])
    toned = face.apply_warmth(face.adjust_saturation(popped, face.COLOR_SATURATION),
                              15.0).contiguous()
    n_p = toned.numel() // 3
    rec = _compare(
        f"rgb_to_lab face portrait (1 portrait {FACE[1]}x{FACE[0]}, the tone stage's input)",
        lambda: kernels.rgb_to_lab(toned, tables),
        lambda: kernels.rgb_to_lab_ref(toned, tables),
        _bound(6 * n_p + 4 * tables.numel(), 47 * n_p))
    _sub_record(records["rgb_to_lab"], "face_portrait", rec)
    _face_clahe_kernels(f"face portrait (1 L plane {FACE[1]}x{FACE[0]}, 8x8 tiles, clip 0.5)",
                        [kernels.rgb_to_lab(toned, tables)[..., 0].contiguous()[None]],
                        0.5, 8, "face_portrait", records)
    del pre, combined, popped, toned
    # the eye pop's kernels on the eye regions enhance_face runs (both boxes of each
    # portrait, cut from the image the eye pop is handed) and on synth.EYE_EDGE_SHAPES
    # (odd widths, heights no multiple of 4) around them, 4x4 tiles
    skins = [face.face_pre_eyes(gauss_d[i], "gaussian")["skin_enhanced"] for i in range(N_FACE)]
    regions = [skins[i][y:y + h, x:x + w] for i in range(N_FACE)
               for (x, y, w, h) in shots["gaussian"][i][1]]
    for i, (h, w) in enumerate(synth.EYE_EDGE_SHAPES):
        ex, ey, ew, eh = shots["gaussian"][i % N_FACE][1][i % 2]
        y0, x0 = ey + eh // 2 - h // 2, ex + ew // 2 - w // 2
        regions.append(skins[i % N_FACE][y0:y0 + h, x0:x0 + w])
    shapes = sorted({tuple(r.shape[:2]) for r in regions})
    if shapes != sorted(synth.eye_region_shapes(*FACE)):
        raise AssertionError(f"eye regions {shapes}: not those of synth.eye_region_shapes")
    eye_rois = [median.median_blur(r, 3, channels_last=True).contiguous() for r in regions]
    n_eye = sum(r.numel() // 3 for r in eye_rois)
    rec = _compare(
        f"rgb_to_lab face eyes ({len(eye_rois)} eye regions {shapes}, one launch each)",
        lambda: tuple(kernels.rgb_to_lab(r, tables) for r in eye_rois),
        lambda: tuple(kernels.rgb_to_lab_ref(r, tables) for r in eye_rois),
        _bound(6 * n_eye + 4 * tables.numel() * len(eye_rois), 47 * n_eye))
    _sub_record(records["rgb_to_lab"], "face_eyes", rec)
    eye_l = [kernels.rgb_to_lab(r, tables)[..., 0].contiguous()[None] for r in eye_rois]
    _face_clahe_kernels(f"face eyes ({len(eye_rois)} eye regions, 4x4 tiles, clip 0.2)",
                        eye_l, 0.2, 4, "face_eyes", records)
    # the eye pop's Gaussians: k 31 on each region's ellipse, sigma 3 (k 19) on the L
    # of its CLAHE'd region (enhance_details)
    ellipses = [face.eye_ellipse(h, w, str(dev))[None] for h, w in shapes]
    details_l = []
    for r, lum_ in zip(eye_rois, eye_l):
        lab = color.rgb_to_lab(r)
        enh = color.lab_to_rgb_l(histogram.clahe(lum_[0], 0.2, 4, 4), lab[..., 1:])
        details_l.append(color.rgb_to_lab(enh)[..., 0].contiguous()[None])
    for what, planes, k, sigma in (("k31_eye_ellipses", ellipses, 31, 0.0),
                                   ("sigma3_eye_l", details_l, 19, 3.0)):
        n_p = sum(p_.numel() for p_ in planes)
        rec = _compare(
            f"gaussian_blur_u8 face {what} k={k} ({len(planes)} planes {shapes}, one launch "
            "each)",
            lambda: tuple(kernels.gaussian_blur_u8(p_, k, sigma) for p_ in planes),
            lambda: tuple(kernels.gaussian_blur_u8_ref(p_, k, sigma) for p_ in planes),
            _bound(2 * n_p + 4 * k * len(planes), 2 * 2 * k * n_p, peaks.INT8_TENSOR_OPS_PER_S))
        _sub_record(records["gaussian_blur_u8"], f"face_{what}", rec)
    del skins, regions, eye_rois, eye_l, ellipses, details_l

    # enhance_face, three (noise, variant) combinations, 4 portraits each, eyes from the synth
    needed = ("bilateral", "gaussian_blur_u8", "rgb_to_lab", "hist256", "clahe_apply")
    face_card = {}
    for noise, variant in FACE_COMBOS:
        name = f"enhance_face {noise} {variant}"
        arrays = [p[0] for p in shots[noise]]
        eyes = [p[1] for p in shots[noise]]
        on_card = [torch.from_numpy(a).to(dev) for a in arrays]

        def run(xs, variant=variant, eyes=eyes):
            return [face.enhance_face(x, eyes=e, variant=variant) for x, e in zip(xs, eyes)]

        run(arrays)                                            # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        outs = run(arrays)                                     # arrays: on the card by default
        torch.cuda.synchronize()
        for k_, v in _launched(name, kernels.launch_counts(), needed).items():
            launches[k_] += v
        for x, out in zip(arrays, outs):
            if out["noise_type"] != noise:
                raise AssertionError(f"{name}: classified {out['noise_type']}")
            for k_ in ("skin_mask", "skin_enhanced", "features_popped", "final"):
                v = out[k_]
                want = FACE if k_ == "skin_mask" else (*FACE, 3)
                if v.device.type != "cuda" or v.dtype != torch.uint8 or tuple(v.shape) != want:
                    raise AssertionError(f"{name} {k_}: {v.device} {v.dtype} {tuple(v.shape)}")
            if not bool((out["final"] != torch.from_numpy(x).to(dev)).any()):
                raise AssertionError(f"{name}: the portrait came back unchanged")
            skin = float((out["skin_mask"] > 128).float().mean())
            if not 0.1 < skin < 0.6:
                raise AssertionError(f"{name}: skin mask covers {skin:.3f} of the portrait")
        face_card[(noise, variant)] = [{k_: v.cpu() for k_, v in o.items()
                                        if isinstance(v, torch.Tensor)} for o in outs[:2]]
        del outs
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2 ** 20
        ms = _cuda_ms(lambda: run(on_card), reps=3, calls=1)
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        print(f"{name}: {ms / N_FACE:.3f} ms per portrait {FACE[1]}x{FACE[0]} = "
              f"{n_face / 1e3 / ms:.1f} MP/s ({N_FACE} portraits, noise classified, eyes given; "
              f"CUDA events, warm, median of 3 runs, input on the card); device memory: peak "
              f"{peak_mb - base_mb:.1f} MiB above the {base_mb:.1f} MiB held before the calls")
        _print_profile(name, ms, lambda: run(on_card))
        del on_card
    # the legacy NLM branch (any other noise_type), once on one portrait
    one, one_eyes = torch.from_numpy(shots["gaussian"][0][0]).to(dev), shots["gaussian"][0][1]
    ms = _cuda_ms(lambda: face.enhance_face(one, "legacy", one_eyes), reps=1, calls=1)
    print(f"enhance_face legacy (NLM h 10 and 30) on 1 portrait {FACE[1]}x{FACE[0]}: "
          f"{ms:.1f} ms (one warm call)")
    # the Haar eye detector on the host: what eyes=None adds to a call
    from tpuimage_torch.native import load_native
    if load_native() is None:
        raise AssertionError("the host library (contours.cpp, haar.cpp) did not build")
    grays = [rgb_to_gray(gauss_d[i]).cpu().numpy() for i in range(N_FACE)]
    t0 = time.perf_counter()
    found = haar.detect_multi_scale_batch(grays, "haarcascade_eye.xml", 1.1, 5, (30, 30),
                                          impl="native")
    host_ms = (time.perf_counter() - t0) * 1e3 / N_FACE
    if found != [haar.detect_eyes(g) for g in grays] or not all(found):
        raise AssertionError(f"detect_eyes: {found}")
    print(f"detect_eyes (native, on the host) on {N_FACE} portraits {FACE[1]}x{FACE[0]}: "
          f"{host_ms:.1f} ms per portrait; eyes found {[len(f) for f in found]} "
          f"(synth boxes {[p[1] for p in shots['gaussian']]}; found {found})")
    # card against host, two portraits of each combination
    for noise, variant in FACE_COMBOS:
        for i in range(2):
            img, eyes = shots[noise][i]
            host = face.enhance_face(img, eyes=eyes, variant=variant, device="cpu")
            for k_, c in face_card[(noise, variant)][i].items():
                diff = (c.to(torch.int32) - host[k_].to(torch.int32)).abs()
                n_diff = int((diff > 0).sum())
                max_levels, max_share = NIGHT_RGB_TOL
                if int(diff.max()) > max_levels or n_diff >= max_share * diff.numel():
                    raise AssertionError(f"enhance_face {noise} {variant} {k_}: {n_diff} of "
                                         f"{diff.numel()} values differ, by up to "
                                         f"{int(diff.max())}")
                print(f"card vs host, enhance_face {noise} {variant} {k_} (portrait {i}): "
                      f"{n_diff} of {diff.numel()} values differ, max |diff| {int(diff.max())}")
    del gauss_d, one, face_card

    # --- 12. classify and route -------------------------------------------------
    print(f"[phase 12 at {time.perf_counter() - t_start:.1f} s]")
    from tpuimage_torch.classify import clip, heuristic, router
    from tpuimage_torch.classify.tokenizer import SimpleTokenizer
    mix = synth.scene_mix(0)
    mix_imgs = [img for _, img in mix]
    wide = [img for img in mix_imgs if img.shape[0] < img.shape[1]]       # night, landscape
    tall = [img for img in mix_imgs if img.shape[0] > img.shape[1]]       # faces, documents
    # the three kernels of the cue program on its stacks, at the cue budget: the
    # mix's two shape groups, and two tall, narrow photos (the 128 * h term)
    for what, imgs in (("wide", wide), ("tall", tall),
                       ("narrow", [synth.document_photo(1250 + i, *NARROW) for i in range(2)])):
        stack = torch.from_numpy(np.stack(imgs)).to(dev)
        gray = rgb_to_gray(stack)
        b, h, w = gray.shape
        budget = heuristic.cue_budget(h, w)
        if (what == "narrow") != (budget == 128 * h):
            raise AssertionError(f"cue budget {budget} at {w}x{h}")
        rows = gray.reshape(b, h * w)
        offset_rows = (rows.to(torch.int64) + 256 * torch.arange(b, device=dev)[:, None]
                       ).reshape(-1)
        rec = _compare(
            f"hist256 classify {what} ({b} gray images {w}x{h}: the cue's Otsu)",
            lambda: kernels.hist256_batch(rows), lambda: kernels.hist256_batch_ref(rows),
            _hist256_bound(rows),
            [lambda: torch.bincount(offset_rows, minlength=b * 256).view(b, 256)])
        _sub_record(records["hist256"], f"classify_{what}", rec)
        cue_edges = edges.canny(gray, 50, 150)
        rank, mask, kk = _rank_planes(cue_edges, budget)
        rec = _compare(
            f"rank_extract classify {what} ({b} edge maps {w}x{h}, kk {kk}, budget {budget}, "
            f"{int(mask.sum())} edges)",
            lambda: kernels.rank_extract(rank, mask, kk),
            lambda: kernels.rank_extract_ref(rank, mask, kk), _rank_bound(mask, kk),
            [lambda: _rank_extract_nonzero(mask, kk)], plain_calls=5)
        _sub_record(records["rank_extract"], f"classify_{what}", rec)
        numrho = (h + w) * 2 + 1
        xs, ys, counts, _ = hough.compact_edges(cue_edges, budget)
        args = (xs, ys, counts, cos_t, sin_t, numrho, (numrho - 1) // 2)
        edges_n, n_t = int(counts.sum()), cos_t.shape[0]
        rec = _compare(
            f"hough_votes classify {what} ({b} edge maps {w}x{h}, {int(counts.max())} edges "
            "max)", lambda: kernels.hough_votes(*args), lambda: kernels.hough_votes_ref(*args),
            _bound(8 * edges_n + 4 * b + 8 * n_t + 4 * b * numrho * n_t, 4 * edges_n * n_t),
            [lambda: _hough_bincount(*args)], plain_calls=5)
        _sub_record(records["hough_votes"], f"classify_{what}", rec)
        for c, hh in zip(heuristic.device_cues(stack), heuristic.device_cues(stack.cpu())):
            if not torch.equal(c.cpu(), hh):
                raise AssertionError(f"the cue program {what}: card and host differ")
        ms = _cuda_ms(lambda: heuristic.device_cues(stack), reps=3, calls=1)
        print(f"cue program {what}: {ms:.3f} ms for {b} images {w}x{h} (CUDA events, warm, "
              "median of 3, input on the card); card = host")
        del stack, gray, rows, offset_rows, cue_edges, rank, mask, xs, ys, counts, args

    # the heuristic classifiers on the mix (arrays from the host, as a user calls them)
    heuristic.classify_weighted_batch(mix_imgs)                    # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    weighted = heuristic.classify_weighted_batch(mix_imgs)
    priority = heuristic.classify_priority_batch(mix_imgs)
    torch.cuda.synchronize()
    for k_, v in _launched("classify_weighted_batch + classify_priority_batch",
                           kernels.launch_counts(), CLASSIFY_KERNELS).items():
        launches[k_] += v
    for (kind, _), (label, probs), plabel in zip(mix, weighted, priority):
        if not np.isclose(sum(probs.values()), 1.0) or label not in heuristic.LABELS:
            raise AssertionError(f"classify {kind}: {label} {probs}")
        print(f"classify {kind}: weighted {label} "
              f"{ {k_: round(p, 4) for k_, p in probs.items()} }, priority {plabel}")
    batch_ms = _wall_ms(lambda: heuristic.classify_weighted_batch(mix_imgs))
    grays = [rgb_to_gray(torch.from_numpy(img)).numpy() for img in mix_imgs]
    haar_ms = _wall_ms(lambda: haar.detect_faces_batch(grays))
    # the batch again with the Haar pass's boxes handed in: the cue programs,
    # the fetches and the rectangle cue alone
    faces = haar.detect_faces_batch(grays)
    heuristic.detect_faces_batch = lambda _grays: faces
    try:
        rest_ms = _wall_ms(lambda: heuristic.classify_weighted_batch(mix_imgs))
        if heuristic.classify_weighted_batch(mix_imgs) != weighted:
            raise AssertionError("classify with the Haar boxes handed in differs")
    finally:
        heuristic.detect_faces_batch = haar.detect_faces_batch
    print(f"classify_weighted_batch: {batch_ms:.1f} ms a batch of {len(mix)} (host clock, warm, "
          f"median of 3, arrays from the host); the host's Haar face pass alone {haar_ms:.1f} "
          f"ms; the batch with its boxes handed in (the cue programs, the fetches and the "
          f"rectangle cue) {rest_ms:.1f} ms")
    _print_profile("classify_weighted_batch", batch_ms,
                   lambda: heuristic.classify_weighted_batch(mix_imgs))

    # CLIP ViT-B/32 at its full shapes on seeded weights
    t0 = time.perf_counter()
    clip_sd = synth.clip_state_dict(7)
    tokens = SimpleTokenizer(merges=synth.prompt_merges()).tokenize(
        [clip.PROMPTS[label] for label in clip.LABELS])
    text_card = clip.compute_text_features(clip_sd, tokens)
    model = clip.ClipZeroShot(clip_sd, text_card.cpu().numpy())
    n_params = sum(v.size for v in clip_sd.values())
    print(f"CLIP ViT-B/32: {n_params / 1e6:.1f}M parameters (seeded), text features "
          f"{tuple(text_card.shape)} and the model on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    clip_card = {}
    for what, batch in ((f"32 images {NIGHT[1]}x{NIGHT[0]}", np.stack(wide * 8)),
                        (f"32 images {NIGHT[0]}x{NIGHT[1]}", np.stack(tall * 8)),
                        (f"1 image {NIGHT[1]}x{NIGHT[0]}", np.stack(wide[:1]))):
        batch_d = torch.from_numpy(batch).to(dev)
        probs = model.predict_batch(batch_d)
        if probs.shape != (len(batch), 4) or not bool(torch.isfinite(probs).all()) or \
                not torch.allclose(probs.sum(-1), torch.ones(len(batch), device=dev)):
            raise AssertionError(f"CLIP {what}: probabilities {probs}")
        clip_card[what] = probs[:4].cpu()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2 ** 20
        ms = _cuda_ms(lambda: model.predict_batch(batch_d), reps=3, calls=1)
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        print(f"CLIP predict_batch, {what}: {ms:.3f} ms a call = {len(batch) * 1e3 / ms:.1f} "
              f"images/s (CUDA events, warm, median of 3, input on the card); device memory: "
              f"peak {peak_mb - base_mb:.1f} MiB above the {base_mb:.1f} MiB held")
        if len(batch) == 32 and what.endswith(f"{NIGHT[1]}x{NIGHT[0]}"):
            _print_profile(f"CLIP predict_batch {what}", ms, lambda: model.predict_batch(batch_d))
        del batch_d

    # the router: every route on the card, two images of each kind, then the
    # whole flow (classify, then route) on each image of the mix
    router.classify_and_enhance(mix_imgs[0])                       # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    routed = [router.enhance_for_label(kind, img) for kind, img in mix]
    torch.cuda.synchronize()
    for k_, v in _launched("enhance_for_label (the four routes, 2 images each)",
                           kernels.launch_counts(), ROUTE_KERNELS).items():
        launches[k_] += v
    for (kind, img), out in zip(mix, routed):
        if out.device.type != dev.type or out.dtype != torch.uint8 or out.dim() != 3 or \
                out.shape[-1] != 3 or (kind != "document" and out.shape != img.shape):
            raise AssertionError(f"route {kind}: {out.device} {out.dtype} {tuple(out.shape)}")
    routed = [r.cpu() for r in routed]
    flow_s = []
    for turn in range(2):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        flow = [router.classify_and_enhance(img) for img in mix_imgs]
        torch.cuda.synchronize()
        flow_s.append(time.perf_counter() - t0)
        if turn == 0:
            for k_, v in _launched("classify_and_enhance (8 images)", kernels.launch_counts(),
                                   CLASSIFY_KERNELS).items():
                launches[k_] += v
    taken = {label: sum(1 for f in flow if f[0] == label) for label in heuristic.LABELS}
    if [f[0] for f in flow] != [label for label, _ in weighted]:
        raise AssertionError("classify_and_enhance routed other labels than the classifier gave")
    print(f"classify_and_enhance: {len(mix) / statistics.median(flow_s):.2f} images/s "
          f"({', '.join(f'{t:.2f}' for t in flow_s)} s for the {len(mix)} images of the mix, one "
          f"call each, arrays from the host, host clock); routes taken: {taken}")

    # card against host: the 8 images of the mix (2 of each kind) on the CPU
    if heuristic.classify_weighted_batch(mix_imgs, device="cpu") != weighted or \
            heuristic.classify_priority_batch(mix_imgs, device="cpu") != priority:
        raise AssertionError("classify: card and host labels or probabilities differ")
    print("card vs host, classify_weighted_batch / classify_priority_batch: labels and "
          "probabilities equal")
    text_host = clip.compute_text_features(clip_sd, tokens, device="cpu")
    model_host = clip.ClipZeroShot(clip_sd, text_card.cpu().numpy(), device="cpu")
    for what, imgs in ((f"32 images {NIGHT[1]}x{NIGHT[0]}", wide),
                       (f"32 images {NIGHT[0]}x{NIGHT[1]}", tall)):
        host = model_host.predict_batch(np.stack(imgs))
        err = float((clip_card[what] - host).abs().max())
        if err > CLIP_TOL or not torch.equal(clip_card[what].argmax(-1), host.argmax(-1)):
            raise AssertionError(f"CLIP card vs host {what}: max |diff| {err}")
        print(f"card vs host, CLIP probabilities ({len(imgs)} images of {what[10:]}): max |diff| "
              f"{err:.2e} (limit {CLIP_TOL}), argmax equal; text features max |diff| "
              f"{float((text_card.cpu() - text_host).abs().max()):.2e}")
    for (kind, img), card_out in zip(mix, routed):
        host = router.enhance_for_label(kind, img, device="cpu")
        if card_out.shape != host.shape:
            raise AssertionError(f"route {kind}: {tuple(card_out.shape)} vs {tuple(host.shape)}")
        diff = (card_out.to(torch.int32) - host.to(torch.int32)).abs()
        n_diff = int((diff > 0).sum())
        max_levels, max_share = (0, BINARY_TOL) if kind == "document" else NIGHT_RGB_TOL
        if (kind != "document" and int(diff.max()) > max_levels) or \
                n_diff >= max_share * diff.numel():
            raise AssertionError(f"route {kind}: {n_diff} of {diff.numel()} values differ, by "
                                 f"up to {int(diff.max())}")
        print(f"card vs host, route {kind}: {n_diff} of {diff.numel()} values differ, max "
              f"|diff| {int(diff.max())}")
    del clip_sd, model, model_host, routed, flow

    # --- 13. the notebook pipelines and presets ---------------------------------
    print(f"[phase 13 at {time.perf_counter() - t_start:.1f} s]")
    _notebook_phase(dev, tables, records, launches, cudnn_tf32)

    # --- 14. the CLIs on PNG files ----------------------------------------------
    print(f"[phase 14 at {time.perf_counter() - t_start:.1f} s]")
    _cli_phase(dev, launches)

    # --- 15. the sharded runtime: mesh, spatial, and the entry points on them --
    print(f"[phase 15 at {time.perf_counter() - t_start:.1f} s]")
    _mesh_phase(dev, launches)

    # --- 16. the repaired forms and the last public names, card = host -------
    print(f"[phase 16 at {time.perf_counter() - t_start:.1f} s]")
    _closure_phase(dev, launches)

    # --- 17. the CLAHE apply in cv2's order, the batch warp's jitted form -----
    print(f"[phase 17 at {time.perf_counter() - t_start:.1f} s]")
    _exact_forms_phase(dev, launches)
    print(f"[phases done at {time.perf_counter() - t_start:.1f} s]")

    torch.cuda.synchronize()
    jax_side = [m for m in sys.modules if m.split(".")[0] in ("jax", "tpuimage")]
    if jax_side:
        raise AssertionError(f"the port imported the JAX side: {jax_side[:5]}")

    sources = {"hist256": ("tpuimage_torch/csrc/hist256.cu",
                           "tpuimage/ops/pallas_kernels.py:1660"),
               "hough_votes": ("tpuimage_torch/csrc/hough_votes.cu",
                               "tpuimage/ops/pallas_kernels.py:598"),
               "rgb_to_lab": ("tpuimage_torch/csrc/lab.cu",
                              "tpuimage/ops/pallas_kernels.py:1007"),
               "clahe_apply": ("tpuimage_torch/csrc/clahe_apply.cu",
                               "tpuimage/ops/pallas_kernels.py:1132"),
               "gray_erode3": ("tpuimage_torch/csrc/morph3.cu",
                               "tpuimage/ops/pallas_kernels.py:1781"),
               "binary_close3": ("tpuimage_torch/csrc/morph3.cu",
                                 "tpuimage/ops/pallas_kernels.py:1809"),
               "gaussian_blur_u8": ("tpuimage_torch/csrc/gauss_sep.cu",
                                    "tpuimage/ops/pallas_kernels.py:187"),
               "gauss_chain": ("tpuimage_torch/csrc/gauss_sep.cu",
                               "tpuimage/ops/pallas_kernels.py:1330"),
               "blackhat_rect": ("tpuimage_torch/csrc/blackhat_rect.cu",
                                 "tpuimage/ops/pallas_kernels.py:1465"),
               "inkmask_weighted": ("tpuimage_torch/csrc/inkmask.cu",
                                    "tpuimage/ops/pallas_kernels.py:1560"),
               "bilateral": ("tpuimage_torch/csrc/bilateral.cu",
                             "tpuimage/ops/pallas_kernels.py:89"),
               "rank_extract": ("tpuimage_torch/csrc/rank_extract.cu",
                                "tpuimage/ops/pallas_kernels.py:825"),
               "canny_pre": ("tpuimage_torch/csrc/canny.cu", None),
               "canny_hysteresis": ("tpuimage_torch/csrc/canny.cu", None)}
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
