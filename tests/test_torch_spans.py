"""tpuimage_torch's spans and counters (``runtime.profiling``) on the CPU:
nothing recorded and no ``record_function`` entered while no profiler
runs; under a CPU profiler the spans of ``scan_batch``, the post-warp
called alone, ``landscape_gui``, the night route and ``scan_stream``
with their parents and call ids; span times mapped onto the profiler's
clock within 0.1 ms; the quad fit's and the median's counters; the launch counts as a view of the counters;
the bounded buffer; the Chrome trace of ``stop_trace`` carrying the
spans."""
import dataclasses
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tpuimage_torch import synth
from tpuimage_torch.ops import kernels
from tpuimage_torch.pipelines import docscan as tdoc
from tpuimage_torch.pipelines import landscape, night
from tpuimage_torch.runtime import profiling

CFG = dataclasses.replace(tdoc.GUI_DOCUMENT_CONFIG, scale_long=256)
POST_WARP = {"docscan.pre_deskew", "docscan.deskew_angle", "docscan.rotate",
             "docscan.morph_cleanup"}
FIT_QUAD = {"docscan.draw_segments", "docscan.find_contours", "docscan.approx_quads"}
NIGHT = ["night.clahe", "night.lab", "night.lab_to_rgb", "night.median", "night.upload"]


@pytest.fixture(autouse=True)
def fresh_record():
    """One intra-op thread and an empty record for each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset_counts()
    yield
    profiling.reset_counts()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def photos():
    """Two document photos and one with no page, 320x240 (height x width)."""
    return [synth.document_photo(61, 320, 240),
            synth.document_photo(62, 320, 240, tilt_deg=4.0, rules=3),
            synth.document_photo(63, 320, 240, with_page=False)]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _children(spans, parent):
    return sorted(s.name for s in spans if s.parent == parent.id)


def _anchor_calls(prof):
    prefix = profiling.CLOCK_ANCHOR + "."
    return sorted(int(e.name[len(prefix):]) for e in prof.events()
                  if e.name.startswith(prefix))


def test_no_profiler_no_record_and_no_record_function(monkeypatch, photos):
    entered = []

    class Counting:
        def __init__(self, name, *a, **k):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("a") is profiling.span("b", call=3)
    assert profiling.trace_annotation("c") is profiling.span("a")
    assert profiling.new_call() is None
    with profiling.span("top"):
        with profiling.span("inner"):
            pass
    tp = profiling.Throughput()
    with tp.stage("stage"):
        pass
    tdoc.scan_batch(photos[:1], CFG, device="cpu")
    landscape.landscape_gui(synth.landscape_scene(1, 40, 60), device="cpu")
    assert profiling.spans() == [] and profiling.dropped() == 0
    assert entered == []
    # the counters are always on: one quad, and Canny's hysteresis checks on
    # localize's and the deskew's edge maps
    assert profiling.counts() == {"docscan.quads": 1, "canny.hysteresis_checks": 3}


def test_scan_batch_and_landscape_spans_under_a_cpu_profiler(photos):
    page = synth.landscape_scene(2, 40, 60)
    with _cpu_profile() as prof:
        first = tdoc.scan_batch(photos, CFG, device="cpu")
        tdoc.scan_batch(photos[:1], CFG, device="cpu")
        landscape.landscape_gui(page, device="cpu")
    spans = profiling.spans()
    tops = [s for s in spans if s.parent is None]
    assert [s.name for s in sorted(tops, key=lambda s: s.start_ns)] == [
        "docscan.scan_batch", "docscan.scan_batch", "landscape.gui"]
    assert all(s.call == s.id for s in tops)
    # one clock anchor per top-level call, named by its id
    assert _anchor_calls(prof) == sorted(s.id for s in tops)
    byid = {s.id: s for s in spans}
    for top in tops:
        mine = [s for s in spans if s.call == top.id]
        for s in mine:
            if s is not top:
                assert byid[s.parent].call == top.id
                assert byid[s.parent].start_ns <= s.start_ns <= s.end_ns <= byid[s.parent].end_ns
    big = tops[0] if tops[0].start_ns < tops[1].start_ns else tops[1]
    n_pages = len({tuple(r["binary"].shape) for r in first})
    assert _children(spans, big) == sorted(["docscan.load_localize", "docscan.quad_fit",
                                            "docscan.fetch"]
                                           + ["docscan.post_warp"] * n_pages)
    (fit,) = [s for s in spans if s.parent == big.id and s.name == "docscan.quad_fit"]
    assert _children(spans, fit) == sorted(["docscan.localize_read", "docscan.warp"]
                                           + ["docscan.fit_quad"] * 3)
    for q in (s for s in spans if s.parent == fit.id and s.name == "docscan.fit_quad"):
        assert set(_children(spans, q)) <= FIT_QUAD | {"docscan.min_area_rect"}
        assert FIT_QUAD <= set(_children(spans, q))
    for pw in (s for s in spans if s.parent == big.id and s.name == "docscan.post_warp"):
        assert _children(spans, pw) == sorted(POST_WARP)
    gui = tops[2]
    assert _children(spans, gui) == sorted(["landscape.upload", "landscape.bilateral",
                                            "landscape.clahe", "landscape.sharpen"])
    assert {s.thread for s in spans} == {threading.get_native_id()}


def test_post_warp_called_alone_is_a_top_level_call():
    pages = torch.from_numpy(np.stack([synth.page(5, 120, 85, tilt_deg=2.0),
                                       synth.page(6, 120, 85)]))
    with _cpu_profile() as prof:
        tdoc.docscan_post_warp_batch(pages, CFG)
    spans = profiling.spans()
    (top,) = [s for s in spans if s.parent is None]
    assert top.name == "docscan.post_warp" and top.call == top.id
    assert _children(spans, top) == sorted(POST_WARP)
    assert all(s.call == top.id for s in spans)
    assert _anchor_calls(prof) == [top.id]


def test_night_route_spans_under_a_cpu_profiler_and_none_without():
    one, batch = synth.night_scene(3, 40, 64), np.stack([synth.night_scene(s, 45, 61)
                                                        for s in (4, 5)])
    night.night_gui(one, device="cpu")
    assert profiling.spans() == [] and profiling.dropped() == 0
    with _cpu_profile() as prof:
        night.night_gui(one, device="cpu")
        night.night_rgb(batch, device="cpu")
    spans = profiling.spans()
    tops = sorted((s for s in spans if s.parent is None), key=lambda s: s.start_ns)
    assert [s.name for s in tops] == ["night.gui", "night.gui"]
    assert all(s.call == s.id for s in tops)
    assert _anchor_calls(prof) == sorted(s.id for s in tops)
    byid = {s.id: s for s in spans}
    for top in tops:
        assert _children(spans, top) == NIGHT
    for s in spans:
        if s.parent is not None:
            parent = byid[s.parent]
            assert parent.name == "night.gui" and s.call == parent.call
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert len(spans) == 2 * (1 + len(NIGHT))


def test_median_exchanges_counted_per_call():
    """The transposition network over k*k views: k*k rounds of (k*k - 1) / 2
    compare-exchanges each, counted with or without a profiler."""
    from tpuimage_torch.ops.median import median_blur

    night.night_gui(synth.night_scene(6, 24, 32), device="cpu")
    assert profiling.counts() == {"median.exchanges": 36}
    night.night_gray(synth.night_scene(7, 24, 32)[..., 0], device="cpu")
    assert profiling.counts() == {"median.exchanges": 72}
    gray = torch.from_numpy(synth.night_scene(8, 20, 30)[..., 1])
    with _cpu_profile():
        median_blur(gray, 5)
    assert profiling.counts() == {"median.exchanges": 72 + 25 * 12}
    median_blur(gray, 1)
    assert profiling.counts() == {"median.exchanges": 372}


def test_scan_stream_tags_worker_phases_with_their_batch(photos):
    batches = [photos[:2], photos[2:], photos[1:2]]
    with _cpu_profile():
        out = list(tdoc.scan_stream(batches, CFG, device="cpu", prefetch=True))
    assert [len(r) for r in out] == [2, 1, 1]
    main = threading.get_native_id()
    spans = profiling.spans()
    phases = [s for s in spans if s.name in ("docscan.load_localize", "docscan.quad_fit",
                                             "docscan.fetch")]
    calls = {}
    for s in phases:
        assert s.parent is None and s.call != s.id
        calls.setdefault(s.call, []).append(s)
    assert len(calls) == len(batches)
    for mine in calls.values():
        names = {s.name: s for s in mine}
        assert sorted(names) == ["docscan.fetch", "docscan.load_localize", "docscan.quad_fit"]
        assert len(mine) == 3
        assert names["docscan.load_localize"].thread != main
        assert names["docscan.fetch"].thread != main
        assert names["docscan.quad_fit"].thread == main
        assert (names["docscan.load_localize"].end_ns <= names["docscan.quad_fit"].start_ns
                and names["docscan.quad_fit"].end_ns <= names["docscan.fetch"].start_ns)
    # each batch's quad fits are children of its quad_fit phase
    byid = {s.id: s for s in spans}
    for s in spans:
        if s.name == "docscan.fit_quad":
            assert byid[s.parent].name == "docscan.quad_fit"
            assert s.call == byid[s.parent].call in calls


def test_span_times_map_onto_the_profilers_clock():
    """A probe's two stamps fall between the mapped readings around them,
    within 0.1 ms (entering a range can take longer than that here)."""
    with _cpu_profile() as prof:
        with profiling.span("outer"):
            time.sleep(0.05)
            with profiling.span("probe_span"):
                with record_function("probe"):
                    inside = time.perf_counter_ns()
                    time.sleep(0.002)
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    to_us = profiling.clock_map(events, 1e3)
    assert to_us is not None
    (probe,) = [e for e in events if e[0] == "probe"]
    (mine,) = [s for s in profiling.spans() if s.name == "probe_span"]
    assert to_us(mine.start_ns) - 100.0 <= probe[1] <= to_us(inside) + 100.0
    assert to_us(inside) - 100.0 <= probe[2] <= to_us(mine.end_ns) + 100.0
    # a trace without this recorder's anchors maps nothing
    assert profiling.clock_map([("tpuimage.clock.999999", 0.0, 1.0), ("x", 0, 1)], 1e3) is None


def _edges(draw):
    e = np.zeros((120, 160), np.uint8)
    draw(e)
    return e


def test_quad_counters_count_a_clean_quad_and_a_fallback():
    rect = _edges(lambda e: (e.__setitem__((slice(20, 100), [30, 130]), 255),
                             e.__setitem__(([20, 99], slice(30, 131)), 255)))
    v, u = np.mgrid[0:120, 0:160]
    ring = ((u - 80) ** 2 + (v - 60) ** 2)
    disc = _edges(lambda e: e.__setitem__((ring >= 40 ** 2) & (ring < 42 ** 2), 255))
    segs, ok = np.zeros((128, 4), np.float32), np.zeros(128, bool)
    quad = tdoc._quad_from_localize(rect, segs, ok, rect.shape, CFG)
    np.testing.assert_allclose(quad, [[30, 20], [130, 20], [130, 99], [30, 99]], atol=0.5)
    assert profiling.counts() == {"docscan.quads": 1}
    quad = tdoc._quad_from_localize(disc, segs, ok, disc.shape, CFG)
    assert quad.shape == (4, 2)
    # each fallback's hull is the native one, counted beside it
    assert profiling.counts() == {"docscan.quads": 2, "docscan.quad_fallbacks": 1,
                                  "contours.hull_native": 1}
    assert tdoc._quad_from_localize(np.zeros_like(rect), segs, ok, rect.shape, CFG) is None
    assert profiling.counts() == {"docscan.quads": 3, "docscan.quad_fallbacks": 1,
                                  "contours.hull_native": 1}
    with _cpu_profile():
        tdoc._localize_parse(torch.from_numpy(np.stack([rect, disc])),
                             torch.from_numpy(np.stack([segs, segs])),
                             torch.from_numpy(np.stack([ok, ok])), CFG)
    assert profiling.counts() == {"docscan.quads": 5, "docscan.quad_fallbacks": 2,
                                  "contours.hull_native": 2}
    names = [s.name for s in profiling.spans()]
    assert names.count("docscan.fit_quad") == 2 and names.count("docscan.min_area_rect") == 1


def test_launch_counts_are_a_view_of_the_counters_and_reset_clears_spans():
    want = dict.fromkeys(["hist256", "hough_votes", "rgb_to_lab", "clahe_apply",
                          "gray_erode3", "binary_close3", "gaussian_blur_u8", "gauss_chain",
                          "blackhat_rect", "inkmask_weighted", "bilateral", "rank_extract",
                          "canny_pre", "canny_hysteresis"], 0)
    assert kernels.launch_counts() == want
    kernels._count("hist256")
    kernels._count("hist256")
    kernels._count("bilateral")
    profiling.count("docscan.quads", 4)
    assert kernels.launch_counts() == {**want, "hist256": 2, "bilateral": 1}
    assert profiling.counts() == {"kernel.hist256": 2, "kernel.bilateral": 1,
                                  "docscan.quads": 4}
    with _cpu_profile():
        with profiling.span("x"):
            pass
    assert [s.name for s in profiling.spans()] == ["x"]
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == want
    assert profiling.counts() == {} and profiling.spans() == []


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAPACITY", 3)
    with _cpu_profile():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["s0", "s1", "s2"]
    assert profiling.dropped() == 2
    profiling.reset_counts()
    assert profiling.dropped() == 0


def test_concurrent_spans_and_counts_lose_nothing():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(200):
                with profiling.span("w"):
                    profiling.count("n")
        with _cpu_profile():
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = profiling.spans()
    assert profiling.counts() == {"n": 1600} and len(spans) == 1600
    assert len({s.id for s in spans}) == 1600 and all(s.call == s.id for s in spans)


def test_stop_trace_writes_the_spans_on_the_profilers_clock(tmp_path):
    profiling.start_trace(str(tmp_path))
    try:
        with profiling.span("tpuimage_stage"):
            time.sleep(0.01)
            with profiling.span("inner_stage"), record_function("probe"):
                torch.ones(64, 64).sum()
    finally:
        path = profiling.stop_trace()
    events = json.loads(Path(path).read_text())["traceEvents"]
    mine = {e["name"]: e for e in events if e.get("cat") == "tpuimage.span"}
    assert set(mine) == {"tpuimage_stage", "inner_stage"}
    assert mine["inner_stage"]["args"]["parent"] == mine["tpuimage_stage"]["args"]["id"]
    (probe,) = [e for e in events if e.get("name") == "probe" and e.get("ph") == "X"]
    inner = mine["inner_stage"]
    assert inner["ts"] - 100.0 <= probe["ts"]
    assert probe["ts"] + probe["dur"] <= inner["ts"] + inner["dur"] + 100.0
    assert mine["tpuimage_stage"]["tid"] == probe["tid"]
