"""Tracing and throughput counters (counterpart of
``tpuimage.runtime.profiling``).

``span`` records a named range of the program's host time, with its
parent span and the top-level call it belongs to, while a
``torch.profiler`` runs in the process (the benchmark's traced window, a
profiler of the card alone, ``start_trace``); with none running it costs
one check.
``count`` keeps named counters, always on (``ops.kernels``' launch
counts are ``kernel.<name>`` among them). ``reset_counts`` clears the
counters and the span buffer, so one reset starts a fresh record.
``Throughput`` keeps per-stage wall-clock, megapixel and image counts
and logs them on the ``tpuimage`` logger, as tpuimage's does; ``sync``
ends the device work a timed stage launched (PyTorch returns before the
card finishes); ``start_trace`` / ``stop_trace`` record one
``torch.profiler`` trace of the host and the card and write it, the
spans included, as a Chrome trace.

A span is never a ``record_function`` range: one with CUDA work inside
would become a row on the card in the profiler's trace. The recorder's
clock (``time.perf_counter_ns``) is tied to the profiler's by one
anchor per top-level call, a ``record_function`` named
``tpuimage.clock.<call id>`` around the reading of the recorder's clock
and nothing else; ``clock_map`` takes a trace's anchors and maps span
times onto its clock.
"""
from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch

log = logging.getLogger("tpuimage")


def _first_tensor(tree) -> Optional[torch.Tensor]:
    """The first tensor leaf of nested dicts, lists and tuples, dict keys
    in sorted order as ``jax.tree_util.tree_leaves`` takes them."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        for item in tree:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


def sync(tree) -> None:
    """Wait for the device work behind the first tensor leaf of ``tree``:
    ``torch.cuda.synchronize`` on its card; nothing for a CPU tensor, whose
    ops have finished when they return."""
    leaf = _first_tensor(tree)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


# spans the buffer keeps between resets; later ones are dropped and counted
SPAN_CAPACITY = 1 << 18
CLOCK_ANCHOR = "tpuimage.clock"


class Span(NamedTuple):
    name: str
    start_ns: int              # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: Optional[int]      # the enclosing span on the thread
    call: int                  # the top-level call: its span's id, or new_call()'s
    thread: int                # threading.get_native_id()


# the record, shared by every thread of the process: spans, the clock
# anchors (call id -> the recorder's ns before, inside and after the
# anchor's range), spans dropped, counters; under _lock
_lock = threading.Lock()
_spans: List[tuple] = []       # Span's fields; made Spans when read
_anchors: Dict[int, Tuple[int, int, int]] = {}
_dropped = 0
_counts: Dict[str, int] = {}
_ids = itertools.count(1)
_NULL = contextlib.nullcontext()


def _profiling() -> bool:
    """Whether a ``torch.profiler`` runs in the process: torch's flag, set
    for the whole of each profile's run (``torch.autograd._profiler_enabled()``
    answers for the calling thread alone, and scan_stream's phases run on
    worker threads)."""
    return torch.autograd.profiler._is_profiler_enabled


class _Thread(threading.local):
    """Each thread's open spans and native id."""

    def __init__(self):
        self.stack: list = []
        self.tid = threading.get_native_id()


_local = _Thread()


def _anchor(call: int) -> None:
    t0 = time.perf_counter_ns()
    with torch.profiler.record_function(f"{CLOCK_ANCHOR}.{call}"):
        t1 = time.perf_counter_ns()
    t2 = time.perf_counter_ns()
    with _lock:
        if len(_anchors) < SPAN_CAPACITY:
            _anchors[call] = (t0, t1, t2)


class _Span:
    __slots__ = ("name", "call", "id", "parent", "start")

    def __init__(self, name: str, call: Optional[int]):
        self.name, self.call = name, call

    def __enter__(self):
        stack = _local.stack
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent = None
            if self.call is None:
                self.call = self.id
                _anchor(self.id)
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        end = time.perf_counter_ns()
        _local.stack.pop()
        rec = (self.name, self.start, end, self.id, self.parent, self.call, _local.tid)
        with _lock:
            if len(_spans) < SPAN_CAPACITY:
                _spans.append(rec)
            else:
                _dropped += 1
        return False


def span(name: str, call: Optional[int] = None):
    """A named range of host time, recorded while a ``torch.profiler``
    runs and a shared null context otherwise. Its parent is the span open
    on the thread; a span with none starts a top-level call (with its
    clock anchor), unless ``call`` names one that :func:`new_call` began:
    a phase of that call on another thread."""
    if not _profiling():
        return _NULL
    return _Span(name, call)


# tpuimage's name for the same primitive
trace_annotation = span


def new_call() -> Optional[int]:
    """The id (and clock anchor) of a call whose spans open on several
    threads, for ``span(..., call=)``; None while no profiler runs."""
    if not _profiling():
        return None
    call = next(_ids)
    _anchor(call)
    return call


def spans() -> List[Span]:
    """The spans recorded since the last reset, in the order they ended."""
    with _lock:
        recs = list(_spans)
    return [Span._make(r) for r in recs]


def dropped() -> int:
    """Spans dropped since the last reset, the buffer being full."""
    return _dropped


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def reset_counts() -> None:
    """Clear every counter, the span buffer and the clock anchors."""
    global _dropped
    with _lock:
        _counts.clear()
        _spans.clear()
        _anchors.clear()
        _dropped = 0


def clock_map(events: Iterable[Tuple[str, float, float]],
              ns_per_unit: float) -> Optional[Callable[[int], float]]:
    """A function taking a recorder time (ns) onto a profiler trace's
    clock, from the trace's events of the clock anchors: ``events`` are
    (name, start, end) in the trace's unit, of which ``ns_per_unit``
    nanoseconds make one. A time goes through the latest anchor before it
    (the first, for times before every anchor). The anchor's start stamp
    falls between the readings before and inside its range, its end stamp
    between those inside and after it; the offset is the middle of what
    both allow (a first range under a new profiler can take a millisecond
    after its start stamp). None where the trace holds no anchor the
    recorder kept."""
    with _lock:
        anchors = dict(_anchors)
    prefix = CLOCK_ANCHOR + "."
    pairs = []
    for n, s, e in events:
        call = n[len(prefix):]
        if n.startswith(prefix) and call.isdigit() and int(call) in anchors:
            t0, t1, t2 = anchors[int(call)]
            s, e = s * ns_per_unit, e * ns_per_unit
            pairs.append((t1, (max(s - t1, e - t2) + min(s - t0, e - t1)) / 2))
    if not pairs:
        return None
    pairs.sort()
    keys = [t for t, _ in pairs]

    def to_trace(ns: int) -> float:
        return (ns + pairs[max(bisect.bisect_right(keys, ns) - 1, 0)][1]) / ns_per_unit
    return to_trace


class Throughput:
    """Per-stage wall-clock + megapixels/sec counters.

    >>> tp = Throughput()
    >>> with tp.stage("docscan", megapixels=8.15):
    ...     out = fused(batch); sync(out)
    >>> tp.report()
    """

    def __init__(self):
        self.stages: Dict[str, Dict[str, float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, megapixels: Optional[float] = None,
              images: Optional[int] = None):
        t0 = time.perf_counter()
        with span(name):
            yield
        dt = time.perf_counter() - t0
        rec = self.stages.setdefault(
            name, {"calls": 0, "seconds": 0.0, "megapixels": 0.0, "images": 0})
        rec["calls"] += 1
        rec["seconds"] += dt
        if megapixels:
            rec["megapixels"] += megapixels
        if images:
            rec["images"] += images

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, r in self.stages.items():
            row = dict(r)
            if r["seconds"] > 0:
                if r["megapixels"]:
                    row["mp_per_s"] = r["megapixels"] / r["seconds"]
                if r["images"]:
                    row["images_per_s"] = r["images"] / r["seconds"]
            out[name] = row
            log.info("stage %s: %s", name, json.dumps(row))
        return out


# the running trace: (profiler, directory, recorder ns at its start); one
# at a time, as jax.profiler's
_trace: Optional[tuple] = None


def start_trace(log_dir: str) -> None:
    """Start recording the host's ops and, where there is a card, its
    kernels, until :func:`stop_trace`."""
    global _trace
    if _trace is not None:
        raise RuntimeError("a trace is already running: stop_trace() first")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _trace = (prof, log_dir, time.perf_counter_ns())


def stop_trace() -> str:
    """Stop the trace and write it into the directory given to
    :func:`start_trace` as a Chrome trace (open it in Perfetto or
    chrome://tracing), with the spans recorded while it ran on the
    profiler's clock (category ``tpuimage.span``); returns the file's
    path."""
    global _trace
    if _trace is None:
        raise RuntimeError("no trace is running: start_trace() first")
    prof, log_dir, start_ns = _trace
    _trace = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    to_us = clock_map(((e["name"], e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                       if e.get("ph") == "X"), 1e3)
    if to_us is not None:
        events.extend({"ph": "X", "cat": "tpuimage.span", "name": s.name, "pid": os.getpid(),
                       "tid": s.thread, "ts": to_us(s.start_ns),
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"id": s.id, "parent": s.parent, "call": s.call}}
                      for s in spans() if s.start_ns >= start_ns)
        with open(path, "w") as f:
            json.dump(doc, f)
    return path
