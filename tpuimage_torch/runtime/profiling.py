"""Tracing and throughput counters (counterpart of
``tpuimage.runtime.profiling``).

``Throughput`` keeps per-stage wall-clock, megapixel and image counts
and logs them on the ``tpuimage`` logger, as tpuimage's does; ``sync``
ends the device work a timed stage launched (PyTorch returns before the
card finishes); ``trace_annotation`` names a range in a profiler trace;
``start_trace`` / ``stop_trace`` record one ``torch.profiler`` trace of
the host and the card and write it as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Optional

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


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named range in a profiler trace (``torch.profiler.record_function``;
    costs next to nothing when no profiler runs)."""
    with torch.profiler.record_function(name):
        yield


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
        with trace_annotation(name):
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


# the running trace: (profiler, directory); one at a time, as jax.profiler's
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
    _trace = (prof, log_dir)


def stop_trace() -> str:
    """Stop the trace and write it into the directory given to
    :func:`start_trace` as a Chrome trace (open it in Perfetto or
    chrome://tracing); returns the file's path."""
    global _trace
    if _trace is None:
        raise RuntimeError("no trace is running: start_trace() first")
    prof, log_dir = _trace
    _trace = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path
