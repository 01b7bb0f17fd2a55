"""The traced window: ``torch.profiler`` over the requests of a run, read
into device intervals and host spans that the per-layer readers in
``portbench/metrics`` take their numbers from.

Device activity is every event the profiler puts on the card (kernels,
memcpy, memset). Busy time is the union of their intervals inside the
window, so overlapping work is counted once; copies count as activity.
An idle gap is labelled by the host operation that overlaps it most: the
outermost torch op the profiler saw on the host then, or "host: no torch
op" where torch ops cover less than half of it (Python and numpy work
such as the quad fit)."""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

WINDOW_SPAN = "portbench.window"
REQUEST_SPAN = "portbench.request"
NO_OP = "host: no torch op"


@dataclass
class Trace:
    """One traced window, times in seconds from the window's start."""
    window_s: float
    device: List[Tuple[float, float, str]]        # (start, end, name), sorted by start
    host: List[Tuple[float, float, str]]          # outermost host ops, sorted by start
    requests: int                                  # requests issued and finished in it
    images: int                                    # their images
    work: dict = field(default_factory=dict)       # stage -> list of shapes, from the entry
    settings: dict = field(default_factory=dict)   # the configuration's settings

    def kernels(self, pattern: str) -> List[Tuple[float, float, str]]:
        rx = re.compile(pattern)
        return [e for e in self.device if rx.search(e[2])]

    def busy(self, events: Optional[list] = None) -> float:
        """Seconds of the union of the events' intervals (default: all
        device events)."""
        total, end = 0.0, float("-inf")
        for s, e, _ in sorted(events if events is not None else self.device):
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals of the device inside the window."""
        out, end = [], 0.0
        for s, e, _ in self.device:
            if s > end:
                out.append((end, s))
            end = max(end, e)
        if end < self.window_s:
            out.append((end, self.window_s))
        return out

    def label(self, start: float, end: float) -> str:
        """The host op that overlaps [start, end) most, or ``NO_OP`` where
        torch ops cover less than half of it."""
        best, best_len, covered = NO_OP, 0.0, 0.0
        for s, e, name in self.host:
            if s >= end:
                break
            overlap = min(e, end) - max(s, start)
            if overlap > 0:
                covered += overlap
                if overlap > best_len:
                    best, best_len = name, overlap
        return best if covered >= 0.5 * (end - start) else NO_OP


def is_memcpy(name: str) -> bool:
    return name.lower().startswith("memcpy")


def read(prof, requests: int, images: int, work: dict, settings: dict) -> Trace:
    """The Trace of a finished ``torch.profiler.profile`` whose window is
    the ``WINDOW_SPAN`` record_function."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    window = next(e for e in events if e.name == WINDOW_SPAN and e.device_type != cuda)
    t0, t1 = window.time_range.start, window.time_range.end
    device, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if t <= t0 or s >= t1:
            continue
        s, t = (max(s, t0) - t0) / 1e6, (min(t, t1) - t0) / 1e6
        if e.name.startswith("portbench."):     # the spans, and their rows on the card
            continue
        if e.device_type == cuda:
            device.append((s, t, e.name))
        elif e.cpu_parent is None or e.cpu_parent.name.startswith("portbench."):
            host.append((s, t, e.name))
    device.sort()
    host.sort()
    return Trace((t1 - t0) / 1e6, device, host, requests, images, work, settings)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device ops with the most time and the longest idle gaps, each
    labelled by the host op overlapping it: [name, seconds] lists."""
    by_name: dict = {}
    for s, e, name in trace.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:120], t] for n, t in ops],
            "idle_gaps": [[trace.label(s, e)[:120], e - s] for s, e in gaps]}

