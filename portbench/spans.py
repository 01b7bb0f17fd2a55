"""The port's own spans and counters (``tpuimage_torch.runtime.profiling``)
as the per-layer readers take them, and where the card's idle time falls
among the spans.

The record holds the traced window alone: ``run_cell`` resets it
(``kernels.reset_launch_counts``) just before the window, spans are
recorded only while a profiler runs, and nothing of the program runs
between the window and the readers. Spans are put on the trace's clock
through the clock anchors (``tpuimage.clock.<call>``) that the trace
keeps among its host ops. A program without the recorder (a checkout
from before it) gives no spans and no counts, and the readers return
None.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs one traced window of a cell on the card and prints, as one JSON
line, its per-layer metrics, the card's idle time split by the innermost
program span covering it, and the idle time each span name covers."""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

OUTSIDE = "outside program spans"


def recorder():
    """``runtime.profiling`` where it has the recorder, else None."""
    try:
        from tpuimage_torch.runtime import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "clock_map") else None


def spans(names) -> list:
    """The recorded spans named in ``names``."""
    rec = recorder()
    if rec is None:
        return []
    return [s for s in rec.spans() if s.name in names]


def counts() -> Dict[str, int]:
    rec = recorder()
    return rec.counts() if rec is not None else {}


def top_level(recorded: list) -> list:
    """The spans that began a call of their own (no parent, not a phase of
    another thread's call)."""
    return [s for s in recorded if s.parent is None and s.call == s.id]


def seconds(s) -> float:
    return (s.end_ns - s.start_ns) / 1e9


def on_trace(trace) -> Optional[List[Tuple[float, float, object]]]:
    """Every recorded span as (start, end, span) in the trace's seconds,
    clipped to its window, or None where the trace holds no anchor."""
    rec = recorder()
    if rec is None:
        return None
    to_s = rec.clock_map(((n, s, e) for s, e, n in trace.host), 1e9)
    if to_s is None:
        return None
    out = []
    for sp in rec.spans():
        s, e = max(to_s(sp.start_ns), 0.0), min(to_s(sp.end_ns), trace.window_s)
        if e > s:
            out.append((s, e, sp))
    return out


def union(intervals) -> List[Tuple[float, float]]:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a, b) -> float:
    """Seconds shared by two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_by_span(trace, mapped) -> Dict[str, float]:
    """Seconds of the card's idle time (``trace.gaps()``) under each span
    name, each moment given to the innermost span open then (the deepest;
    of two equally deep, the later), or to ``OUTSIDE``."""
    byid = {sp.id: sp for _, _, sp in mapped}

    def depth(sp):
        d = 0
        while sp.parent in byid:
            sp, d = byid[sp.parent], d + 1
        return d

    depths = {sp.id: depth(sp) for _, _, sp in mapped}
    gaps = trace.gaps()
    edges: Dict[float, list] = {}
    for k, (s, e, _) in enumerate(mapped):
        edges.setdefault(s, []).append((1, k))
        edges.setdefault(e, []).append((-1, k))
    for s, e in gaps:
        edges.setdefault(s, [])
        edges.setdefault(e, [])
    times = sorted(edges)
    active: dict = {}
    out: Dict[str, float] = {}
    g = 0
    for t0, t1 in zip(times, times[1:]):
        for step, k in edges[t0]:
            if step > 0:
                active[k] = mapped[k]
            else:
                active.pop(k, None)
        while g < len(gaps) and gaps[g][1] <= t0:
            g += 1
        if g == len(gaps) or gaps[g][0] > t0:
            continue        # the card is busy over [t0, t1)
        if active:
            sp = max(active.values(), key=lambda m: (depths[m[2].id], m[0]))[2]
            name = sp.name
        else:
            name = OUTSIDE
        out[name] = out.get(name, 0.0) + (t1 - t0)
    return out


def idle_covered(trace, mapped) -> Dict[str, float]:
    """Seconds of the card's idle time inside the union of each span
    name's spans."""
    gaps = trace.gaps()
    names = sorted({sp.name for _, _, sp in mapped})
    return {n: overlap(union((s, e) for s, e, sp in mapped if sp.name == n), gaps)
            for n in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from portbench import run
    from tpuimage_torch.runtime.cache import enable_compile_cache

    enable_compile_cache(str(run.HERE / ".cache" / "build"))
    r = run.run_cell(args.workload, args.seed, args.seconds, True)
    trace = r["trace"]
    mapped = on_trace(trace) or []
    idle = sum(e - s for s, e in trace.gaps())
    rec = recorder()
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "correct": r["correct"],
        "metrics": {k: v["value"] for k, v in r["metrics"].items()},
        "window_s": trace.window_s, "idle_s": idle, "requests": trace.requests,
        "images": trace.images, "spans": len(mapped),
        "dropped": rec.dropped() if rec is not None else None, "counts": counts(),
        "idle_by_innermost_span": dict(sorted(idle_by_span(trace, mapped).items(),
                                              key=lambda kv: -kv[1])),
        "idle_covered_by": dict(sorted(idle_covered(trace, mapped).items(),
                                       key=lambda kv: -kv[1])),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
