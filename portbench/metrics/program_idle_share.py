"""Share of the traced window in which the card is idle while the host is
inside one of the port's spans, in %: the card's idle gaps
(``trace.gaps()``) against the union of the spans put on the trace's
clock. At most ``device_idle_share``; the rest of the idle time falls in
the caller's code (its upload and fetch, the harness's loop)."""
from portbench import spans


def read(trace):
    if trace.window_s <= 0 or not trace.device:
        return None
    mapped = spans.on_trace(trace)
    if not mapped:
        return None
    inside = spans.union((s, e) for s, e, _ in mapped)
    return 100.0 * spans.overlap(inside, trace.gaps()) / trace.window_s
