"""Milliseconds of host time a request spends inside the port's
``night.median`` spans (the median's replicate pad, its 9 shifted views
and the 36 compare-exchange steps of its transposition network,
enqueued), over the requests in the traced window."""
from portbench import spans


def read(trace):
    medians = spans.spans({"night.median"})
    if not medians or not trace.requests:
        return None
    return 1e3 * sum(spans.seconds(s) for s in medians) / trace.requests
