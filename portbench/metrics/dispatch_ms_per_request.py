"""Milliseconds of host time a request spends inside the route's own
top-level span (``landscape.gui``; ``docscan.post_warp`` called alone):
the enqueue of its kernels and glue, and the waits on the card inside it
(the post-warp's ``nonzero``, the pageable upload), over the requests in
the traced window. The caller's upload and fetch are outside it."""
from portbench import spans

ROUTES = {"landscape.gui", "docscan.post_warp"}


def read(trace):
    top = spans.top_level(spans.spans(ROUTES))
    if not top or not trace.requests:
        return None
    return 1e3 * sum(spans.seconds(s) for s in top) / trace.requests
