"""Share of the window's quad fits that found no 4-gon and took the
min-area rectangle of the largest contour: the port's counters
``docscan.quad_fallbacks`` over ``docscan.quads``, in %."""
from portbench import spans


def read(trace):
    c = spans.counts()
    if not c.get("docscan.quads"):
        return None
    return 100.0 * c.get("docscan.quad_fallbacks", 0) / c["docscan.quads"]
