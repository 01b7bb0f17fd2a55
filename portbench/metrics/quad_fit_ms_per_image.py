"""Milliseconds of host time one photo's quad fit takes: the port's
``docscan.fit_quad`` spans in the traced window (``_quad_from_localize``:
the segments drawn, the contours traced, the 4-gon search and the
min-area-rect fallback), their sum over their count."""
from portbench import spans


def read(trace):
    fits = spans.spans({"docscan.fit_quad"})
    if not fits:
        return None
    return 1e3 * sum(spans.seconds(s) for s in fits) / len(fits)
