"""Milliseconds of host <-> device copies on the card per request: the
profiler's memcpy activity in the traced window over the requests it
holds."""
from portbench.trace import is_memcpy


def read(trace):
    copies = [e for e in trace.device if is_memcpy(e[2])]
    if not copies or not trace.requests:
        return None
    return 1e3 * sum(e - s for s, e, _ in copies) / trace.requests
