"""Share of the traced window in which nothing ran on the card: 1 minus
the union of all device activity (kernels, copies, memsets) over the
window, in %."""


def read(trace):
    if trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy() / trace.window_s)
