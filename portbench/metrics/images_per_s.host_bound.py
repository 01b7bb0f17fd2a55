"""Images finished over the traced window's seconds, in cells whose
rate the host's speed sets too widely for an end-to-end bound (the
quad fit's Python loops on a shared host): the rate is kept here, per
layer, beside the end-to-end metric that such a cell is held to."""


def read(trace):
    if trace.window_s <= 0 or not trace.images:
        return None
    return trace.images / trace.window_s
