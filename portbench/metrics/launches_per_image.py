"""Device kernels, copies and memsets in the traced window over the
images its requests held: the port's own kernels and ATen's eager glue
alike."""


def read(trace):
    if not trace.device or not trace.images:
        return None
    return len(trace.device) / trace.images
