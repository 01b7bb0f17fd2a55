"""The colour bilateral filter against its roofline: the least time its
work needs on the card (``portbench/work/bilateral.py``, from the
images' shapes) over the device time of the ``bilateral.cu`` kernel, in
%."""
from portbench.work import bilateral


def read(trace):
    images = trace.work.get("bilateral")
    kernels = trace.kernels(bilateral.KERNEL_PATTERN)
    if not images or not kernels:
        return None
    least, _ = bilateral.bound(images, trace.settings)
    return 100.0 * least / sum(e - s for s, e, _ in kernels)
