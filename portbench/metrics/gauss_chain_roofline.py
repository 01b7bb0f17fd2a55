"""The post-warp's three separable Gaussians (``gauss_chain``: divide,
sub, adaptive) against their roofline: the least time their work needs
on the card (``portbench/work/gauss_chain.py``, from the pages' shapes)
over the device time of the ``gauss_sep.cu`` kernels, in %."""
from portbench.work import gauss_chain


def read(trace):
    pages = trace.work.get("gauss_chain")
    kernels = trace.kernels(gauss_chain.KERNEL_PATTERN)
    if not pages or not kernels:
        return None
    least, _ = gauss_chain.bound(pages, trace.settings)
    return 100.0 * least / sum(e - s for s, e, _ in kernels)
