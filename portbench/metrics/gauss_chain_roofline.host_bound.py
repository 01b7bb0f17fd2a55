"""``gauss_chain_roofline`` in the cells the host sets, where it moves
that cell's end-to-end metric instead of ``images_per_s``."""
from portbench.metrics.gauss_chain_roofline import read  # noqa: F401
