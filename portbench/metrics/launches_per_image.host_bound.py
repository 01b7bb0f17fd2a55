"""``launches_per_image`` in the cells the host sets, where it moves
that cell's end-to-end metric instead of ``images_per_s``."""
from portbench.metrics.launches_per_image import read  # noqa: F401
