"""The least device time of the colour bilateral filter, counted from the
image's shape as ``chip_smoke.py`` counts it: each byte read and written
once; per pixel and tap, three |diff| and their two adds, the table
lookup, the weight's multiply, and per channel a multiply and an add,
then the weights' add: 14 operations, at the card's f32 rate. The taps
are cv2.bilateralFilter's: the offsets within the radius d // 2."""
from __future__ import annotations

from portbench import peaks

# the kernel of csrc/bilateral.cu, as the profiler names it
KERNEL_PATTERN = r"\bbilateral_kernel\b"


def n_taps(d: int) -> int:
    r = d // 2
    return sum(1 for i in range(-r, r + 1) for j in range(-r, r + 1) if i * i + j * j <= r * r)


def bound(images, settings: dict) -> tuple:
    """(seconds, bound_by) over ``images``, a list of (H, W) RGB image
    shapes, for the configuration's ``settings`` (bilateral_d)."""
    taps = n_taps(settings["bilateral_d"])
    return peaks.add(peaks.bound(2 * 3 * h * w, 14 * taps * h * w) for h, w in images)
