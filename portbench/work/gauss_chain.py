"""The least device time of the post-warp's three separable Gaussians on
each page, counted from the page's shape as ``chip_smoke.py`` counts them:
the illumination divide (k = the page's illumination ksize) and the ink
background's sub (k = 51) as Q8.8 passes, k products of a byte with a
byte and their adds per pass and pixel at the int8 tensor cores' rate;
the adaptive threshold (block 31) as 1 + 3 * (block // 2) f32 operations
per pass and pixel (the centre product, then per pair its add, the
product and the accumulating add). Each pass reads its plane once and
writes its output once, plus its taps."""
from __future__ import annotations

from portbench import peaks

# the kernels of csrc/gauss_sep.cu, as the profiler names them
KERNEL_PATTERN = r"\bgauss_(sep|mma|vpass|hpass)_kernel\b"


def illum_ksize(h: int, w: int, blur_frac: float) -> int:
    base = max(15, int(round(min(h, w) * blur_frac)))
    return base + (base % 2 == 0)


def _odd(k: int) -> int:
    return k + (k % 2 == 0)


def q8_pass(n_px: int, k: int) -> tuple:
    return peaks.bound(2 * n_px + 4 * k, 2 * 2 * k * n_px, peaks.INT8_TENSOR_OPS_PER_S)


def adaptive_pass(n_px: int, block: int) -> tuple:
    return peaks.bound(2 * n_px + 4 * block, 2 * (1 + 3 * (block // 2)) * n_px)


def bound(pages, settings: dict) -> tuple:
    """(seconds, bound_by) over ``pages``, a list of (H, W) page shapes,
    for the configuration's ``settings`` (illum_blur_frac,
    mask_blur_ksize, block_size)."""
    parts = []
    for h, w in pages:
        n_px = h * w
        parts.append(q8_pass(n_px, illum_ksize(h, w, settings["illum_blur_frac"])))
        parts.append(q8_pass(n_px, _odd(settings["mask_blur_ksize"])))
        parts.append(adaptive_pass(n_px, _odd(settings["block_size"])))
    return peaks.add(parts)
