"""The state carried across from tpuimage.

No pipeline has learned weights. DocScanner's state is its config plus
static tables (the Q8 Gaussian taps, the f32 adaptive-threshold taps and
its integer offset, the Hough cos/sin tables, the structuring elements
and the preprocess's bilateral taps and weights); the night paths' is
the Lab tables and CLAHE's blend matrices. The tables are built from
numpy exactly as tpuimage builds them.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from tpuimage_torch.ops.bilateral import tap_tables
from tpuimage_torch.ops.color import lab_tables
from tpuimage_torch.ops.filters import gaussian_kernel_q8, get_gaussian_kernel
from tpuimage_torch.ops.histogram import clahe_blend_matrix, clahe_geometry
from tpuimage_torch.ops.hough import hough_tables
from tpuimage_torch.ops.kernels import color_weight_table
from tpuimage_torch.pipelines.docscan import (INK_DILATE_SE, DocScanConfig,
                                              adaptive_block, blackhat_se,
                                              illum_ksize, mask_ksize)


def config_from_tpuimage(cfg) -> DocScanConfig:
    """A tpuimage ``DocScanConfig`` (read by ``dataclasses.asdict``; tpuimage
    itself is not imported) -> the port's ``DocScanConfig``."""
    fields = dataclasses.asdict(cfg)
    ours = {f.name for f in dataclasses.fields(DocScanConfig)}
    if set(fields) != ours:
        raise ValueError(f"config fields differ: {sorted(set(fields) ^ ours)}")
    return DocScanConfig(**fields)


def static_tables(config: DocScanConfig, page_shape=(1200, 849)) -> dict:
    """The static tables the post-warp program uses on a page of
    ``page_shape`` (H, W)."""
    cos_t, sin_t = hough_tables()
    tables = {
        "illum_taps_q8": gaussian_kernel_q8(illum_ksize(*page_shape, config)),
        "mask_taps_q8": gaussian_kernel_q8(mask_ksize(config)),
        "adaptive_taps_f32": get_gaussian_kernel(adaptive_block(config)).astype(np.float32),
        "adaptive_idelta": math.ceil(config.C),
        "hough_cos": cos_t,
        "hough_sin": sin_t,
        "se_blackhat": blackhat_se(config),
        "se_ink_dilate": INK_DILATE_SE,
    }
    return tables


def bilateral_tables(d: int, sigma_color: float, sigma_space: float,
                     channels: int = 1) -> dict:
    """The bilateral filter's tables for cv2.bilateralFilter(d, sigma_color,
    sigma_space) on 1 or 3 channels: the (T, 2) int32 (dy, dx) tap offsets
    in tpuimage's tap order and the (T,) float32 space weights, built from
    numpy as tpuimage builds them, and the float32 colour weights of every
    distance 0..255 * channels (the plain version's expression, on the
    CPU)."""
    radius, offsets, space_w, gc = tap_tables(d, sigma_color, sigma_space)
    return {
        "radius": radius,
        "tap_offsets": offsets,
        "space_weights": space_w,
        "gauss_color": gc,
        "color_weights": color_weight_table(255 * channels + 1, gc, "cpu").numpy(),
    }


def night_tables(shape=(853, 1280), tiles=(8, 8)) -> dict:
    """The static tables of the night paths on an (H, W) image with
    ``tiles`` = (tiles_x, tiles_y): the Lab gamma and cube-root tables and
    fixed-point coefficients, and CLAHE's tile size and blend matrices
    R (H, ty) and C (tx, W)."""
    h, w = shape
    tiles_x, tiles_y = tiles
    gamma, cbrt, coeffs = lab_tables()
    _, _, th, tw = clahe_geometry(h, w, tiles_x, tiles_y)
    return {
        "lab_gamma": gamma,
        "lab_cbrt": cbrt,
        "lab_coeffs": coeffs,
        "clahe_tile": (th, tw),
        "clahe_R": clahe_blend_matrix(h, th, tiles_y),
        "clahe_C": clahe_blend_matrix(w, tw, tiles_x).T,
    }
