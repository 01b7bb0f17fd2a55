"""Global and adaptive thresholds (counterpart of ``tpuimage.ops.threshold``)."""
from __future__ import annotations

import math

import torch

from tpuimage_torch.core.borders import BORDER_REPLICATE
from tpuimage_torch.core.dtypes import f32, i32, saturate_u8
from tpuimage_torch.ops.filters import box_filter_u8, gaussian_blur_f32


def threshold_binary(gray: torch.Tensor, thresh, maxval: int = 255) -> torch.Tensor:
    """cv2.THRESH_BINARY: dst = src > thresh ? maxval : 0 (strict >).
    ``thresh`` may be a tensor broadcasting against ``gray``."""
    return torch.where(f32(gray) > thresh,
                       torch.tensor(maxval, dtype=torch.uint8, device=gray.device),
                       torch.tensor(0, dtype=torch.uint8, device=gray.device))


def threshold_binary_inv(gray: torch.Tensor, thresh, maxval: int = 255) -> torch.Tensor:
    """cv2.THRESH_BINARY_INV: dst = src > thresh ? 0 : maxval."""
    return torch.where(f32(gray) > thresh,
                       torch.tensor(0, dtype=torch.uint8, device=gray.device),
                       torch.tensor(maxval, dtype=torch.uint8, device=gray.device))


def threshold_otsu(gray: torch.Tensor, maxval: int = 255):
    """cv2.threshold(..., THRESH_BINARY + THRESH_OTSU) on each (H, W) plane
    of a (..., H, W) uint8 tensor -> (thresholds (...,) float32, binary)."""
    from tpuimage_torch.ops.histogram import hist256_batch, otsu_from_hist
    lead = gray.shape[:-2]
    t = otsu_from_hist(hist256_batch(gray.reshape((-1,) + gray.shape[-2:])))
    return t.reshape(lead), threshold_binary(gray, t.reshape(lead + (1, 1)), maxval)


def adaptive_threshold(gray: torch.Tensor, max_value: int = 255,
                       method: str = "gaussian", block_size: int = 35,
                       C: float = 10.0, inverse: bool = False) -> torch.Tensor:
    """cv2.adaptiveThreshold on each (H, W) plane, THRESH_BINARY (or
    THRESH_BINARY_INV with ``inverse``). GAUSSIAN_C: the mean is an f32
    Gaussian blur with a CV_32F kernel and a replicate border, cvRounded
    to uint8; MEAN_C ("mean"): :func:`box_filter_u8`. The test is
    ``src - mean > -idelta`` (``<=`` when inverted), idelta = ceil(C)
    (floor(C) when inverted)."""
    if method not in ("gaussian", "mean"):
        raise ValueError(f"adaptive_threshold: method must be 'gaussian' or 'mean', "
                         f"got {method!r}")
    if block_size % 2 == 0:
        block_size += 1
    if method == "gaussian":
        mean = saturate_u8(gaussian_blur_f32(f32(gray), ksize=block_size,
                                             border=BORDER_REPLICATE))
    else:
        mean = box_filter_u8(gray, block_size, border=BORDER_REPLICATE)
    idelta = math.floor(C) if inverse else math.ceil(C)
    diff = i32(gray) - i32(mean)
    hit = diff <= -idelta if inverse else diff > -idelta
    return torch.where(hit,
                       torch.tensor(max_value, dtype=torch.uint8, device=gray.device),
                       torch.tensor(0, dtype=torch.uint8, device=gray.device))
