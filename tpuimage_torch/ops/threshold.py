"""Global and adaptive thresholds (counterpart of ``tpuimage.ops.threshold``)."""
from __future__ import annotations

import math

import torch

from tpuimage_torch.core.borders import BORDER_REPLICATE
from tpuimage_torch.core.dtypes import f32, i32, saturate_u8
from tpuimage_torch.ops.filters import gaussian_blur_f32


def threshold_binary(gray: torch.Tensor, thresh, maxval: int = 255) -> torch.Tensor:
    """cv2.THRESH_BINARY: dst = src > thresh ? maxval : 0 (strict >).
    ``thresh`` may be a tensor broadcasting against ``gray``."""
    return torch.where(f32(gray) > thresh,
                       torch.tensor(maxval, dtype=torch.uint8, device=gray.device),
                       torch.tensor(0, dtype=torch.uint8, device=gray.device))


def threshold_otsu(gray: torch.Tensor, maxval: int = 255):
    """cv2.threshold(..., THRESH_BINARY + THRESH_OTSU) on each (H, W) plane
    of a (..., H, W) uint8 tensor -> (thresholds (...,) float32, binary)."""
    from tpuimage_torch.ops.histogram import hist256_batch, otsu_from_hist
    lead = gray.shape[:-2]
    t = otsu_from_hist(hist256_batch(gray.reshape((-1,) + gray.shape[-2:])))
    return t.reshape(lead), threshold_binary(gray, t.reshape(lead + (1, 1)), maxval)


def adaptive_threshold(gray: torch.Tensor, max_value: int = 255,
                       method: str = "gaussian", block_size: int = 35,
                       C: float = 10.0) -> torch.Tensor:
    """cv2.adaptiveThreshold THRESH_BINARY, ADAPTIVE_THRESH_GAUSSIAN_C, on
    each (H, W) plane: the mean is an f32 Gaussian blur with a CV_32F
    kernel and a replicate border, cvRounded to uint8; the test is
    ``src - mean > -ceil(C)``."""
    if method != "gaussian":
        raise NotImplementedError(f"adaptive_threshold method {method!r}")
    if block_size % 2 == 0:
        block_size += 1
    mean = saturate_u8(gaussian_blur_f32(f32(gray), ksize=block_size,
                                         border=BORDER_REPLICATE))
    idelta = math.ceil(C)
    diff = i32(gray) - i32(mean)
    return torch.where(diff > -idelta,
                       torch.tensor(max_value, dtype=torch.uint8, device=gray.device),
                       torch.tensor(0, dtype=torch.uint8, device=gray.device))
