"""RGB -> gray, bit-exact with OpenCV's fixed-point path (counterpart of
``tpuimage.ops.color.rgb_to_gray``)."""
from __future__ import annotations

import torch

from tpuimage_torch.core.dtypes import descale, i32

# Y = descale(R*9798 + G*19235 + B*3735, 15), Q15 fixed point
_R2Y15, _G2Y15, _B2Y15 = 9798, 19235, 3735


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 RGB -> (..., H, W) uint8 gray."""
    r, g, b = i32(img[..., 0]), i32(img[..., 1]), i32(img[..., 2])
    return descale(r * _R2Y15 + g * _G2Y15 + b * _B2Y15, 15).to(torch.uint8)
