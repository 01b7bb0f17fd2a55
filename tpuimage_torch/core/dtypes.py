"""Dtype policy and OpenCV-compatible rounding/saturation helpers
(counterpart of ``tpuimage.core.dtypes``).

Images are stored as uint8 and computed in float32 / int32. Every cast
back to uint8 goes through :func:`saturate_u8` (OpenCV's
``saturate_cast<uchar>``: round half to even, then clamp).
``round_half_even`` is ``torch.round``, which rounds half to even.
"""
from __future__ import annotations

import torch


def f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def saturate_u8(x: torch.Tensor) -> torch.Tensor:
    """OpenCV saturate_cast<uchar>: cvRound for floats, clamp to [0, 255]."""
    if x.is_floating_point():
        x = torch.round(x)
    return torch.clamp(x, 0, 255).to(torch.uint8)


def trunc_u8(x: torch.Tensor) -> torch.Tensor:
    """``np.clip(x, 0, 255).astype(np.uint8)``: truncation, not cvRound."""
    return torch.clamp(x, 0, 255).to(torch.uint8)


def descale(x: torch.Tensor, n: int) -> torch.Tensor:
    """OpenCV CV_DESCALE(x, n) = (x + (1 << (n-1))) >> n on int32."""
    return (i32(x) + (1 << (n - 1))) >> n
