"""Dtype policy and OpenCV-compatible rounding/saturation helpers
(counterpart of ``tpuimage.core.dtypes``).

Images are stored as uint8 and computed in float32 / int32. Every cast
back to uint8 goes through :func:`saturate_u8` (OpenCV's
``saturate_cast<uchar>``: round half to even, then clamp).
``round_half_even`` is ``torch.round``, which rounds half to even.
"""
from __future__ import annotations

import numpy as np
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


def lerp2(v11, v12, v21, v22, xa, ya):
    """Bilinear blend ``(v11*(1-xa)+v12*xa)*(1-ya) + (v21*(1-xa)+v22*xa)*ya``
    of f32 tensors, as tpuimage's jitted ``lerp2`` computes it: XLA's CPU
    compiler fuses one product of each add into an fma (``v12*xa``,
    ``v21*(1-xa)`` and the top row's ``*(1-ya)``; found by trying each form
    against the jitted function), each rounded once (:func:`fma_f32`).
    Called outside ``jit``, tpuimage rounds every op, up to 3 ulp away."""
    xa1 = 1.0 - xa
    ya1 = 1.0 - ya
    top = fma_f32(v12, xa, (v11 * xa1).double())
    bottom = fma_f32(v21, xa1, (v22 * xa).double())
    return fma_f32(top, ya1, (bottom * ya).double())


def trunc_u8(x: torch.Tensor) -> torch.Tensor:
    """``np.clip(x, 0, 255).astype(np.uint8)``: truncation, not cvRound."""
    return torch.clamp(x, 0, 255).to(torch.uint8)


def descale(x: torch.Tensor, n: int) -> torch.Tensor:
    """OpenCV CV_DESCALE(x, n) = (x + (1 << (n-1))) >> n on int32."""
    return (i32(x) + (1 << (n - 1))) >> n


def fma_f32(x: torch.Tensor, y: torch.Tensor, z) -> torch.Tensor:
    """f32 ``x * y + z`` rounded once, as the fused multiply-add that XLA's
    compiler makes of a product feeding an add: the f64 product of two f32
    values is exact, and one rounding of the f64 sum to f32 is the fused
    result but for a double rounding at an f32 tie (an f64 sum exactly
    halfway between two f32 values), which the callers' inputs do not meet
    in their tests."""
    return (x.double() * y.double() + z).to(torch.float32)


def fma_np(x, y, z) -> np.ndarray:
    """numpy f32 ``x * y + z`` rounded once (the f64 product of f32 values
    is exact): the tables' form of :func:`fma_f32`."""
    return (np.float64(x) * np.float64(y) + np.float64(z)).astype(np.float32)


def pow_np(x: np.ndarray, p: float):
    """``x ** p`` on f32 as XLA computes ``pow(x, p)``: (left, right) of
    the last product for p = 2 and 3 (the compiler writes x*x and
    x*(x*x)), else (the f32 value, None): 1 and x for p = 0 and 1, the
    correctly rounded f64 power otherwise."""
    p = np.float32(p)
    if p == 2:
        return x, x
    if p == 3:
        return x, x * x
    if p == 0:
        return np.ones_like(x), None
    if p == 1:
        return x, None
    return np.power(x.astype(np.float64), np.float64(p)).astype(np.float32), None
