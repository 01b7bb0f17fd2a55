"""Pillow's bicubic resize, bit for bit (counterpart of
``tpuimage.ops.pil_resize``).

open_clip's eval transform resizes a PIL image: Pillow's 8-bit resample,
which antialiases (the kernel's support grows with the downscale factor)
and rounds each of its two separable passes to uint8 through a 22-bit
fixed-point accumulator. The port keeps that algorithm exactly:

- each axis' coefficient matrix is built on the host in float64 with
  Pillow's bicubic (a = -0.5), support scaling, normalisation and round
  half away from zero to fixed point (Resample.c, PRECISION_BITS = 32 - 8
  - 2);
- two passes, the horizontal one first, as Pillow runs them (each pass
  rounds to uint8, so the order shows);
- each pass is one contraction of the bytes with the integer weights,
  then ``+ 2^21``, a floor shift by 22 and a clip to [0, 255].

The contraction runs in float64 on both devices: PyTorch has no int32
matrix product on CUDA, and every partial sum is an integer below 2^31,
far inside float64's 2^53, so the float64 product is exact in any order.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_PRECISION_BITS = 22  # Pillow Resample.c: 32 - 8 - 2


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Pillow's bicubic_filter (support 2.0, a = -0.5), vectorized."""
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


@functools.lru_cache(maxsize=64)
def pil_bicubic_coeffs(insize: int, outsize: int) -> np.ndarray:
    """(outsize, insize) int32 fixed-point weight matrix reproducing
    Pillow's precompute_coeffs + normalize_coeffs_8bpc for BICUBIC."""
    scale = insize / outsize
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    inv = 1.0 / filterscale
    W = np.zeros((outsize, insize), np.int64)
    for xx in range(outsize):
        center = (xx + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(insize, int(center + support + 0.5)) - xmin
        k = _bicubic((np.arange(xmax) + xmin - center + 0.5) * inv)
        k = k / k.sum()
        # C cast after +/-0.5: truncation toward zero == round half away
        W[xx, xmin:xmin + xmax] = np.trunc(
            k * (1 << _PRECISION_BITS) + np.copysign(0.5, k)).astype(np.int64)
    return W.astype(np.int32)


@functools.lru_cache(maxsize=64)
def _coeffs_on(insize: int, outsize: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(pil_bicubic_coeffs(insize, outsize).astype(np.float64)).to(device)


def _pass(img: torch.Tensor, W: torch.Tensor, axis: int) -> torch.Tensor:
    """One resample pass over ``axis`` (-3: rows, -2: columns) of a (..., H,
    W, C) uint8 tensor: the exact float64 contraction, + 2^21, floor shift
    by 22, clip to u8."""
    x = img.movedim(axis, -1).to(torch.float64)            # the resized axis last
    acc = torch.matmul(x, W.t())
    out = torch.floor((acc + float(1 << (_PRECISION_BITS - 1))) * (1.0 / (1 << _PRECISION_BITS)))
    return torch.clamp(out, 0, 255).to(torch.uint8).movedim(-1, axis)


def pil_resize_bicubic(img: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """``PIL.Image.resize((tw, th), Image.BICUBIC)`` on each (H, W, C)
    uint8 image of a (..., H, W, C) tensor, bit for bit: the horizontal
    pass first, then the vertical one."""
    h, w = int(img.shape[-3]), int(img.shape[-2])
    out = img
    if w != tw:
        out = _pass(out, _coeffs_on(w, tw, img.device), axis=-2)
    if h != th:
        out = _pass(out, _coeffs_on(h, th, img.device), axis=-3)
    return out
