"""Saturating uint8 arithmetic and NORM_MINMAX (counterpart of
``tpuimage.ops.arith``).

NORM_MINMAX rounds ``x * scale + offset`` once, as the fused multiply-add
of tpuimage's jitted programs (and cv2's ``convertTo``) does: the f64
product of a byte and an f32 scale is exact, and so is its sum with the
f32 offset ``-min * scale`` (alpha 0: both lie on the grid of scale's
last bit, within 2**40 of it), so one f32 rounding of the f64 value is
that fused result. Two rounded f32 ops would move pixels across cvRound
boundaries.
"""
from __future__ import annotations

import torch

from tpuimage_torch.core.dtypes import f32, fma_f32, i32, saturate_u8, trunc_u8


def add_u8(a: torch.Tensor, b) -> torch.Tensor:
    return saturate_u8(i32(a) + i32(torch.as_tensor(b, device=a.device)))


def subtract_u8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return saturate_u8(i32(a) - i32(b))


def divide_u8(a: torch.Tensor, b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """cv2.divide: dst = saturate(round(a*scale/b)), b == 0 -> 0.

    uint8 inputs with an integer scale take tpuimage's exact integer
    quotient with round half to even. Other scales (and dtypes) take its
    f32 path: ``f32(a) * scale`` rounded, then a true f32 division by b,
    then cvRound; tpuimage's jitted program divides there too (no
    reciprocal product), which the tests check on all byte pairs."""
    if not (a.dtype == torch.uint8 and b.dtype == torch.uint8
            and float(scale) == int(scale) and 0 <= int(scale) < (1 << 23)):
        bf = f32(b)
        nz = bf != 0
        q = f32(a) * float(scale) / torch.where(nz, bf, torch.ones_like(bf))
        return saturate_u8(torch.where(nz, q, torch.zeros_like(q)))
    n = i32(a) * int(scale)
    d = i32(b)
    safe = torch.clamp(d, min=1)
    q0 = torch.div(n, safe, rounding_mode="floor")
    r0 = n - q0 * safe
    q = (q0 + (2 * r0 > safe).to(torch.int32)
         + ((2 * r0 == safe) & (q0 % 2 == 1)).to(torch.int32))
    q = torch.where(d > 0, q, torch.zeros_like(q))
    return torch.clamp(q, 0, 255).to(torch.uint8)


def multiply_u8(a: torch.Tensor, b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    return saturate_u8(f32(a) * f32(b) * scale)


def max_u8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


def min_u8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.minimum(a, b)


def bitwise_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def bitwise_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b


def bitwise_not(a: torch.Tensor) -> torch.Tensor:
    return ~a


def absdiff_u8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return saturate_u8(torch.abs(i32(a) - i32(b)))


def blend_mask(a: torch.Tensor, b: torch.Tensor, mask01: torch.Tensor) -> torch.Tensor:
    """trunc(a * m + b * (1 - m)), each product and the sum rounded on its
    own (tpuimage's op called alone; inside a jitted program XLA fuses one
    product, which the pipelines reproduce at their own sites). A mask
    with one dim fewer than the images weighs every channel."""
    m = f32(mask01)
    if m.dim() == a.dim() - 1:
        m = m[..., None]
    return trunc_u8(f32(a) * m + f32(b) * (1.0 - m))


def in_range(img: torch.Tensor, lower, upper) -> torch.Tensor:
    """cv2.inRange: 255 where lower <= img <= upper, else 0. Bounds given
    per channel (sequences) test an (..., H, W, C) image in every channel
    and give (..., H, W); scalar bounds test each value of a plane.
    (tpuimage reduces when the image is 3-D; the bounds decide here so that
    a batch of images takes the same call.)"""
    lo = torch.as_tensor(lower, dtype=img.dtype, device=img.device)
    hi = torch.as_tensor(upper, dtype=img.dtype, device=img.device)
    ok = (img >= lo) & (img <= hi)
    if lo.dim() > 0 or hi.dim() > 0:
        ok = ok.all(dim=-1)
    return ok.to(torch.uint8) * 255


def add_weighted(a: torch.Tensor, alpha: float, b: torch.Tensor, beta: float,
                 gamma: float = 0.0) -> torch.Tensor:
    """cv2.addWeighted: saturate(a*alpha + b*beta + gamma) in f32. On bytes
    at landscape's sharpening weights every byte pair gives what
    tpuimage's jitted programs give (the products round to the same sum
    whether or not XLA fuses one of them into the add)."""
    return saturate_u8(f32(a) * alpha + f32(b) * beta + gamma)


def _minmax_scale(smin: torch.Tensor, smax: torch.Tensor, alpha: float,
                  beta: float):
    """The NORM_MINMAX affine coefficients in f32, shared by the per-pixel
    and the LUT forms so both compute the identical expression."""
    rng = smax - smin
    pos = rng > 0
    # a true division: `scalar / tensor` would be reciprocal-then-multiply
    span = torch.full_like(rng, beta - alpha)
    scale = torch.where(pos, span / torch.where(pos, rng, torch.ones_like(rng)),
                        torch.zeros_like(rng))
    return scale, alpha - smin * scale


def normalize_minmax_lut(smin: torch.Tensor, smax: torch.Tensor,
                         alpha: float = 0.0, beta: float = 255.0) -> torch.Tensor:
    """The NORM_MINMAX map as 256-entry uint8 LUTs: smin/smax of shape
    (...,) give LUTs of shape (..., 256) with ``lut[v]`` equal to
    normalize_minmax's value for a pixel of value v. Monotone
    non-decreasing, which lets callers pull thresholds back to the raw
    plane. Each entry is ``v * scale + offset`` rounded once (the module
    docstring)."""
    smin, smax = f32(smin)[..., None], f32(smax)[..., None]
    scale, offset = _minmax_scale(smin, smax, alpha, beta)
    v = torch.arange(256, dtype=torch.float32, device=smin.device)
    return saturate_u8(fma_f32(v, scale, offset.double()))


def normalize_minmax(img: torch.Tensor, alpha: float = 0.0,
                     beta: float = 255.0) -> torch.Tensor:
    """cv2.normalize(..., alpha, beta, NORM_MINMAX) on each uint8 (H, W)
    plane of a (..., H, W) tensor: each plane's :func:`normalize_minmax_lut`
    gathered per pixel, so the two forms are one expression."""
    if img.dtype != torch.uint8:
        raise TypeError(f"normalize_minmax: expected torch.uint8, got {img.dtype}")
    rows = img.reshape(-1, img.shape[-2] * img.shape[-1])
    lut = normalize_minmax_lut(torch.amin(rows, dim=1), torch.amax(rows, dim=1), alpha, beta)
    return torch.gather(lut, 1, rows.to(torch.int64)).reshape(img.shape)
