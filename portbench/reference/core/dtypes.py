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


def fma_f32(x, y, z) -> torch.Tensor:
    """f32 ``x * y + z`` rounded once, as the fused multiply-add that XLA's
    compiler makes of a product feeding an add: the f64 product of two f32
    values is exact, and one rounding of the f64 sum to f32 is the fused
    result but for a double rounding at an f32 tie (an f64 sum exactly
    halfway between two f32 values), which the callers' inputs do not meet
    in their tests. Each operand is an f32 tensor or a Python float holding
    an f32 value."""
    x, y, z = (v.double() if isinstance(v, torch.Tensor) else v for v in (x, y, z))
    return (x * y + z).to(torch.float32)


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


def round_half_even(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, in the input's float dtype (``jnp.round``)."""
    return torch.round(x)


def _window_sums(v: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """One level of XLA's tree rewrite of a reduce over the last two dims
    (``v`` of shape (..., A, B)): windows of 32 along each dim longer than
    32, zero-padded to a multiple of 32 with half the padding (rounded
    down) before, the whole dim otherwise -> (..., A', B', window)."""
    wa, wb = min(a, 32), min(b, 32)
    pa, pb = -a % wa, -b % wb
    v = torch.nn.functional.pad(v, (pb // 2, pb - pb // 2, pa // 2, pa - pa // 2))
    na, nb = (a + pa) // wa, (b + pb) // wb
    v = v.reshape(v.shape[:-2] + (na, wa, nb, wb)).transpose(-3, -2)
    return v.reshape(v.shape[:-4] + (na, nb, wa * wb))


def _accumulate_f32(v: torch.Tensor) -> torch.Tensor:
    """f32 sum over the last dim, one rounding per element in order from 0.
    On the card in one launch: torch's cumsum along the leading dim of a
    2-D tensor of two or more columns is ATen's ``scan_outer_dim``, one
    thread a column adding in order in the tensor's dtype (a zero column
    keeps a single row off CUB's parallel scan). The host's cumsum adds
    in f64, so there it is a loop of f32 adds."""
    if v.is_cuda:
        cols = v.reshape(-1, v.shape[-1]).t()
        cols = torch.cat([cols, torch.zeros_like(cols[:, :1])], dim=1)
        return torch.cumsum(cols, dim=0)[-1, :-1].reshape(v.shape[:-1])
    acc = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)
    for k in range(v.shape[-1]):
        acc = acc + v[..., k]
    return acc


def xla_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of integer-valued ``x`` (..., A, B) over its last two
    dims as XLA's CPU compiler computes ``jnp.sum`` of it in f32: its tree
    rewrite sums windows of up to 32 x 32 (:func:`_window_sums`), level
    after level until neither dim is longer than 32, then a plain reduce;
    each window and the reduce add in row-major order, rounding each add.
    The first level's windows of bytes are exact (at most 1024 * 255), so
    they are summed as integers; the rest one add at a time
    (:func:`_accumulate_f32`)."""
    v = x
    a, b = int(v.shape[-2]), int(v.shape[-1])
    first = True
    while a > 32 or b > 32:
        w = _window_sums(v, a, b)
        v = w.sum(dim=-1, dtype=torch.int64).to(torch.float32) if first else _accumulate_f32(w)
        a, b, first = int(v.shape[-2]), int(v.shape[-1]), False
    flat = v.reshape(v.shape[:-2] + (a * b,))
    if first:
        return flat.sum(dim=-1, dtype=torch.int64).to(torch.float32)
    return _accumulate_f32(flat)
