"""Separable Gaussian filters bit-matching OpenCV's 8-bit paths
(counterpart of ``tpuimage.ops.filters``).

The 8u blur quantizes the float64 kernel to Q8.8 taps by left-to-right
error diffusion; all intermediates are integers < 2**24, exact in f32 in
any order. The f32 blur (adaptiveThreshold's mean) is NOT order-free: it
follows OpenCV's symmetric tap order, vertical pass first, one op at a
time, which is the order tpuimage's CPU path rounds in.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.core.borders import BORDER_REFLECT_101, BORDER_REPLICATE, pad2d
from portbench.reference.core.dtypes import f32, i32, saturate_u8

# Fixed binary kernels OpenCV uses for sigma<=0, ksize<=7 (small_gaussian_tab)
_SMALL_GAUSSIAN = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
}


def gaussian_sigma_from_ksize(ksize: int) -> float:
    """OpenCV: sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8 when sigma <= 0."""
    return 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8


def gaussian_ksize_from_sigma(sigma: float, depth_8u: bool = True) -> int:
    """OpenCV createGaussianKernels: ksize = round(sigma*(8u?3:4)*2+1) | 1."""
    k = int(round(sigma * (3 if depth_8u else 4) * 2 + 1)) | 1
    return max(k, 1)


def get_gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """Float64 kernel identical to cv2.getGaussianKernel (normalized)."""
    if sigma <= 0 and ksize <= 7 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize].copy()
    s = sigma if sigma > 0 else gaussian_sigma_from_ksize(ksize)
    c = (ksize - 1) * 0.5
    x = np.arange(ksize, dtype=np.float64) - c
    k = np.exp(-(x * x) / (2.0 * s * s))
    return k / k.sum()


def gaussian_kernel_q8(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """OpenCV's bit-exact 8u kernel: Q8.8 by left-to-right error diffusion."""
    c = get_gaussian_kernel(ksize, sigma) * 256.0
    q = np.zeros(ksize, dtype=np.int64)
    err = 0.0
    for i in range(ksize):
        v = c[i] + err
        q[i] = np.rint(v)
        err = v - q[i]
    return q


def _sepconv_valid_f32(padded: torch.Tensor, kx, ky, fma: bool = False) -> torch.Tensor:
    """Separable 'valid' convolution of an already-padded (..., H, W) f32
    tensor: the vertical pass first, then the horizontal one. Symmetric
    odd kernels accumulate in OpenCV's order
    ``k[r]*x[0] + sum_i k[r+i]*(x[+i] + x[-i])``; others tap 0..k-1.
    ``fma`` (symmetric kernels) rounds each ``acc + pair * k`` once, the
    first one with the ``x[0] * k[r]`` product fused, as XLA's CPU
    compiler makes of tpuimage's jitted blur."""
    kyv = np.asarray(ky, dtype=np.float32).ravel()
    kxv = np.asarray(kx, dtype=np.float32).ravel()

    def one_axis(x, k, dim):
        n = len(k)
        out = x.shape[dim] - n + 1
        sl = lambda i: x.narrow(dim, i, out)  # noqa: E731
        if n % 2 == 1 and bool(np.all(k == k[::-1])):
            r = n // 2
            if fma:
                # f32 acc + pair * k rounded once: the f64 product of two f32
                # values is exact, one f64 sum rounded to f32 is the fused result
                acc = torch.add(((sl(r - 1) + sl(r + 1)) * float(k[r + 1])).double(),
                                sl(r).double(), alpha=float(k[r])).to(torch.float32)
                for i in range(2, r + 1):
                    acc = torch.add(acc.double(), (sl(r - i) + sl(r + i)).double(),
                                    alpha=float(k[r + i])).to(torch.float32)
                return acc
            acc = sl(r) * float(k[r])
            for i in range(1, r + 1):
                acc = acc + (sl(r - i) + sl(r + i)) * float(k[r + i])
            return acc
        if fma:
            raise ValueError("_sepconv_valid_f32: fma takes a symmetric odd kernel")
        acc = sl(0) * float(k[0])
        for i in range(1, n):
            acc = acc + sl(i) * float(k[i])
        return acc

    return one_axis(one_axis(padded, kyv, -2), kxv, -1)


def gaussian_blur_u8(img: torch.Tensor, ksize: int = 0, sigma: float = 0.0,
                     border: str = BORDER_REFLECT_101,
                     channels_last: bool = False) -> torch.Tensor:
    """cv2.GaussianBlur on each uint8 (H, W) plane of a (..., H, W) tensor,
    or, with ``channels_last``, on each channel of a (..., H, W, C) tensor
    (tpuimage's blur of an (H, W, C) image); bit-exact (Q8.8 taps, Q16.16
    accumulator, round half up). ksize == 0 derives it from sigma.

    On a CUDA uint8 tensor with the reflect-101 border this is the
    ``gaussian_blur_u8`` kernel (``ops.kernels``); elsewhere the plain
    separable form below."""
    if ksize <= 0:
        if sigma <= 0:
            return img
        ksize = gaussian_ksize_from_sigma(sigma)
    if ksize == 1:
        return img
    if channels_last:
        planes = gaussian_blur_u8(img.movedim(-1, -3).contiguous(), ksize, sigma, border)
        return planes.movedim(-3, -1).contiguous()
    if img.is_cuda and img.dtype == torch.uint8 and border == BORDER_REFLECT_101:
        from portbench.reference.ops import kernels   # kernels imports this module
        planes = img.reshape((-1,) + tuple(img.shape[-2:])).contiguous()
        return kernels.gaussian_blur_u8(planes, ksize, sigma).reshape(img.shape)
    return gaussian_blur_u8_plain(img, ksize, sigma, border)


def gaussian_blur_u8_plain(img: torch.Tensor, ksize: int, sigma: float = 0.0,
                           border: str = BORDER_REFLECT_101) -> torch.Tensor:
    """The plain PyTorch form of :func:`gaussian_blur_u8` for a resolved
    odd ``ksize``: the Q8.8 taps as exact integers in f32."""
    k = gaussian_kernel_q8(ksize, sigma).astype(np.float32)
    r = ksize // 2
    p = pad2d(f32(img), r, r, r, r, mode=border)
    out32 = _sepconv_valid_f32(p, k, k)  # exact integers in f32, Q16.16
    return torch.clamp(torch.floor((out32 + 32768.0) * (1.0 / 65536.0)),
                       0, 255).to(torch.uint8)


def gaussian_blur_f32(img: torch.Tensor, ksize: int = 0, sigma: float = 0.0,
                      border: str = BORDER_REFLECT_101, channels_last: bool = False,
                      fma: bool = False) -> torch.Tensor:
    """Float Gaussian blur of each (H, W) plane (adaptiveThreshold's mean),
    or, with ``channels_last``, of each channel of a (..., H, W, C) tensor.
    ``fma`` rounds each tap's multiply-add once, as tpuimage's jitted
    programs do (the shadow mask, the Retinex, local contrast); without
    it each product and sum rounds on its own (OpenCV's order, which the
    adaptive threshold's kernel follows). Plain tensor ops on every
    device: tpuimage has no kernel for it."""
    if ksize <= 0:
        if sigma <= 0:
            return img
        ksize = gaussian_ksize_from_sigma(sigma, depth_8u=False)
    if ksize == 1:
        return img
    if channels_last:
        planes = gaussian_blur_f32(img.movedim(-1, -3), ksize, sigma, border, fma=fma)
        return planes.movedim(-3, -1).contiguous()
    k = get_gaussian_kernel(ksize, sigma).astype(np.float32)
    r = ksize // 2
    p = pad2d(f32(img), r, r, r, r, mode=border)
    return _sepconv_valid_f32(p, k, k, fma=fma)


def box_sums_valid(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sums over every k x k window inside each (H, W) plane of a (..., H,
    W) float tensor ('valid': (..., H - k + 1, W - k + 1)), the rows first,
    added one shifted view at a time: exact for integer values whose sums
    stay below 2**24 (in f32: the squares and products of bytes over 7x7).
    A plane smaller than the window has no window: an empty result."""
    h, w = x.shape[-2] - k + 1, x.shape[-1] - k + 1
    if h <= 0 or w <= 0:
        return x.new_zeros(x.shape[:-2] + (max(h, 0), max(w, 0)))
    s = x[..., 0:h, :]
    for i in range(1, k):
        s = s + x[..., i:i + h, :]
    out = s[..., 0:w]
    for i in range(1, k):
        out = out + s[..., i:i + w]
    return out


def _window_sums(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Sums of every k consecutive int32 values along ``dim`` (a 'valid'
    box of length k), from one exact integer prefix sum."""
    c = torch.cumsum(x, dim=dim, dtype=torch.int32)
    n = x.shape[dim] - k + 1
    first = c.narrow(dim, k - 1, 1)
    return torch.cat([first, c.narrow(dim, k, n - 1) - c.narrow(dim, 0, n - 1)], dim=dim)


def box_filter_u8(img: torch.Tensor, ksize: int,
                  border: str = BORDER_REPLICATE) -> torch.Tensor:
    """Normalized cv2.boxFilter on each uint8 (H, W) plane (the
    ADAPTIVE_THRESH_MEAN_C mean): the exact integer window sum, times
    ``float32(1 / ksize**2)`` in f32, cvRounded, as tpuimage's. Plain
    tensor ops on every device: tpuimage has no kernel for it."""
    r = ksize // 2
    p = pad2d(i32(img), r, ksize - 1 - r, r, ksize - 1 - r, mode=border)
    s = _window_sums(_window_sums(p, ksize, -2), ksize, -1)
    inv_area = torch.tensor(1.0 / (ksize * ksize), dtype=torch.float32, device=img.device)
    return saturate_u8(f32(s) * inv_area)


def unsharp_mask_u8(img: torch.Tensor, amount: float, sigma: float = 0.0,
                    ksize: int = 0, channels_last: bool = False) -> torch.Tensor:
    """sharpen = addWeighted(img, 1 + amount, blur, -amount, 0), the blur
    :func:`gaussian_blur_u8` (tpuimage's ``unsharp_mask_u8``)."""
    blurred = gaussian_blur_u8(img, ksize=ksize, sigma=sigma, channels_last=channels_last)
    return saturate_u8(f32(img) * (1.0 + amount) + f32(blurred) * (-amount))
