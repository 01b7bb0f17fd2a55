"""Restoration ops: single-scale Retinex, Richardson-Lucy deconvolution and
the 3x3 sharpening kernel (counterpart of ``tpuimage.ops.restore``).

tpuimage has no Pallas kernel for any of them, so they are plain tensor
ops on every device, written in the arithmetic of tpuimage's jitted
programs: the Retinex blur's multiply-adds fused (XLA's CPU compiler
fuses each product into the add that takes it), ``gray / 255`` a product
with the f32 reciprocal, and the Richardson-Lucy convolution as 25
shifted f32 multiply-adds in true-convolution order (no cuDNN call, whose
TF32 default would make the card differ from the host). The logarithm is
the correctly rounded one, which XLA's f32 log need not be, and XLA's
convolution order is its own: the tests hold these two within a stated
bound.
"""
from __future__ import annotations

import numpy as np
import torch

from tpuimage_torch.core.borders import BORDER_CONSTANT, pad2d
from tpuimage_torch.core.dtypes import f32, saturate_u8
from tpuimage_torch.ops.filters import gaussian_blur_f32, get_gaussian_kernel

_RECIP_255 = float(np.float32(1.0) / np.float32(255.0))


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 log, correctly rounded (through f64) on every device and thread
    count: PyTorch's f32 log takes a vector or a scalar path by where an
    element falls in a thread's chunk, which differ in the last place."""
    return torch.log(x.double()).to(torch.float32)


def single_scale_retinex(rgb: torch.Tensor, sigma: float = 80.0) -> torch.Tensor:
    """r = log(I + 1) - log(G_sigma(I + 1) + 1) on each image of an (...,
    H, W, 3) uint8 tensor, each channel min-max scaled to 0..255 and
    truncated. The blur is OpenCV's f32 kernel (sigma 80: 641 taps),
    reflect-101 past the image's own size as numpy pads."""
    img = f32(rgb) + 1.0
    blur = gaussian_blur_f32(img, ksize=0, sigma=sigma, channels_last=True, fma=True)
    retinex = _log_f32(img) - _log_f32(blur + 1.0)
    mn = torch.amin(retinex, dim=(-3, -2), keepdim=True)
    ch = retinex - mn
    mx = torch.amax(ch, dim=(-3, -2), keepdim=True)
    out = ch * (torch.full_like(mx, 255.0) / torch.clamp(mx, min=1e-12))
    return torch.clamp(out, 0, 255).to(torch.uint8)


def _conv2_same(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """2-D 'same' true convolution of each (H, W) plane with zero padding
    (scipy's ``convolve(mode='same')``): the flipped kernel's taps in row
    order, each a product and an add in f32."""
    kh, kw = k.shape
    h, w = x.shape[-2], x.shape[-1]
    p = pad2d(x, (kh - 1) // 2, kh // 2, (kw - 1) // 2, kw // 2, mode=BORDER_CONSTANT)
    kf = k[::-1, ::-1]
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            term = p[..., dy:dy + h, dx:dx + w] * float(kf[dy, dx])
            acc = term if acc is None else acc + term
    return acc


def richardson_lucy_gray(gray: torch.Tensor, iterations: int = 20, psf_size: int = 5,
                         psf_sigma: float = 1.0) -> torch.Tensor:
    """skimage's richardson_lucy on each (H, W) uint8 plane / 255 with a
    Gaussian PSF (the outer product of cv2.getGaussianKernel), from 0.5,
    clipped back to uint8 by truncation."""
    k1 = get_gaussian_kernel(psf_size, psf_sigma)
    psf = np.outer(k1, k1).astype(np.float32)
    psf_mirror = psf[::-1, ::-1]
    img = f32(gray) * _RECIP_255
    im = torch.full_like(img, 0.5)
    for _ in range(iterations):
        conv = _conv2_same(im, psf)
        relative_blur = img / torch.clamp(conv, min=1e-12)
        im = im * _conv2_same(relative_blur, psf_mirror)
    return torch.clamp(im * 255.0, 0, 255).to(torch.uint8)


_SHARPEN_3X3 = ((0, -1, 0), (-1, 5, -1), (0, -1, 0))


def sharpen_kernel_3x3(rgb: torch.Tensor) -> torch.Tensor:
    """filter2D with [[0,-1,0],[-1,5,-1],[0,-1,0]] (reflect-101,
    saturating) on an (H, W) or (..., H, W, C) uint8 tensor; exact
    integers in f32."""
    planes = rgb[..., None] if rgb.dim() == 2 else rgb
    x = f32(planes.movedim(-1, -3))
    h, w = x.shape[-2], x.shape[-1]
    p = pad2d(x, 1, 1, 1, 1)
    acc = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            acc = acc + p[..., dy:dy + h, dx:dx + w] * float(_SHARPEN_3X3[dy][dx])
    out = saturate_u8(acc).movedim(-3, -1)
    return out[..., 0] if rgb.dim() == 2 else out.contiguous()
