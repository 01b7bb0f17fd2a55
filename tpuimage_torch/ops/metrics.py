"""Quality metrics: PSNR, MSE, SSIM and brightness / contrast
(counterpart of ``tpuimage.ops.metrics``; cv2.PSNR and skimage's
``structural_similarity`` with its defaults for uint8 inputs).

An image is (H, W) gray or (H, W, C) colour, as in tpuimage; the first
``batch_dims`` axes of a tensor index images, and each function then
gives one value (or map) per image, never one over the batch.

The window sums of SSIM (x, x*x, x*y over 7x7) are integers below 2**24
for uint8 inputs, so they are exact in f32 in any order, and are then
scaled as tpuimage's jitted programs scale them: times the f32
reciprocal of the window's area (XLA's compiler turns the division by a
constant into that product), each variance ``S * r - u * v`` as one
fused multiply-add. Means over an image are taken in float64, then
rounded to f32.
"""
from __future__ import annotations

import torch

from tpuimage_torch.core.dtypes import f32, fma_f32
from tpuimage_torch.ops.filters import box_sums_valid


def _image_dims(x: torch.Tensor, batch_dims: int):
    return tuple(range(batch_dims, x.dim()))


def _mean(x: torch.Tensor, batch_dims: int) -> torch.Tensor:
    return x.double().mean(dim=_image_dims(x, batch_dims)).to(torch.float32)


def mse(a: torch.Tensor, b: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    d = f32(a) - f32(b)
    return _mean(d * d, batch_dims)


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0,
         batch_dims: int = 0) -> torch.Tensor:
    """cv2.PSNR: 10 log10(max**2 / MSE); inf where the images are equal."""
    m = mse(a, b, batch_dims)
    return 10.0 * torch.log10(torch.full_like(m, max_val * max_val) / m)


def ssim_map(a: torch.Tensor, b: torch.Tensor, win_size: int = 7,
             data_range: float = 255.0, k1: float = 0.01, k2: float = 0.03,
             batch_dims: int = 0) -> torch.Tensor:
    """The per-pixel SSIM map over the valid region: (..., H - win + 1,
    W - win + 1[, C])."""
    colour = a.dim() - batch_dims == 3
    x, y = f32(a), f32(b)
    if colour:
        x, y = x.movedim(-1, -3), y.movedim(-1, -3)
    npix = win_size * win_size
    cov_norm = npix / (npix - 1.0)
    r = torch.tensor(1.0 / npix, dtype=torch.float32, device=x.device)
    ux = box_sums_valid(x, win_size) * r
    uy = box_sums_valid(y, win_size) * r

    def cov(s, u, v):       # cov_norm * (S * r - u * v), the bracket one fused multiply-add
        return cov_norm * fma_f32(s, r, -(u * v).double())

    vx = cov(box_sums_valid(x * x, win_size), ux, ux)
    vy = cov(box_sums_valid(y * y, win_size), uy, uy)
    vxy = cov(box_sums_valid(x * y, win_size), ux, uy)
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    m = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return m.movedim(-3, -1) if colour else m


def ssim(a: torch.Tensor, b: torch.Tensor, win_size: int = 7, data_range: float = 255.0,
         k1: float = 0.01, k2: float = 0.03, batch_dims: int = 0) -> torch.Tensor:
    """skimage.metrics.structural_similarity(a, b) with its defaults: the
    mean of :func:`ssim_map` (over the channels too for colour)."""
    return _mean(ssim_map(a, b, win_size, data_range, k1, k2, batch_dims), batch_dims)


def image_stats(gray: torch.Tensor, batch_dims: int = 0):
    """Landscape.py get_image_stats: brightness = mean, contrast = std."""
    g = gray.double()
    dims = _image_dims(g, batch_dims)
    return {"brightness": g.mean(dim=dims).to(torch.float32),
            "contrast": g.std(dim=dims, correction=0).to(torch.float32)}
