"""Non-Local Means denoising, cv2.fastNlMeansDenoising / ...Colored
(counterpart of ``tpuimage.ops.nlm``; template window 7 and search window
21 at every call site of the reference).

For every search offset t of the window, in tpuimage's order (row-major
over the window), the patch SSD ``D_t = box_7x7((I - shift_t(I))**2)``
(reflect-101 borders) weighs the shifted image by
``exp(-max(D_t - 2 sigma**2 N, 0) / (h**2 N))``, N the patch area times
the channels; the output is the weighted sum over the sum of weights.
The SSDs are integers below 2**24, exact in f32 in any order; the
weighted sums accumulate in f32 in tpuimage's offset order. The colour
form converts to Lab, denoises L with h and (a, b) jointly with h_color,
and converts back.

tpuimage has no Pallas kernel here (441 shifted views fused by XLA), so
plain tensor operations are its port on every device; on the card the
Lab conversion is the ``rgb_to_lab`` kernel.
"""
from __future__ import annotations

import torch

from tpuimage_torch.core.borders import BORDER_REFLECT_101, pad2d
from tpuimage_torch.core.dtypes import f32, saturate_u8
from tpuimage_torch.ops import color
from tpuimage_torch.ops.filters import box_sums_valid


def _box_sum_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sums over the k x k window around each pixel of each (H, W) plane,
    reflect-101 borders (same size)."""
    r = k // 2
    return box_sums_valid(pad2d(x, r, r, r, r, mode=BORDER_REFLECT_101), k)


def nlm_denoise(img: torch.Tensor, h: float, template_size: int = 7, search_size: int = 21,
                sigma: float = 0.0, channels_last: bool = False) -> torch.Tensor:
    """NLM on each uint8 (H, W) plane of a (..., H, W) tensor, or with
    ``channels_last`` on each (H, W, C) image of a (..., H, W, C) tensor
    (the channels weighed jointly); h is the filter strength."""
    x = f32(img)
    if channels_last:
        x = x.movedim(-1, -3)
    sr = search_size // 2
    hh, ww = x.shape[-2], x.shape[-1]
    cn = img.shape[-1] if channels_last else 1
    n = float(template_size * template_size * cn)
    inv = 1.0 / (h * h * n)
    bias = 2.0 * sigma * sigma * n
    p = pad2d(x, sr, sr, sr, sr, mode=BORDER_REFLECT_101)
    num = torch.zeros_like(x)
    den = torch.zeros(x.shape[:-3] + x.shape[-2:] if channels_last else x.shape,
                      dtype=torch.float32, device=x.device)
    for dy in range(search_size):
        for dx in range(search_size):
            view = p[..., dy:dy + hh, dx:dx + ww]
            d = x - view
            ssd = _box_sum_same(d * d, template_size)
            if channels_last:
                ssd = ssd.sum(dim=-3)
            wgt = torch.exp(-torch.clamp(ssd - bias, min=0.0) * inv)
            num = num + view * (wgt.unsqueeze(-3) if channels_last else wgt)
            den = den + wgt
    out = saturate_u8(num / (den.unsqueeze(-3) if channels_last else den))
    return out.movedim(-3, -1) if channels_last else out


def nlm_denoise_colored(img_rgb: torch.Tensor, h: float, h_color: float = None,
                        template_size: int = 7, search_size: int = 21) -> torch.Tensor:
    """cv2.fastNlMeansDenoisingColored on (..., H, W, 3) uint8 RGB: Lab
    split, L with h, (a, b) with h_color (default h)."""
    if h_color is None:
        h_color = h
    lab = color.rgb_to_lab(img_rgb)
    lum = nlm_denoise(lab[..., 0], h, template_size, search_size)
    ab = nlm_denoise(lab[..., 1:], h_color, template_size, search_size, channels_last=True)
    return color.lab_to_rgb(torch.cat([lum[..., None], ab], dim=-1))
