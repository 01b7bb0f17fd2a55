"""Landscape enhancement and the degrade / restore evaluation (counterpart
of ``tpuimage.pipelines.landscape``).

- :func:`enhance_image` — Landscape.py's enhance_image with
  :data:`ENHANCEMENT_PRESET`: bilateral denoise, CLAHE on Lab L with the
  sky-protection blend, unsharp mask;
- :func:`landscape_gui` — the GUI's landscape route (bilateral 9/100/75,
  CLAHE 2.2 with sky power 2 and blend 0.55, unsharp 0.8);
- :func:`landscape_eval_step` / :func:`landscape_eval_batch` — the
  reference's batch loop: enhance the original; degrade it, restore it
  (``is_noisy``); PSNR and gray SSIM of each, per image.

Leading dims are a batch in place of tpuimage's ``vmap``. An entry point
takes an array to ``device`` (default the card, which must exist) and runs
a tensor where it is. On the card the path runs the ``bilateral``,
``rgb_to_lab``, ``hist256``, ``clahe_apply`` and ``gaussian_blur_u8``
kernels.

The float blends truncate to bytes (``trunc_u8``), so the port computes
them as tpuimage's jitted programs do, where XLA's compiler turns a
division by a constant into a product with its f32 reciprocal, ``pow`` by
2 or 3 into products, and fuses a product into the add or subtract that
takes it. The sky blend is a function of two bytes (L and its CLAHE
value) and the degrade's contrast-and-gamma step of one, so both are
tables built once with numpy in that arithmetic; the rest runs op for op
(``degrade_image``'s noise add as one fused multiply-add).

``degrade_image`` takes its noise as a tensor, or draws it from a
``torch.Generator``: tpuimage draws it from ``jax.random``, a stream torch
cannot reproduce.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpuimage_torch.core.device import as_input
from tpuimage_torch.core.dtypes import f32, fma_f32, fma_np, pow_np, trunc_u8
from tpuimage_torch.ops import color
from tpuimage_torch.ops.arith import add_weighted
from tpuimage_torch.ops.bilateral import bilateral_filter
from tpuimage_torch.ops.filters import gaussian_blur_u8
from tpuimage_torch.ops.histogram import clahe
from tpuimage_torch.ops.median import median_blur
from tpuimage_torch.ops.metrics import psnr, ssim
from tpuimage_torch.ops.nlm import nlm_denoise_colored

# Landscape.py's preset (the GUI hard-codes the same values)
ENHANCEMENT_PRESET = {
    "denoising": {"enabled": True, "method": "bilateral", "kernel_size": 5},
    "clahe": {"enabled": True, "clip_limit": 2.2, "tile_grid_size": (8, 8),
              "sky_protection_power": 2.0, "blend_strength": 0.55},
    "sharpening": {"enabled": True, "amount": 0.8, "radius": 1.0},
    "degradation": {"contrast_reduction": 0.7, "underexposure": 0.85,
                    "noise_amount": 10, "saturation_reduction": 0.85},
}

_F32 = np.float32
_RECIP_255 = _F32(1.0) / _F32(255.0)   # x / 255 in the jitted programs


@functools.lru_cache(maxsize=None)
def sky_blend_table(sky_power: float, blend: float) -> np.ndarray:
    """(256, 256) uint8: entry [l, c] is the sky-protected L for original
    L = l and CLAHE L = c: trunc(c * w + l * (1 - w)) with w = (1 -
    (l / 255) ** sky_power) * blend, in the f32 of tpuimage's jitted
    programs (``enhance_contrast_clahe``, ``enhance_image``,
    ``landscape_gui`` and the vmapped evaluation alike): ``1 - x ** p``
    fused, and of the sum's two products the ``l * (1 - w)`` one fused
    into the add. (The blend's lines jitted alone fuse the other product.)"""
    lo = np.arange(256, dtype=_F32)[:, None]
    lc = np.arange(256, dtype=_F32)[None, :]
    left, right = pow_np(lo * _RECIP_255, sky_power)
    t = fma_np(-left, right, _F32(1)) if right is not None else _F32(1) - left
    ew = t * _F32(blend)
    val = fma_np(lo, _F32(1) - ew, lc * ew)
    return np.clip(val, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def degrade_tone_table(contrast: float, underexposure: float) -> np.ndarray:
    """(256,) uint8: degrade_image's first step for each byte v,
    trunc(((v / 255) * contrast + (1 - contrast) / 2) ** (1 / underexposure)
    * 255) in the jitted program's f32."""
    x = fma_np(np.arange(256, dtype=_F32) * _RECIP_255, _F32(contrast),
                _F32(0.5 * (1.0 - contrast)))
    left, right = pow_np(np.maximum(x, _F32(0)), 1.0 / underexposure)
    x = left * right if right is not None else left
    return np.clip(x * _F32(255), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _table_on(make, params: tuple, device: str) -> torch.Tensor:
    """``make(*params)``, flattened, on ``device`` (made once)."""
    return torch.from_numpy(np.ascontiguousarray(make(*params))).reshape(-1).to(device)


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.to(torch.int64)]


def degrade_image(rgb, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None, config=None,
                  device=None) -> torch.Tensor:
    """Landscape.py degrade_image on (..., H, W, 3) uint8 RGB: contrast,
    underexposure, desaturation in HSV, Gaussian noise. ``noise`` is a
    standard normal f32 tensor of the image's shape; without it the noise
    is drawn from ``generator`` (the default generator when None)."""
    x = as_input(rgb, device)
    cfg = config or ENHANCEMENT_PRESET["degradation"]
    tone = _table_on(degrade_tone_table, (cfg.get("contrast_reduction", 0.6),
                                          cfg.get("underexposure", 0.8)), str(x.device))
    hsv = color.rgb_to_hsv(_lookup(tone, x))
    sat = trunc_u8(f32(hsv[..., 1]) * cfg.get("saturation_reduction", 0.8))
    rgb2 = color.hsv_to_rgb(torch.stack([hsv[..., 0], sat, hsv[..., 2]], dim=-1))
    y = f32(rgb2) * float(_RECIP_255)
    noise_level = cfg.get("noise_amount", 15)
    if noise_level > 0:
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                                device=x.device)
        elif tuple(noise.shape) != tuple(x.shape):
            raise ValueError(f"noise {tuple(noise.shape)} for an image {tuple(x.shape)}")
        level = torch.tensor(noise_level / 255.0, dtype=torch.float32, device=x.device)
        y = fma_f32(noise.to(device=x.device, dtype=torch.float32), level, y.double())
    return trunc_u8(y * 255.0)


def denoise_image(rgb: torch.Tensor, method: str = "median", kernel_size: int = 5,
                  is_noisy: bool = False) -> torch.Tensor:
    """Landscape.py denoise_image on (..., H, W, 3) uint8 RGB."""
    if method == "median":
        return median_blur(rgb, kernel_size + 2 if is_noisy else kernel_size,
                           channels_last=True)
    if method == "bilateral":
        sigma = 100 if is_noisy else 75
        return bilateral_filter(rgb, 11 if is_noisy else 9, sigma, sigma)
    if method == "nlmeans":
        h = 15.0 if is_noisy else 10.0
        return nlm_denoise_colored(rgb, h, h)
    return rgb


def enhance_contrast_clahe(rgb: torch.Tensor, clip_limit: float = 2.5,
                           tile_grid: Tuple[int, int] = (8, 8), sky_power: float = 3.0,
                           blend: float = 0.6) -> torch.Tensor:
    """Landscape.py: CLAHE on Lab L, blended back with the sky protection
    (bright L keeps more of itself), then Lab -> RGB."""
    lab = color.rgb_to_lab(rgb)
    l_orig = lab[..., 0]
    l_clahe = clahe(l_orig, clip_limit=clip_limit, tiles_x=tile_grid[0], tiles_y=tile_grid[1])
    table = _table_on(sky_blend_table, (float(sky_power), float(blend)), str(rgb.device))
    l_final = _lookup(table, l_orig.to(torch.int32) * 256 + l_clahe)
    return color.lab_to_rgb(torch.cat([l_final[..., None], lab[..., 1:]], dim=-1))


def sharpen_image(rgb: torch.Tensor, amount: float = 1.5, radius: float = 1.0) -> torch.Tensor:
    """Landscape.py: unsharp mask, GaussianBlur((0, 0), radius) per channel."""
    blurred = gaussian_blur_u8(rgb, ksize=0, sigma=radius, channels_last=True)
    return add_weighted(rgb, 1.0 + amount, blurred, -amount, 0.0)


def calculate_metrics(before: torch.Tensor, after: torch.Tensor):
    """Landscape.py: (cv2.PSNR over RGB, SSIM of the gray images), one value
    per (H, W, 3) image of the (..., H, W, 3) tensors."""
    batch = before.dim() - 3
    return (psnr(before, after, batch_dims=batch),
            ssim(color.rgb_to_gray(before), color.rgb_to_gray(after), batch_dims=batch))


def _enhance(rgb: torch.Tensor, is_noisy: bool, preset) -> torch.Tensor:
    p = preset
    cur = rgb
    if p["denoising"]["enabled"]:
        cur = denoise_image(cur, p["denoising"]["method"], p["denoising"]["kernel_size"],
                            is_noisy)
    if p["clahe"]["enabled"]:
        cur = enhance_contrast_clahe(cur, p["clahe"]["clip_limit"],
                                     p["clahe"]["tile_grid_size"],
                                     p["clahe"]["sky_protection_power"],
                                     p["clahe"]["blend_strength"])
    if p["sharpening"]["enabled"]:
        amount = p["sharpening"]["amount"] * (0.7 if is_noisy else 1.0)
        cur = sharpen_image(cur, amount, p["sharpening"]["radius"])
    return cur


def enhance_image(rgb, is_noisy: bool = False, device=None) -> torch.Tensor:
    """Landscape.py enhance_image with :data:`ENHANCEMENT_PRESET`, on
    (..., H, W, 3) uint8 RGB."""
    return _enhance(as_input(rgb, device), is_noisy, ENHANCEMENT_PRESET)


def landscape_gui(rgb, device=None) -> torch.Tensor:
    """The GUI's landscape route: bilateral 9/100/75, CLAHE (2.2, sky 2,
    blend 0.55), unsharp 0.8."""
    cur = bilateral_filter(as_input(rgb, device), 9, 100, 75)
    cur = enhance_contrast_clahe(cur, 2.2, (8, 8), 2.0, 0.55)
    return sharpen_image(cur, 0.8, 1.0)


def landscape_eval_step(rgb, generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None,
                        device=None) -> Dict[str, torch.Tensor]:
    """One iteration of the reference's batch loop on (..., H, W, 3) uint8
    RGB: enhance the original; degrade it (``noise`` / ``generator`` as in
    :func:`degrade_image`) and restore it; the stage images and each
    image's PSNR and SSIM."""
    x = as_input(rgb, device)
    enhanced = enhance_image(x, is_noisy=False)
    p1_psnr, p1_ssim = calculate_metrics(x, enhanced)
    degraded = degrade_image(x, generator, noise)
    restored = enhance_image(degraded, is_noisy=True)
    p2_psnr, p2_ssim = calculate_metrics(degraded, restored)
    return {"original": x, "enhanced": enhanced, "degraded": degraded, "restored": restored,
            "psnr_enhanced": p1_psnr, "ssim_enhanced": p1_ssim,
            "psnr_restored": p2_psnr, "ssim_restored": p2_ssim}


landscape_eval_batch = landscape_eval_step
