"""A preset (``presets.loader``) applied as an op chain (counterpart of
``tpuimage.presets.apply``).

The op semantics are tpuimage's, the standard OpenCV formulation of each
field. The appliers take (..., H, W, 3) uint8 RGB (the enhancement
applier also a gray (..., H, W) plane with ``gray=True``); leading dims
are a batch and the gray-world means are each image's own. An entry
point takes an array to ``device`` (default the card, which must exist)
and runs a tensor where it is. On the card the CLAHE and equalisation
stages run the ``rgb_to_lab``, ``hist256`` and ``clahe_apply`` kernels;
the rest are plain tensor ops (tpuimage has no kernel for them).

The arithmetic is that of tpuimage's jitted appliers: ``/ 255`` a
product with the f32 reciprocal, a product feeding an add fused into it
(the chroma excursion, the local-contrast add, the highlight curve's
blend), ``pow`` by 2 or 3 as products, XLA's f32 means as the sums its
tree reduce rounds times the f32 reciprocal. The enhancement applier's L blends are
functions of two bytes and so tables built once with numpy in that
arithmetic. ``pow`` and ``log1p`` are taken in f64 and rounded to f32
(correctly rounded, the same on every device and thread count).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tpuimage_torch.core.device import as_input
from tpuimage_torch.core.dtypes import f32, fma_f32, fma_np, pow_np, saturate_u8, xla_sum_f32
from tpuimage_torch.ops import color
from tpuimage_torch.ops.filters import gaussian_blur_f32
from tpuimage_torch.ops.histogram import clahe, equalize_hist
from tpuimage_torch.presets.loader import CategorizationPreset, EnhancementPreset

_F32 = np.float32
_RECIP_255 = _F32(1.0) / _F32(255.0)


def _apply_luminance(rgb: torch.Tensor, fn) -> torch.Tensor:
    lab = color.rgb_to_lab(rgb)
    return color.lab_to_rgb_l(fn(lab[..., 0]), lab[..., 1:])


def _channel_means(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 mean over (H, W) of each channel of byte-valued (..., H,
    W, C): the sum as XLA's tree reduce rounds it (:func:`xla_sum_f32`;
    past 2**24 it is not the exact sum) times the f32 reciprocal."""
    n = int(x.shape[-3]) * int(x.shape[-2])
    return xla_sum_f32(x.movedim(-1, -3)) * float(_F32(1.0) / _F32(n))


def _highlight_curve(l: torch.Tensor, mode: str) -> torch.Tensor:
    """The top half of L bent toward sqrt (or log), ``mild_sqrt`` at half
    strength: saturate((ln * (1 - t) + curved * t) * 255)."""
    ln = f32(l) * float(_RECIP_255)
    if mode == "log":
        curved = (torch.log1p((ln * 9.0).double()).to(torch.float32)
                  * float(_F32(1.0) / _F32(np.log(10.0))))
    else:
        curved = torch.sqrt(ln)
    t = torch.clamp((ln - 0.5) * 2.0, 0.0, 1.0)
    if mode == "mild_sqrt":
        t = t * 0.5
    return saturate_u8(fma_f32(curved, t, (ln * (1.0 - t)).double()) * 255.0)


def _local_contrast(l: torch.Tensor, radius: float, amount: float,
                    threshold: float) -> torch.Tensor:
    """Thresholded unsharp on L: saturate(l + amount * detail), detail =
    l - blur(l) where |detail| > threshold."""
    lf = f32(l)
    blur = gaussian_blur_f32(lf, ksize=0, sigma=radius, fma=True)
    detail = lf - blur
    detail = torch.where(torch.abs(detail) > threshold, detail, torch.zeros_like(detail))
    return saturate_u8(fma_f32(detail, torch.tensor(amount, device=l.device), lf.double()))


def apply_categorization_preset(rgb, preset: CategorizationPreset, device=None) -> torch.Tensor:
    """brightness -> contrast -> saturation -> white balance -> chroma ->
    highlight compression -> local contrast -> optional invert, on (...,
    H, W, 3) uint8 RGB."""
    p = preset
    rgb = as_input(rgb, device)
    x = f32(rgb)
    # brightness: a linear beta, or a gamma curve on [0, 1]
    if p.brightness_mode == "linear":
        x = x + p.brightness_beta
    elif p.brightness_mode == "gamma":
        base = torch.clamp(x * float(_RECIP_255), 0.0, 1.0).double()
        x = torch.pow(base, p.brightness_gamma).to(torch.float32) * 255.0
    if p.linear_boost_beta:
        x = x + p.linear_boost_beta
    x = saturate_u8(x)
    # contrast: an alpha gain about 0, or CLAHE on Lab L
    if p.contrast_mode == "alpha":
        x = saturate_u8(f32(x) * p.contrast_alpha)
    elif p.contrast_mode == "clahe":
        x = _apply_luminance(x, lambda l: clahe(l, clip_limit=p.clahe_clip,
                                                tiles_x=p.clahe_tiles[0],
                                                tiles_y=p.clahe_tiles[1]))
    # saturation with its cap: S *= min(mult, 1 + cap)
    if p.saturation_mult != 1.0:
        mult = min(p.saturation_mult, 1.0 + p.saturation_cap)
        hsv = color.rgb_to_hsv(x)
        s = saturate_u8(f32(hsv[..., 1]) * mult)
        x = color.hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))
    # gray-world white balance with clamped gains
    if p.gray_world:
        means = _channel_means(x)
        gain = ((means[..., :1] + means[..., 1:2]) + means[..., 2:]) * float(_F32(1.0) / _F32(3.0))
        gain = gain / torch.clamp(means, min=1e-6)
        gain = torch.clamp(gain, p.gain_clamp[0], p.gain_clamp[1])
        x = saturate_u8(f32(x) * gain[..., None, None, :])
    # chroma boost: Cr and Cb excursions about 128 scaled in YCrCb
    if p.chroma_boost_cb != 1.0 or p.chroma_boost_cr != 1.0:
        ycc = f32(color.rgb_to_ycrcb(x))
        mid = torch.tensor(128.0, dtype=torch.float64, device=ycc.device)
        cr = fma_f32(ycc[..., 1] - 128.0, torch.tensor(p.chroma_boost_cr), mid)
        cb = fma_f32(ycc[..., 2] - 128.0, torch.tensor(p.chroma_boost_cb), mid)
        x = color.ycrcb_to_rgb(saturate_u8(torch.stack([ycc[..., 0], cr, cb], dim=-1)))
    # highlight compression on the top half of L
    if p.highlight_compression in ("sqrt", "log", "mild_sqrt"):
        x = _apply_luminance(x, lambda l: _highlight_curve(l, p.highlight_compression))
    # local contrast: a thresholded unsharp on L
    if p.local_contrast:
        x = _apply_luminance(x, lambda l: _local_contrast(l, p.lc_radius, p.lc_amount,
                                                          p.lc_threshold))
    if p.invert:
        x = 255 - x
    return x


@functools.lru_cache(maxsize=None)
def luminance_blend_table(sky_power: float, blend: float) -> np.ndarray:
    """(256, 256) uint8: entry [l, c] is the blended L for original L = l
    and equalised / CLAHE L = c, cvRounded. With ``sky_power`` > 0 the
    sky protection (Landscape.py): w = (1 - (l / 255) ** power) * blend,
    ``1 - x ** p`` fused; else w = blend. Of ``c * w + l * (1 - w)`` the
    ``l * (1 - w)`` product is fused into the add, as in tpuimage's jitted
    applier."""
    lo = np.arange(256, dtype=_F32)[:, None]
    lc = np.arange(256, dtype=_F32)[None, :]
    if sky_power > 0:
        left, right = pow_np(lo * _RECIP_255, sky_power)
        t = fma_np(-left, right, _F32(1)) if right is not None else _F32(1) - left
        w = t * _F32(blend)
        val = fma_np(lo, _F32(1) - w, lc * w)
    else:
        val = fma_np(lo, _F32(1) - _F32(blend), lc * _F32(blend))
    return np.clip(np.rint(val), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _table_on(sky_power: float, blend: float, device: str) -> torch.Tensor:
    return torch.from_numpy(luminance_blend_table(sky_power, blend)).reshape(-1).to(device)


def apply_enhancement_preset(rgb, preset: EnhancementPreset, gray: bool = False,
                             device=None) -> torch.Tensor:
    """contrast stretch (alpha) -> histogram modification (equalisation
    or CLAHE) on Lab L, or on the plane itself with ``gray``, with the
    optional sky-protection blend -> optional invert."""
    p = preset
    x = as_input(rgb, device)
    if p.contrast_alpha != 1.0:
        x = saturate_u8(f32(x) * p.contrast_alpha)
    if p.hist_method in ("equalization", "clahe"):
        lab = None if gray else color.rgb_to_lab(x)
        lum = x if gray else lab[..., 0]
        if p.hist_method == "equalization":
            l2 = equalize_hist(lum)
        else:
            l2 = clahe(lum, clip_limit=p.clahe_clip, tiles_x=p.clahe_tiles[0],
                       tiles_y=p.clahe_tiles[1])
        if p.sky_protection_power > 0 or p.blend_strength < 1.0:
            power = p.sky_protection_power if p.sky_protection_power > 0 else 0.0
            table = _table_on(float(power), float(p.blend_strength), str(x.device))
            l2 = table[lum.to(torch.int64) * 256 + l2.to(torch.int64)]
        if gray:
            x = l2
        else:
            x = color.lab_to_rgb_l(l2, lab[..., 1:])
    if p.invert:
        x = 255 - x
    return x
