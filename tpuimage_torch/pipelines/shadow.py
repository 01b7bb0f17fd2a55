"""Unified shadow-protected enhancement (counterpart of
``tpuimage.pipelines.shadow``, the notebook's cell 19).

- :class:`ShadowPreset` and :data:`PRESETS` (DOCUMENT / NIGHT / PORTRAIT /
  GENERAL);
- :func:`auto_categorize` and its checks: NIGHT when the mean HSV V is
  under 80, DOCUMENT when > 70% of V is over 230 and > 1.5% of the
  Laplacian over 150, PORTRAIT when asked to look for faces and Haar
  finds one, else GENERAL;
- the stages: :func:`get_shadow_mask_brightness` (V under the threshold,
  ellipse-5 close, f32 Gaussian, / 255), :func:`adaptive_clahe` (CLAHE on
  Lab L where the mask is bright), :func:`contrast_stretch_rgb` (each
  channel's percentiles), :func:`adaptive_unsharp`;
- :func:`enhance_shadow_protected` (mask -> optional Retinex blend ->
  CLAHE -> stretch -> unsharp -> the final shadow-preserving blend),
  :func:`enhance_image` (categorise, then the preset's path; returns
  ``(final, mask, category)``) and :func:`enhance_shadow_batch`.

The stages take (..., H, W, 3) tensors: leading dims are a batch in place
of tpuimage's ``vmap``, and each image takes its own percentiles. An
entry point takes an array to ``device`` (default the card, which must
exist) and runs a tensor where it is. On the card the path runs the
``rgb_to_lab``, ``hist256``, ``clahe_apply`` and ``gaussian_blur_u8``
kernels; the rest (the f32 blurs, the Retinex, the percentile sort) are
plain tensor ops, as tpuimage has no kernel for them.

The blends truncate to bytes, so the port computes them as tpuimage's
jitted programs do: the mask's blur fuses each tap's multiply-add (XLA's
CPU compiler fuses a product into the add that takes it), ``soft / 255``
is a product with the f32 reciprocal, ``mask * strength`` folds the two
constants, and of each blend's two products the second is fused into the
add, found against copies of those programs, single and vmapped alike.
One exception: XLA recomputes a stage inside every fusion that reads it,
and where the unsharp's add reads the stretch's blend (DOCUMENT,
GENERAL) that fusion rounds its first product instead, while the
unsharp's blur still reads the second; so with an unsharp the stretch is
computed both ways. The categorisation's means are exact counts (or
integer sums) times the f32 reciprocal of the pixel count, as XLA
computes ``jnp.mean``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpuimage_torch.core.device import as_input
from tpuimage_torch.core.dtypes import f32, fma_f32, trunc_u8
from tpuimage_torch.ops import color
from tpuimage_torch.ops.arith import add_weighted
from tpuimage_torch.ops.edges import laplacian
from tpuimage_torch.ops.filters import gaussian_blur_f32, gaussian_blur_u8
from tpuimage_torch.ops.histogram import clahe, percentile
from tpuimage_torch.ops.morphology import MORPH_ELLIPSE, morph_close, structuring_element
from tpuimage_torch.ops.restore import single_scale_retinex


@dataclasses.dataclass(frozen=True)
class ShadowPreset:
    """Cell 19 PRESETS fields."""
    shadow_v_threshold: int = 80
    mask_blur_ksize: int = 51
    use_clahe: bool = True
    clahe_clip: float = 3.0
    clahe_tile: Tuple[int, int] = (8, 8)
    use_contrast_stretch: bool = True
    stretch_percentiles: Tuple[float, float] = (2, 98)
    use_retinex: bool = False
    retinex_sigma: float = 80.0
    retinex_blend: float = 0.5
    use_unsharp: bool = True
    unsharp_radius: int = 1
    unsharp_amount: float = 1.0
    final_shadow_blend_strength: float = 1.0
    mode_info: str = ""


PRESETS: Dict[str, ShadowPreset] = {
    "DOCUMENT": ShadowPreset(
        shadow_v_threshold=110, use_clahe=False, clahe_clip=3.0,
        use_contrast_stretch=True, stretch_percentiles=(5, 98),
        use_retinex=True, retinex_sigma=80, retinex_blend=0.6,
        use_unsharp=True, unsharp_amount=0.8,
        final_shadow_blend_strength=0.7,
        mode_info="Focuses on illumination equalization and text protection."),
    "NIGHT": ShadowPreset(
        shadow_v_threshold=80, use_clahe=False, clahe_clip=8.0,
        use_contrast_stretch=True, stretch_percentiles=(1, 99),
        use_retinex=False, retinex_sigma=150, retinex_blend=1.0,
        use_unsharp=False, unsharp_amount=1.5,
        final_shadow_blend_strength=0.0,
        mode_info="Simple global contrast stretch and strong brightening."),
    "PORTRAIT": ShadowPreset(
        shadow_v_threshold=85, use_clahe=True, clahe_clip=2.0,
        use_contrast_stretch=False, use_retinex=False,
        use_unsharp=False, unsharp_amount=0.0,
        final_shadow_blend_strength=0.6,
        mode_info="Gentle contrast boost, preserves natural skin tones."),
    "GENERAL": ShadowPreset(
        shadow_v_threshold=80, use_clahe=True, clahe_clip=3.0,
        use_contrast_stretch=True, stretch_percentiles=(2, 98),
        use_retinex=False, retinex_blend=0.5,
        use_unsharp=True, unsharp_amount=1.0,
        final_shadow_blend_strength=0.5,
        mode_info="Balanced enhancement for overall dynamic range and clarity."),
}

_ELLIPSE5 = structuring_element(MORPH_ELLIPSE, 5)
_F32 = np.float32
_RECIP_255 = float(_F32(1.0) / _F32(255.0))


def _mix(x: torch.Tensor, wx, y: torch.Tensor, wy, fuse_first: bool = False) -> torch.Tensor:
    """f32 ``x * wx + y * wy`` with one product rounded into the add: the
    second, or the first with ``fuse_first``."""
    if fuse_first:
        return fma_f32(x, wx, (y * wy).double())
    return fma_f32(y, wy, (x * wx).double())


# ---------------------------------------------------------------------------
# categorisation (cell 19 section 2)
# ---------------------------------------------------------------------------

def _mean_f32(values: torch.Tensor, n: int) -> torch.Tensor:
    """XLA's f32 mean of integer values: their exact sum, in f32, times
    the f32 reciprocal of the count."""
    total = values.sum(dim=(-2, -1), dtype=torch.int64).to(torch.float32)
    return total * float(_F32(1.0) / _F32(n))


def categorize_cues(rgb, device=None):
    """(v_mean, near_white_ratio, edge_ratio), each f32 of shape (...) for
    an (..., H, W, 3) RGB image: the mean HSV V, the share of V over 230
    and the share of |Laplacian (ksize 1)| over 150 of the gray image."""
    x = as_input(rgb, device)
    v = color.rgb_to_hsv(x)[..., 2]
    n = int(v.shape[-2]) * int(v.shape[-1])
    lap = laplacian(color.rgb_to_gray(x))
    return (_mean_f32(v, n), _mean_f32(v > 230, n), _mean_f32(torch.abs(lap) > 150, n))


def check_night_mode(rgb, threshold: float = 80.0, device=None) -> bool:
    v_mean, _, _ = categorize_cues(rgb, device)
    return float(v_mean) < threshold


def check_document_mode(rgb, bright_ratio: float = 0.7, edge_ratio_min: float = 0.015,
                        device=None) -> bool:
    _, white, edges = categorize_cues(rgb, device)
    return float(white) > bright_ratio and float(edges) > edge_ratio_min


def check_portrait_mode(rgb, detect_faces: bool = False, device=None) -> bool:
    """The reference's check is a placeholder that returns False; with
    ``detect_faces`` the Haar face detector (on the host) decides."""
    if not detect_faces:
        return False
    from tpuimage_torch.detect.haar import detect_faces as haar_faces
    gray = color.rgb_to_gray(as_input(rgb, device)).cpu().numpy()
    return len(haar_faces(gray)) > 0


def auto_categorize(rgb, detect_faces: bool = False, device=None) -> str:
    """NIGHT > DOCUMENT > PORTRAIT > GENERAL for one (H, W, 3) image."""
    x = as_input(rgb, device)
    v_mean, white, edges = (float(c) for c in categorize_cues(x))
    if v_mean < 80.0:
        return "NIGHT"
    if white > 0.7 and edges > 0.015:
        return "DOCUMENT"
    if check_portrait_mode(x, detect_faces):
        return "PORTRAIT"
    return "GENERAL"


# ---------------------------------------------------------------------------
# stages (cell 19 helpers, the truncating casts kept)
# ---------------------------------------------------------------------------

def _shadow_soft(rgb: torch.Tensor, v_threshold: int, blur_ksize: int) -> torch.Tensor:
    """The mask before the / 255: V under the threshold -> 255, ellipse-5
    close, f32 Gaussian with the taps' multiply-adds fused."""
    v = color.rgb_to_hsv(rgb)[..., 2]
    bin_mask = (v < v_threshold).to(torch.uint8) * 255
    closed = morph_close(bin_mask, _ELLIPSE5)
    k = blur_ksize + (blur_ksize % 2 == 0)
    return gaussian_blur_f32(f32(closed), ksize=k, fma=True)


def get_shadow_mask_brightness(rgb: torch.Tensor, v_threshold: int = 70,
                               blur_ksize: int = 51) -> torch.Tensor:
    """Soft f32 [0, 1] mask of each (..., H, W, 3) image, 1 = shadow: V
    under the threshold -> 255, ellipse-5 close, f32 Gaussian, times
    f32(1 / 255)."""
    return _shadow_soft(rgb, v_threshold, blur_ksize) * _RECIP_255


def adaptive_clahe(rgb: torch.Tensor, clahe_clip: float = 3.0,
                   tile_grid: Tuple[int, int] = (8, 8),
                   shadow_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CLAHE on Lab L, blended back toward the original L where the mask
    says shadow."""
    lab = color.rgb_to_lab(rgb)
    lum = lab[..., 0]
    l_clahe = clahe(lum, clip_limit=clahe_clip, tiles_x=tile_grid[0], tiles_y=tile_grid[1])
    if shadow_mask is None:
        l_out = l_clahe
    else:
        bright = torch.clamp(1.0 - shadow_mask, 0.0, 1.0)
        l_out = trunc_u8(_mix(f32(l_clahe), bright, f32(lum), 1.0 - bright))
    return color.lab_to_rgb(torch.cat([l_out[..., None], lab[..., 1:]], dim=-1))


def _channel_values(rgb: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) -> the f32 values of each image's channels, (..., 3,
    H * W)."""
    h, w = rgb.shape[-3], rgb.shape[-2]
    return f32(rgb).reshape(rgb.shape[:-3] + (h * w, 3)).transpose(-1, -2)


def _stretch(rgb: torch.Tensor, percentiles) -> torch.Tensor:
    vals = _channel_values(rgb)
    lo = percentile(vals, percentiles[0])[..., None, None, :]
    hi = percentile(vals, percentiles[1])[..., None, None, :]
    span = hi - lo
    denom = torch.where(span == 0, torch.ones_like(span), span)
    return trunc_u8(torch.clamp((f32(rgb) - lo) * 255.0 / denom, 0, 255))


def _shadow_blend(out: torch.Tensor, rgb: torch.Tensor, mask: torch.Tensor,
                  fuse_first: bool = False) -> torch.Tensor:
    """trunc(out * (1 - m) + rgb * m), the mask over every channel."""
    m = mask[..., None]
    return trunc_u8(_mix(f32(out), 1.0 - m, f32(rgb), m, fuse_first))


def contrast_stretch_rgb(rgb: torch.Tensor, percentiles=(2, 98),
                         shadow_mask: Optional[torch.Tensor] = None,
                         fuse_first: bool = False) -> torch.Tensor:
    """Each channel stretched from its own (lo, hi) percentiles to 0..255,
    truncated; then blended back toward the input where the mask says
    shadow (``fuse_first``: the module docstring's exception)."""
    out = _stretch(rgb, percentiles)
    if shadow_mask is None:
        return out
    return _shadow_blend(out, rgb, shadow_mask, fuse_first)


def adaptive_unsharp(rgb: torch.Tensor, radius: int = 1, amount: float = 1.0,
                     shadow_mask: Optional[torch.Tensor] = None,
                     blur_input: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unsharp mask (channel-last Gaussian k 2r+1, addWeighted), blended
    back toward the input where the mask says shadow. ``blur_input`` is
    the input as the blur reads it, where that differs (the module
    docstring)."""
    ksize = radius * 2 + 1 if radius >= 1 else 3
    blurred = gaussian_blur_u8(rgb if blur_input is None else blur_input, ksize=ksize,
                               channels_last=True)
    sharpened = add_weighted(rgb, 1.0 + amount, blurred, -amount, 0.0)
    if shadow_mask is None:
        return sharpened
    return _shadow_blend(sharpened, rgb, shadow_mask)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _enhance(rgb: torch.Tensor, preset: ShadowPreset):
    cfg = preset
    img = rgb
    soft = _shadow_soft(img, cfg.shadow_v_threshold, cfg.mask_blur_ksize)
    mask = soft * _RECIP_255
    if cfg.use_retinex:
        r = single_scale_retinex(img, sigma=cfg.retinex_sigma)
        img = add_weighted(r, cfg.retinex_blend, img, 1.0 - cfg.retinex_blend, 0.0)
    if cfg.use_clahe:
        img = adaptive_clahe(img, cfg.clahe_clip, cfg.clahe_tile, mask)
    blur_input = None
    if cfg.use_contrast_stretch:
        out = _stretch(img, cfg.stretch_percentiles)
        if cfg.use_unsharp:
            blur_input = _shadow_blend(out, img, mask)
        img = _shadow_blend(out, img, mask, fuse_first=cfg.use_unsharp)
    if cfg.use_unsharp:
        img = adaptive_unsharp(img, cfg.unsharp_radius, cfg.unsharp_amount, mask, blur_input)
    # mask * strength: XLA folds the two constants, soft * f32(f32(1/255) * strength)
    m = torch.clamp(soft * float(_F32(_RECIP_255) * _F32(cfg.final_shadow_blend_strength)),
                    0.0, 1.0)
    return _shadow_blend(img, rgb, m), mask


def enhance_shadow_protected(rgb, preset: ShadowPreset, device=None):
    """Cell 19 enhance_image (the working definition) on one (H, W, 3)
    uint8 RGB image: (final uint8, shadow mask f32 in [0, 1])."""
    x = as_input(rgb, device)
    return _enhance(x, preset)


def enhance_image(rgb, category: Optional[str] = None, detect_faces: bool = False,
                  device=None):
    """Categorise one (H, W, 3) image (unless ``category`` is given), then
    run its preset: (final, mask, category)."""
    x = as_input(rgb, device)
    if category is None:
        category = auto_categorize(x, detect_faces=detect_faces)
    preset = PRESETS.get(category, PRESETS["GENERAL"])
    final, mask = _enhance(x, preset)
    return final, mask, category


def enhance_shadow_batch(rgb_batch, preset: ShadowPreset, device=None):
    """:func:`enhance_shadow_protected` on a (B, H, W, 3) batch, each image
    on its own (its percentiles, its Retinex range), in the arithmetic of
    tpuimage's vmapped program."""
    x = as_input(rgb_batch, device)
    if x.dim() != 4:
        raise ValueError(f"enhance_shadow_batch: expected (B, H, W, 3), got {tuple(x.shape)}")
    return _enhance(x, preset)
