"""FaceEnhancement: the noise-adaptive portrait pipeline (counterpart of
``tpuimage.pipelines.face``).

- :func:`noise_kurtosis` / :func:`classify_noise_type` — the kurtosis of
  the median residuals; the host branches on ``k > 5`` (impulse);
- :func:`face_pre_eyes` — the dual denoise (Gaussian k 5 / 9, median 3 /
  5, or the legacy NLM), the YCrCb skin mask, the masked blend and the
  glamour bilateral (radius 15);
- :func:`pixel_pop_eyes` — median 3, CLAHE 0.2 at 4x4 tiles on Lab L,
  details 0.5 and a feathered elliptical alpha, per eye box;
- :func:`face_post_eyes` — saturation, warmth, then CLAHE 0.5 and the
  d 5 bilateral (gaussian) or the L stretch (otherwise), and the masked
  sharpening of the script tail;
- :func:`enhance_face` — the whole path, Haar eyes when none are given.

An entry point takes an array to ``device`` (default the card, which must
exist) and runs a tensor where it is; on the card the path runs the
``bilateral``, ``gaussian_blur_u8``, ``rgb_to_lab``, ``hist256`` and
``clahe_apply`` kernels. The stages take (..., H, W, 3) tensors: leading
dims are a batch in place of tpuimage's ``vmap``.

The float blends truncate to bytes, so the port computes them as
tpuimage's jitted programs do: ``mask / 255`` is a product with the f32
reciprocal, and of ``a * m + b * (1 - m)`` the ``a * m`` product is fused
into the add (``fma_f32``), at every call site of ``blend_masked`` in both
programs and in the eye blend, whose alpha is ``soft * f32(f32(1 / 255) *
0.1)`` (the constants folded). The eye's ellipse is tested as XLA folds
it: ``x * f32(1 / a)`` squared and added, each step rounded.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from tpuimage_torch.core.device import as_input
from tpuimage_torch.core.dtypes import f32, fma_f32, trunc_u8
from tpuimage_torch.detect.haar import detect_eyes
from tpuimage_torch.ops import color
from tpuimage_torch.ops.arith import add_weighted, in_range, normalize_minmax
from tpuimage_torch.ops.bilateral import bilateral_filter
from tpuimage_torch.ops.filters import gaussian_blur_u8
from tpuimage_torch.ops.histogram import clahe
from tpuimage_torch.ops.lut import lut_lookup_u8
from tpuimage_torch.ops.median import median_blur
from tpuimage_torch.ops.morphology import MORPH_ELLIPSE, dilate, morph_open, structuring_element
from tpuimage_torch.ops.nlm import nlm_denoise_colored

# FaceEnhancement.py:8-12
BILATERAL_SIGMA_COLOR = 30
BILATERAL_SIGMA_SPACE = 10
SHARPEN_AMOUNT = 2.0
SKIN_MASK_THRESHOLD = (0, 133, 77, 255, 173, 127)
COLOR_SATURATION = 1.20

VARIANTS = ("script", "gui")

_ELLIPSE5 = structuring_element(MORPH_ELLIPSE, 5)
_F32 = np.float32
_RECIP_255 = float(_F32(1.0) / _F32(255.0))                # m / 255 in the programs
_EYE_ALPHA = float(_F32(_F32(1.0) / _F32(255.0)) * _F32(0.1))   # soft / 255 * 0.1, folded


def _fused_blend(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """trunc(a * m + b * (1 - m)) with the ``a * m`` product fused."""
    return trunc_u8(fma_f32(f32(a), m, f32(b) * (1.0 - m)))


# ---------------------------------------------------------------------------
# noise classification (FaceEnhancement.py:55-96)
# ---------------------------------------------------------------------------

def noise_kurtosis(rgb, device=None) -> torch.Tensor:
    """Pearson kurtosis of the residual gray - median3(gray), per image of
    an (..., H, W, 3) RGB tensor (or of one (H, W) gray plane): f32, summed
    in f64 (the reference's numpy precision; tpuimage sums in f32)."""
    x = as_input(rgb, device)
    gray = color.rgb_to_gray(x) if x.dim() >= 3 else x
    resid = gray.to(torch.float64) - median_blur(gray, 3).to(torch.float64)
    mean = resid.mean(dim=(-2, -1), keepdim=True)
    var = ((resid - mean) ** 2).mean(dim=(-2, -1))
    fourth = ((resid - mean) ** 4).mean(dim=(-2, -1))
    k = torch.where(var > 0, fourth / torch.clamp(var * var, min=1e-20),
                    torch.zeros_like(var))
    return k.to(torch.float32)


def classify_noise_type(rgb, device=None) -> str:
    """The host's branch, as the reference's: kurtosis > 5 -> impulse."""
    k = float(noise_kurtosis(rgb, device))
    return "impulse" if k > 5.0 else "gaussian"


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def get_refined_skin_mask(rgb, device=None) -> torch.Tensor:
    """FaceEnhancement.py:101-122: the YCrCb skin box, an open and two
    dilations with the 5x5 ellipse, feathered by a 21x21 Gaussian;
    (..., H, W) uint8."""
    ycrcb = color.rgb_to_ycrcb(as_input(rgb, device))
    mask = in_range(ycrcb, SKIN_MASK_THRESHOLD[:3], SKIN_MASK_THRESHOLD[3:])
    mask = morph_open(mask, _ELLIPSE5)
    mask = dilate(mask, _ELLIPSE5, iterations=2)
    return gaussian_blur_u8(mask, ksize=21, sigma=0.0)


def blend_masked(a, b, mask_u8, device=None) -> torch.Tensor:
    """(a * mask + b * (1 - mask)) truncated to uint8, mask in [0, 255]
    (a colour ``a`` takes a plane mask per pixel)."""
    a, b, mask_u8 = (as_input(t, device) for t in (a, b, mask_u8))
    m = f32(mask_u8) * _RECIP_255
    if a.dim() > mask_u8.dim():
        m = m[..., None]
    return _fused_blend(a, b, m)


def apply_glamour_skin(rgb, mask_u8, device=None) -> torch.Tensor:
    """FaceEnhancement.py:127-144: the colour bilateral d -1, 30/10
    (radius 15), blended in under the skin mask."""
    x = as_input(rgb, device)
    smooth = bilateral_filter(x, -1, BILATERAL_SIGMA_COLOR, BILATERAL_SIGMA_SPACE)
    return blend_masked(smooth, x, as_input(mask_u8, device))


def enhance_details(rgb, amount: float = 1.0, device=None) -> torch.Tensor:
    """FaceEnhancement.py:149-168: unsharp on Lab L (sigma 3)."""
    lab = color.rgb_to_lab(as_input(rgb, device))
    lum = lab[..., 0]
    blurred = gaussian_blur_u8(lum, ksize=0, sigma=3.0)
    sharp = add_weighted(lum, 1.0 + amount, blurred, -amount, 0.0)
    return color.lab_to_rgb(torch.cat([sharp[..., None], lab[..., 1:]], dim=-1))


@functools.lru_cache(maxsize=None)
def _saturation_table(saturation: float, device: str) -> torch.Tensor:
    """The reference's float64 product, clipped and truncated, per S byte."""
    return torch.from_numpy(np.clip(np.arange(256, dtype=np.float64) * saturation, 0, 255)
                            .astype(np.uint8)).to(device)


def adjust_saturation(rgb, saturation: float = 1.0, device=None) -> torch.Tensor:
    """FaceEnhancement.py:235-249: S scaled in float64 (a host-built table),
    through the 8-bit HSV round trip (not a no-op at 1.0)."""
    hsv = color.rgb_to_hsv(as_input(rgb, device))
    s = lut_lookup_u8(_saturation_table(float(saturation), str(hsv.device)), hsv[..., 1])
    return color.hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


def apply_warmth(rgb, amount: float = 10.0, device=None) -> torch.Tensor:
    """FaceEnhancement.py:251-264: R += amount, B -= amount * 0.05, in f32,
    truncated."""
    x = f32(as_input(rgb, device))
    return trunc_u8(torch.stack([x[..., 0] + amount, x[..., 1], x[..., 2] + (-amount * 0.05)],
                                dim=-1))


def apply_contrast_stretching(rgb, device=None) -> torch.Tensor:
    """FaceEnhancement.py:266-278: NORM_MINMAX on Lab L."""
    lab = color.rgb_to_lab(as_input(rgb, device))
    lum = normalize_minmax(lab[..., 0])
    return color.lab_to_rgb(torch.cat([lum[..., None], lab[..., 1:]], dim=-1))


def apply_histogram_equalization(rgb, device=None) -> torch.Tensor:
    """FaceEnhancement.py:281-295: CLAHE 0.5 at 8x8 tiles on Lab L."""
    lab = color.rgb_to_lab(as_input(rgb, device))
    lum = clahe(lab[..., 0], clip_limit=0.5, tiles_x=8, tiles_y=8)
    return color.lab_to_rgb(torch.cat([lum[..., None], lab[..., 1:]], dim=-1))


def apply_masked_sharpening(rgb, mask_u8, amount: float = 1.0, device=None) -> torch.Tensor:
    """FaceEnhancement.py:297-312: details at ``amount`` on the face, half
    of it on the background."""
    x = as_input(rgb, device)
    face = enhance_details(x, amount=amount)
    bg = enhance_details(x, amount=amount * 0.5)
    return blend_masked(face, bg, as_input(mask_u8, device))


# ---------------------------------------------------------------------------
# eye pop (FaceEnhancement.py:173-230)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def eye_ellipse(h: int, w: int, device: str = "cpu") -> torch.Tensor:
    """(h, w) uint8 on ``device``: 255 inside the filled ellipse of axes
    (w // 2, h // 2) about (w // 2, h // 2), tested in f32 as tpuimage's
    program folds it (made once per shape and device)."""
    ys = np.arange(h, dtype=_F32)[:, None] - _F32(h // 2)
    xs = np.arange(w, dtype=_F32)[None, :] - _F32(w // 2)
    qx = xs * (_F32(1) / _F32(max(w // 2, 1)))
    qy = ys * (_F32(1) / _F32(max(h // 2, 1)))
    inside = qx * qx + qy * qy <= _F32(1)
    return torch.from_numpy(np.where(inside, np.uint8(255), np.uint8(0))).to(device)


def _eye_roi_enhance(roi: torch.Tensor) -> torch.Tensor:
    """One (h, w, 3) eye region: median 3, CLAHE 0.2 at 4x4 tiles on Lab L,
    details 0.5, blended in at 10% under the feathered ellipse."""
    h, w = roi.shape[0], roi.shape[1]
    r = median_blur(roi, 3, channels_last=True)
    lab = color.rgb_to_lab(r)
    lum = clahe(lab[..., 0], clip_limit=0.2, tiles_x=4, tiles_y=4)
    enh = color.lab_to_rgb(torch.cat([lum[..., None], lab[..., 1:]], dim=-1))
    enh = enhance_details(enh, amount=0.5)
    soft = gaussian_blur_u8(eye_ellipse(h, w, str(roi.device)), ksize=31, sigma=0.0)
    return eye_blend(enh, r, soft)


def eye_blend(enh: torch.Tensor, r: torch.Tensor, soft: torch.Tensor) -> torch.Tensor:
    """trunc(enh * alpha + r * (1 - alpha)), alpha = soft / 255 * 0.1 per
    pixel of the (h, w) feathered ellipse ``soft``."""
    return _fused_blend(enh, r, (f32(soft) * _EYE_ALPHA)[..., None])


def pixel_pop_eyes(rgb, eyes: List[Tuple[int, int, int, int]], device=None) -> torch.Tensor:
    """Each (x, y, w, h) box of one (H, W, 3) image enhanced in turn, as the
    reference's loop does (a box past the edge is cut to the image, an
    empty one skipped, a later box sees an earlier one's output). The
    boxes are slices of the tensor where it lies: nothing goes to the
    host."""
    out = as_input(rgb, device).clone()
    for (x, y, w, h) in eyes:
        roi = out[y:y + h, x:x + w]
        if roi.numel() == 0:
            continue
        out[y:y + h, x:x + w] = _eye_roi_enhance(roi)
    return out


# ---------------------------------------------------------------------------
# full pipelines
# ---------------------------------------------------------------------------

def face_pre_eyes(rgb, noise_type: str = "gaussian", device=None) -> Dict[str, torch.Tensor]:
    """The stages up to the eye pop on (..., H, W, 3) uint8 RGB."""
    x = as_input(rgb, device)
    if noise_type == "gaussian":
        light = gaussian_blur_u8(x, ksize=5, channels_last=True)
        strong = gaussian_blur_u8(x, ksize=9, channels_last=True)
    elif noise_type == "impulse":
        light = median_blur(x, 3, channels_last=True)
        strong = median_blur(x, 5, channels_last=True)
    else:  # the legacy NLM (FaceEnhancement.py:351-360)
        light = nlm_denoise_colored(x, 10.0, 10.0)
        strong = nlm_denoise_colored(x, 30.0, 30.0)
    mask = get_refined_skin_mask(light)
    combined = blend_masked(light, strong, mask)
    skin = apply_glamour_skin(combined, mask)
    return {"denoised_light": light, "denoised_strong": strong, "skin_mask": mask,
            "denoised_combined": combined, "skin_enhanced": skin}


def face_post_eyes(rgb, mask, noise_type: str = "gaussian", variant: str = "script",
                   device=None) -> torch.Tensor:
    """The tone, colour and sharpening tail after the eye pop.

    variant='script': FaceEnhancement.py:387-440 (gaussian ends with the
    masked sharpening at 2.0); variant='gui': AI_classification.py:744-768
    (saturation 1.2 for gaussian, 1.0 otherwise, which still runs the HSV
    round trip; gaussian ends at the bilateral polish)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    x = as_input(rgb, device)
    mask = as_input(mask, device)
    if variant == "gui":
        x = adjust_saturation(x, COLOR_SATURATION if noise_type == "gaussian" else 1.0)
    else:
        x = adjust_saturation(x, COLOR_SATURATION)
    x = apply_warmth(x, 15.0)
    if noise_type == "gaussian":
        x = apply_histogram_equalization(x)        # CLAHE 0.5
        x = bilateral_filter(x, 5, 20, 20)         # polish
        if variant == "script":
            x = apply_masked_sharpening(x, mask, amount=SHARPEN_AMOUNT)
        return x
    # impulse (and legacy): the stretch; impulse skips the sharpening
    x = apply_contrast_stretching(x)
    if noise_type != "impulse" and variant == "script":
        x = apply_masked_sharpening(x, mask, amount=SHARPEN_AMOUNT)
    return x


def enhance_face(rgb, noise_type: str | None = None,
                 eyes: List[Tuple[int, int, int, int]] | None = None,
                 variant: str = "script", device=None) -> Dict[str, object]:
    """The whole face path on one (H, W, 3) uint8 RGB image.

    ``noise_type=None`` classifies the noise; ``eyes=None`` runs the Haar
    eye detector (``tpuimage_torch.detect.haar``) on the gray image fetched
    to the host, and ``eyes=[]`` skips the eye pop. Returns tpuimage's
    keys; the images are tensors on the image's device."""
    x = as_input(rgb, device)
    if noise_type is None:
        noise_type = classify_noise_type(x)
    pre = face_pre_eyes(x, noise_type=noise_type)
    skin = pre["skin_enhanced"]
    if eyes is None:
        eyes = detect_eyes(color.rgb_to_gray(x).cpu().numpy())
    popped = pixel_pop_eyes(skin, eyes)
    final = face_post_eyes(popped, pre["skin_mask"], noise_type=noise_type, variant=variant)
    return {"noise_type": noise_type, "eyes": eyes, "skin_mask": pre["skin_mask"],
            "skin_enhanced": skin, "features_popped": popped, "final": final}
