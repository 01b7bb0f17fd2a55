"""The notebook's modules 1-7 (counterpart of
``tpuimage.pipelines.modules``), each with the notebook cell's parameters
and op order:

1. enhancement: CLAHE 4.0 on Lab L, a percentile stretch over all
   channels at once, unsharp 1.2;
2. restoration: median 3, coloured NLM (h 10), an optional 3x3 sharpen;
3. geometry: rotate, scale, translate, the automatic perspective
   correction (Canny, the largest 4-gon contour, a warp to its own size);
4. segmentation: a global or adaptive threshold, OR'd Canny edges, a
   closing or opening;
5. colour: an HSV or YCrCb round trip, then CLAHE 2.0 on Lab L;
6. features: Canny, the Sobel magnitude and phase statistics, the
   Laplacian variance;
7. compression: JPEG q30/60/90 and PNG l0/5/9 sweeps with their sizes.

An entry point takes an array to ``device`` (default the card, which must
exist) and runs a tensor where it is; modules 1, 2, 4, 5 and 6 take
(..., H, W, 3) with leading batch dims (module 1's percentiles are each
image's own), module 3 one (H, W[, 3]) image, as tpuimage runs it op by
op on the host's side of its jit. Module 7 writes files with PIL, imported
inside the function. On the card the modules run the ``rgb_to_lab``,
``hist256``, ``clahe_apply`` and ``gaussian_blur_u8`` kernels.

Module 1's stretch takes its percentiles as tpuimage's jitted program
does: the interpolation's low product fused into the add.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from tpuimage_torch.core.device import as_input
from tpuimage_torch.core.dtypes import f32
from tpuimage_torch.detect import contours as cnt
from tpuimage_torch.ops import color, geometry
from tpuimage_torch.ops.arith import add_weighted, bitwise_or
from tpuimage_torch.ops.edges import canny, laplacian_variance, magnitude, phase, sobel
from tpuimage_torch.ops.filters import gaussian_blur_u8
from tpuimage_torch.ops.histogram import clahe, percentile
from tpuimage_torch.ops.median import median_blur
from tpuimage_torch.ops.morphology import (MORPH_RECT, morph_close, morph_open,
                                           structuring_element)
from tpuimage_torch.ops.nlm import nlm_denoise_colored
from tpuimage_torch.ops.restore import sharpen_kernel_3x3
from tpuimage_torch.ops.threshold import adaptive_threshold, threshold_binary


def _lab_l_clahe(rgb: torch.Tensor, clip: float, tiles=(8, 8)) -> torch.Tensor:
    lab = color.rgb_to_lab(rgb)
    lum = clahe(lab[..., 0], clip_limit=clip, tiles_x=tiles[0], tiles_y=tiles[1])
    return color.lab_to_rgb_l(lum, lab[..., 1:])


# --- module 1: enhancement (cell 12) ----------------------------------------

def module1_enhance(rgb, use_clahe: bool = True, clahe_clip: float = 4.0,
                    percentiles: Tuple[float, float] = (2, 98), use_unsharp: bool = True,
                    unsharp_radius: int = 1, unsharp_amount: float = 1.2,
                    device=None) -> torch.Tensor:
    x = as_input(rgb, device)
    if use_clahe:
        x = _lab_l_clahe(x, clahe_clip)
    if percentiles is not None:
        # cell 12's contrast_stretch: the percentiles over all of an image's values
        xf = f32(x)
        flat = xf.reshape(xf.shape[:-3] + (-1,))
        lo = percentile(flat, percentiles[0])[..., None, None, None]
        hi = percentile(flat, percentiles[1])[..., None, None, None]
        x = torch.clamp((xf - lo) * 255.0 / (hi - lo), 0, 255).to(torch.uint8)
    if use_unsharp:
        blurred = gaussian_blur_u8(x, ksize=unsharp_radius * 2 + 1, channels_last=True)
        x = add_weighted(x, 1.0 + unsharp_amount, blurred, -unsharp_amount, 0.0)
    return x


# --- module 2: restoration (cell 13) ----------------------------------------

def module2_restore(rgb, use_median: bool = True, median_ksize: int = 3, use_nlm: bool = True,
                    nlm_h: float = 10.0, nlm_h_color: float = 10.0, use_deblur: bool = False,
                    device=None) -> torch.Tensor:
    x = as_input(rgb, device)
    if use_median:
        x = median_blur(x, median_ksize, channels_last=True)
    if use_nlm:
        x = nlm_denoise_colored(x, nlm_h, nlm_h_color)
    if use_deblur:
        x = sharpen_kernel_3x3(x)
    return x


# --- module 3: geometry (cell 14) -------------------------------------------

def module3_transform(rgb, rotation_angle: float = 0.0, scale_factor: float = 1.0,
                      translate: Tuple[float, float] = (0, 0), use_perspective: bool = False,
                      device=None) -> torch.Tensor:
    """Rotate about the centre, scale (bilinear), translate, then
    optionally :func:`auto_perspective_correction`, on one image."""
    x = as_input(rgb, device)
    if rotation_angle:
        x = geometry.rotate(x, rotation_angle)
    if scale_factor != 1.0:
        h, w = int(x.shape[0]), int(x.shape[1])
        x = geometry.resize(x, int(h * scale_factor), int(w * scale_factor), "linear")
    if translate != (0, 0):
        x = geometry.translate(x, translate[0], translate[1])
    if use_perspective:
        x = auto_perspective_correction(x)
    return x


def auto_perspective_correction(rgb, device=None) -> torch.Tensor:
    """Cell 14: Gaussian 5 -> Canny 50/150 -> the largest contour whose
    approxPolyDP (2% of its perimeter) is a 4-gon -> a warp to that quad's
    own width and height. The image back unchanged when none is found."""
    x = as_input(rgb, device)
    edges = canny(gaussian_blur_u8(color.rgb_to_gray(x), ksize=5), 50, 150).cpu().numpy()
    found = cnt.find_external_contours(edges)
    for c in sorted(found, key=cnt.contour_area, reverse=True):
        approx = cnt.approx_poly_dp(c, 0.02 * cnt.arc_length(c, True), True)
        if len(approx) != 4:
            continue
        pts = np.asarray(approx, np.float64).reshape(4, 2)
        s = pts.sum(axis=1)
        d = pts[:, 1] - pts[:, 0]
        rect = np.array([pts[np.argmin(s)], pts[np.argmin(d)],
                         pts[np.argmax(s)], pts[np.argmax(d)]], np.float32)
        tl, tr, br, bl = rect
        mw = max(int(np.linalg.norm(br - bl)), int(np.linalg.norm(tr - tl)))
        mh = max(int(np.linalg.norm(tr - br)), int(np.linalg.norm(tl - bl)))
        if mw < 2 or mh < 2:
            continue
        dst = np.array([[0, 0], [mw - 1, 0], [mw - 1, mh - 1], [0, mh - 1]], np.float32)
        try:
            M = geometry.get_perspective_transform(rect, dst)
        except np.linalg.LinAlgError:
            continue  # a degenerate quad (repeated or collinear corners)
        return geometry.warp_perspective(x, M, mh, mw)
    return x


# --- module 4: segmentation (cell 15) ---------------------------------------

def module4_segment(rgb, use_global: bool = False, global_value: int = 127,
                    block_size: int = 15, C: int = 5, use_canny: bool = True,
                    morph_op: str = "close", morph_ksize: int = 3, morph_iters: int = 1,
                    device=None) -> torch.Tensor:
    gray = color.rgb_to_gray(as_input(rgb, device))
    if use_global:
        seg = threshold_binary(gray, global_value)
    else:
        seg = adaptive_threshold(gray, 255, "gaussian", block_size, C)
    if use_canny:
        seg = bitwise_or(seg, canny(gray, 50, 150))
    if morph_iters > 0:
        se = structuring_element(MORPH_RECT, morph_ksize)
        fn = morph_close if morph_op == "close" else morph_open
        seg = fn(seg, se, iterations=morph_iters)
    return seg


# --- module 5: colour (cell 16) ---------------------------------------------

def module5_color(rgb, space: str = "LAB", clahe_clip: float = 2.0,
                  device=None) -> torch.Tensor:
    """A gray (H, W) image is taken as RGB; the HSV and YCrCb round trips
    are lossy in uint8 as cv2's are; then CLAHE on Lab L."""
    x = as_input(rgb, device)
    if x.dim() == 2:
        x = color.gray_to_rgb(x)
    if space.upper() == "HSV":
        x = color.hsv_to_rgb(color.rgb_to_hsv(x))
    elif space.upper() == "YCRCB":
        x = color.ycrcb_to_rgb(color.rgb_to_ycrcb(x))
    return _lab_l_clahe(x, clahe_clip)


# --- module 6: features (cells 8 and 17) ------------------------------------

def module6_features(rgb, device=None) -> Dict[str, torch.Tensor]:
    """Canny edges, the mean and standard deviation of the Sobel gradient's
    magnitude and angle (degrees), and the Laplacian's variance, per image
    of an (..., H, W, 3) RGB tensor (or of a gray (H, W) plane); the
    statistics in f32."""
    x = as_input(rgb, device)
    gray = color.rgb_to_gray(x) if x.dim() >= 3 else x
    gx = sobel(gray, 1, 0)
    gy = sobel(gray, 0, 1)
    mag = magnitude(gx, gy)
    ang = phase(gx, gy, degrees=True)
    dims = (-2, -1)
    return {
        "edge_map": canny(gray, 50, 150),
        "grad_magnitude_mean": mag.mean(dim=dims),
        "grad_magnitude_std": mag.std(dim=dims, unbiased=False),
        "grad_angle_mean": ang.mean(dim=dims),
        "grad_angle_std": ang.std(dim=dims, unbiased=False),
        "laplacian_variance": laplacian_variance(gray),
    }


# --- module 7: compression sweep (cell 18) ----------------------------------

def module7_compress(rgb, out_dir: str, jpeg_qualities=(30, 60, 90),
                     png_levels=(0, 5, 9)) -> Dict[str, int]:
    """Save the JPEG and PNG sweeps of one (H, W, 3) image under
    ``out_dir``; returns {file name: bytes}."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    arr = rgb.cpu().numpy() if isinstance(rgb, torch.Tensor) else np.asarray(rgb)
    im = Image.fromarray(arr)
    sizes: Dict[str, int] = {}
    for q in jpeg_qualities:
        p = os.path.join(out_dir, f"compressed_jpeg_q{q}.jpg")
        im.save(p, "JPEG", quality=q)
        sizes[os.path.basename(p)] = os.path.getsize(p)
    for lvl in png_levels:
        p = os.path.join(out_dir, f"compressed_png_l{lvl}.png")
        im.save(p, "PNG", compress_level=lvl)
        sizes[os.path.basename(p)] = os.path.getsize(p)
    return sizes
