"""The notebook's document restoration (counterpart of
``tpuimage.pipelines.docrestore``, cells 3-10): quad correction ->
denoise (median 3 + coloured NLM) -> CLAHE 2.0 on Lab L -> each channel's
(2, 98) percentile stretch -> unsharp 0.8 -> optional Richardson-Lucy
deblur -> adaptive-threshold segmentation -> edge overlay -> the clean
scan (text from the sharpened gray on white) -> JPEG / PNG variants ->
PSNR and SSIM against the corrected gray, written to ``metrics.csv``.

The device core (:func:`_enhance_core`, ``restore.richardson_lucy_gray``,
:func:`_segment_and_final`) takes tensors, (..., H, W, 3) and (..., H, W)
with leading batch dims; on the card it runs the ``rgb_to_lab``,
``hist256``, ``clahe_apply`` and ``gaussian_blur_u8`` kernels.
:func:`process_image` and :func:`main_process` read and write files
through ``io.imageio`` (PIL inside the functions) and run the core on
``device`` (default the card, which must exist). The stretch takes its
percentiles as tpuimage's jitted core does: the interpolation's low
product fused into the add.
"""
from __future__ import annotations

import csv
import glob
import os
from typing import Dict

import torch

from tpuimage_torch.core.device import resolve_device
from tpuimage_torch.core.dtypes import f32
from tpuimage_torch.io.imageio import ensure_dir, load_image_rgb, save_image
from tpuimage_torch.ops import color, geometry
from tpuimage_torch.ops.arith import add_weighted
from tpuimage_torch.ops.edges import canny
from tpuimage_torch.ops.filters import gaussian_blur_u8
from tpuimage_torch.ops.histogram import clahe, percentile
from tpuimage_torch.ops.median import median_blur
from tpuimage_torch.ops.metrics import psnr, ssim
from tpuimage_torch.ops.morphology import MORPH_RECT, morph_open, structuring_element
from tpuimage_torch.ops.nlm import nlm_denoise_colored
from tpuimage_torch.ops.restore import richardson_lucy_gray
from tpuimage_torch.ops.threshold import adaptive_threshold
from tpuimage_torch.pipelines.modules import auto_perspective_correction

_OPEN_2X2 = structuring_element(MORPH_RECT, 2)


def _enhance_core(warped: torch.Tensor):
    """Cells 5-6: median 3 + NLM (h 10) -> CLAHE 2.0 on Lab L -> each
    channel's (2, 98) stretch -> unsharp 0.8 (sigma 1, k 7). Returns
    (denoised, CLAHE'd, sharpened)."""
    den = _denoise(warped)
    cl = _clahe_l(den)
    return den, cl, _stretch_sharpen(cl)


def _denoise(warped: torch.Tensor) -> torch.Tensor:
    """The core's head: median 3, then the coloured NLM (h 10)."""
    return nlm_denoise_colored(median_blur(warped, 3, channels_last=True), 10.0, 10.0)


def _clahe_l(den: torch.Tensor) -> torch.Tensor:
    """CLAHE 2.0 at 8x8 tiles on Lab L."""
    lab = color.rgb_to_lab(den)
    lum = clahe(lab[..., 0], clip_limit=2.0, tiles_x=8, tiles_y=8)
    return color.lab_to_rgb_l(lum, lab[..., 1:])


def _stretch_sharpen(cl: torch.Tensor) -> torch.Tensor:
    """The core's tail: each channel's (2, 98) stretch, then unsharp 0.8."""
    x = f32(cl)
    h, w = x.shape[-3], x.shape[-2]
    vals = x.reshape(x.shape[:-3] + (h * w, 3)).transpose(-1, -2)
    lo = percentile(vals, 2)[..., None, None, :]
    hi = percentile(vals, 98)[..., None, None, :]
    scale = torch.full_like(hi, 255.0) / torch.clamp(hi - lo, min=1e-8)
    stretched = torch.clamp((x - lo) * scale, 0, 255).to(torch.uint8)
    blurred = gaussian_blur_u8(stretched, ksize=0, sigma=1.0, channels_last=True)
    return add_weighted(stretched, 1.8, blurred, -0.8, 0.0)


def _segment_and_final(gray: torch.Tensor):
    """Cell 6's segment_text (adaptive Gaussian 25 / 10, a 2x2 opening) and
    cell 9's clean scan (the gray where the segmentation is text, white
    elsewhere); also the Canny (50, 150) edges. Returns (seg, final,
    edges)."""
    seg = adaptive_threshold(gray, 255, "gaussian", 25, 10)
    seg = morph_open(seg, _OPEN_2X2)
    final = torch.where(seg < 128, gray, torch.full_like(gray, 255))
    return seg, final, canny(gray, 50, 150)


def process_image(path_in: str, out_root: str = "outputs", max_dim: int = 2000,
                  do_deblur: bool = False, device=None) -> Dict[str, float]:
    """Cell 9's process_image: the stage files under corrected/,
    enhanced/, segmented/ and final/ of ``out_root``; returns {basename,
    psnr, ssim}."""
    from PIL import Image
    dev = resolve_device(device)
    rgb = geometry.resize_long_side(torch.from_numpy(load_image_rgb(path_in)), max_dim)
    base = os.path.splitext(os.path.basename(path_in))[0]
    dirs = {k: os.path.join(out_root, k) for k in ("corrected", "enhanced", "segmented", "final")}
    for d in dirs.values():
        ensure_dir(d)

    warped = auto_perspective_correction(rgb.to(dev))
    save_image(os.path.join(dirs["corrected"], f"{base}_corrected.png"), warped)

    den, _, sharp = _enhance_core(warped)
    save_image(os.path.join(dirs["enhanced"], f"{base}_denoised.png"), den)
    save_image(os.path.join(dirs["enhanced"], f"{base}_enhanced.png"), sharp)

    gray_sharp = color.rgb_to_gray(sharp)
    if do_deblur:
        gray_sharp = richardson_lucy_gray(gray_sharp, iterations=15)
        save_image(os.path.join(dirs["enhanced"], f"{base}_deblurred.png"),
                   color.gray_to_rgb(gray_sharp))

    seg, final_gray, edges = _segment_and_final(gray_sharp)
    save_image(os.path.join(dirs["segmented"], f"{base}_seg.png"), seg)

    overlay = warped.cpu().numpy().copy()
    overlay[edges.cpu().numpy() > 0] = (255, 0, 0)
    save_image(os.path.join(dirs["enhanced"], f"{base}_edges_overlay.png"), overlay)

    final_rgb = color.gray_to_rgb(final_gray).cpu().numpy()
    save_image(os.path.join(dirs["final"], f"{base}_final.png"), final_rgb)
    for q in (80, 60):
        Image.fromarray(final_rgb).save(
            os.path.join(dirs["final"], f"{base}_final_q{q}.jpg"), "JPEG", quality=q)
    Image.fromarray(final_rgb).save(
        os.path.join(dirs["final"], f"{base}_final_lossless.png"), "PNG", compress_level=0)

    ref_gray = color.rgb_to_gray(warped)
    return {"basename": base, "psnr": float(psnr(ref_gray, final_gray)),
            "ssim": float(ssim(ref_gray, final_gray))}


def main_process(input_folder: str, output_root: str = "outputs", do_deblur: bool = False,
                 device=None) -> str:
    """Cell 9's main_process: every .jpg/.jpeg/.png/.bmp of the folder
    through :func:`process_image` (a failing image is reported and
    skipped, as the notebook's handler does), then ``metrics.csv``."""
    files = []
    for e in ("*.jpg", "*.jpeg", "*.png", "*.bmp"):
        files.extend(sorted(glob.glob(os.path.join(input_folder, e))))
    rows = []
    for f in files:
        try:
            rows.append(process_image(f, output_root, do_deblur=do_deblur, device=device))
        except Exception as e:  # per-image isolation, as the notebook's handler
            print(f"Failed {f}: {e}")
    csv_path = os.path.join(output_root, "metrics.csv")
    ensure_dir(output_root)
    with open(csv_path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["basename", "psnr", "ssim"])
        w.writeheader()
        w.writerows(rows)
    return csv_path
