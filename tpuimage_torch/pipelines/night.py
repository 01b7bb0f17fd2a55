"""Night-landscape low-light pipelines (counterpart of
``tpuimage.pipelines.night``).

- :func:`night_gray` — NightLandscapeEnhancement: median 3x3, then
  CLAHE(clip 2.0, 8x8).
- :func:`night_rgb` — asm.py: median 3x3 on the colour image, CLAHE(2.0,
  8x8) on the Lab L channel, merge back, Lab -> RGB.
- :func:`night_gui` — the GUI's night route, the same math as night_rgb.

Leading dims are a batch in place of tpuimage's ``vmap``, so the
``*_batch`` names are the same functions. On the card night_rgb runs the
``rgb_to_lab``, ``hist256`` and ``clahe_apply`` kernels, night_gray the
last two. Stage keys as tpuimage's: ``original``, ``filtered``,
``enhanced``; the stages are tensors on the device the path ran on.
night_rgb records the spans ``night.gui`` > ``night.upload``,
``night.median``, ``night.lab``, ``night.clahe``, ``night.lab_to_rgb``
(``runtime.profiling``).
"""
from __future__ import annotations

from typing import Dict

import torch

from tpuimage_torch.core.device import as_input
from tpuimage_torch.ops.color import lab_to_rgb, rgb_to_lab
from tpuimage_torch.ops.histogram import clahe
from tpuimage_torch.ops.median import median_blur
from tpuimage_torch.runtime.profiling import span

CLIP_LIMIT = 2.0
TILES = 8


def night_gray(gray, device=None) -> Dict[str, torch.Tensor]:
    """uint8 (..., H, W) -> stage dict. An array goes to ``device``
    (default the card, which must exist); a tensor runs where it is."""
    g = as_input(gray, device)
    filtered = median_blur(g, 3)
    enhanced = clahe(filtered, clip_limit=CLIP_LIMIT, tiles_x=TILES, tiles_y=TILES)
    return {"original": g, "filtered": filtered, "enhanced": enhanced}


def night_rgb(rgb, device=None) -> Dict[str, torch.Tensor]:
    """uint8 (..., H, W, 3) RGB -> stage dict. The Lab math is
    channel-order-agnostic: asm.py's BGR2LAB on BGR equals rgb_to_lab on
    RGB. Device rule as for :func:`night_gray`."""
    with span("night.gui"):
        with span("night.upload"):
            x = as_input(rgb, device)
        with span("night.median"):
            filtered = median_blur(x, 3, channels_last=True).contiguous()
        with span("night.lab"):
            lab = rgb_to_lab(filtered)
        with span("night.clahe"):
            l_enh = clahe(lab[..., 0], clip_limit=CLIP_LIMIT, tiles_x=TILES, tiles_y=TILES)
        with span("night.lab_to_rgb"):
            enhanced = lab_to_rgb(torch.cat([l_enh[..., None], lab[..., 1:]], dim=-1))
        return {"original": x, "filtered": filtered, "enhanced": enhanced}


night_gui = night_rgb
night_gray_batch = night_gray
night_rgb_batch = night_rgb
