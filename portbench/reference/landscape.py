"""The GUI's landscape route, frozen from the port's
``pipelines/landscape.py``: the colour bilateral 9/100/75, Lab, CLAHE
2.2 at 8x8 on L blended back with the sky protection (power 2, blend
0.55), Lab -> RGB, the unsharp mask 0.8 (sigma 1)."""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from portbench.reference.core.dtypes import fma_np, pow_np
from portbench.reference.ops import color
from portbench.reference.ops.arith import add_weighted
from portbench.reference.ops.bilateral import bilateral_filter
from portbench.reference.ops.filters import gaussian_blur_u8
from portbench.reference.ops.histogram import clahe

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
def _table_on(make, params: tuple, device: str) -> torch.Tensor:
    """``make(*params)``, flattened, on ``device`` (made once)."""
    return torch.from_numpy(np.ascontiguousarray(make(*params))).reshape(-1).to(device)


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.to(torch.int64)]


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


def landscape_gui(rgb: torch.Tensor, s: dict) -> torch.Tensor:
    """(..., H, W, 3) uint8 RGB -> the GUI route's output, with the
    configuration's settings ``s``."""
    cur = bilateral_filter(rgb, s["bilateral_d"], s["bilateral_sigma_color"],
                           s["bilateral_sigma_space"])
    cur = enhance_contrast_clahe(cur, s["clahe_clip_limit"], tuple(s["clahe_tile_grid"]),
                                 s["sky_protection_power"], s["blend_strength"])
    return sharpen_image(cur, s["sharpen_amount"], s["sharpen_sigma"])
