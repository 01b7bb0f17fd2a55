"""The GUI's night route (``AI_classification.py`` ``_run_night_enhance``,
asm.py's math): median 3x3 on the colour image, RGB -> Lab, CLAHE on L,
Lab -> RGB. Built from the reference's own Lab, CLAHE and median (a sort,
not the port's network); imports nothing of the port or of JAX."""
from __future__ import annotations

import torch

from portbench.reference.ops import color
from portbench.reference.ops.histogram import clahe
from portbench.reference.ops.median import median_blur


def night_gui(rgb: torch.Tensor, s: dict) -> torch.Tensor:
    """(..., H, W, 3) uint8 RGB -> the route's enhanced RGB, with the
    configuration's settings ``s``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    filtered = median_blur(rgb, s["median_ksize"], channels_last=True).contiguous()
    lab = color.rgb_to_lab(filtered)
    tiles_x, tiles_y = s["clahe_tile_grid"]
    l_enh = clahe(lab[..., 0], clip_limit=s["clahe_clip_limit"], tiles_x=tiles_x,
                  tiles_y=tiles_y)
    return color.lab_to_rgb(torch.cat([l_enh[..., None], lab[..., 1:]], dim=-1))
