"""Border handling matching OpenCV border types (counterpart of
``tpuimage.core.borders``).

Unlike tpuimage's ``pad2d`` (HW or HWC), this one pads the LAST two dims
of a (..., H, W) tensor, so leading dims are a batch. Reflect-101,
reflect and replicate are index gathers built with numpy's own pad rules, so they
take any dtype and any pad width, exactly as ``jnp.pad`` does.
"""
from __future__ import annotations

import numpy as np
import torch

BORDER_REFLECT_101 = "reflect"   # cv2.BORDER_DEFAULT / BORDER_REFLECT_101
BORDER_REPLICATE = "edge"        # cv2.BORDER_REPLICATE
BORDER_REFLECT = "symmetric"     # cv2.BORDER_REFLECT
BORDER_CONSTANT = "constant"     # cv2.BORDER_CONSTANT


def _pad_index(n: int, before: int, after: int, mode: str) -> np.ndarray:
    return np.pad(np.arange(n), (before, after), mode=mode)


def pad2d(img: torch.Tensor, top: int, bottom: int, left: int, right: int,
          mode: str = BORDER_REFLECT_101, value=0) -> torch.Tensor:
    """Pad the last two (H, W) dims of a (..., H, W) tensor."""
    if mode == BORDER_CONSTANT:
        h, w = img.shape[-2], img.shape[-1]
        out = torch.full(img.shape[:-2] + (h + top + bottom, w + left + right),
                         value, dtype=img.dtype, device=img.device)
        out[..., top:top + h, left:left + w] = img
        return out
    if mode not in (BORDER_REFLECT_101, BORDER_REPLICATE, BORDER_REFLECT):
        raise ValueError(f"unsupported border mode {mode!r}")
    iy = _pad_index(img.shape[-2], top, bottom, mode)
    ix = _pad_index(img.shape[-1], left, right, mode)
    iy = torch.from_numpy(iy).to(img.device)
    ix = torch.from_numpy(ix).to(img.device)
    return img.index_select(-2, iy).index_select(-1, ix)
