"""cv2.medianBlur for an odd ksize, written apart from the port's
transposition network: the k*k shifted views of the replicate-padded
plane stacked on a new last dim and sorted, the middle one taken. Exact
on uint8: a sort moves values and computes none."""
from __future__ import annotations

import torch

from portbench.reference.core.borders import BORDER_REPLICATE, pad2d


def median_blur(img: torch.Tensor, ksize: int, channels_last: bool = False) -> torch.Tensor:
    """The median of each pixel's ksize x ksize window, the border
    replicated, on each (H, W) plane of a (..., H, W) tensor, or of a
    (..., H, W, C) tensor with ``channels_last``."""
    if ksize % 2 != 1:
        raise ValueError("medianBlur requires an odd ksize")
    if channels_last:
        return median_blur(img.movedim(-1, -3), ksize).movedim(-3, -1)
    r = ksize // 2
    p = pad2d(img, r, r, r, r, mode=BORDER_REPLICATE)
    h, w = img.shape[-2], img.shape[-1]
    views = torch.stack([p[..., dy:dy + h, dx:dx + w]
                         for dy in range(ksize) for dx in range(ksize)], dim=-1)
    return torch.sort(views, dim=-1).values[..., ksize * ksize // 2]
