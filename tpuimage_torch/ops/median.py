"""Exact median filtering, cv2.medianBlur (counterpart of
``tpuimage.ops.median``): a replicate border and an odd-even
transposition sort over the k*k shifted views of each plane. The counter
``median.exchanges`` (``runtime.profiling``) counts the compare-exchange
steps enqueued, each a ``torch.minimum`` and a ``torch.maximum``: n rounds
of (n - 1) / 2 over n = k*k views, added once a call."""
from __future__ import annotations

import torch

from tpuimage_torch.core.borders import BORDER_REPLICATE, pad2d
from tpuimage_torch.runtime.profiling import count


def _median_of_views(views):
    """Exact median of an odd number of equal-shaped tensors."""
    v = list(views)
    n = len(v)
    for rnd in range(n):
        for i in range(rnd % 2, n - 1, 2):
            v[i], v[i + 1] = torch.minimum(v[i], v[i + 1]), torch.maximum(v[i], v[i + 1])
    count("median.exchanges", n * (n - 1) // 2)
    return v[n // 2]


def median_blur(img: torch.Tensor, ksize: int, channels_last: bool = False) -> torch.Tensor:
    """cv2.medianBlur (exact) for odd ``ksize`` on each (H, W) plane of a
    (..., H, W) tensor, or of a (..., H, W, C) tensor with
    ``channels_last``, whose channels are filtered independently."""
    if ksize <= 1:
        return img
    if ksize % 2 != 1:
        raise ValueError("medianBlur requires an odd ksize")
    if channels_last:
        return median_blur(img.movedim(-1, -3), ksize).movedim(-3, -1)
    r = ksize // 2
    p = pad2d(img, r, r, r, r, mode=BORDER_REPLICATE)
    h, w = img.shape[-2], img.shape[-1]
    views = [p[..., dy:dy + h, dx:dx + w] for dy in range(ksize) for dx in range(ksize)]
    return _median_of_views(views)
