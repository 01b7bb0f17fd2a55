"""256-bin histograms and Otsu (counterpart of ``tpuimage.ops.histogram``).

``hist256_batch`` is the hand-written CUDA kernel on a CUDA tensor and its
plain ``bincount`` version on a CPU tensor (``ops.kernels``).
"""
from __future__ import annotations

import numpy as np
import torch

from tpuimage_torch.ops.kernels import hist256_batch as _hist256_rows


def hist256_batch(vals: torch.Tensor) -> torch.Tensor:
    """(B, ...) uint8 -> (B, 256) int32 counts, one histogram per leading
    index."""
    return _hist256_rows(vals.reshape(vals.shape[0], -1).contiguous())


def hist256(gray: torch.Tensor) -> torch.Tensor:
    """256-bin histogram of a uint8 tensor (int32 counts)."""
    return hist256_batch(gray.reshape(1, -1))[0]


def otsu_from_hist(hist: torch.Tensor) -> torch.Tensor:
    """Otsu threshold from (..., 256) histograms -> (...,) float32.

    Computed in float64, as OpenCV's getThreshold_Otsu8u computes it
    (with its FLT_EPSILON guards), where tpuimage uses float32: the f32
    prefix sums round differently under every summation order (XLA's
    rewritten scan, PyTorch's CPU and CUDA scans), and a near-tie in the
    between-class variance could then pick a different bin on each device.
    In float64 the argmax is the same on every device."""
    h = hist.to(torch.float64)
    n = h.sum(dim=-1, keepdim=True)
    scale = 1.0 / n
    idx = torch.arange(256, dtype=torch.float64, device=h.device)
    mu = (idx * h).sum(dim=-1, keepdim=True) * scale
    p = h * scale
    q1 = torch.cumsum(p, dim=-1)
    s1 = torch.cumsum(idx * p, dim=-1)
    q2 = 1.0 - q1
    eps = float(np.finfo(np.float32).eps)
    valid = (torch.minimum(q1, q2) >= eps) & (torch.maximum(q1, q2) <= 1.0 - eps)
    one = torch.ones_like(q1)
    mu1 = torch.where(q1 > 0, s1 / torch.where(q1 > 0, q1, one), torch.zeros_like(q1))
    mu2 = torch.where(q2 > 0, (mu - q1 * mu1) / torch.where(q2 > 0, q2, one),
                      torch.zeros_like(q2))
    sigma = torch.where(valid, q1 * q2 * (mu1 - mu2) ** 2, -one)
    return torch.argmax(sigma, dim=-1).to(torch.float32)
