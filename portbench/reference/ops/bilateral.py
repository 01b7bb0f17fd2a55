"""Bilateral filter matching cv2.bilateralFilter's 8u path (counterpart of
``tpuimage.ops.bilateral``).

OpenCV's semantics, as tpuimage reproduces them:

- d > 0: radius = d // 2; d <= 0: radius = round(sigma_space * 1.5), with
  Python's half-to-even ``round``; radius >= 1; a sigma <= 0 becomes 1;
- the circular tap set {(i, j): sqrt(i^2 + j^2) <= radius}, row-major;
- space weight ``float32(exp(r^2 * -0.5 / ss^2))`` computed in float64;
- colour weight ``exp(d * d * gc)`` in f32, ``gc = float32(-0.5 / sc^2)``,
  with d the integer |diff| (the L1 sum over the channels for colour),
  read from a table of every distance (0..255 or 0..765);
- output cvRound(sum(w * v) / sum(w)) per channel, reflect-101 border.

A CUDA tensor runs the ``bilateral`` kernel, a CPU tensor its plain
version (``ops.kernels``). Against tpuimage the contract is the float one,
±1 LSB on < 0.5% of pixels: XLA's CPU backend contracts products into
fmas and its exp is not PyTorch's.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.ops import kernels


def _params(d: int, sigma_color: float, sigma_space: float):
    sc = sigma_color if sigma_color > 0 else 1.0
    ss = sigma_space if sigma_space > 0 else 1.0
    if d <= 0:
        radius = int(round(ss * 1.5))
    else:
        radius = d // 2
    radius = max(radius, 1)
    return radius, sc, ss


def _tap_offsets(radius: int):
    taps = []
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r = np.sqrt(i * i + j * j)
            if r > radius:
                continue
            taps.append((i, j, float(r)))
    return taps


def tap_tables(d: int, sigma_color: float, sigma_space: float):
    """(radius, (T, 2) int32 (dy, dx) offsets, (T,) float32 space weights,
    float32 ``gc``), built as tpuimage's scan form builds them."""
    radius, sc, ss = _params(d, sigma_color, sigma_space)
    taps = _tap_offsets(radius)
    gauss_space = -0.5 / (ss * ss)
    offsets = np.asarray([(dy, dx) for (dy, dx, _) in taps], dtype=np.int32)
    space_w = np.asarray([np.float32(np.exp(r * r * gauss_space)) for (_, _, r) in taps],
                         dtype=np.float32)
    return radius, offsets, space_w, np.float32(-0.5 / (sc * sc))


def tables_on(d: int, sigma_color: float, sigma_space: float, channels: int, device):
    """(radius, taps, space weights, colour-weight table): the ``bilateral``
    kernel's arguments on ``device`` for 1 or 3 channels, made once per
    (parameters, channels, device). The colour table is built on the host
    by ``kernels.color_weight_table`` and copied: the card's ``exp`` rounds
    a few weights otherwise, and a result on the card would then differ
    from the host's."""
    return _tables_on(int(d), float(sigma_color), float(sigma_space), int(channels),
                      str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _tables_on(d: int, sigma_color: float, sigma_space: float, channels: int, device: str):
    radius, offsets, space_w, gc = tap_tables(d, sigma_color, sigma_space)
    return (radius, torch.from_numpy(offsets).to(device), torch.from_numpy(space_w).to(device),
            kernels.color_weight_table(255 * channels + 1, gc, "cpu").to(device))


def bilateral_filter(img: torch.Tensor, d: int, sigma_color: float,
                     sigma_space: float) -> torch.Tensor:
    """cv2.bilateralFilter of a uint8 tensor: (H, W) or (H, W, 3), or a
    batch (B, H, W) or (B, H, W, 3). A 3-D tensor whose last dim is 3 is
    one colour image."""
    if img.dtype != torch.uint8:
        raise TypeError(f"bilateral_filter: expected torch.uint8, got {img.dtype}")
    color = img.shape[-1] == 3 and img.dim() in (3, 4)
    single = img.dim() == (3 if color else 2)
    if img.dim() not in (2, 3, 4) or (img.dim() == 4 and not color):
        raise ValueError(f"bilateral_filter: expected (H, W[, 3]) or (B, H, W[, 3]), "
                         f"got {tuple(img.shape)}")
    batch = (img[None] if single else img).contiguous()
    radius, taps, space_w, lut = tables_on(d, sigma_color, sigma_space, 3 if color else 1,
                                           img.device)
    out = kernels.bilateral(batch, taps, space_w, lut, radius)
    return out[0] if single else out
