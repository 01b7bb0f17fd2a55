"""Erode / dilate / open / close / blackhat / tophat / gradient with flat structuring elements
(counterpart of ``tpuimage.ops.morphology``).

Borders follow OpenCV's constant +inf/-inf semantics (erode pads 255,
dilate pads 0) with the asymmetric anchor pads ``(k//2, k-1-k//2)``, which
matter for even SEs such as the ink mask's 2x2 dilate. A full rectangle
is two separable 1-D sliding extremes by log-step doubling.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.core.borders import BORDER_CONSTANT, pad2d
from portbench.reference.core.dtypes import saturate_u8

MORPH_RECT = "rect"
MORPH_ELLIPSE = "ellipse"
MORPH_CROSS = "cross"


def structuring_element(shape: str, ksize) -> np.ndarray:
    """cv2.getStructuringElement with OpenCV's exact ellipse rasterization;
    ``ksize`` is (width, height) or an int."""
    kw, kh = (ksize, ksize) if isinstance(ksize, int) else (ksize[0], ksize[1])
    anchor_x, anchor_y = kw // 2, kh // 2
    el = np.zeros((kh, kw), dtype=np.uint8)
    if shape == MORPH_RECT:
        el[:] = 1
        return el
    if shape == MORPH_CROSS:
        el[anchor_y, :] = 1
        el[:, anchor_x] = 1
        return el
    r, c = anchor_y, anchor_x
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(kh):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2))) if r else c
            j1, j2 = max(c - dx, 0), min(c + dx + 1, kw)
            el[i, j1:j2] = 1
    return el


def _window_extreme(img: torch.Tensor, se: np.ndarray, is_erode: bool) -> torch.Tensor:
    """One erosion/dilation step of each (H, W) plane; ``se`` is a numpy
    0/1 mask."""
    kh, kw = se.shape
    ay, ax = kh // 2, kw // 2
    p = pad2d(img, ay, kh - 1 - ay, ax, kw - 1 - ax, mode=BORDER_CONSTANT,
              value=255 if is_erode else 0)
    fn = torch.minimum if is_erode else torch.maximum
    if se.all():
        out = p
        for dim, n in ((-2, kh), (-1, kw)):
            g, m = out, 1
            while m * 2 <= n:
                valid = g.shape[dim] - m
                g = fn(g.narrow(dim, 0, valid), g.narrow(dim, m, valid))
                m *= 2
            if m < n:
                valid = g.shape[dim] - (n - m)
                g = fn(g.narrow(dim, 0, valid), g.narrow(dim, n - m, valid))
            out = g
        return out
    h, w = img.shape[-2], img.shape[-1]
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            if se[dy, dx]:
                view = p[..., dy:dy + h, dx:dx + w]
                acc = view if acc is None else fn(acc, view)
    return acc


def erode(img: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    for _ in range(iterations):
        img = _window_extreme(img, se, is_erode=True)
    return img


def dilate(img: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    for _ in range(iterations):
        img = _window_extreme(img, se, is_erode=False)
    return img


def morph_open(img: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    return dilate(erode(img, se, iterations), se, iterations)


def morph_close(img: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    return erode(dilate(img, se, iterations), se, iterations)


def morph_blackhat(img: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """cv2.MORPH_BLACKHAT = close(src) - src, saturating.

    On a CUDA uint8 tensor with a full odd rectangle at ``iterations=1``
    this is the ``blackhat_rect`` kernel (``ops.kernels``); other SEs keep
    the log-step form below."""
    se = np.asarray(se)
    kh, kw = se.shape
    if (img.is_cuda and img.dtype == torch.uint8 and iterations == 1 and se.all()
            and kh % 2 == 1 and kw % 2 == 1):
        from portbench.reference.ops import kernels   # kernels imports this module
        planes = img.reshape((-1,) + tuple(img.shape[-2:])).contiguous()
        return kernels.blackhat_rect(planes, kw, kh).reshape(img.shape)
    return morph_blackhat_plain(img, se, iterations)


def morph_blackhat_plain(img: torch.Tensor, se: np.ndarray,
                         iterations: int = 1) -> torch.Tensor:
    """The log-step form of :func:`morph_blackhat`."""
    closed = morph_close(img, se, iterations)
    return saturate_u8(closed.to(torch.int32) - img.to(torch.int32))


def morph_tophat(img: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """cv2.MORPH_TOPHAT = src - open(src), saturating."""
    opened = morph_open(img, se, iterations)
    return saturate_u8(img.to(torch.int32) - opened.to(torch.int32))


def morph_gradient(img: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """cv2.MORPH_GRADIENT = dilate(src) - erode(src)."""
    return saturate_u8(dilate(img, se, iterations).to(torch.int32)
                       - erode(img, se, iterations).to(torch.int32))
