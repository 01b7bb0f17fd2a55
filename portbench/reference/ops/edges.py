"""Sobel, Scharr, Laplacian, magnitude / phase and Canny (counterpart of
``tpuimage.ops.edges``).

Canny is OpenCV's exact algorithm on each (H, W) plane: Sobel3 with a
reflect-101 border (as ``tpuimage.ops.edges._conv3x3_i32`` pads), L1
magnitude (or the squared L2 one against the squared thresholds),
integer sector NMS with TG22 in Q15 and zero-filled shifts, double
threshold, then hysteresis grown to the weak-reachability fixpoint: 8
masked 3x3 growth steps per convergence check, at most ``h + w`` checks
unless asked otherwise, like tpuimage's CPU schedule. Growth is
monotone, so the batch runs until its slowest plane converges and each
plane's result is its own fixpoint.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.core.borders import BORDER_REFLECT_101, pad2d
from portbench.reference.core.dtypes import f32

_SOBEL_3 = {
    # (deriv order dx, dy) -> 3x3 kernel (correlation form, like cv2)
    (1, 0): np.outer([1, 2, 1], [-1, 0, 1]),
    (0, 1): np.outer([-1, 0, 1], [1, 2, 1]),
    (2, 0): np.outer([1, 2, 1], [1, -2, 1]),
    (0, 2): np.outer([1, -2, 1], [1, 2, 1]),
    (1, 1): np.outer([-1, 0, 1], [-1, 0, 1]),
}

_SCHARR = {
    (1, 0): np.outer([3, 10, 3], [-1, 0, 1]),
    (0, 1): np.outer([-1, 0, 1], [3, 10, 3]),
}

_LAPLACIAN = {1: np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]]),
              3: np.array([[2, 0, 2], [0, -8, 0], [2, 0, 2]])}

_TG22 = 13573  # cv2: tan(22.5 deg) * 2^15, rounded
_STEPS_PER_CHECK = 8


def _conv3x3_f32(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Exact integer 3x3 correlation of each (H, W) plane by shifted adds
    (f32 is exact: |acc| < 2^24), reflect-101 border."""
    h, w = img.shape[-2], img.shape[-1]
    p = f32(pad2d(img, 1, 1, 1, 1, mode=BORDER_REFLECT_101))
    acc = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    for dy in range(3):
        for dx in range(3):
            c = float(k[dy, dx])
            if c != 0.0:
                acc = acc + p[..., dy:dy + h, dx:dx + w] * c
    return acc


def sobel(img: torch.Tensor, dx: int, dy: int, ksize: int = 3,
          scharr: bool = False) -> torch.Tensor:
    """cv2.Sobel ksize 3, or Scharr (``scharr`` or ``ksize=-1``), values
    identical to CV_32F / CV_16S output."""
    if scharr or ksize == -1:
        return _conv3x3_f32(img, _SCHARR[(dx, dy)])
    if ksize != 3:
        raise ValueError(f"sobel: ksize 3 or -1 (Scharr), got {ksize}")
    return _conv3x3_f32(img, _SOBEL_3[(dx, dy)])


def laplacian(img: torch.Tensor, ksize: int = 1) -> torch.Tensor:
    """cv2.Laplacian, ksize 1 ([[0,1,0],[1,-4,1],[0,1,0]]) or 3
    ([[2,0,2],[0,-8,0],[2,0,2]]), exact in f32."""
    return _conv3x3_f32(img, _LAPLACIAN[1 if ksize <= 1 else 3])


def magnitude(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """cv2.magnitude (L2). On Sobel values the sum of squares is an exact
    integer, so a fused multiply-add gives the same value."""
    return torch.sqrt(f32(gx) * f32(gx) + f32(gy) * f32(gy))


def phase(gx: torch.Tensor, gy: torch.Tensor, degrees: bool = True) -> torch.Tensor:
    """cv2.phase: atan2 in [0, 360) degrees (or [0, 2 pi) radians); the
    atan2 in f64 rounded to f32, the same on every device."""
    ang = torch.atan2(gy.double(), gx.double()).to(torch.float32)
    if degrees:
        ang = ang * float(np.float32(180.0 / np.pi))
        return torch.where(ang < 0, ang + 360.0, ang)
    return torch.where(ang < 0, ang + float(np.float32(2.0 * np.pi)), ang)


def laplacian_variance(gray: torch.Tensor) -> torch.Tensor:
    """Var(Laplacian) of each (H, W) plane (the blur metric), f32."""
    lap = laplacian(gray)
    return lap.var(dim=(-2, -1), unbiased=False)


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = x[..., y+dy, x+dx], out of range -> 0."""
    h, w = x.shape[-2], x.shape[-1]
    p = torch.nn.functional.pad(x, (1, 1, 1, 1))
    return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def canny_pre(gray: torch.Tensor, low: float, high: float, l2_gradient: bool = False,
              row_valid=None):
    """Sobel3 -> L1 (or, with ``l2_gradient``, squared L2) magnitude ->
    sector NMS -> double threshold. Returns the (strong, weak) bool maps of
    each plane. ``row_valid`` (H,) bool zeroes the magnitude of the rows
    outside the image (a halo'd block's), as the unsharded NMS sees 0
    there."""
    if low > high:
        low, high = high, low
    dx = sobel(gray, 1, 0)
    dy = sobel(gray, 0, 1)
    if l2_gradient:
        mag = dx * dx + dy * dy
        low_t, high_t = float(low) ** 2, float(high) ** 2
    else:
        mag = torch.abs(dx) + torch.abs(dy)
        low_t, high_t = float(int(low)), float(int(high))  # cv2 truncates for L1
    if row_valid is not None:
        valid = torch.as_tensor(row_valid, dtype=torch.bool, device=mag.device)
        mag = torch.where(valid[:, None], mag, torch.zeros_like(mag))

    xs = torch.abs(dx)
    ys = torch.abs(dy) * 32768.0
    tg22x = xs * float(_TG22)
    tg67x = tg22x + xs * 65536.0

    m = mag
    left, right = _shift2d(m, 0, -1), _shift2d(m, 0, 1)
    up, down = _shift2d(m, -1, 0), _shift2d(m, 1, 0)
    same_sign = (dx * dy) >= 0
    diag1 = torch.where(same_sign, _shift2d(m, -1, -1), _shift2d(m, -1, 1))
    diag2 = torch.where(same_sign, _shift2d(m, 1, 1), _shift2d(m, 1, -1))

    horiz = ys < tg22x
    vert = ys > tg67x
    keep = torch.where(
        horiz, (m > left) & (m >= right),
        torch.where(vert, (m > up) & (m >= down), (m > diag1) & (m >= diag2)))
    cand = keep & (m > low_t)
    strong = cand & (m > high_t)
    return strong, cand & ~strong


def dilate8_bool(b: torch.Tensor) -> torch.Tensor:
    """8-connected boolean dilation of each (H, W) plane (3x3 OR)."""
    v = b.clone()
    v[..., 1:, :] |= b[..., :-1, :]
    v[..., :-1, :] |= b[..., 1:, :]
    out = v.clone()
    out[..., :, 1:] |= v[..., :, :-1]
    out[..., :, :-1] |= v[..., :, 1:]
    return out


def _hysteresis(strong: torch.Tensor, weak: torch.Tensor, max_iters: int) -> torch.Tensor:
    s = strong
    for _ in range(max_iters):
        new = s
        for _ in range(_STEPS_PER_CHECK):
            new = new | (weak & dilate8_bool(new))
        changed = bool((new != s).any())
        s = new
        if not changed:
            break
    return s


def canny(gray: torch.Tensor, low: float, high: float, l2_gradient: bool = False,
          max_hysteresis_iters=None) -> torch.Tensor:
    """cv2.Canny (aperture 3, L1 or ``l2_gradient``) on each uint8 (H, W)
    plane of a (..., H, W) tensor -> uint8 0/255; at most
    ``max_hysteresis_iters`` convergence checks (default h + w)."""
    strong, weak = canny_pre(gray, low, high, l2_gradient)
    h, w = gray.shape[-2], gray.shape[-1]
    strong = _hysteresis(strong, weak, max_hysteresis_iters or (h + w))
    return strong.to(torch.uint8) * 255


def canny_batch(grays: torch.Tensor, low: float, high: float, l2_gradient: bool = False,
                max_hysteresis_iters=None) -> torch.Tensor:
    """:func:`canny` of a (B, H, W) stack (``canny`` takes any leading
    dims; each plane is its own fixpoint)."""
    return canny(grays, low, high, l2_gradient, max_hysteresis_iters)
