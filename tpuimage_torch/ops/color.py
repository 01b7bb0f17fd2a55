"""Colour conversions bit-matching OpenCV's 8-bit paths (counterpart of
``tpuimage.ops.color``): RGB <-> gray, RGB <-> YCrCb (Q14 fixed point),
RGB -> Lab (fixed point, the ``rgb_to_lab`` kernel on the card), Lab ->
RGB (float, or integer tables with ``impl="lut"``) and RGB <-> HSV (8-bit, H in [0, 180)); the BGR forms flip
the channels around them."""
from __future__ import annotations

import functools

import numpy as np
import torch

from tpuimage_torch.core.dtypes import descale, f32, fma_f32, i32, saturate_u8
from tpuimage_torch.ops import kernels

# Y = descale(R*9798 + G*19235 + B*3735, 15), Q15 fixed point
_R2Y15, _G2Y15, _B2Y15 = 9798, 19235, 3735


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 RGB -> (..., H, W) uint8 gray."""
    r, g, b = i32(img[..., 0]), i32(img[..., 1]), i32(img[..., 2])
    return descale(r * _R2Y15 + g * _G2Y15 + b * _B2Y15, 15).to(torch.uint8)


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    return rgb_to_gray(img.flip(-1))


def gray_to_rgb(gray: torch.Tensor) -> torch.Tensor:
    """(..., H, W) uint8 gray -> (..., H, W, 3), the value in each channel."""
    return torch.stack([gray, gray, gray], dim=-1)


# ---------------------------------------------------------------------------
# YCrCb (8-bit, output order Y, Cr, Cb): OpenCV's historical Q14 path
# ---------------------------------------------------------------------------
_R2Y, _G2Y, _B2Y = 4899, 9617, 1868
_YUV_SHIFT = 14
_YCRCB_C3 = 11682  # cvRound(0.713 * 2**14)
_YCRCB_C4 = 9241   # cvRound(0.564 * 2**14)


def rgb_to_ycrcb(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB -> (..., 3) uint8 YCrCb, exact integer arithmetic."""
    r, g, b = i32(img[..., 0]), i32(img[..., 1]), i32(img[..., 2])
    y = descale(r * _R2Y + g * _G2Y + b * _B2Y, _YUV_SHIFT)
    delta = 128 << _YUV_SHIFT
    cr = descale((r - y) * _YCRCB_C3 + delta, _YUV_SHIFT)
    cb = descale((b - y) * _YCRCB_C4 + delta, _YUV_SHIFT)
    return saturate_u8(torch.stack([y, cr, cb], dim=-1))


def bgr_to_ycrcb(img: torch.Tensor) -> torch.Tensor:
    return rgb_to_ycrcb(img.flip(-1))


_YCRCB_INV = (22987, -11698, -5636, 29049)  # 1.403, -0.714, -0.344, 1.773 in Q14


def ycrcb_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 YCrCb -> (..., 3) uint8 RGB, exact integer arithmetic."""
    y, cr, cb = i32(img[..., 0]), i32(img[..., 1]) - 128, i32(img[..., 2]) - 128
    c0, c1, c2, c3 = _YCRCB_INV
    r = y + descale(cr * c0, _YUV_SHIFT)
    g = y + descale(cr * c1 + cb * c2, _YUV_SHIFT)
    b = y + descale(cb * c3, _YUV_SHIFT)
    return saturate_u8(torch.stack([r, g, b], dim=-1))


def ycrcb_to_bgr(img: torch.Tensor) -> torch.Tensor:
    return ycrcb_to_rgb(img).flip(-1)


# ---------------------------------------------------------------------------
# Lab (8-bit): gamma + cube-root tables, integer descale (color_lab.cpp)
# ---------------------------------------------------------------------------
_LAB_SHIFT = 12
_GAMMA_SHIFT = 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_D65 = (0.950456, 1.0, 1.088754)
_SRGB2XYZ_D65 = np.array([
    [0.412453, 0.357580, 0.180423],
    [0.212671, 0.715160, 0.072169],
    [0.019334, 0.119193, 0.950227],
])
_XYZ2SRGB_D65 = np.linalg.inv(_SRGB2XYZ_D65)
_XYZ2SRGB_F32 = _XYZ2SRGB_D65.astype(np.float32)


def lab_tables():
    """(gamma (256,), cube root (3072,), coefficients (3, 3)) int64, built
    as tpuimage's ``_lab_tables`` builds them."""
    x = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    gamma_tab = np.rint(lin * 255.0 * (1 << _GAMMA_SHIFT)).astype(np.int64)

    n = 256 * 3 // 2 * (1 << _GAMMA_SHIFT)  # 3072
    t = np.arange(n, dtype=np.float64) / (255.0 * (1 << _GAMMA_SHIFT))
    fy = np.where(t < 0.008856, t * 7.787 + 16.0 / 116.0, np.cbrt(t))
    cbrt_tab = np.rint(fy * (1 << _LAB_SHIFT2)).astype(np.int64)

    scale = np.array([(1 << _LAB_SHIFT) / _D65[0],
                      (1 << _LAB_SHIFT),
                      (1 << _LAB_SHIFT) / _D65[2]])
    coeffs = np.rint(_SRGB2XYZ_D65 * scale[:, None]).astype(np.int64)
    return gamma_tab, cbrt_tab, coeffs


@functools.lru_cache(maxsize=None)
def lab_tables_on(device: torch.device) -> torch.Tensor:
    """The packed int32 table the ``rgb_to_lab`` kernel takes, on ``device``."""
    return torch.from_numpy(kernels.pack_lab_tables(*lab_tables())).to(device)


def rgb_to_lab(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB -> (..., 3) uint8 Lab, OpenCV's fixed-point path
    (tpuimage's ``rgb_to_lab``)."""
    return kernels.rgb_to_lab(img.contiguous(), lab_tables_on(img.device))


def bgr_to_lab(img: torch.Tensor) -> torch.Tensor:
    return rgb_to_lab(img.flip(-1))


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true division. On a CUDA tensor PyTorch turns
    ``tensor / python_scalar`` into a multiply by the reciprocal, which
    rounds differently from tpuimage's divide; a device scalar keeps it a
    division on both devices."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _cube(t: torch.Tensor) -> torch.Tensor:
    """``t ** 3`` as XLA evaluates it (integer_pow: t * (t * t))."""
    return t * (t * t)


def lab_to_rgb(img: torch.Tensor, impl: str = "float") -> torch.Tensor:
    """(..., 3) uint8 Lab -> (..., 3) uint8 RGB: tpuimage's float path
    (Lab2RGBfloat with 8-bit rescale and the sRGB gamma), op for op; or,
    with ``impl="lut"``, its integer fixed-point path (:func:`_lab_to_rgb_lut`),
    which the sharded night pipeline uses."""
    if impl == "lut":
        return _lab_to_rgb_lut(img)
    if impl != "float":
        raise ValueError(f"lab_to_rgb: impl must be 'float' or 'lut', got {impl!r}")
    lum = f32(img[..., 0]) * (100.0 / 255.0)
    a = f32(img[..., 1]) - 128.0
    b = f32(img[..., 2]) - 128.0

    fy = _div(lum + 16.0, 116.0)
    fx = fy + _div(a, 500.0)
    fz = fy - _div(b, 200.0)

    def finv(t):
        t3 = _cube(t)
        return torch.where(t3 > 0.008856, t3, _div(t - 16.0 / 116.0, 7.787))

    y = torch.where(lum > 8.0, _cube(fy), _div(lum, 903.3))
    x = finv(fx) * _D65[0]
    z = finv(fz) * _D65[2]
    m = [[float(v) for v in row] for row in _XYZ2SRGB_F32]
    rgb_lin = torch.stack([m[c][0] * x + m[c][1] * y + m[c][2] * z for c in range(3)],
                          dim=-1)
    rgb_lin = torch.clamp(rgb_lin, 0.0, 1.0)
    srgb = torch.where(rgb_lin <= 0.0031308, rgb_lin * 12.92,
                       1.055 * rgb_lin ** (1.0 / 2.4) - 0.055)
    return saturate_u8(srgb * 255.0)


# --- the integer fixed-point Lab -> RGB (tpuimage's impl="lut") -----------
_LAB_INV_SHIFT = 26


@functools.lru_cache(maxsize=None)
def lab_inv_tables():
    """tpuimage's ``_lab_inv_tables``, built the same way in float64 on the
    host: (XT (3, 256, 256) indexed (L, a), YT (3, 256) indexed L, ZT (3,
    256, 256) indexed (L, b), each channel's contribution at 2^26 fixed
    point as int32, and thr (255,) int32, the smallest fixed-point value
    whose gamma-encoded, cvRound-ed byte reaches 1 .. 255)."""
    S = float(1 << _LAB_INV_SHIFT)
    M = _XYZ2SRGB_D65
    L = np.arange(256, dtype=np.float64) * (100.0 / 255.0)
    fy = (L + 16.0) / 116.0
    y = np.where(L > 8.0, fy ** 3, L / 903.3)
    ab = np.arange(256, dtype=np.float64) - 128.0
    fx = fy[:, None] + ab[None, :] / 500.0
    fz = fy[:, None] - ab[None, :] / 200.0

    def finv(t):
        return np.where(t ** 3 > 0.008856, t ** 3, (t - 16.0 / 116.0) / 7.787)

    x = finv(fx) * _D65[0]
    z = finv(fz) * _D65[2]
    XT = np.rint(M[:, 0][:, None, None] * x[None] * S).astype(np.int32)
    YT = np.rint(M[:, 1][:, None] * y[None] * S).astype(np.int32)
    ZT = np.rint(M[:, 2][:, None, None] * z[None] * S).astype(np.int32)

    def gamma255(m):
        t = m / S
        s = np.where(t <= 0.0031308, t * 12.92, 1.055 * t ** (1.0 / 2.4) - 0.055)
        return np.rint(s * 255.0)

    thr = np.empty(255, dtype=np.int32)
    for k in range(1, 256):
        s = (k - 0.5) / 255.0
        t = s / 12.92 if s <= 0.0031308 * 12.92 else ((s + 0.055) / 1.055) ** 2.4
        m = int(np.ceil(t * S))
        while m > 0 and gamma255(m - 1) >= k:
            m -= 1
        while gamma255(m) < k:
            m += 1
        thr[k - 1] = m
    return XT, YT, ZT, thr


@functools.lru_cache(maxsize=None)
def _lab_inv_tables_on(device: torch.device):
    XT, YT, ZT, thr = lab_inv_tables()
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in (XT.reshape(3, -1), YT, ZT.reshape(3, -1), thr))


def _lab_to_rgb_lut(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 Lab -> RGB through the integer tables: per channel
    the three contributions looked up and summed in int32, clamped to
    [0, 2^26], then the byte is the count of thresholds at or below it.
    Integer throughout, so every device gives the same bytes."""
    XT, YT, ZT, thr = _lab_inv_tables_on(img.device)
    li = img[..., 0].to(torch.int64)
    la = li * 256 + img[..., 1].to(torch.int64)
    lb = li * 256 + img[..., 2].to(torch.int64)
    outs = []
    for c in range(3):
        acc = torch.clamp(XT[c][la] + YT[c][li] + ZT[c][lb], 0, 1 << _LAB_INV_SHIFT)
        outs.append(torch.searchsorted(thr, acc.contiguous(), right=True).to(torch.uint8))
    return torch.stack(outs, dim=-1)


def lab_to_bgr(img: torch.Tensor) -> torch.Tensor:
    return lab_to_rgb(img).flip(-1)


# ---------------------------------------------------------------------------
# HSV (8-bit, H in [0, 180)): the integer table algorithm of color_hsv.simd
# one way, OpenCV's float sector algorithm the other
# ---------------------------------------------------------------------------
_HSV_SHIFT = 12


def hsv_tables():
    """(sdiv, hdiv) int32 (256,): round((255 << 12) / i) and
    round((180 << 12) / (6 i)), 0 at i = 0, as tpuimage's ``_hsv_tables``."""
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << _HSV_SHIFT) / i), 0.0)
        hdiv = np.where(i > 0, np.rint((180 << _HSV_SHIFT) / (6.0 * i)), 0.0)
    return sdiv.astype(np.int32), hdiv.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _hsv_tables_on(device: str):
    return tuple(torch.from_numpy(t).to(device) for t in hsv_tables())


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB -> (..., 3) uint8 HSV, exact integer arithmetic
    (the tables as plain gathers)."""
    sdiv, hdiv = _hsv_tables_on(str(img.device))
    r, g, b = i32(img[..., 0]), i32(img[..., 1]), i32(img[..., 2])
    v = torch.maximum(torch.maximum(r, g), b)
    diff = v - torch.minimum(torch.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v.to(torch.int64)] + half) >> _HSV_SHIFT
    h_raw = torch.where(v == r, g - b, torch.where(v == g, (b - r) + 2 * diff,
                                                   (r - g) + 4 * diff))
    h = (h_raw * hdiv[diff.to(torch.int64)] + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


def bgr_to_hsv(img: torch.Tensor) -> torch.Tensor:
    return rgb_to_hsv(img.flip(-1))


def hsv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 HSV -> (..., 3) uint8 RGB: OpenCV's float sector
    algorithm with the 8-bit rescale truncated, as tpuimage's jitted
    programs compute it (``1 - s * f`` fused into one multiply-add)."""
    h = f32(img[..., 0]) * (6.0 / 180.0)
    s = f32(img[..., 1]) * (1.0 / 255.0)
    v = f32(img[..., 2]) * (1.0 / 255.0)
    sector = torch.floor(h)
    hfrac = h - sector
    sector = sector.to(torch.int32) % 6
    tabs = [v, v * (1.0 - s), v * fma_f32(-s, hfrac, 1.0),
            v * fma_f32(-s, 1.0 - hfrac, 1.0)]

    def pick(idx_per_sector):
        out = tabs[idx_per_sector[0]]
        for k in range(1, 6):
            out = torch.where(sector == k, tabs[idx_per_sector[k]], out)
        return out

    # OpenCV's sector_data, emitted as r, g, b
    rgb = torch.stack([pick([0, 2, 1, 1, 3, 0]), pick([3, 0, 0, 2, 1, 1]),
                       pick([1, 1, 3, 0, 0, 2])], dim=-1)
    return torch.clamp(torch.floor(rgb * 255.0), 0, 255).to(torch.uint8)


def hsv_to_bgr(img: torch.Tensor) -> torch.Tensor:
    return hsv_to_rgb(img).flip(-1)


def split(img: torch.Tensor):
    """The channels of an (..., C) image, each (...)."""
    return tuple(img[..., c] for c in range(img.shape[-1]))


def merge(channels) -> torch.Tensor:
    return torch.stack(list(channels), dim=-1)
