"""Colour conversions bit-matching OpenCV's 8-bit paths (counterpart of
``tpuimage.ops.color``): RGB <-> gray, RGB <-> YCrCb (Q14 fixed point),
RGB -> Lab (fixed point, the ``rgb_to_lab`` kernel on the card), Lab ->
RGB (float, or integer tables with ``impl="lut"``) and RGB <-> HSV (8-bit, H in [0, 180)); the BGR forms flip
the channels around them."""
from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.core.dtypes import descale, f32, fma_f32, i32, saturate_u8
from portbench.reference.ops import kernels

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


def _lab_inv_constants() -> dict:
    """The f32 constants of tpuimage's jitted lab_to_rgb as XLA folds them:
    each ``/ c`` a product with the f32 reciprocal, ``l * (100 / 255) /
    903.3`` and each matrix entry times its white point one constant."""
    c = np.float32(100.0 / 255.0)
    m = _XYZ2SRGB_F32
    white = (np.float32(_D65[0]), np.float32(1.0), np.float32(_D65[2]))
    return {"l": float(c), "r116": float(np.float32(1) / np.float32(116)),
            "r500": float(np.float32(1) / np.float32(500)),
            "r200": float(np.float32(1) / np.float32(200)),
            "r7.787": float(np.float32(1) / np.float32(7.787)),
            "-16/116": float(-np.float32(16.0 / 116.0)),
            "l/903.3": float(c * (np.float32(1) / np.float32(903.3))),
            "m": [[float(m[r, j] * white[j]) for j in range(3)] for r in range(3)]}


_LAB_INV = _lab_inv_constants()


def lab_to_rgb(img: torch.Tensor, impl: str = "float") -> torch.Tensor:
    """(..., 3) uint8 Lab -> (..., 3) uint8 RGB: tpuimage's float path
    (Lab2RGBfloat with 8-bit rescale and the sRGB gamma) as XLA's CPU
    compiler computes it jitted: its constants folded
    (:func:`_lab_inv_constants`), ``a / 500`` and ``b / 200`` fused into
    ``fx`` and ``fz``, and of each row's three products the x (the y in
    the G row) and then the z product fused, found on every (L, a, b) byte
    triple; the linear value's sRGB byte is then looked up among XLA's
    thresholds. With ``impl="lut"``, its integer fixed-point path
    (:func:`_lab_to_rgb_lut`), which the sharded night pipeline uses."""
    if impl == "lut":
        return _lab_to_rgb_lut(img)
    if impl != "float":
        raise ValueError(f"lab_to_rgb: impl must be 'float' or 'lut', got {impl!r}")
    lum8 = f32(img[..., 0])
    lum = lum8 * _LAB_INV["l"]
    fy = (lum + 16.0) * _LAB_INV["r116"]
    fx = fma_f32(f32(img[..., 1]) - 128.0, _LAB_INV["r500"], fy)
    fz = fma_f32(128.0 - f32(img[..., 2]), _LAB_INV["r200"], fy)

    def finv(t):
        t3 = (t * t) * t
        return torch.where(t3 > 0.008856, t3, (t + _LAB_INV["-16/116"]) * _LAB_INV["r7.787"])

    x, z = finv(fx), finv(fz)
    y = torch.where(lum > 8.0, (fy * fy) * fy, lum8 * _LAB_INV["l/903.3"])
    k = _LAB_INV["m"]
    rgb_lin = torch.stack([fma_f32(z, k[0][2], fma_f32(x, k[0][0], y * k[0][1])),
                           fma_f32(z, k[1][2], fma_f32(y, k[1][1], x * k[1][0])),
                           fma_f32(z, k[2][2], fma_f32(x, k[2][0], y * k[2][1]))], dim=-1)
    rgb_lin = torch.clamp(rgb_lin, 0.0, 1.0)
    return torch.bucketize(rgb_lin, _srgb_thresholds(rgb_lin.device), right=True).to(torch.uint8)


# The smallest f32 linear value in [0, 1] whose sRGB byte is 1 .. 255 in
# tpuimage's jitted lab_to_rgb tail, saturate((v <= 0.0031308 ? v * 12.92 :
# 1.055 * v ** (1 / 2.4) - 0.055) * 255), as f32 bit patterns. XLA's CPU
# f32 pow is the host libm's powf, which torch's f32 pow (vector and scalar
# paths differ in the last place) and CUDA's powf are not; the byte is
# monotone in v over every f32 in [0, 1], so these 255 values give it
# exactly (tests/test_torch_night.py recomputes them).
_SRGB_THRESHOLD_BITS = (
    0x391f22b5, 0x39eeb40e, 0x3a46eb62, 0x3a8b3e5d, 0x3ab3070c, 0x3adacfb7, 0x3b014c33, 0x3b153089,
    0x3b2914e1, 0x3b3cf936, 0x3b50f2d1, 0x3b65fb9a, 0x3b7c3404, 0x3b89d060, 0x3b962333, 0x3ba314bc,
    0x3bb0a733, 0x3bbedcb6, 0x3bcdb76e, 0x3bdd3968, 0x3bed64b2, 0x3bfe3b44, 0x3c07df92, 0x3c10f91b,
    0x3c1a6b32, 0x3c2436c7, 0x3c2e5cc9, 0x3c38de19, 0x3c43bba5, 0x3c4ef649, 0x3c5a8ee5, 0x3c668654,
    0x3c72dd73, 0x3c7f950e, 0x3c865703, 0x3c8d1490, 0x3c940398, 0x3c9b247c, 0x3ca277a8, 0x3ca9fd77,
    0x3cb1b654, 0x3cb9a299, 0x3cc1c2ac, 0x3cca16e3, 0x3cd29fa7, 0x3cdb5d4a, 0x3ce45034, 0x3ced78b4,
    0x3cf6d72f, 0x3d0035fc, 0x3d051bb6, 0x3d0a1cec, 0x3d0f39d1, 0x3d14728a, 0x3d19c745, 0x3d1f382b,
    0x3d24c56a, 0x3d2a6f21, 0x3d303586, 0x3d3618b6, 0x3d3c18e6, 0x3d423630, 0x3d4870cb, 0x3d4ec8d3,
    0x3d553e77, 0x3d5bd1d3, 0x3d62831c, 0x3d69526a, 0x3d703ff2, 0x3d774bca, 0x3d7e7627, 0x3d82df90,
    0x3d869374, 0x3d8a56cc, 0x3d8e29af, 0x3d920c28, 0x3d95fe52, 0x3d9a0036, 0x3d9e11ee, 0x3da23384,
    0x3da66512, 0x3daaa6a0, 0x3daef849, 0x3db35a15, 0x3db7cc1d, 0x3dbc4e6a, 0x3dc0e116, 0x3dc5842a,
    0x3dca37bd, 0x3dcefbd7, 0x3dd3d092, 0x3dd8b5f6, 0x3dddac1c, 0x3de2b30a, 0x3de7cadc, 0x3decf395,
    0x3df22d52, 0x3df77817, 0x3dfcd3fe, 0x3e012087, 0x3e03dfaf, 0x3e06a77c, 0x3e0977f8, 0x3e0c5127,
    0x3e0f3316, 0x3e121dc6, 0x3e151145, 0x3e180d95, 0x3e1b12c4, 0x3e1e20d1, 0x3e2137cc, 0x3e2457b5,
    0x3e27809a, 0x3e2ab27c, 0x3e2ded69, 0x3e313162, 0x3e347e73, 0x3e37d49d, 0x3e3b33ee, 0x3e3e9c68,
    0x3e420e18, 0x3e4588fa, 0x3e490d25, 0x3e4c9a8f, 0x3e50314f, 0x3e53d15c, 0x3e577acd, 0x3e5b2d99,
    0x3e5ee9d6, 0x3e62af7c, 0x3e667ea1, 0x3e6a573c, 0x3e6e3963, 0x3e72250e, 0x3e761a53, 0x3e7a192d,
    0x3e7e21aa, 0x3e8119e2, 0x3e8327ca, 0x3e853a87, 0x3e875224, 0x3e896e9e, 0x3e8b8ffe, 0x3e8db641,
    0x3e8fe172, 0x3e92118b, 0x3e944698, 0x3e968094, 0x3e98bf8b, 0x3e9b0377, 0x3e9d4c63, 0x3e9f9a4b,
    0x3ea1ed3a, 0x3ea4452a, 0x3ea6a228, 0x3ea9042d, 0x3eab6b46, 0x3eadd76b, 0x3eb048ac, 0x3eb2beff,
    0x3eb53a72, 0x3eb7baff, 0x3eba40b2, 0x3ebccb86, 0x3ebf5b84, 0x3ec1f0a7, 0x3ec48afd, 0x3ec72a7d,
    0x3ec9cf35, 0x3ecc791e, 0x3ecf2845, 0x3ed1dca2, 0x3ed49644, 0x3ed75521, 0x3eda1948, 0x3edce2b1,
    0x3edfb16a, 0x3ee2856a, 0x3ee55ebf, 0x3ee83d62, 0x3eeb215f, 0x3eee0aaf, 0x3ef0f961, 0x3ef3ed69,
    0x3ef6e6d9, 0x3ef9e5a6, 0x3efce9e0, 0x3efff37c, 0x3f018145, 0x3f030b82, 0x3f049878, 0x3f062827,
    0x3f07ba94, 0x3f094fba, 0x3f0ae7a1, 0x3f0c8244, 0x3f0e1fac, 0x3f0fbfd2, 0x3f1162bf, 0x3f13086e,
    0x3f14b0e6, 0x3f165c22, 0x3f180a2a, 0x3f19baf9, 0x3f1b6e97, 0x3f1d24fe, 0x3f1ede37, 0x3f209a3b,
    0x3f225914, 0x3f241abb, 0x3f25df39, 0x3f27a688, 0x3f2970b0, 0x3f2b3dac, 0x3f2d0d84, 0x3f2ee031,
    0x3f30b5be, 0x3f328e25, 0x3f34696b, 0x3f36478c, 0x3f382891, 0x3f3a0c73, 0x3f3bf33c, 0x3f3ddce5,
    0x3f3fc977, 0x3f41b8eb, 0x3f43ab4a, 0x3f45a08f, 0x3f4798c1, 0x3f4993da, 0x3f4b91e4, 0x3f4d92d8,
    0x3f4f96bf, 0x3f519d91, 0x3f53a75a, 0x3f55b410, 0x3f57c3bf, 0x3f59d65e, 0x3f5bebf8, 0x3f5e0485,
    0x3f60200f, 0x3f623e8e, 0x3f64600d, 0x3f668484, 0x3f68abfc, 0x3f6ad671, 0x3f6d03e8, 0x3f6f345b,
    0x3f7167d5, 0x3f739e4d, 0x3f75d7cf, 0x3f781452, 0x3f7a53e0, 0x3f7c9671, 0x3f7edc13,
)


@functools.lru_cache(maxsize=None)
def _srgb_thresholds(device) -> torch.Tensor:
    bits = np.array(_SRGB_THRESHOLD_BITS, dtype=np.uint32)
    return torch.from_numpy(bits.view(np.float32).copy()).to(device)


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
