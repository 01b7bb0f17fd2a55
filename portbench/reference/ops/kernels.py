"""Frozen plain PyTorch versions of the port's hand-written kernels
(``tpuimage_torch/ops/kernels.py``'s ``*_ref`` functions), bound under the
kernels' own names so the copied op modules call them on every device.
The plain arithmetic is the kernels' specification: exact integer sums,
and the f32 products and sums rounded one at a time."""
from __future__ import annotations


import numpy as np
import torch

from portbench.reference.core.borders import pad2d
from portbench.reference.core.dtypes import descale, saturate_u8
from portbench.reference.ops.arith import divide_u8, max_u8, subtract_u8
from portbench.reference.ops.filters import gaussian_blur_u8_plain
from portbench.reference.ops.morphology import (MORPH_RECT, dilate, morph_blackhat_plain,
                                                structuring_element)
from portbench.reference.ops.threshold import adaptive_threshold, threshold_binary


def hist256_batch_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch 256-bin histograms of each row of a (B, N) uint8."""
    b = x.shape[0]
    off = torch.arange(b, device=x.device, dtype=torch.int64)[:, None] * 256
    flat = (x.to(torch.int64) + off).reshape(-1)
    return torch.bincount(flat, minlength=b * 256).reshape(b, 256).to(torch.int32)


_REF_THETA_CHUNK = 30   # thetas per step (bounds the memory)


def hough_votes_ref(xs: torch.Tensor, ys: torch.Tensor, counts: torch.Tensor,
                    cos_t: torch.Tensor, sin_t: torch.Tensor, numrho: int,
                    shift: int) -> torch.Tensor:
    """Plain PyTorch Hough votes: for image b, edge e < counts[b] and
    theta t, one vote at ``rint(fma(x, cos[t], f32(y*sin[t]))) + shift``.

    The fma is formed exactly: the f64 product of an integer coordinate
    and an f32 cosine is exact, so one f32 rounding of the f64 sum is the
    correctly rounded fma that tpuimage's XLA path computes."""
    b, k = xs.shape
    t = cos_t.shape[0]
    dev = xs.device
    valid = torch.arange(k, device=dev)[None, :] < counts.to(torch.int64)[:, None]
    x64 = xs.to(torch.float64)[:, :, None]
    yf = ys.to(torch.float32)[:, :, None]
    out = torch.zeros((b, t, numrho), dtype=torch.int64, device=dev)
    bvalid = valid[:, :, None]
    bidx = torch.arange(b, device=dev)[:, None, None]
    for t0 in range(0, t, _REF_THETA_CHUNK):
        t1 = min(t0 + _REF_THETA_CHUNK, t)
        c = cos_t[t0:t1].to(torch.float64)[None, None, :]
        ys_s = (yf * sin_t[t0:t1][None, None, :]).to(torch.float64)
        r = torch.round((x64 * c + ys_s).to(torch.float32)).to(torch.int64) + shift
        tj = torch.arange(t0, t1, device=dev)[None, None, :]
        flat = ((bidx * t + tj) * numrho + r).expand(b, k, t1 - t0)
        flat = flat[bvalid.expand(b, k, t1 - t0)]
        out.view(-1).index_add_(0, flat, torch.ones_like(flat))
    return out.transpose(1, 2).contiguous().to(torch.int32)


LAB_GAMMA_N = 256      # sRGB gamma table entries
LAB_CBRT_N = 3072      # cube-root table entries
LAB_TABLES_LEN = LAB_GAMMA_N + LAB_CBRT_N + 9
_LAB_SHIFT, _LAB_SHIFT2 = 12, 15
_LAB_L_SCALE = (116 * 255 + 50) // 100
_LAB_L_SHIFT = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)


def pack_lab_tables(gamma: np.ndarray, cbrt: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """The one int32 table the kernel and its plain version take: gamma
    (256) | cube root (3072) | the 3x3 fixed-point sRGB -> XYZ
    coefficients, row-major."""
    if gamma.shape != (LAB_GAMMA_N,) or cbrt.shape != (LAB_CBRT_N,) or coeffs.shape != (3, 3):
        raise ValueError("pack_lab_tables: expected (256,), (3072,) and (3, 3)")
    return np.concatenate([gamma, cbrt, coeffs.reshape(-1)]).astype(np.int32)


def rgb_to_lab_ref(img: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch OpenCV 8-bit RGB -> Lab: the gather form of tpuimage's
    XLA path; ``tables`` as :func:`pack_lab_tables` lays it out."""
    gamma = tables[:LAB_GAMMA_N]
    cbrt = tables[LAB_GAMMA_N:LAB_GAMMA_N + LAB_CBRT_N]
    coef = tables[LAB_GAMMA_N + LAB_CBRT_N:].tolist()
    r, g, b = (gamma[img[..., c].to(torch.int64)] for c in range(3))

    def fchan(row):
        idx = descale(r * coef[3 * row] + g * coef[3 * row + 1]
                      + b * coef[3 * row + 2], _LAB_SHIFT)
        return cbrt[idx.clamp(0, LAB_CBRT_N - 1).to(torch.int64)]

    fx, fy, fz = fchan(0), fchan(1), fchan(2)
    lum = descale(_LAB_L_SCALE * fy + _LAB_L_SHIFT, _LAB_SHIFT2)
    a = descale(500 * (fx - fy) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    bb = descale(200 * (fy - fz) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    return saturate_u8(torch.stack([lum, a, bb], dim=-1))


def clahe_apply_ref(gray: torch.Tensor, luts: torch.Tensor, rows: torch.Tensor,
                    cols: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch CLAHE apply in cv2's order: each pixel blends its
    four tile LUT values ``(l11*xa1 + l12*xa)*ya1 + (l21*xa1 + l22*xa)*ya``
    in f32 (``xa1 = 1 - xa``, ``ya1 = 1 - ya``), each product and sum
    rounded on its own, then cvRound and clamp. ``rows`` (H, 3) and
    ``cols`` (W, 3) are the blend tables ``(t1, t2, a)``."""
    b, h, w = gray.shape
    tx = luts.shape[2]
    r1, r2, ya = rows[:, 0].to(torch.int64), rows[:, 1].to(torch.int64), rows[:, 2, None]
    c1, c2, xa = cols[:, 0].to(torch.int64), cols[:, 1].to(torch.int64), cols[:, 2]
    flat = luts.reshape(b, -1).to(torch.float32)
    v = gray.to(torch.int64).reshape(b, -1)

    def lut(rt, ct):
        base = ((rt[:, None] * tx + ct[None, :]) * 256).reshape(1, -1)
        return flat.gather(1, base + v).reshape(b, h, w)

    xa1, ya1 = 1.0 - xa, 1.0 - ya
    top = lut(r1, c1) * xa1 + lut(r1, c2) * xa
    bot = lut(r2, c1) * xa1 + lut(r2, c2) * xa
    return saturate_u8(top * ya1 + bot * ya)


_SE_INK = structuring_element(MORPH_RECT, (2, 2))


def gaussian_blur_u8_ref(x: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """Plain PyTorch cv2.GaussianBlur 8u, reflect-101 border
    (``filters.gaussian_blur_u8``'s plain form)."""
    return gaussian_blur_u8_plain(x, ksize, sigma)


def gauss_chain_ref(x: torch.Tensor, ksize: int, mode: str, C: float = 0.0) -> torch.Tensor:
    """Plain PyTorch Gaussian and its consumer: the Q8.8 blur, then
    ``divide_u8(x, blur, 255)``, ``subtract_u8(x, blur)`` or
    ``subtract_u8(blur, x)``; or ``adaptive_threshold(x, 255, "gaussian",
    ksize, C)``."""
    if mode == "adaptive":
        return adaptive_threshold(x, 255, "gaussian", ksize, C)
    blur = gaussian_blur_u8_ref(x, ksize)
    if mode == "divide":
        return divide_u8(x, blur, scale=255)
    if mode == "subtract":
        return subtract_u8(x, blur)
    if mode == "sub":
        return subtract_u8(blur, x)
    raise ValueError(f"gauss_chain: unknown mode {mode!r}")


def blackhat_rect_ref(x: torch.Tensor, kw: int, kh: int) -> torch.Tensor:
    """Plain PyTorch ``close(x) - x`` with a kw x kh rect (the log-step
    form of ``morphology.morph_blackhat``)."""
    return morph_blackhat_plain(x, structuring_element(MORPH_RECT, (kw, kh)))


def inkmask_weighted_ref(sub_raw: torch.Tensor, bh_raw: torch.Tensor, adapt: torch.Tensor,
                         t_sub: torch.Tensor, t_bh: torch.Tensor, iters: int):
    """Plain PyTorch ink-mask epilogue: ``threshold_binary`` (strict >) of
    both raw planes, their max, ``iters`` 2x2 dilations, then
    ``where(mask == 0, 255, adapt)``."""
    mask = max_u8(threshold_binary(sub_raw, t_sub[:, None, None]),
                  threshold_binary(bh_raw, t_bh[:, None, None]))
    if iters > 0:
        mask = dilate(mask, _SE_INK, iterations=iters)
    return mask, torch.where(mask == 0, torch.full_like(adapt, 255), adapt)


def color_weight_table(n: int, gauss_color: float, device) -> torch.Tensor:
    """(n,) float32 colour weights ``exp(d * d * gauss_color)`` for the
    integer distances d = 0..n-1, in f32 on ``device``: the expression
    tpuimage's tap loop evaluates per tap, evaluated once per distance."""
    d = torch.arange(n, dtype=torch.float32, device=device)
    return torch.exp(d * d * float(np.float32(gauss_color)))


def bilateral_ref(img: torch.Tensor, taps: torch.Tensor, space_w: torch.Tensor,
                  color_lut: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain PyTorch cv2.bilateralFilter 8u of each image of a (B, H, W)
    or (B, H, W, 3) uint8 batch, reflect-101 border: per tap (dy, dx) in
    table order, ``w = color_lut[|diff|] * space_w[t]`` (the L1 distance
    over the channels for colour), ``num += view * w``, ``den += w``, each
    product and sum rounded on its own; then ``cvRound(num / den)``."""
    color = img.dim() == 4
    planes = img.movedim(-1, -3) if color else img        # (B, [C,] H, W)
    h, w = planes.shape[-2], planes.shape[-1]
    r = radius
    padded = pad2d(planes, r, r, r, r)
    center = planes.to(torch.int32)
    num = torch.zeros(planes.shape, dtype=torch.float32, device=img.device)
    den = torch.zeros(img.shape[:3], dtype=torch.float32, device=img.device)
    for (dy, dx), sw in zip(taps.tolist(), space_w.tolist()):
        view = padded[..., r + dy:r + dy + h, r + dx:r + dx + w]
        diff = (view.to(torch.int32) - center).abs()
        if color:
            diff = diff.sum(dim=-3)
        wgt = color_lut[diff.to(torch.int64)] * sw
        num = num + view.to(torch.float32) * (wgt[:, None] if color else wgt)
        den = den + wgt
    out = saturate_u8(num / (den[:, None] if color else den))
    return out.movedim(-3, -1).contiguous() if color else out


def rank_extract_ref(rank: torch.Tensor, mask: torch.Tensor, kk: int) -> torch.Tensor:
    """Plain PyTorch ``ci[rank[p, b], b] = p`` for every position p of
    band b where the mask is set and ``rank < kk``, over zeros:
    (N, nb) -> (kk, nb) int32."""
    n, nb = rank.shape
    ci = torch.zeros((kk, nb), dtype=torch.int32, device=rank.device)
    keep = mask & (rank < kk)
    p, b = torch.nonzero(keep, as_tuple=True)
    ci[rank[p, b].to(torch.int64), b] = p.to(torch.int32)
    return ci


hist256_batch = hist256_batch_ref
hough_votes = hough_votes_ref
rgb_to_lab = rgb_to_lab_ref
clahe_apply = clahe_apply_ref
gaussian_blur_u8 = gaussian_blur_u8_ref
gauss_chain = gauss_chain_ref
blackhat_rect = blackhat_rect_ref
inkmask_weighted = inkmask_weighted_ref
bilateral = bilateral_ref
rank_extract = rank_extract_ref
