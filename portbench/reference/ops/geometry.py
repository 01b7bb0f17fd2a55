"""Resize (nearest, linear, cubic, area), affine and perspective warps,
rotation and translation, and the deskew rotation (counterpart of
``tpuimage.ops.geometry``).

Warp and rotation are inverse-map bilinear gathers with a final cvRound,
as this OpenCV build computes them in plain f32. Each rounds its products
and sums as the tpuimage program its callers run: the warps op by op,
``warp_perspective_batch`` and ``rotate_pages`` as XLA's CPU compiler
fuses them in tpuimage's jitted programs, so that they equal tpuimage's
on every pixel. tpuimage's one-hot matmul tiles are TPU devices; the port
samples the same coordinates with a gather.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.core.dtypes import f32, fma_f32, saturate_u8

_RESIZE_BITS = 11          # INTER_RESIZE_COEF_BITS
_RESIZE_SCALE = 1 << _RESIZE_BITS


# ---------------------------------------------------------------------------
# resize (HW or HWC uint8)
# ---------------------------------------------------------------------------

def _linear_coeffs_1d(dst: int, src: int):
    """OpenCV resize INTER_LINEAR source indices + Q11 fixed-point weights."""
    scale = src / dst
    x = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    sx = np.floor(x).astype(np.int64)
    fx = x - sx
    fx = np.where(sx < 0, 0.0, fx)
    sx = np.maximum(sx, 0)
    fx = np.where(sx >= src - 1, 0.0, fx)
    sx = np.minimum(sx, src - 1)
    w1 = np.rint((1.0 - fx) * _RESIZE_SCALE)
    w2 = np.rint(fx * _RESIZE_SCALE)
    return sx, w1.astype(np.float32), w2.astype(np.float32)


def _bshape(n: int, axis: int, ndim: int):
    shp = [1] * ndim
    shp[axis] = n
    return shp


def _resize_linear_u8(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    h, w = img.shape[0], img.shape[1]
    sy, wy1, wy2 = _linear_coeffs_1d(out_h, h)
    sx, wx1, wx2 = _linear_coeffs_1d(out_w, w)
    dev, nd = img.device, img.dim()
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    x = f32(img)
    left = x[:, t(sx)]
    right = x[:, t(np.minimum(sx + 1, w - 1))]
    row = (left * t(wx1).reshape(_bshape(out_w, 1, nd))
           + right * t(wx2).reshape(_bshape(out_w, 1, nd)))
    top = row[t(sy)]
    bot = row[t(np.minimum(sy + 1, h - 1))]
    acc = (top * t(wy1).reshape(_bshape(out_h, 0, nd))
           + bot * t(wy2).reshape(_bshape(out_h, 0, nd)))
    return saturate_u8(torch.floor((acc + 2.0 ** 21) / 2.0 ** 22))


def _cubic_kernel(x: np.ndarray, A: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1.0, ((A + 2.0) * ax - (A + 3.0)) * ax * ax + 1.0,
        np.where(ax < 2.0, ((A * ax - 5.0 * A) * ax + 8.0 * A) * ax - 4.0 * A, 0.0))


def _cubic_coeffs_1d(dst: int, src: int):
    """OpenCV resize INTER_CUBIC: four source indices (clamped) and Q11
    weights per destination index."""
    scale = src / dst
    x = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    sx = np.floor(x).astype(np.int64)
    fx = x - sx
    offs = np.arange(-1, 3)
    w = np.rint(_cubic_kernel(fx[:, None] - offs[None, :]) * _RESIZE_SCALE)
    idx = np.clip(sx[:, None] + offs[None, :], 0, src - 1)
    return idx, w.astype(np.float32)


def _resize_cubic_u8(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The four taps of each pass summed in order from 0, as tpuimage's
    ``sum`` does (the second pass's sums pass 2**24, so the order counts)."""
    h, w = img.shape[0], img.shape[1]
    iy, wy = _cubic_coeffs_1d(out_h, h)
    ix, wx = _cubic_coeffs_1d(out_w, w)
    dev, nd = img.device, img.dim()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    x = f32(img)
    row = 0
    for j in range(4):
        row = row + x[:, t(ix[:, j])] * t(wx[:, j]).reshape(_bshape(out_w, 1, nd))
    acc = 0
    for j in range(4):
        acc = acc + row[t(iy[:, j])] * t(wy[:, j]).reshape(_bshape(out_h, 0, nd))
    return saturate_u8(acc / 2.0 ** 22)


def _resize_nearest(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    h, w = img.shape[0], img.shape[1]
    sy = np.minimum(np.floor(np.arange(out_h) * (h / out_h)).astype(np.int64), h - 1)
    sx = np.minimum(np.floor(np.arange(out_w) * (w / out_w)).astype(np.int64), w - 1)
    return img[torch.from_numpy(sy).to(img.device)][:, torch.from_numpy(sx).to(img.device)]


def _area_coeffs(dst: int, src: int):
    scale = src / dst
    rows = []
    for d in range(dst):
        a, b = d * scale, (d + 1) * scale
        ia, ib = int(np.floor(a)), int(min(np.ceil(b), src))
        idx = np.arange(ia, ib)
        wgt = np.minimum(idx + 1, b) - np.maximum(idx, a)
        rows.append((idx, wgt / (b - a)))
    n = max(len(r[0]) for r in rows)
    idx_m = np.zeros((dst, n), dtype=np.int64)
    wgt_m = np.zeros((dst, n), dtype=np.float32)
    for d, (idx, wgt) in enumerate(rows):
        idx_m[d, :len(idx)] = idx
        wgt_m[d, :len(idx)] = wgt
    return idx_m, wgt_m


def _resize_area_u8(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    h, w = img.shape[0], img.shape[1]
    if h % out_h == 0 and w % out_w == 0:
        # integer decimation: exact box mean with cvRound
        ky, kx = h // out_h, w // out_w
        x = f32(img).reshape((out_h, ky, out_w, kx) + tuple(img.shape[2:]))
        return saturate_u8(x.sum(dim=(1, 3)) * (1.0 / (ky * kx)))
    # fractional INTER_AREA: weighted box per output pixel, summed tap by
    # tap in tpuimage's order
    iy, wy = _area_coeffs(out_h, h)
    ix, wx = _area_coeffs(out_w, w)
    dev, nd = img.device, img.dim()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    x = f32(img)
    row = None
    for j in range(ix.shape[1]):
        term = x[:, t(ix[:, j])] * t(wx[:, j]).reshape(_bshape(out_w, 1, nd))
        row = term if row is None else row + term
    acc = None
    for j in range(iy.shape[1]):
        term = row[t(iy[:, j])] * t(wy[:, j]).reshape(_bshape(out_h, 0, nd))
        acc = term if acc is None else acc + term
    return saturate_u8(acc)


def resize(img: torch.Tensor, out_h: int, out_w: int,
           interpolation: str = "area") -> torch.Tensor:
    """cv2.resize of an (H, W) or (H, W, C) uint8 tensor; interpolation in
    {nearest, linear, cubic, area} (an INTER_AREA upscale falls back to
    bilinear, as OpenCV's does)."""
    if out_h == img.shape[0] and out_w == img.shape[1]:
        return img
    if interpolation == "nearest":
        return _resize_nearest(img, out_h, out_w)
    if interpolation == "linear":
        return _resize_linear_u8(img, out_h, out_w)
    if interpolation == "cubic":
        return _resize_cubic_u8(img, out_h, out_w)
    if interpolation != "area":
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if out_h >= img.shape[0] or out_w >= img.shape[1]:
        return _resize_linear_u8(img, out_h, out_w)
    return _resize_area_u8(img, out_h, out_w)


def resize_long_side(img: torch.Tensor, scale_long: int,
                     interpolation: str = "area") -> torch.Tensor:
    """Long side -> scale_long, aspect kept; no-op when already smaller."""
    h, w = int(img.shape[0]), int(img.shape[1])
    long_side = max(h, w)
    if long_side <= scale_long:
        return img
    s = scale_long / long_side
    return resize(img, int(round(h * s)), int(round(w * s)), interpolation)


# ---------------------------------------------------------------------------
# warps (batched inverse-map bilinear gather)
# ---------------------------------------------------------------------------

def get_perspective_transform(src_pts, dst_pts) -> np.ndarray:
    """cv2.getPerspectiveTransform: 3x3 homography from 4 point pairs
    (host numpy, the same 8x8 solve as tpuimage)."""
    src = np.asarray(src_pts, dtype=np.float64).reshape(4, 2)
    dst = np.asarray(dst_pts, dtype=np.float64).reshape(4, 2)
    A = np.zeros((8, 8), dtype=np.float64)
    b = np.zeros(8, dtype=np.float64)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        A[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        A[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[i], b[i + 4] = u, v
    h = np.linalg.solve(A, b)
    return np.append(h, 1.0).reshape(3, 3)


def get_rotation_matrix_2d(center, angle_deg: float, scale: float = 1.0) -> np.ndarray:
    """cv2.getRotationMatrix2D: the forward 2x3 float64 matrix."""
    a = np.deg2rad(angle_deg)
    alpha, beta = scale * np.cos(a), scale * np.sin(a)
    cx, cy = center
    return np.array([
        [alpha, beta, (1 - alpha) * cx - beta * cy],
        [-beta, alpha, beta * cx + (1 - alpha) * cy],
    ], dtype=np.float64)


def _bilinear_gather_u8(img: torch.Tensor, map_x: torch.Tensor,
                        map_y: torch.Tensor, border: str,
                        border_value: float = 0.0, form: str = "op") -> torch.Tensor:
    """Sample each image of a (B, H, W[, C]) uint8 batch at float coords
    (B, oh, ow) with cv2 INTER_LINEAR semantics; ``border`` is
    ``constant`` (``border_value``) or ``replicate``. ``form`` is how the
    caller's tpuimage program rounds the blend:

    - ``"op"``: the four taps times their weight products, each product
      and sum rounded on its own (tpuimage's warps run op by op);
    - ``"fused"``: the sum as ``warp_perspective_batch``'s jitted program
      computes it, read from its fusion's optimized LLVM IR: the first
      product fused into the add of the second (the second into that add
      on the last of two or more channels, whose first product the
      compiler leaves in a block of its own) and each later product into
      its add;
    - ``"rows_first"``: the two rows' y-blends blended in x, each product
      rounded, none fused (``rotate_traced_tiled``'s one-hot contractions
      in tpuimage's jitted program)."""
    b, h, w = img.shape[0], img.shape[1], img.shape[2]
    chan = img.dim() == 4
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx, fy = map_x - x0, map_y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = img.reshape((b, h * w) + tuple(img.shape[3:]))
    base = (torch.arange(b, device=img.device) * (h * w)).reshape(b, 1, 1)
    flat = flat.reshape((b * h * w,) + tuple(img.shape[3:]))

    def tap(yi, xi):
        yc = torch.clamp(yi, 0, h - 1)
        xc = torch.clamp(xi, 0, w - 1)
        v = f32(flat[base + yc * w + xc])
        if border == "replicate":
            return v
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        if chan:
            inb = inb[..., None]
        return torch.where(inb, v, torch.full_like(v, float(border_value)))

    def wmul(wy, wx):
        ww = wy * wx
        return ww[..., None] if chan else ww

    if form == "rows_first":
        r0 = tap(y0i, x0i) * (1.0 - fy) + tap(y0i + 1, x0i) * fy
        r1 = tap(y0i, x0i + 1) * (1.0 - fy) + tap(y0i + 1, x0i + 1) * fy
        return saturate_u8(r0 * (1.0 - fx) + r1 * fx)
    taps = ((tap(y0i, x0i), wmul(1.0 - fy, 1.0 - fx)), (tap(y0i, x0i + 1), wmul(1.0 - fy, fx)),
            (tap(y0i + 1, x0i), wmul(fy, 1.0 - fx)), (tap(y0i + 1, x0i + 1), wmul(fy, fx)))
    if form == "fused":
        (v0, w0), (v1, w1) = taps[:2]
        acc = fma_f32(v0, w0, v1 * w1)
        if chan and img.shape[3] >= 2:
            acc = torch.cat([acc[..., :-1], fma_f32(v1[..., -1:], w1, v0[..., -1:] * w0)],
                            dim=-1)
        for v, wt in taps[2:]:
            acc = fma_f32(v, wt, acc)
        return saturate_u8(acc)
    acc = taps[0][0] * taps[0][1]
    for v, wt in taps[1:]:
        acc = acc + v * wt
    return saturate_u8(acc)


def _grid(out_h: int, out_w: int, device) -> tuple:
    ys = torch.arange(out_h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=device)[None, :]
    return ys.expand(out_h, out_w), xs.expand(out_h, out_w)


def _warp_grid(img: torch.Tensor, a: np.ndarray, out_h: int, out_w: int, border: str,
               border_value: float, perspective: bool) -> torch.Tensor:
    """One (H, W[, C]) image sampled through the INVERSE map ``a`` (2x3 or
    3x3 float64, taken to f32), each product and sum rounded on its own,
    as tpuimage's warps compute op by op."""
    ys, xs = _grid(out_h, out_w, img.device)
    c = [float(v) for v in np.asarray(a, dtype=np.float32).ravel()]
    sx = c[0] * xs + c[1] * ys + c[2]
    sy = c[3] * xs + c[4] * ys + c[5]
    if perspective:
        denom = c[6] * xs + c[7] * ys + c[8]
        denom = torch.where(denom != 0, denom, torch.full_like(denom, 1e-20))
        sx, sy = sx / denom, sy / denom
    return _bilinear_gather_u8(img[None], sx[None], sy[None], border, border_value)[0]


def warp_affine(img: torch.Tensor, M: np.ndarray, out_h: int, out_w: int,
                border: str = "constant", border_value: float = 0.0) -> torch.Tensor:
    """cv2.warpAffine INTER_LINEAR of one (H, W[, C]) uint8 image; ``M`` is
    the forward 2x3, inverted on the host as cv2's invertAffineTransform."""
    M = np.asarray(M, dtype=np.float64)
    D = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    Di = 1.0 / D if D != 0 else 0.0
    ia = np.array([[M[1, 1] * Di, -M[0, 1] * Di, 0.0],
                   [-M[1, 0] * Di, M[0, 0] * Di, 0.0]])
    ia[0, 2] = -ia[0, 0] * M[0, 2] - ia[0, 1] * M[1, 2]
    ia[1, 2] = -ia[1, 0] * M[0, 2] - ia[1, 1] * M[1, 2]
    return _warp_grid(img, ia, out_h, out_w, border, border_value, perspective=False)


def warp_perspective(img: torch.Tensor, M: np.ndarray, out_h: int, out_w: int,
                     border: str = "constant", border_value: float = 0.0) -> torch.Tensor:
    """cv2.warpPerspective INTER_LINEAR of one (H, W[, C]) uint8 image; ``M``
    maps source to destination and is inverted on the host."""
    minv = np.linalg.inv(np.asarray(M, dtype=np.float64))
    return _warp_grid(img, minv, out_h, out_w, border, border_value, perspective=True)


def rotate(img: torch.Tensor, angle_deg: float, scale: float = 1.0,
           border: str = "constant") -> torch.Tensor:
    """getRotationMatrix2D about the center + warpAffine (the notebook's
    rotate)."""
    h, w = int(img.shape[0]), int(img.shape[1])
    M = get_rotation_matrix_2d((w / 2.0, h / 2.0), angle_deg, scale)
    return warp_affine(img, M, h, w, border=border)


def translate(img: torch.Tensor, tx: float, ty: float,
              border: str = "constant") -> torch.Tensor:
    """warpAffine with [[1, 0, tx], [0, 1, ty]] (the notebook's translate)."""
    M = np.array([[1.0, 0.0, tx], [0.0, 1.0, ty]])
    h, w = int(img.shape[0]), int(img.shape[1])
    return warp_affine(img, M, h, w, border=border)


# XLA's CPU compiler vectorises a row of the coordinate lines 32 columns a
# step (8 f32 lanes, 4 interleaved). Where that stays a loop (a row of at
# least 10 steps), each ``a * x`` product sits in the loop beside the add
# that takes it and is fused there; the last ``W % 32`` columns, and every
# column of a row that is unrolled whole, take products hoisted out of the
# loop, unfused (read from the fusion's optimized LLVM IR).
_XLA_STEP_COLS = 32
_XLA_LOOP_MIN_COLS = 320


def _homography_line(p: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
                     xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """``p * x + q * y + r`` over the (oh, ow) grid with (B, 1, 1)
    coefficients, as ``warp_perspective_batch``'s jitted program rounds
    it: ``fma(p, x, q * y) + r`` on the columns its vectorised loop
    covers, each op rounded alone on the rest."""
    ow = xs.shape[-1]
    fused = ow // _XLA_STEP_COLS * _XLA_STEP_COLS if ow >= _XLA_LOOP_MIN_COLS else 0
    plain = p * xs[..., fused:] + q * ys[..., fused:] + r
    if not fused:
        return plain
    head = fma_f32(p, xs[..., :fused], q * ys[..., :fused]) + r
    return torch.cat([head, plain], dim=-1)


def warp_perspective_batch(imgs: torch.Tensor, Minv: torch.Tensor,  # noqa: N803
                           out_h: int, out_w: int, border: str = "constant",
                           border_value: float = 0.0) -> torch.Tensor:
    """cv2.warpPerspective INTER_LINEAR of a (B, H, W, C) uint8 batch with
    per-image INVERSE homographies (B, 3, 3) float32; ``border`` is
    ``constant`` (``border_value``) or ``replicate``. Rounded as tpuimage's
    jitted ``warp_perspective_batch`` (:func:`_homography_line`, the
    ``"fused"`` tap sum)."""
    ys, xs = _grid(out_h, out_w, imgs.device)
    a = Minv.to(torch.float32).reshape(-1, 9, 1, 1)
    line = lambda i: _homography_line(a[:, i], a[:, i + 1], a[:, i + 2], xs, ys)  # noqa: E731
    denom = line(6)
    denom = torch.where(denom != 0, denom, torch.full_like(denom, 1e-20))
    sx = line(0) / denom
    sy = line(3) / denom
    return _bilinear_gather_u8(imgs, sx, sy, border=border, border_value=border_value,
                               form="fused")


def rotate_pages(imgs: torch.Tensor, angles_deg: torch.Tensor,
                 max_angle: float) -> torch.Tensor:
    """Rotate each (H, W) page of a (B, H, W) uint8 batch about its center
    by its angle in degrees, clipped to +-max_angle, bilinear with a
    replicate border: tpuimage's ``rotate_traced_tiled`` (the deskew
    rotation) as its jitted program computes it. ``cos`` / ``sin`` are
    taken in f64 and rounded (torch's f32 ``cos`` is an ulp off XLA's at
    +-4 degrees), XLA fuses ``ca * xr`` into ``sx`` and ``sa * xr`` into
    ``sy``, and the taps are blended rows first."""
    b, h, w = imgs.shape
    cx, cy = w / 2.0, h / 2.0
    a = torch.deg2rad(torch.clamp(f32(angles_deg), -max_angle, max_angle)).double()
    ca = torch.cos(a).to(torch.float32).reshape(b, 1, 1)
    sa = torch.sin(a).to(torch.float32).reshape(b, 1, 1)
    gy, gx = _grid(h, w, imgs.device)
    xr, yr = gx - cx, gy - cy
    sx = fma_f32(ca, xr, -(sa * yr)) + cx
    sy = fma_f32(sa, xr, ca * yr) + cy
    return _bilinear_gather_u8(imgs, sx, sy, border="replicate", form="rows_first")
