"""256-bin histograms, Otsu and CLAHE (counterpart of
``tpuimage.ops.histogram``).

``hist256_batch`` and the CLAHE apply are hand-written CUDA kernels on a
CUDA tensor and their plain PyTorch versions on a CPU tensor
(``ops.kernels``).

CLAHE reproduces OpenCV as tpuimage does: pad to a tile multiple with
BORDER_REFLECT_101, per-tile 256-bin histogram, integer clip with uniform
+ stepped-residual redistribution, cumulative LUT scaled by 255/tileArea
(cvRound). The bilinear blend of the four neighbouring tile LUTs then
follows cv2's own order and roundings (per-row and per-column blend
tables, :func:`clahe_blend_table`), so the result equals
``cv2.createCLAHE().apply`` at the cvRound .5 ties too, where tpuimage's
own forms disagree with each other and with cv2.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.core.borders import BORDER_REFLECT_101, pad2d
from portbench.reference.core.dtypes import f32, fma_f32, saturate_u8
from portbench.reference.ops import kernels
from portbench.reference.ops.kernels import hist256_batch as _hist256_rows


def hist256_batch(vals: torch.Tensor) -> torch.Tensor:
    """(B, ...) uint8 -> (B, 256) int32 counts, one histogram per leading
    index."""
    return _hist256_rows(vals.reshape(vals.shape[0], -1).contiguous())


def hist256(gray: torch.Tensor) -> torch.Tensor:
    """256-bin histogram of a uint8 tensor (int32 counts)."""
    return hist256_batch(gray.reshape(1, -1))[0]


def otsu_threshold(gray: torch.Tensor) -> torch.Tensor:
    """Otsu threshold of a uint8 image (all its values, one histogram):
    :func:`hist256`, then :func:`otsu_from_hist`; f32 scalar."""
    return otsu_from_hist(hist256(gray))


def otsu_from_hist(hist: torch.Tensor) -> torch.Tensor:
    """Otsu threshold from (..., 256) histograms -> (...,) float32.

    Computed in float64, as OpenCV's getThreshold_Otsu8u computes it
    (with its FLT_EPSILON guards), where tpuimage uses float32: the f32
    prefix sums round differently under every summation order (XLA's
    rewritten scan, PyTorch's CPU and CUDA scans), and a near-tie in the
    between-class variance could then pick a different bin on each device.

    The prefix sums are integer scans (exact in any order), and every
    float64 step after them is one correctly rounded op, so the variances
    are the same bits on every device. That matters at exact ties: over a
    run of empty bins the variance is constant, and argmax takes the first
    bin of the run on the CPU and the card alike, as OpenCV's strict ``>``
    does. (A float64 scan of the probabilities breaks such a run into
    last-bit noise on the card, whose parallel scan associates the sums
    differently.)"""
    h = hist.to(torch.int64)
    n = h.sum(dim=-1, keepdim=True).to(torch.float64)
    idx = torch.arange(256, dtype=torch.int64, device=h.device)
    c1 = torch.cumsum(h, dim=-1)
    m1 = torch.cumsum(idx * h, dim=-1)
    mu = m1[..., -1:].to(torch.float64) / n
    q1 = c1.to(torch.float64) / n
    s1 = m1.to(torch.float64) / n
    q2 = 1.0 - q1
    eps = float(np.finfo(np.float32).eps)
    valid = (torch.minimum(q1, q2) >= eps) & (torch.maximum(q1, q2) <= 1.0 - eps)
    one = torch.ones_like(q1)
    mu1 = torch.where(q1 > 0, s1 / torch.where(q1 > 0, q1, one), torch.zeros_like(q1))
    mu2 = torch.where(q2 > 0, (mu - q1 * mu1) / torch.where(q2 > 0, q2, one),
                      torch.zeros_like(q2))
    sigma = torch.where(valid, q1 * q2 * (mu1 - mu2) ** 2, -one)
    return torch.argmax(sigma, dim=-1).to(torch.float32)


def percentile(values: torch.Tensor, q) -> torch.Tensor:
    """``jnp.percentile(values, q)`` (linear interpolation) over the last
    dim of an f32 tensor, each row on its own, as tpuimage's jitted
    programs compute it: a sort; the position ``q / 100 * (n - 1)`` as
    XLA folds its constants (an integer q: q * f32(f32(n - 1) * f32(1 /
    100)); a float q: f32(q / 100) * (n - 1)); then ``low * (1 - w) +
    high * w`` with the low product fused into the add. A sort, not
    ``torch.quantile``, which refuses more than 2**24 values."""
    f = np.float32
    n = int(values.shape[-1])
    if isinstance(q, (int, np.integer)):
        pos = f(q) * f(f(n - 1) * (f(1.0) / f(100.0)))
    else:
        pos = f(f(q) / f(100.0)) * f(n - 1)
    hw = f(pos - np.floor(pos))
    lw = f(1.0) - hw
    low = int(min(max(np.floor(pos), 0), n - 1))
    high = int(min(max(np.ceil(pos), 0), n - 1))
    ordered = torch.sort(values, dim=-1).values
    lv, hv = ordered[..., low], ordered[..., high]
    return fma_f32(lv, torch.tensor(float(lw)), (hv * float(hw)).double())


def equalize_hist(gray: torch.Tensor) -> torch.Tensor:
    """cv2.equalizeHist on each (H, W) plane of a (..., H, W) uint8 tensor:
    the CDF LUT anchored at the first occupied bin, ``(cdf - cdf[first]) *
    f32(255 / (n - h[first]))`` cvRounded; a constant plane stays as it is.
    The histograms through the ``hist256`` kernel, then one gather of each
    plane's LUT (the ``ops.lut`` pattern, a row of tables at once)."""
    h, w = gray.shape[-2], gray.shape[-1]
    rows = gray.reshape(-1, h * w)
    hist = hist256_batch(rows)
    first = torch.argmax((hist > 0).to(torch.int32), dim=1, keepdim=True)
    denom = h * w - torch.gather(hist, 1, first)
    safe = f32(torch.clamp(denom, min=1))
    scale = torch.where(denom > 0, torch.full_like(safe, 255.0) / safe, torch.zeros_like(safe))
    csum = torch.cumsum(hist, dim=1)
    lut = saturate_u8((f32(csum) - f32(torch.gather(csum, 1, first))) * scale)
    idx = torch.arange(256, device=gray.device)[None, :]
    lut = torch.where(idx < first, torch.zeros_like(lut), lut)
    out = torch.gather(lut, 1, rows.to(torch.int64))
    out = torch.where(denom > 0, out, rows)
    return out.reshape(gray.shape)


# ---------------------------------------------------------------------------
# CLAHE
# ---------------------------------------------------------------------------

def clahe_geometry(h: int, w: int, tiles_x: int, tiles_y: int):
    """(pad_bottom, pad_right, tile_h, tile_w) of an (h, w) image. OpenCV's
    quirk: when either dim is not divisible, BOTH are padded with
    ``tiles - dim % tiles``, a full extra tile on a divisible dim."""
    if h % tiles_y == 0 and w % tiles_x == 0:
        return 0, 0, h // tiles_y, w // tiles_x
    ph = tiles_y - (h % tiles_y)
    pw = tiles_x - (w % tiles_x)
    return ph, pw, (h + ph) // tiles_y, (w + pw) // tiles_x


def tile_luts_from_counts(counts: torch.Tensor, clip_limit: float,
                          tile_area: int) -> torch.Tensor:
    """(T, 256) tile histograms -> (T, 256) uint8 tile LUTs: OpenCV's clip,
    uniform + stepped-residual redistribution and CDF LUT."""
    nbins = 256
    hist = counts.to(torch.int64)
    if clip_limit > 0:
        clip = max(int(clip_limit * tile_area / nbins), 1)
        clipped = torch.clamp(hist, max=clip)
        excess = (hist - clipped).sum(dim=1)
        residual = excess % nbins
        hist = clipped + (excess // nbins)[:, None]
        # bins k*step for k < residual, step = max(256 // residual, 1)
        step = torch.where(residual > 0, nbins // torch.clamp(residual, min=1),
                           torch.full_like(residual, nbins)).clamp(min=1)[:, None]
        idx = torch.arange(nbins, device=hist.device)[None, :]
        hist = hist + ((idx % step == 0) & (idx // step < residual[:, None]))
    # OpenCV: lutScale = 255.0f / tileArea as an f32 divide, then sum * lutScale in f32
    lut_scale = float(np.float32(255.0) / np.float32(tile_area))
    return saturate_u8(f32(torch.cumsum(hist, dim=1)) * lut_scale)


def clahe_blend_matrix(n_pix: int, tile: int, n_tiles: int) -> np.ndarray:
    """Static (n_pix, n_tiles) bilinear tile-blend matrix (OpenCV coord
    math: inv_t = 1.0f/tile as an f32 divide, pf = p*inv_t - 0.5f)."""
    pf = (np.arange(n_pix, dtype=np.float32)
          * (np.float32(1.0) / np.float32(tile)) - np.float32(0.5))
    t1 = np.floor(pf).astype(np.int64)
    fa = (pf - t1).astype(np.float32)
    t1c = np.clip(t1, 0, n_tiles - 1)
    t2c = np.clip(t1 + 1, 0, n_tiles - 1)
    m = np.zeros((n_pix, n_tiles), dtype=np.float32)
    m[np.arange(n_pix), t1c] += 1.0 - fa
    m[np.arange(n_pix), t2c] += fa
    return m


def clahe_blend_table(n_pix: int, tile: int, n_tiles: int) -> np.ndarray:
    """(n_pix, 3) float32 rows ``(t1, t2, a)`` of cv2's CLAHE blend along
    one axis: ``pf = p * (1.0f / tile) - 0.5f`` (each op rounded), ``t1 =
    max(floor(pf), 0)``, ``t2 = min(floor(pf) + 1, n_tiles - 1)`` and the
    fraction ``a = pf - floor(pf)``. At the edges both tiles are the same
    one and both weights stay (cv2 still takes two products there, where
    :func:`clahe_blend_matrix` adds the weights into one entry)."""
    pf = (np.arange(n_pix, dtype=np.float32)
          * (np.float32(1.0) / np.float32(tile)) - np.float32(0.5))
    t = np.floor(pf)
    return np.stack([np.maximum(t, 0), np.minimum(t + 1, n_tiles - 1),
                     (pf - t).astype(np.float32)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=32)
def blend_tables_on(h: int, w: int, th: int, tw: int, tiles_y: int, tiles_x: int,
                    device: torch.device):
    """The row table (h, 3) and column table (w, 3) of
    :func:`clahe_blend_table` as float32 tensors on ``device`` (built once
    per geometry)."""
    rows = torch.from_numpy(clahe_blend_table(h, th, tiles_y)).to(device)
    return rows, torch.from_numpy(clahe_blend_table(w, tw, tiles_x)).to(device)


def clahe_tiles(gray: torch.Tensor, tiles_x: int = 8, tiles_y: int = 8):
    """(B, H, W) uint8 -> (the (B * tiles_y * tiles_x, th * tw) contiguous
    tile rows of the padded image, th, tw)."""
    b, h, w = gray.shape
    ph, pw, th, tw = clahe_geometry(h, w, tiles_x, tiles_y)
    src = pad2d(gray, 0, ph, 0, pw, mode=BORDER_REFLECT_101) if (ph or pw) else gray
    tiles = (src.reshape(b, tiles_y, th, tiles_x, tw).permute(0, 1, 3, 2, 4)
             .reshape(b * tiles_y * tiles_x, th * tw).contiguous())
    return tiles, th, tw


def clahe(gray: torch.Tensor, clip_limit: float = 40.0, tiles_x: int = 8,
          tiles_y: int = 8) -> torch.Tensor:
    """cv2.createCLAHE(clip_limit, (tiles_x, tiles_y)).apply on each (H, W)
    plane of a (..., H, W) uint8 tensor: the tile histograms through the
    ``hist256`` kernel, the apply through the ``clahe_apply`` kernel."""
    h, w = gray.shape[-2], gray.shape[-1]
    g = gray.reshape(-1, h, w)
    tiles, th, tw = clahe_tiles(g, tiles_x, tiles_y)
    luts = tile_luts_from_counts(_hist256_rows(tiles), clip_limit, th * tw)
    rows, cols = blend_tables_on(h, w, th, tw, tiles_y, tiles_x, g.device)
    out = kernels.clahe_apply(g.contiguous(), luts.reshape(-1, tiles_y, tiles_x, 256), rows,
                              cols)
    return out.reshape(gray.shape)
