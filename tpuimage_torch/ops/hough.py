"""Hough line transform over a dense vote accumulator (counterpart of
``tpuimage.ops.hough``).

Edges are compacted to per-image coordinate lists by the CPU reference's
rule: the ``k`` lowest flat indices are kept, and ``overflow`` is
``count > k``. (tpuimage's banded TPU compaction also flags per-band and
per-group overflow; the port follows the CPU reference.) The compaction
is the ``rank_extract`` kernel and the votes the ``hough_votes`` kernel on
a CUDA tensor, their plain versions on a CPU tensor (``ops.kernels``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from tpuimage_torch.core.dtypes import f32
from tpuimage_torch.ops.kernels import hough_votes, rank_extract


def default_max_edges(h: int, w: int) -> int:
    """tpuimage's default edge budget: 18.75% of pixels, floor 128k, cap 512k."""
    return min(max(131072, (h * w * 3) // 16), 524288)


def hough_tables(theta_bins: int = 180, rho: float = 1.0):
    """(cos, sin) f32 tables exactly as tpuimage builds them: float64
    ``theta = t * pi / theta_bins``, divided by rho, cast to float32."""
    thetas = np.arange(theta_bins) * (np.pi / theta_bins)
    return ((np.cos(thetas) / rho).astype(np.float32),
            (np.sin(thetas) / rho).astype(np.float32))


_RANK_CHUNK = 1024   # positions per chunk of exclusive_rank's first scan


def exclusive_rank(flat: torch.Tensor):
    """(B, P) bool -> ((B, P) int32 exclusive running count of each row,
    (B,) int32 row counts), as ``cumsum - flat``.

    A scan along a few long rows leaves most of the card idle (one row per
    block of PyTorch's innermost-dim scan), so each row is scanned in
    chunks of _RANK_CHUNK positions, many rows of work at once, and the
    chunk totals' exclusive scan is added after. Integer sums: exact in
    any order. The rank is a view of a padded buffer (rows strided)."""
    b, p = flat.shape
    c = max(-(-p // _RANK_CHUNK), 1)
    x = torch.zeros((b, c * _RANK_CHUNK), dtype=torch.int32, device=flat.device)
    x[:, :p] = flat
    x = x.view(b, c, _RANK_CHUNK)
    local = torch.cumsum(x, dim=2, dtype=torch.int32)
    totals = local[:, :, -1]
    before = torch.cumsum(totals, dim=1, dtype=torch.int32) - totals
    rank = (local - x + before[:, :, None]).view(b, c * _RANK_CHUNK)[:, :p]
    return rank, totals.sum(dim=1, dtype=torch.int32)


def compact_edges(edges: torch.Tensor, k: int):
    """(B, H, W) edge maps -> (xs, ys, counts, overflow): (B, K) int32
    coordinates of each image's ``min(count, k)`` lowest-index edges in
    row-major order (0 past each count), (B,) int32 counts and (B,) bool
    ``count > k``. K is the largest kept count of the batch (at least 1).

    tpuimage's sort-free form (``band_compact_coords(impl="rank")``) with
    each image's flat plane as one band: the exclusive per-image rank by
    cumsum (:func:`exclusive_rank`), then ``rank_extract`` puts each kept
    edge's flat index in its slot. The one read back to the host is K."""
    b, h, w = edges.shape
    flat = edges.reshape(b, h * w) > 0
    rank, true_counts = exclusive_rank(flat)
    counts = torch.clamp(true_counts, max=k)
    kk = max(int(counts.max()) if b else 0, 1)
    ci = rank_extract(rank.t(), flat.t(), kk).t()      # (B, K) flat indices
    xs = (ci % w).contiguous()
    ys = torch.div(ci, w, rounding_mode="floor").contiguous()
    return xs, ys, counts, true_counts > k


def hough_accumulator(edges: torch.Tensor, rho: float = 1.0,
                      theta_bins: int = 180, max_edges: int = 0,
                      return_overflow: bool = False):
    """(B, H, W) edge maps -> (B, numrho, theta_bins) int32 votes, binned
    like cv2.HoughLines with theta = pi/theta_bins: ``r = rint(x cos t + y
    sin t) + (numrho - 1) / 2``; with ``return_overflow`` also the (B,)
    bool edge-budget overflow (more edges than ``max_edges``)."""
    _, h, w = edges.shape
    numrho = int(round(((w + h) * 2 + 1) / rho))
    if max_edges <= 0:
        max_edges = default_max_edges(h, w)
    k = min(max_edges, h * w)
    xs, ys, counts, overflow = compact_edges(edges, k)
    cos_np, sin_np = hough_tables(theta_bins, rho)
    cos_t = torch.from_numpy(cos_np).to(edges.device)
    sin_t = torch.from_numpy(sin_np).to(edges.device)
    acc = hough_votes(xs, ys, counts, cos_t, sin_t, numrho, (numrho - 1) // 2)
    return (acc, overflow) if return_overflow else acc


def _is_peak(acc: torch.Tensor, threshold: int) -> torch.Tensor:
    """cv2 findLocalMaximums on each (numrho, theta) plane: votes >
    threshold, strict vs rho-1/theta-1, >= vs rho+1/theta+1."""
    a = torch.nn.functional.pad(acc, (1, 1, 1, 1))
    c = a[..., 1:-1, 1:-1]
    return ((c > a[..., :-2, 1:-1]) & (c >= a[..., 2:, 1:-1])
            & (c > a[..., 1:-1, :-2]) & (c >= a[..., 1:-1, 2:])
            & (c > threshold))


def fold_median_from_acc(acc: torch.Tensor, threshold: int,
                         theta_bins: int = 180) -> torch.Tensor:
    """Median of fold-to-[-90, 90) angles (degrees) over every Hough peak
    of each (numrho, theta) plane -> (B,) float32; 0 with no peak."""
    counts = _is_peak(acc, threshold).to(torch.int32).sum(dim=-2)   # (B, T)
    theta_deg = np.arange(theta_bins) * (180.0 / theta_bins)
    fold = np.mod(theta_deg + 90.0, 180.0) - 90.0
    order = np.argsort(fold, kind="stable")
    fold_sorted = torch.from_numpy(fold[order].astype(np.float32)).to(acc.device)
    c = torch.cumsum(counts[..., torch.from_numpy(order).to(acc.device)], dim=-1)
    n = c[..., -1:]

    def value_at_rank(q):  # 0-indexed rank -> fold value
        return fold_sorted[torch.argmax((c > q).to(torch.uint8), dim=-1)]

    med = 0.5 * (value_at_rank(torch.div(n - 1, 2, rounding_mode="floor"))
                 + value_at_rank(torch.div(n, 2, rounding_mode="floor")))
    return torch.where(n[..., 0] > 0, med, torch.zeros_like(med))


def hough_fold_median_angle(edges: torch.Tensor, threshold: int,
                            rho: float = 1.0, theta_bins: int = 180,
                            return_overflow: bool = False, max_edges: int = 0):
    """DocScanner's deskew statistic over (B, H, W) edge maps -> (B,)
    float32 angle; with ``return_overflow`` also the (B,) bool edge-budget
    overflow."""
    acc, overflow = hough_accumulator(edges, rho=rho, theta_bins=theta_bins,
                                      max_edges=max_edges, return_overflow=True)
    angle = fold_median_from_acc(acc, threshold, theta_bins)
    return (angle, overflow) if return_overflow else angle


def hough_line_count(edges: torch.Tensor, threshold: int, rho: float = 1.0,
                     theta_bins: int = 180, max_lines: int = 64, max_edges: int = 0,
                     return_overflow: bool = False):
    """min(number of Hough peaks above threshold, max_lines) of each (B, H,
    W) edge map -> (B,) int32 counts, the count of ``hough_lines``' valid
    lines without ordering the peaks; with ``return_overflow`` also the
    (B,) bool edge-budget overflow."""
    acc, overflow = hough_accumulator(edges, rho=rho, theta_bins=theta_bins,
                                      max_edges=max_edges, return_overflow=True)
    n = torch.clamp(_is_peak(acc, threshold).sum(dim=(-2, -1), dtype=torch.int32),
                    max=max_lines)
    return (n, overflow) if return_overflow else n


def hough_lines(edges: torch.Tensor, threshold: int, rho: float = 1.0,
                theta_bins: int = 180, max_lines: int = 64, max_edges: int = 0,
                return_overflow: bool = False):
    """cv2.HoughLines analog over (B, H, W) edge maps -> ((B, max_lines, 2)
    [rho, theta] f32, (B, max_lines) valid), and with ``return_overflow``
    the (B,) bool edge-budget overflow after them. Peaks are ordered by
    votes, ties by lower flat (rho, theta) index, as ``lax.top_k`` orders
    them."""
    acc, overflow = hough_accumulator(edges, rho=rho, theta_bins=theta_bins,
                                      max_edges=max_edges, return_overflow=True)
    b, numrho = acc.shape[0], acc.shape[1]
    votes = torch.where(_is_peak(acc, threshold), acc, torch.zeros_like(acc))
    top_v, top_i = torch.sort(votes.reshape(b, -1), dim=-1, descending=True,
                              stable=True)
    top_v, top_i = top_v[:, :max_lines], top_i[:, :max_lines]
    r_idx = torch.div(top_i, theta_bins, rounding_mode="floor")
    t_idx = top_i % theta_bins
    rhos = (f32(r_idx) - (numrho - 1) // 2) * rho
    thetas = f32(t_idx) * (math.pi / theta_bins)
    lines = torch.stack([rhos, thetas], dim=-1)
    return (lines, top_v > 0, overflow) if return_overflow else (lines, top_v > 0)


def hough_lines_p_det(edges: torch.Tensor, threshold: int,
                      min_line_length: float = 0.0, max_lines: int = 64,
                      rho: float = 1.0, theta_bins: int = 180):
    """Deterministic stand-in for cv2.HoughLinesP over (B, H, W) edge maps
    -> ((B, max_lines, 4) [x1, y1, x2, y2] f32, (B, max_lines) valid):
    each peak line clipped to the image rectangle, shorter than
    ``min_line_length`` pruned."""
    h, w = edges.shape[-2], edges.shape[-1]
    lines, valid = hough_lines(edges, threshold, rho=rho,
                               theta_bins=theta_bins, max_lines=max_lines)
    r = lines[..., 0]
    t = lines[..., 1]
    ct, st = torch.cos(t), torch.sin(t)
    big = float(h + w) * 2.0

    def rng(p0, d, lo, hi):
        nz = d != 0
        dd = torch.where(nz, d, torch.ones_like(d))
        s1 = torch.where(nz, (lo - p0) / dd, torch.full_like(d, -big))
        s2 = torch.where(nz, (hi - p0) / dd, torch.full_like(d, big))
        return torch.minimum(s1, s2), torch.maximum(s1, s2)

    px, py = r * ct, r * st
    dx, dy = -st, ct
    ax1, ax2 = rng(px, dx, 0.0, w - 1.0)
    ay1, ay2 = rng(py, dy, 0.0, h - 1.0)
    s0, s1 = torch.maximum(ax1, ay1), torch.minimum(ax2, ay2)
    x1, y1 = px + s0 * dx, py + s0 * dy
    x2, y2 = px + s1 * dx, py + s1 * dy
    seg_len = torch.hypot(x2 - x1, y2 - y1)
    ok = valid & (s1 > s0) & (seg_len >= min_line_length)
    return torch.stack([x1, y1, x2, y2], dim=-1), ok
