"""Thick-segment rasterization (host-side numpy): localize draws the
Hough segments over the edge map before the contour walk, and
process_document its quad overlay. Copies of ``tpuimage.ops.draw``'s
``draw_segments`` (the same f64 point-to-segment predicate) and
``draw_polyline_overlay``; the port's C++ rasterizer is left out."""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np


def draw_segments(shape: Tuple[int, int], segments: Iterable[Sequence[float]],
                  thickness: int = 2) -> np.ndarray:
    """Binary uint8 (0/255) mask with each (x1, y1, x2, y2) segment drawn:
    every pixel whose center lies within thickness/2 of the segment."""
    h, w = shape
    out = np.zeros((h, w), dtype=np.uint8)
    r = thickness / 2.0
    seg_arr = np.ascontiguousarray(
        np.asarray(list(segments), dtype=np.float64).reshape(-1, 4))
    if not len(seg_arr):
        return out
    for seg in seg_arr:
        x1, y1, x2, y2 = [float(v) for v in seg]
        lo_x = max(int(np.floor(min(x1, x2) - r - 1)), 0)
        hi_x = min(int(np.ceil(max(x1, x2) + r + 1)), w - 1)
        lo_y = max(int(np.floor(min(y1, y2) - r - 1)), 0)
        hi_y = min(int(np.ceil(max(y1, y2) + r + 1)), h - 1)
        if hi_x < lo_x or hi_y < lo_y:
            continue
        ys, xs = np.mgrid[lo_y:hi_y + 1, lo_x:hi_x + 1]
        dx, dy = x2 - x1, y2 - y1
        L2 = dx * dx + dy * dy
        if L2 == 0:
            d2 = (xs - x1) ** 2 + (ys - y1) ** 2
        else:
            t = np.clip(((xs - x1) * dx + (ys - y1) * dy) / L2, 0.0, 1.0)
            d2 = (xs - (x1 + t * dx)) ** 2 + (ys - (y1 + t * dy)) ** 2
        out[lo_y:hi_y + 1, lo_x:hi_x + 1] |= (d2 <= r * r).astype(np.uint8) * 255
    return out


def draw_polyline_overlay(img_rgb: np.ndarray, pts: np.ndarray,
                          color: Tuple[int, int, int] = (0, 255, 0),
                          thickness: int = 2, closed: bool = True) -> np.ndarray:
    """A copy of the image with the polygon's outline drawn (cv2.polylines'
    analog; DocScanner's scan_02 quad overlay)."""
    out = np.asarray(img_rgb).copy()
    p = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
    n = len(p)
    segs = [(p[i][0], p[i][1], p[(i + 1) % n][0], p[(i + 1) % n][1])
            for i in range(n - 1 + (1 if closed else 0))]
    mask = draw_segments(out.shape[:2], segs, thickness=thickness) != 0
    out[mask] = np.asarray(color, dtype=out.dtype)
    return out
