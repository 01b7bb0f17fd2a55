"""Helpers of the seeded document generators, frozen from the port's
``synth.py``: text rows and table rules on a page, paper shading, a dark
desk texture, and the 8x8 homography solve."""
from __future__ import annotations

import numpy as np


def _text_ink(u: np.ndarray, v: np.ndarray, ph: int, pw: int,
              tilt_deg: float, rng: np.random.Generator,
              rules: int = 0) -> np.ndarray:
    """Boolean ink mask at page coords (u, v) in pixels of a (ph, pw) page:
    rows of words, each letter a left stem, maybe a right stem and maybe a
    top or bottom bar, of random widths, and ``rules`` vertical ruled
    lines down 96% of the height (a table's columns); all rotated by
    tilt_deg about the page center."""
    a = np.deg2rad(tilt_deg)
    cu, cv = pw / 2.0, ph / 2.0
    ur = np.cos(a) * (u - cu) + np.sin(a) * (v - cv) + cu
    vr = -np.sin(a) * (u - cu) + np.cos(a) * (v - cv) + cv
    pitch = max(ph * 0.03, 5.0)
    band = max(pitch * 0.4, 2.0)
    stroke = max(int(round(pw * 0.003)), 1)
    letter = max(pw * 0.009, 3.0 * stroke + 1)
    top, left, right = 0.08 * ph, 0.08 * pw, 0.92 * pw
    n_rows = int((0.9 * ph - top) // pitch)
    cols = int(np.ceil(pw))
    stem = np.zeros((n_rows, cols), dtype=bool)   # full-height strokes
    tbar = np.zeros((n_rows, cols), dtype=bool)   # strokes along the top
    bbar = np.zeros((n_rows, cols), dtype=bool)   # strokes along the bottom
    for r in range(n_rows):
        x = left + rng.uniform(0, 0.05) * pw
        while x < right:
            end = min(x + rng.uniform(0.04, 0.14) * pw, right)
            while x + stroke < end:
                lw = letter * rng.uniform(0.6, 1.4)
                x0, x1 = int(x), int(min(x + lw - stroke, end))
                stem[r, x0:x0 + stroke] = True
                if rng.random() < 0.6:
                    stem[r, max(x1 - stroke, x0):x1] = True
                if rng.random() < 0.3:
                    tbar[r, x0:x1] = True
                if rng.random() < 0.3:
                    bbar[r, x0:x1] = True
                x += lw
            x = end + rng.uniform(0.015, 0.03) * pw
    row = np.floor((vr - top) / pitch).astype(np.int64)
    yoff = vr - top - row * pitch
    ui = np.floor(ur).astype(np.int64)
    inside = (row >= 0) & (row < n_rows) & (yoff < band) & (ui >= 0) & (ui < cols)
    ri, ci, yi = row[inside], ui[inside], yoff[inside]
    ink = np.zeros(u.shape, dtype=bool)
    ink[inside] = (stem[ri, ci] | (tbar[ri, ci] & (yi < stroke))
                   | (bbar[ri, ci] & (yi >= band - stroke)))
    for x in (np.arange(rules) + 0.5) * ((right - left) / max(rules, 1)) + left:
        ink |= (np.abs(ur - x) < stroke) & (vr >= 0.02 * ph) & (vr <= 0.98 * ph)
    return ink


def _paper(u: np.ndarray, v: np.ndarray, ph: int, pw: int,
           rng: np.random.Generator, level: float = 226.0) -> np.ndarray:
    """Paper brightness with a smooth illumination falloff."""
    gu, gv = rng.uniform(-1, 1, size=2)
    shade = 18.0 * (gu * (u / pw - 0.5) + gv * (v / ph - 0.5))
    return level + shade


def _background(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """Dark smooth texture (a wooden desk, say) with fine noise."""
    gh, gw = max(height // 40, 2), max(width // 40, 2)
    coarse = rng.uniform(35.0, 75.0, size=(gh + 1, gw + 1))
    yy = np.linspace(0, gh, height)
    xx = np.linspace(0, gw, width)
    y0 = np.minimum(np.floor(yy).astype(int), gh - 1)
    x0 = np.minimum(np.floor(xx).astype(int), gw - 1)
    fy = (yy - y0)[:, None]
    fx = (xx - x0)[None, :]
    c00 = coarse[y0][:, x0]
    c01 = coarse[y0][:, x0 + 1]
    c10 = coarse[y0 + 1][:, x0]
    c11 = coarse[y0 + 1][:, x0 + 1]
    smooth = (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy
    return smooth + rng.normal(0.0, 2.0, size=(height, width))


def _homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        a[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[i], b[i + 4] = u, v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)
