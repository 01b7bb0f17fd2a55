"""Seeded numpy generators of test images (no PIL, no cv2, no torch):
document photos and pages for DocScanner and morph_seq, and night scenes
for the night pipelines.

``document_photo`` draws a textured dark background and, optionally, a
bright page quad under mild perspective carrying rows of dark text
strokes; ``page`` renders such a page flat, as the warp would deliver it.
``tilt_deg`` rotates the text inside the page, so DocScanner's deskew
finds a nonzero angle; ``with_page=False`` gives a photo with no page, so the
use-whole fallback runs. All sizes scale with the image, so the same
generator serves 320x240 test photos and 1600x1200 ones (height x width,
portrait, as a phone holds them).
"""
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
           rng: np.random.Generator) -> np.ndarray:
    """Paper brightness with a smooth illumination falloff."""
    gu, gv = rng.uniform(-1, 1, size=2)
    shade = 18.0 * (gu * (u / pw - 0.5) + gv * (v / ph - 0.5))
    return 226.0 + shade


def page(seed: int, height: int = 1200, width: int = 849,
         tilt_deg: float = 0.0, rules: int = 0) -> np.ndarray:
    """A flat (height, width, 3) uint8 page with text rows and ``rules``
    table column lines. (DocScanner's deskew statistic folds line normals
    to [-90, 90) degrees, so near-vertical lines carry the skew and
    horizontal ones fold to about -90 and drop out.)"""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    gray = _paper(u, v, height, width, rng)
    ink = _text_ink(u, v, height, width, tilt_deg, rng, rules)
    gray = np.where(ink, rng.uniform(25, 60), gray)
    gray = gray + rng.normal(0.0, 2.0, size=gray.shape)
    rgb = np.stack([gray + 3.0, gray, gray - 4.0], axis=-1)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


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


def document_photo(seed: int, height: int = 1600, width: int = 1200,
                   with_page: bool = True, tilt_deg: float = 0.0,
                   rules: int = 0) -> np.ndarray:
    """A (height, width, 3) uint8 photo: textured background and, when
    ``with_page``, a portrait page quad carrying text rows and ``rules``
    table column lines, tilted by ``tilt_deg``. The page fills most of the frame, as in a phone photo of
    a document: 88% of the height at the A4 ratio, corners jittered by up
    to 1.5% of the height. (Localize draws every Hough line across the
    whole image, so the page's contour keeps short arms out to the image
    border; the quad fit's approxPolyDP drops arms shorter than its
    tolerance, 2% of the perimeter, which a page this large keeps.)"""
    rng = np.random.default_rng(seed)
    bg = _background(rng, height, width)
    tint = rng.uniform(-6, 6, size=3)
    gray = bg
    if with_page:
        ph = 0.88 * height
        pw = ph / np.sqrt(2.0)
        cy = height / 2.0 + rng.uniform(-0.01, 0.01) * height
        cx = width / 2.0 + rng.uniform(-0.01, 0.01) * width
        rect = np.array([[-pw / 2, -ph / 2], [pw / 2, -ph / 2],
                         [pw / 2, ph / 2], [-pw / 2, ph / 2]])
        quad = rect + np.array([cx, cy]) \
            + rng.uniform(-0.015, 0.015, size=(4, 2)) * height
        page_rect = np.array([[0, 0], [pw, 0], [pw, ph], [0, ph]])
        hmat = _homography(quad, page_rect)
        v, u = np.mgrid[0:height, 0:width].astype(np.float64)
        den = hmat[2, 0] * u + hmat[2, 1] * v + hmat[2, 2]
        pu = (hmat[0, 0] * u + hmat[0, 1] * v + hmat[0, 2]) / den
        pv = (hmat[1, 0] * u + hmat[1, 1] * v + hmat[1, 2]) / den
        on = (pu >= 0) & (pu < pw) & (pv >= 0) & (pv < ph)
        paper = _paper(pu, pv, ph, pw, rng)
        ink = _text_ink(pu, pv, int(ph), int(pw), tilt_deg, rng, rules)
        content = np.where(ink, rng.uniform(25, 60), paper)
        gray = np.where(on, content + rng.normal(0.0, 2.0, size=bg.shape), bg)
    rgb = np.stack([gray + tint[0], gray + tint[1], gray + tint[2]], axis=-1)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def night_scene(seed: int, height: int = 853, width: int = 1280) -> np.ndarray:
    """A (height, width, 3) uint8 night landscape: a dark sky brightening
    toward a hilly horizon, darker ground, a few bright warm lights with
    soft glows, and sensor noise. Most pixels lie in 0-60, so CLAHE's clip
    limit binds."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    phase = rng.uniform(0, 2 * np.pi, 3)
    xn = u[0] / width
    horizon = height * (0.58 + 0.05 * np.sin(2 * np.pi * 1.3 * xn + phase[0])
                        + 0.025 * np.sin(2 * np.pi * 3.7 * xn + phase[1])
                        + 0.01 * np.sin(2 * np.pi * 9.1 * xn + phase[2]))
    sky = 8.0 + 34.0 * (v / horizon[None, :]) ** 2
    ground = 5.0 + 12.0 * _background(rng, height, width) / 75.0
    base = np.where(v < horizon[None, :], sky, ground)
    rgb = base[..., None] * np.array([0.8, 0.9, 1.2])
    for _ in range(int(rng.integers(6, 12))):
        cy = rng.uniform(0.45, 0.95) * height
        cx = rng.uniform(0.02, 0.98) * width
        core = rng.uniform(0.002, 0.006) * width
        reach = int(8 * core) + 1
        y0, y1 = max(int(cy) - reach, 0), min(int(cy) + reach, height)
        x0, x1 = max(int(cx) - reach, 0), min(int(cx) + reach, width)
        d2 = (v[y0:y1, x0:x1] - cy) ** 2 + (u[y0:y1, x0:x1] - cx) ** 2
        glow = 255.0 * np.exp(-d2 / (2 * core ** 2)) + 60.0 * np.exp(-d2 / (2 * (4 * core) ** 2))
        rgb[y0:y1, x0:x1] += glow[..., None] * np.array([1.0, 0.78, 0.45])
    rgb += rng.normal(0.0, 3.0, size=rgb.shape)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)
