"""Seeded numpy generators of test images (no PIL, no cv2, no torch):
document photos and pages for DocScanner and morph_seq, night scenes for
the night pipelines, daylight landscapes for the landscape pipeline,
noisy portraits for the face pipeline and a mix of the four for the
classifier; also the classifier's random CLIP weights and BPE merges.

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

from typing import Tuple

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


def page(seed: int, height: int = 1200, width: int = 849,
         tilt_deg: float = 0.0, rules: int = 0, paper: float = 226.0) -> np.ndarray:
    """A flat (height, width, 3) uint8 page with text rows and ``rules``
    table column lines on paper of mean brightness ``paper``.
    (DocScanner's deskew statistic folds line normals to [-90, 90)
    degrees, so near-vertical lines carry the skew and horizontal ones
    fold to about -90 and drop out.)"""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    gray = _paper(u, v, height, width, rng, paper)
    ink = _text_ink(u, v, height, width, tilt_deg, rng, rules)
    gray = np.where(ink, rng.uniform(25, 60), gray)
    gray = gray + rng.normal(0.0, 2.0, size=gray.shape)
    rgb = np.stack([gray + 3.0, gray, gray - 4.0], axis=-1)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def white_page(seed: int, height: int = 1600, width: int = 1200) -> np.ndarray:
    """A scanned page on bright paper (~244), the notebook's DOCUMENT
    category: > 70% of its HSV V over 230 and ~14% of its Laplacian over
    150 (:func:`page` at the default paper level has ~30% over 230)."""
    return page(seed, height, width, paper=244.0)


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


def landscape_scene(seed: int, height: int = 853, width: int = 1280) -> np.ndarray:
    """A (height, width, 3) uint8 daylight landscape: a bright blue sky
    brightening toward a hilly horizon (Lab L ~170-240, where the sky
    protection keeps most of the original), with a few soft clouds, over
    darker green-brown ground with grass texture and rocks in the
    foreground, and sensor noise."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    phase = rng.uniform(0, 2 * np.pi, 3)
    xn = u[0] / width
    horizon = height * (0.45 + 0.06 * np.sin(2 * np.pi * 1.1 * xn + phase[0])
                        + 0.03 * np.sin(2 * np.pi * 2.9 * xn + phase[1])
                        + 0.012 * np.sin(2 * np.pi * 8.3 * xn + phase[2]))
    t = np.clip(v / horizon[None, :], 0.0, 1.0)[..., None]
    sky = np.array([90.0, 150.0, 235.0]) * (1 - t) + np.array([200.0, 220.0, 240.0]) * t
    for _ in range(int(rng.integers(3, 7))):
        cy, cx = rng.uniform(0.05, 0.35) * height, rng.uniform(0.0, 1.0) * width
        ry, rx = rng.uniform(0.03, 0.07) * height, rng.uniform(0.08, 0.2) * width
        cloud = np.exp(-(((v - cy) / ry) ** 2 + ((u - cx) / rx) ** 2))
        sky = sky + cloud[..., None] * (np.array([250.0, 250.0, 252.0]) - sky) * 0.8
    depth = np.clip((v - horizon[None, :]) / (height - horizon[None, :] + 1.0), 0.0, 1.0)
    texture = (_background(rng, height, width) - 55.0) / 20.0       # about -1 .. 1
    grass = rng.normal(0.0, 1.0, (height, width)) * (0.3 + 0.7 * depth)
    shade = 0.55 + 0.25 * texture + 0.12 * grass
    ground = np.array([70.0, 105.0, 45.0]) * (1 - depth[..., None] * 0.3) * shade[..., None]
    for _ in range(int(rng.integers(4, 9))):
        cy, cx = rng.uniform(0.7, 1.0) * height, rng.uniform(0.0, 1.0) * width
        r = rng.uniform(0.02, 0.06) * width
        rock = np.exp(-((v - cy) ** 2 + (u - cx) ** 2) / (2 * r * r))
        ground = ground + rock[..., None] * (np.array([120.0, 110.0, 100.0]) - ground) * 0.9
    rgb = np.where((v < horizon[None, :])[..., None], sky, ground)
    rgb += rng.normal(0.0, 2.0, size=rgb.shape)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def shadowed_scene(seed: int, height: int = 853, width: int = 1280) -> np.ndarray:
    """A (height, width, 3) uint8 sunlit street scene with a soft cast
    shadow: a pale sky band over sunlit walls with window rows and a
    pavement (HSV V ~130-240), crossed by the shadow of something out of
    frame, a tilted edge softened over ~2% of the width plus a round
    blob, covering 30-50% of the image at 25-33% of the light with a
    bluish skylight tint (V ~40-90 there: under the presets' 80-110
    thresholds, so the shadow mask is neither empty nor full)."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    xn, yn = u / width, v / height
    sky_end = rng.uniform(0.15, 0.25)
    ground = rng.uniform(0.65, 0.75)
    sky = np.array([170.0, 200.0, 235.0]) + 15.0 * yn[..., None] / sky_end
    wall_tone = rng.uniform(0.85, 1.0, 3) * np.array([225.0, 205.0, 175.0])
    texture = (_background(rng, height, width) - 55.0) / 20.0       # about -1 .. 1
    wall = wall_tone * (1.0 + 0.04 * texture)[..., None]
    pitch_x, pitch_y = rng.uniform(0.08, 0.12) * width, rng.uniform(0.12, 0.16) * height
    win = ((np.mod(u, pitch_x) < 0.45 * pitch_x) & (np.mod(v - sky_end * height, pitch_y)
                                                  < 0.5 * pitch_y))
    wall = np.where(win[..., None], wall * 0.55 + np.array([40.0, 50.0, 70.0]), wall)
    pave = np.array([200.0, 195.0, 185.0]) * (1.0 + 0.06 * texture)[..., None]
    rgb = np.where((yn < sky_end)[..., None], sky,
                   np.where((yn < ground)[..., None], wall, pave))
    # the shadow: a tilted edge placed so that 30-50% falls behind it, and a blob
    ang = rng.uniform(-0.6, 0.6)
    d = (np.cos(ang) * (xn - 0.5) + np.sin(ang) * (yn - 0.5)) * width
    d = d - np.quantile(d, 1.0 - rng.uniform(0.3, 0.42))
    soft = 0.02 * width
    s = 1.0 / (1.0 + np.exp(-np.clip(d / soft, -40.0, 40.0)))
    by, bx = rng.uniform(0.3, 0.7) * height, rng.uniform(0.2, 0.8) * width
    br = rng.uniform(0.08, 0.14) * width
    blob = 1.0 / (1.0 + np.exp(-np.clip((br - np.hypot(v - by, u - bx)) / soft, -40.0, 40.0)))
    s = np.maximum(s, blob)
    dark = rng.uniform(0.25, 0.33)
    light = 1.0 - s[..., None] * (1.0 - dark * np.array([0.9, 0.95, 1.15]))
    rgb = rgb * light + rng.normal(0.0, 2.0, size=rgb.shape)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


PORTRAIT_NOISE = ("gaussian", "impulse")


def _paint(rgb: np.ndarray, dist: np.ndarray, colour, soft: float) -> np.ndarray:
    """``rgb`` with ``colour`` laid over the region dist <= 0 (``dist`` in
    pixels, negative inside), its edge a linear ramp ``soft`` pixels wide."""
    a = np.clip(0.5 - dist / soft, 0.0, 1.0)[..., None]
    return rgb * (1.0 - a) + np.asarray(colour, dtype=np.float64) * a


def _ellipse_dist(u, v, cx, cy, ax, ay) -> np.ndarray:
    """About the distance in pixels to the ellipse's outline (< 0 inside)."""
    return (np.sqrt(((u - cx) / ax) ** 2 + ((v - cy) / ay) ** 2) - 1.0) * min(ax, ay)


# (h, w) of eye regions beside the portraits' own: odd widths, heights no
# multiple of 4 (CLAHE's padded tile geometry), 33-61 px
EYE_EDGE_SHAPES = ((31, 45), (37, 51), (44, 61), (53, 33), (61, 57), (35, 39), (48, 47),
                   (59, 43))


def portrait_eye_shape(height: int = 1280, width: int = 853) -> Tuple[int, int]:
    """(h, w) of the two eye boxes ``portrait`` returns at this size (57 x
    69 at 1280 x 853)."""
    ax, ay = width * 0.27, height * 0.26
    return max(int(round(0.17 * ay)), 3), max(int(round(0.30 * ax)), 3)


def eye_region_shapes(height: int = 1280, width: int = 853) -> Tuple[Tuple[int, int], ...]:
    """The eye regions the face path runs on a portrait of this size, then
    ``EYE_EDGE_SHAPES``."""
    return (portrait_eye_shape(height, width),) + EYE_EDGE_SHAPES


def portrait(seed: int, height: int = 1280, width: int = 853, noise: str = "gaussian"):
    """A (height, width, 3) uint8 head-and-shoulders portrait and its two
    eye boxes [(x, y, w, h), (x, y, w, h)] (the image's left eye first).

    A shaded skin-toned face and neck (every skin pixel inside the face
    pipeline's YCrCb box, Cr 133-173 and Cb 77-127, before the noise),
    dark hair over the head, two darker eyes (white, a brown iris, a black
    pupil) under brows, lips, shoulders and a cool background, every edge
    a ramp a few pixels wide. Then seeded sensor noise: ``"gaussian"`` adds
    N(0, 10) to every value; ``"impulse"`` sets 6% of the pixels to black
    or white (salt and pepper). The face pipeline's kurtosis classifier
    reads the first near 3 and the second far above its threshold of 5."""
    if noise not in PORTRAIT_NOISE:
        raise ValueError(f"noise must be one of {PORTRAIT_NOISE}, got {noise!r}")
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    yn, xn = v / height, u / width
    soft = max(8.0, 0.006 * width)
    rgb = (np.array([150.0, 165.0, 185.0]) * (0.95 - 0.15 * yn[..., None])
           + 6.0 * np.sin(2 * np.pi * (xn * rng.uniform(1, 3) + yn * rng.uniform(1, 3)))[..., None])
    cx, cy = width * rng.uniform(0.48, 0.52), height * rng.uniform(0.40, 0.44)
    ax, ay = width * 0.27, height * 0.26
    rgb = _paint(rgb, np.maximum(cy + 1.3 * ay - v, np.abs(u - cx) - width * 0.42),
                 (60.0, 70.0, 110.0), soft)                                  # shoulders
    rgb = _paint(rgb, np.maximum(_ellipse_dist(u, v, cx, cy - 0.12 * ay, 1.12 * ax, 1.12 * ay),
                                 v - (cy - 0.3 * ay)), (55.0, 38.0, 28.0), soft)   # hair
    # skin: shade 0.78-1.0 of (228, 176, 146) keeps Cr ~151-158 and Cb ~100-105
    shade = (0.9 + 0.07 * np.cos(np.pi * np.clip((u - cx) / ax, -1, 1))
             - 0.05 * np.clip((v - cy) / ay, -1, 1.5))
    skin = np.array([228.0, 176.0, 146.0]) * np.clip(shade, 0.78, 1.0)[..., None]
    neck = np.maximum(np.abs(u - cx) - 0.45 * ax, np.maximum(cy - v, v - (cy + 1.4 * ay)))
    face = np.maximum(_ellipse_dist(u, v, cx, cy, ax, ay), cy - 0.33 * ay - v)
    a = np.clip(0.5 - np.minimum(face, neck) / soft, 0.0, 1.0)[..., None]
    rgb = rgb * (1.0 - a) + skin * a
    rgb = _paint(rgb, _ellipse_dist(u, v, cx, cy + 0.55 * ay, 0.32 * ax, 0.07 * ay),
                 (180.0, 90.0, 95.0), soft)                                  # lips
    eh, ew = portrait_eye_shape(height, width)
    boxes = []
    for side in (-1, 1):
        ex, ey = cx + side * 0.42 * ax, cy - 0.12 * ay
        rgb = _paint(rgb, _ellipse_dist(u, v, ex, ey - 0.9 * eh, 0.6 * ew, 0.12 * eh + 1),
                     (60.0, 42.0, 30.0), soft)                               # brow
        rgb = _paint(rgb, _ellipse_dist(u, v, ex, ey, 0.5 * ew, 0.35 * eh),
                     (235.0, 232.0, 228.0), soft)
        rgb = _paint(rgb, _ellipse_dist(u, v, ex, ey, 0.3 * eh, 0.3 * eh), (95.0, 60.0, 35.0),
                     soft)
        rgb = _paint(rgb, _ellipse_dist(u, v, ex, ey, 0.13 * eh, 0.13 * eh), (12.0, 10.0, 10.0),
                     soft)
        boxes.append((int(round(ex - ew / 2)), int(round(ey - eh / 2)), ew, eh))
    if noise == "gaussian":
        rgb = rgb + rng.normal(0.0, 10.0, size=rgb.shape)
    out = np.clip(np.rint(rgb), 0, 255).astype(np.uint8)
    if noise == "impulse":
        hit = rng.random((height, width)) < 0.06
        salt = rng.random((height, width)) < 0.5
        out[hit & salt] = 255
        out[hit & ~salt] = 0
    return out, boxes


def face_photo(seed: int, height: int = 1280, width: int = 853) -> np.ndarray:
    """A (height, width, 3) uint8 front-facing head and shoulders that the
    frontal-face Haar cascade finds (``portrait``'s face, with its bright
    eye whites, it does not): a skin-toned oval face (inside the face
    pipeline's YCrCb box) with shaded eye sockets under dark brows, a
    lighter nose ridge and a mouth, hair, a neck, shoulders, a cool
    background and N(0, 4) noise; every edge a ramp a few pixels wide."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    soft = max(3.0, 0.006 * width)
    rgb = np.array([120.0, 140.0, 160.0]) * (1.0 - 0.2 * v / height)[..., None]
    cx, cy = width * rng.uniform(0.47, 0.53), height * rng.uniform(0.43, 0.47)
    ax, ay = width * 0.30, height * 0.27
    rgb = _paint(rgb, np.maximum(cy + 1.25 * ay - v, np.abs(u - cx) - width * 0.42),
                 (50.0, 60.0, 100.0), soft)                                  # shoulders
    rgb = _paint(rgb, np.maximum(_ellipse_dist(u, v, cx, cy - 0.1 * ay, 1.1 * ax, 1.1 * ay),
                                 v - (cy - 0.55 * ay)), (50.0, 35.0, 25.0), soft)   # hair
    rgb = _paint(rgb, np.maximum(np.abs(u - cx) - 0.4 * ax,
                                 np.maximum(cy - v, v - (cy + 1.3 * ay))),
                 (205.0, 150.0, 120.0), soft)                                # neck
    rgb = _paint(rgb, np.maximum(_ellipse_dist(u, v, cx, cy, ax, ay), cy - 0.55 * ay - v),
                 (225.0, 170.0, 140.0), soft)                                # face
    for side in (-1, 1):
        ex, ey = cx + side * 0.4 * ax, cy - 0.15 * ay
        rgb = _paint(rgb, _ellipse_dist(u, v, ex, ey, 0.3 * ax, 0.13 * ay),
                     (70.0, 45.0, 40.0), soft)                               # eye socket
        rgb = _paint(rgb, _ellipse_dist(u, v, ex, ey - 0.22 * ay, 0.3 * ax, 0.04 * ay),
                     (45.0, 30.0, 25.0), soft)                               # brow
    rgb = _paint(rgb, np.maximum(np.abs(u - cx) - 0.08 * ax, np.abs(v - (cy + 0.1 * ay)) - 0.2 * ay),
                 (240.0, 195.0, 170.0), soft)                                # nose ridge
    rgb = _paint(rgb, _ellipse_dist(u, v, cx, cy + 0.55 * ay, 0.35 * ax, 0.06 * ay),
                 (150.0, 70.0, 75.0), soft)                                  # mouth
    rgb = rgb + rng.normal(0.0, 4.0, size=rgb.shape)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


SCENE_KINDS = ("nightscape", "landscape", "face", "document")


def scene_mix(seed: int, height: int = 853, width: int = 1280):
    """The classifier's mix: 8 (kind, (H, W, 3) uint8 image) pairs, two of
    each of ``SCENE_KINDS``: night and landscape scenes of height x width,
    and portraits and document photos held upright (width x height), so
    that a batch holds two shape groups. The first portrait is a
    ``face_photo``, which the face cascade finds; the second a
    ``portrait``, whose eyes the eye cascade finds and whose face it does
    not."""
    mix = []
    for i in range(2):
        s = seed + 10 * i
        face = face_photo(s + 2, width, height) if i == 0 else portrait(s + 2, width, height)[0]
        mix += [("nightscape", night_scene(s, height, width)),
                ("landscape", landscape_scene(s + 1, height, width)),
                ("face", face),
                ("document", document_photo(s + 3, width, height))]
    return mix


def _clip_rand(rng: np.random.Generator, *shape, scale: float = 0.02) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32) * scale


def clip_state_dict(seed: int = 7) -> dict:
    """A random open_clip-layout state dict at ViT-B/32's real shapes
    (vision 768 wide, 12 layers, patch 32, out 512; text vocab 49408,
    context 77, 512 wide, 12 layers; ~151M float32 values), drawn in the
    order of tpuimage's tests/test_clip_numerics.py ``make_state_dict``,
    so the same seed gives the same arrays."""
    rng = np.random.default_rng(seed)
    sd = {"visual.conv1.weight": _clip_rand(rng, 768, 3, 32, 32),
          "visual.class_embedding": _clip_rand(rng, 768),
          "visual.positional_embedding": _clip_rand(rng, 50, 768)}
    for p, w in (("visual.ln_pre", 768), ("visual.ln_post", 768), ("ln_final", 512)):
        sd[p + ".weight"] = 1.0 + _clip_rand(rng, w)
        sd[p + ".bias"] = _clip_rand(rng, w)
    sd["visual.proj"] = _clip_rand(rng, 768, 512)
    sd["token_embedding.weight"] = _clip_rand(rng, 49408, 512)
    sd["positional_embedding"] = _clip_rand(rng, 77, 512)
    sd["text_projection"] = _clip_rand(rng, 512, 512)

    def add_block(prefix, width):
        for ln in ("ln_1", "ln_2"):
            sd[f"{prefix}.{ln}.weight"] = 1.0 + _clip_rand(rng, width)
            sd[f"{prefix}.{ln}.bias"] = _clip_rand(rng, width)
        sd[f"{prefix}.attn.in_proj_weight"] = _clip_rand(rng, 3 * width, width)
        sd[f"{prefix}.attn.in_proj_bias"] = _clip_rand(rng, 3 * width)
        sd[f"{prefix}.attn.out_proj.weight"] = _clip_rand(rng, width, width)
        sd[f"{prefix}.attn.out_proj.bias"] = _clip_rand(rng, width)
        sd[f"{prefix}.mlp.c_fc.weight"] = _clip_rand(rng, 4 * width, width)
        sd[f"{prefix}.mlp.c_fc.bias"] = _clip_rand(rng, 4 * width)
        sd[f"{prefix}.mlp.c_proj.weight"] = _clip_rand(rng, width, 4 * width)
        sd[f"{prefix}.mlp.c_proj.bias"] = _clip_rand(rng, width)

    for i in range(12):
        add_block(f"visual.transformer.resblocks.{i}", 768)
        add_block(f"transformer.resblocks.{i}", 512)
    return sd


def prompt_merges():
    """A BPE merges list that merges every distinct word of the four
    classifier prompts whole, left to right, with ``</w>`` word endings:
    the structure of the real bpe_simple_vocab_16e6 rules, which are not
    in the repository. (Reads the prompts from ``classify.clip``.)"""
    from tpuimage_torch.classify.clip import PROMPTS
    words = sorted({w for p in PROMPTS.values() for w in p.lower().split()})
    merges = []
    for wd in words:
        if len(wd) < 2:
            continue
        syms = list(wd[:-1]) + [wd[-1] + "</w>"]
        while len(syms) > 1:
            merges.append((syms[0], syms[1]))
            syms = [syms[0] + syms[1]] + syms[2:]
    return merges


# ---------------------------------------------------------------------------
# inputs chosen to break a kernel, for the card tests and the card run
# ---------------------------------------------------------------------------

def edge_lists(edge_maps, k: int):
    """(B, H, W) boolean maps -> (xs, ys, counts): each map's edges in
    row-major order as (B, K) int32 coordinate lists, K = min(k, the
    largest count) and at least 1, 0 past a map's kept edges, and the
    (B,) int32 counts as found (so a count may exceed K, which caps it)."""
    found = [np.nonzero(m) for m in edge_maps]
    counts = np.array([len(ys) for ys, _ in found], np.int32)
    width = max(min(k, int(counts.max(initial=0))), 1)
    xs = np.zeros((len(found), width), np.int32)
    ys = np.zeros_like(xs)
    for b, (yy, xx) in enumerate(found):
        n = min(len(yy), width)
        xs[b, :n], ys[b, :n] = xx[:n], yy[:n]
    return xs, ys, counts


def hough_stress_cases(seed: int = 0):
    """Coordinate lists that stress a Hough vote kernel, as (name, xs, ys,
    counts, height, width): whole rows and whole columns of edges (at theta
    90 a whole warp of the row-major list votes for one bin, at theta 0 a
    column does); every pixel an edge with the list capped below the count;
    lists of 0, 1, 31, 32, 33 and 65 edges around the warp size, on one row
    and scattered; a sparse 1600x1200 map with a full row, a full column
    and a diagonal (the photo's numrho); 24 maps of 2400x1800 whose edges
    span the whole map (more maps than a kernel with a block per
    multiprocessor can share its blocks among, and rho rows that fit
    shared memory only a few thetas at a time), one of them empty; and
    1030 tiny maps (a batch past any per-image bookkeeping)."""
    rng = np.random.default_rng(seed)
    lines = np.zeros((2, 240, 320), bool)
    lines[0, [10, 11, 100, 239]] = True
    lines[0][:, [0, 5, 6, 200]] = True
    lines[1, 77] = True
    yield ("rows_and_columns", *edge_lists(lines, 10 ** 6), 240, 320)
    full = np.ones((2, 96, 128), bool)
    full[1, 40:] = False
    yield ("every_pixel_capped", *edge_lists(full, 5000), 96, 128)
    sizes = [0, 1, 31, 32, 33, 65]
    xs = np.zeros((2 * len(sizes), 65), np.int32)
    ys = np.zeros_like(xs)
    for i, n in enumerate(sizes):
        xs[i, :n], ys[i, :n] = np.arange(n) + 3, 17            # one row
        xs[len(sizes) + i, :n] = rng.integers(0, 80, n)         # scattered
        ys[len(sizes) + i, :n] = rng.integers(0, 60, n)
    yield ("counts_around_a_warp", xs, ys, np.array(sizes * 2, np.int32), 60, 80)
    photo = rng.random((1, 1600, 1200)) < 0.01
    photo[0, 801] = True
    photo[0][:, 1199] = True
    photo[0, np.arange(1200), np.arange(1200)] = True
    yield ("photo_numrho", *edge_lists(photo, 10 ** 6), 1600, 1200)
    n = 1500
    xs, ys = rng.integers(0, 1800, (24, n)), rng.integers(0, 2400, (24, n))
    xs[:, :2], ys[:, :2] = (0, 1799), (0, 2399)                 # the map's corners
    counts = np.full(24, n, np.int32)
    counts[5] = 0
    yield ("many_large_maps", xs.astype(np.int32), ys.astype(np.int32), counts, 2400, 1800)
    counts = rng.integers(0, 6, 1030).astype(np.int32)
    yield ("many_tiny_maps", rng.integers(0, 8, (1030, 5)).astype(np.int32),
           rng.integers(0, 8, (1030, 5)).astype(np.int32), counts, 8, 8)


# (B, H, W) shapes for a separable blur: an odd width with rows off every
# word boundary and a height that no tile or register block divides; a
# width of 1; a plane narrower and shorter than most radii; one row; and a
# plane just past one tile in both directions
BLUR_STRESS_SHAPES = ((2, 70, 849), (2, 37, 1), (3, 13, 9), (1, 1, 40), (2, 67, 131))
# the smallest kernels; the last and the first ksize of each step count of
# the tensor-core form (17 | 19, 49 | 51, 81) and the first of the
# sliding-window form behind it (83), the post-warp chain's 43 and 51 among
# them; the widest tiled one and the first of the split form
BLUR_STRESS_KSIZES = (1, 3, 17, 19, 43, 49, 51, 81, 83, 255, 257)
# every (mode, C) of gauss_chain: the adaptive threshold with and without
# an offset
CHAIN_STRESS_MODES = (("divide", 0.0), ("subtract", 0.0), ("sub", 0.0), ("adaptive", 3.0),
                      ("adaptive", 0.0))


def blur_stress_planes(shape, seed: int = 0) -> np.ndarray:
    """(B, H, W) uint8: random bytes, with the second plane (if any) a
    two-level checkerboard, whose means sit on rounding ties."""
    rng = np.random.default_rng(seed + shape[1] * shape[2])
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    if shape[0] > 1:
        yy, xx = np.mgrid[:shape[1], :shape[2]]
        x[1] = 100 + (yy + xx) % 2
    return x
