"""A phone photo of a document on a desk, frozen from the port's
``synth.document_photo``: a textured dark background and a bright A4
page under mild perspective carrying rows of dark text strokes, the page
``page_share`` of the photo's height (88% unless the cell says), its
corners jittered by up to 1.5% of it."""
from __future__ import annotations

import numpy as np

from portbench.images._common import _background, _homography, _paper, _text_ink


def make(seed: int, height: int, width: int, rng: np.random.Generator, params: dict,
         device) -> np.ndarray:
    """One photo; the text tilt is drawn from ``params["tilt_deg"]``
    ([low, high]) with ``rng``, the pixels from ``seed``."""
    del device
    lo, hi = params.get("tilt_deg", (0.0, 0.0))
    return document_photo(seed, height, width, tilt_deg=float(rng.uniform(lo, hi)),
                          page_share=params.get("page_share", 0.88))


def document_photo(seed: int, height: int = 1600, width: int = 1200,
                   with_page: bool = True, tilt_deg: float = 0.0,
                   rules: int = 0, page_share: float = 0.88) -> np.ndarray:
    """A (height, width, 3) uint8 photo: textured background and, when
    ``with_page``, a portrait page quad carrying text rows and ``rules``
    table column lines, tilted by ``tilt_deg``. The page fills most of the frame, as in a phone photo of
    a document: ``page_share`` of the height at the A4 ratio, corners jittered by up
    to 1.5% of the height. (Localize draws every Hough line across the
    whole image, so the page's contour keeps short arms out to the image
    border; the quad fit's approxPolyDP drops arms shorter than its
    tolerance, 2% of the perimeter, which a page this large keeps.)"""
    rng = np.random.default_rng(seed)
    bg = _background(rng, height, width)
    tint = rng.uniform(-6, 6, size=3)
    gray = bg
    if with_page:
        ph = page_share * height
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
