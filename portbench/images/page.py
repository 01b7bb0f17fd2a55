"""A flat A4 page as a scanner or a client app's crop delivers it, frozen
from the port's ``synth.page``: text rows on shaded paper, the text
tilted so that the deskew finds an angle."""
from __future__ import annotations

import numpy as np

from portbench.images._common import _paper, _text_ink


def make(seed: int, height: int, width: int, rng: np.random.Generator, params: dict,
         device) -> np.ndarray:
    """One page; the text tilt is drawn from ``params["tilt_deg"]``
    ([low, high]) with ``rng``, the pixels from ``seed``."""
    del device
    lo, hi = params.get("tilt_deg", (0.0, 0.0))
    return page(seed, height, width, tilt_deg=float(rng.uniform(lo, hi)))


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
