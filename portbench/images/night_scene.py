"""A low-light landscape photo, frozen from the port's
``synth.night_scene``: a dark sky brightening toward a hilly horizon,
darker ground, a few bright warm lights with soft glows, and sensor
noise. Most pixels lie in 0-60 (98.5-99.9% of the values), so CLAHE's
clip limit binds, and each photo's mean gray is under 80, the
classifier's rule for the night route: 15.7-17.7 at LOL's 600x400 over
the pools of 64 seeds (512 photos). ``make`` draws the same photo as
``synth.night_scene(seed, height, width)``."""
from __future__ import annotations

import numpy as np

from portbench.images._common import _background


def make(seed: int, height: int, width: int, rng: np.random.Generator, params: dict,
         device) -> np.ndarray:
    del seed, params, device
    return night_scene(rng, height, width)


def night_scene(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """A (height, width, 3) uint8 night landscape drawn from ``rng``."""
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
