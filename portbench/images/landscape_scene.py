"""A daylight landscape photo, the port's ``synth.landscape_scene`` moved
to torch so that a DIV2K-sized pool is made on the card in a few calls:
a bright blue sky brightening toward a hilly horizon with a few soft
clouds, over darker green-brown ground with grass texture and rocks in
the foreground, and sensor noise. The scalar draws (horizon phases,
cloud and rock places) come from ``rng`` as in the port's form; the
per-pixel noise from a ``torch.Generator`` on ``device`` seeded with
``seed``, so the same seed gives the same photo on the same device."""
from __future__ import annotations

import math

import numpy as np
import torch


def make(seed: int, height: int, width: int, rng: np.random.Generator, params: dict,
         device) -> np.ndarray:
    del params
    return landscape_scene(seed, height, width, rng, device)


def _background(rng: np.random.Generator, gen: torch.Generator, height: int, width: int,
                device) -> torch.Tensor:
    """Dark smooth texture with fine noise: a coarse random grid
    interpolated bilinearly, plus N(0, 2)."""
    gh, gw = max(height // 40, 2), max(width // 40, 2)
    coarse = torch.from_numpy(rng.uniform(35.0, 75.0, size=(gh + 1, gw + 1))).to(device)
    yy = torch.linspace(0, gh, height, dtype=torch.float64, device=device)
    xx = torch.linspace(0, gw, width, dtype=torch.float64, device=device)
    y0 = torch.clamp(torch.floor(yy).long(), max=gh - 1)
    x0 = torch.clamp(torch.floor(xx).long(), max=gw - 1)
    fy = (yy - y0)[:, None]
    fx = (xx - x0)[None, :]
    c00 = coarse[y0][:, x0]
    c01 = coarse[y0][:, x0 + 1]
    c10 = coarse[y0 + 1][:, x0]
    c11 = coarse[y0 + 1][:, x0 + 1]
    smooth = (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy
    noise = torch.randn((height, width), generator=gen, dtype=torch.float64, device=device)
    return smooth + 2.0 * noise


def landscape_scene(seed: int, height: int, width: int, rng: np.random.Generator,
                    device) -> np.ndarray:
    """A (height, width, 3) uint8 landscape in host memory."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    f64 = dict(dtype=torch.float64, device=device)
    v = torch.arange(height, **f64)[:, None]
    u = torch.arange(width, **f64)[None, :]
    phase = rng.uniform(0, 2 * np.pi, 3)
    xn = u[0] / width
    horizon = height * (0.45 + 0.06 * torch.sin(2 * math.pi * 1.1 * xn + phase[0])
                        + 0.03 * torch.sin(2 * math.pi * 2.9 * xn + phase[1])
                        + 0.012 * torch.sin(2 * math.pi * 8.3 * xn + phase[2]))
    t = torch.clamp(v / horizon[None, :], 0.0, 1.0)[..., None]
    sky = (torch.tensor([90.0, 150.0, 235.0], **f64) * (1 - t)
           + torch.tensor([200.0, 220.0, 240.0], **f64) * t)
    white = torch.tensor([250.0, 250.0, 252.0], **f64)
    for _ in range(int(rng.integers(3, 7))):
        cy, cx = rng.uniform(0.05, 0.35) * height, rng.uniform(0.0, 1.0) * width
        ry, rx = rng.uniform(0.03, 0.07) * height, rng.uniform(0.08, 0.2) * width
        cloud = torch.exp(-(((v - cy) / ry) ** 2 + ((u - cx) / rx) ** 2))
        sky = sky + cloud[..., None] * (white - sky) * 0.8
    depth = torch.clamp((v - horizon[None, :]) / (height - horizon[None, :] + 1.0), 0.0, 1.0)
    texture = (_background(rng, gen, height, width, device) - 55.0) / 20.0   # about -1 .. 1
    grass = torch.randn((height, width), generator=gen, **f64) * (0.3 + 0.7 * depth)
    shade = 0.55 + 0.25 * texture + 0.12 * grass
    ground = (torch.tensor([70.0, 105.0, 45.0], **f64) * (1 - depth[..., None] * 0.3)
              * shade[..., None])
    rock_colour = torch.tensor([120.0, 110.0, 100.0], **f64)
    for _ in range(int(rng.integers(4, 9))):
        cy, cx = rng.uniform(0.7, 1.0) * height, rng.uniform(0.0, 1.0) * width
        r = rng.uniform(0.02, 0.06) * width
        rock = torch.exp(-((v - cy) ** 2 + (u - cx) ** 2) / (2 * r * r))
        ground = ground + rock[..., None] * (rock_colour - ground) * 0.9
    rgb = torch.where((v < horizon[None, :])[..., None], sky, ground)
    rgb = rgb + 2.0 * torch.randn(rgb.shape, generator=gen, **f64)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8).cpu().numpy()
