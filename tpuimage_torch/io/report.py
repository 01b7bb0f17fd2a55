"""Review artifacts: side-by-side compare composites and matplotlib report
panels (counterpart of ``tpuimage.io.report``, copied: the port imports
nothing of tpuimage).

- ``compare_composite`` writes a single labeled before/after image (the
  reference's dual-pane compare viewer as a file); its label bars are
  drawn with PIL's default bitmap font;
- ``landscape_report`` / ``night_panel`` render the reference's
  matplotlib report and histogram windows to a file with the Agg backend.

PIL and matplotlib are imported inside the functions that need them, so
the module imports where they are absent; the CLIs' options that call
these (``--compare``, ``--report``) need them where they run.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# compare composite (pure numpy, no matplotlib needed)
# ---------------------------------------------------------------------------

def _to_rgb(img: np.ndarray) -> np.ndarray:
    a = np.asarray(img)
    if a.ndim == 2:
        a = np.repeat(a[..., None], 3, axis=-1)
    return a.astype(np.uint8)


def _label_bar(width: int, text: str, height: int = 18) -> np.ndarray:
    """Dark bar with the label rendered via PIL's default bitmap font."""
    from PIL import Image, ImageDraw
    bar = Image.new("RGB", (width, height), (32, 32, 32))
    ImageDraw.Draw(bar).text((6, 3), text, fill=(230, 230, 230))
    return np.asarray(bar)


def compare_composite(before: np.ndarray, after: np.ndarray,
                      labels: Sequence[str] = ("original", "enhanced"),
                      gap: int = 4) -> np.ndarray:
    """Side-by-side labeled before/after composite (uint8 RGB HWC).

    Shapes may differ (e.g. docscan input vs warped binary): the shorter
    pane is letterboxed with dark gray so rows align.
    """
    a, b = _to_rgb(before), _to_rgb(after)
    h = max(a.shape[0], b.shape[0])

    def pad_to(img):
        out = np.full((h, img.shape[1], 3), 48, np.uint8)
        off = (h - img.shape[0]) // 2
        out[off:off + img.shape[0]] = img
        return out

    a, b = pad_to(a), pad_to(b)
    divider = np.full((h, gap, 3), 255, np.uint8)
    panes = np.concatenate([a, divider, b], axis=1)
    bar_a = _label_bar(a.shape[1], str(labels[0]))
    bar_b = _label_bar(b.shape[1], str(labels[1]))
    bar = np.concatenate([bar_a, np.full((bar_a.shape[0], gap, 3), 255, np.uint8),
                          bar_b], axis=1)
    return np.concatenate([bar, panes], axis=0)


def write_compare(path: str, before: np.ndarray, after: np.ndarray,
                  labels: Sequence[str] = ("original", "enhanced")) -> None:
    from tpuimage_torch.io.imageio import save_image
    save_image(path, compare_composite(before, after, labels))


# ---------------------------------------------------------------------------
# matplotlib report panels
# ---------------------------------------------------------------------------

def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _gray(img: np.ndarray) -> np.ndarray:
    a = np.asarray(img)
    if a.ndim == 2:
        return a
    # luminance for histogram display (the reference uses cvtColor GRAY;
    # display-only here, not a parity surface)
    return (0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]).astype(np.uint8)


def _metrics_text(title: str, stats_before: Dict[str, float],
                  stats_after: Dict[str, float], psnr: float, ssim: float) -> str:
    return (f"""{title}
{'-' * 25}
Brightness:
  Before: {stats_before['brightness']:.1f}
  After:  {stats_after['brightness']:.1f}
  Change: {stats_after['brightness'] - stats_before['brightness']:+.1f}

Contrast (Std):
  Before: {stats_before['contrast']:.1f}
  After:  {stats_after['contrast']:.1f}
  Change: {stats_after['contrast'] - stats_before['contrast']:+.1f}

Quality:
  PSNR: {psnr:.2f} dB
  SSIM: {ssim:.4f}""")


def landscape_report(path: str, filename: str,
                     original: np.ndarray, enhanced_orig: np.ndarray,
                     degraded: np.ndarray, enhanced_deg: np.ndarray,
                     psnr_orig: float, ssim_orig: float,
                     psnr_deg: float, ssim_deg: float) -> None:
    """The Landscape.py:270-356 2x4 report figure, saved to ``path``:
    row 1 = original path (image, enhanced, overlaid grayscale histograms,
    metrics text), row 2 = degraded path."""
    import torch
    from tpuimage_torch.ops.metrics import image_stats

    def stats(img):
        s = image_stats(torch.from_numpy(np.ascontiguousarray(_gray(img))))
        return {k: float(v) for k, v in s.items()}

    plt = _plt()
    fig = plt.figure(figsize=(16, 10))
    fig.suptitle(filename, fontsize=14, fontweight="bold")

    rows = [("Original", original, enhanced_orig, psnr_orig, ssim_orig,
             "green", "Histogram (Original Path)", "ORIGINAL PATH METRICS",
             "gray", "Before", "After"),
            ("Degraded (Noisy)", degraded, enhanced_deg, psnr_deg, ssim_deg,
             "blue", "Histogram (Degraded Path)", "DEGRADED PATH METRICS",
             "red", "Degraded", "Enhanced")]
    for r, (t0, before, after, ps, ss, col, htitle, mtitle,
            hcol, lab0, lab1) in enumerate(rows):
        base = 4 * r
        plt.subplot(2, 4, base + 1)
        plt.imshow(_to_rgb(before))
        plt.title(t0, fontsize=11)
        plt.axis("off")

        plt.subplot(2, 4, base + 2)
        plt.imshow(_to_rgb(after))
        plt.title(f"Enhanced ({t0.split()[0]})\nPSNR:{ps:.1f}dB SSIM:{ss:.3f}",
                  fontsize=10, color=col)
        plt.axis("off")

        plt.subplot(2, 4, base + 3)
        plt.hist(_gray(before).ravel(), bins=256, range=[0, 256],
                 color=hcol, alpha=0.6, label=lab0)
        plt.hist(_gray(after).ravel(), bins=256, range=[0, 256],
                 color=col, alpha=0.6, label=lab1)
        plt.title(htitle, fontsize=10)
        plt.legend(fontsize=8)
        plt.xlabel("Intensity")

        plt.subplot(2, 4, base + 4)
        plt.axis("off")
        plt.text(0.1, 0.5, _metrics_text(mtitle, stats(before), stats(after),
                                         ps, ss),
                 fontsize=9, family="monospace", va="center")

    plt.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def night_panel(path: str, image: np.ndarray, title: str,
                compare_to: Optional[np.ndarray] = None) -> None:
    """asm.py:32-51 panel: image + RGB channel histograms + grayscale
    histogram (1x3); with ``compare_to`` it renders the before/after pair
    plus both grayscale histograms instead (NightLandscapeEnhancement.py
    :58-89 style)."""
    plt = _plt()
    img = _to_rgb(image)
    if compare_to is None:
        fig = plt.figure(figsize=(12, 4))
        plt.subplot(1, 3, 1)
        plt.imshow(img)
        plt.title(title)
        plt.axis("off")
        plt.subplot(1, 3, 2)
        for i, color in enumerate(("r", "g", "b")):
            plt.hist(img[:, :, i].ravel(), bins=256, range=(0, 256),
                     color=color, alpha=0.5, label=color.upper())
        plt.title("RGB Histogram")
        plt.xlabel("Intensity")
        plt.ylabel("Frequency")
        plt.legend()
        plt.subplot(1, 3, 3)
        plt.hist(_gray(img).ravel(), bins=256, range=(0, 256), color="gray")
        plt.title("Grayscale Histogram")
        plt.xlabel("Intensity")
        plt.ylabel("Frequency")
    else:
        ref = _to_rgb(compare_to)
        fig = plt.figure(figsize=(12, 8))
        for i, (im, t) in enumerate(((ref, "Before"), (img, title))):
            plt.subplot(2, 2, i + 1)
            plt.imshow(im)
            plt.title(t)
            plt.axis("off")
            plt.subplot(2, 2, i + 3)
            plt.hist(_gray(im).ravel(), bins=256, range=(0, 256), color="gray")
            plt.title(f"{t} Histogram")
            plt.xlabel("Intensity")
    plt.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
