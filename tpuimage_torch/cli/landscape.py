"""Landscape batch CLI (counterpart of ``tpuimage.cli.landscape``): for
every image in a file or folder, enhance the original and
degrade-then-restore it, with PSNR / SSIM (stage PNGs and a metrics CSV).

Adds ``--device`` (the package docstring). The degradation noise comes
from one ``torch.Generator`` on the device seeded with ``--seed``, drawn
file after file; tpuimage splits ``jax.random.PRNGKey(seed)`` per file. So
at the same seed ``degraded``, ``restored`` and their metrics differ from
tpuimage's, while ``enhanced`` and its metrics do not. Each image is
isolated as in the reference: a failure prints a ``FAILED`` line and the
batch goes on.
"""
from __future__ import annotations

import argparse
import csv
import glob
import os

import torch

from tpuimage_torch.cli import add_device_argument, start
from tpuimage_torch.io.imageio import ensure_dir, load_image_rgb, save_image
from tpuimage_torch.pipelines import landscape


def collect(path: str):
    if os.path.isfile(path):
        return [path]
    exts = ("*.jpg", "*.jpeg", "*.png", "*.bmp")
    files = []
    for e in exts:
        files.extend(sorted(glob.glob(os.path.join(path, e))))
    return files


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Batch landscape enhancement + "
                                "degrade/restore evaluation")
    p.add_argument("input", help="image file or folder")
    p.add_argument("--out", default="outputs")
    p.add_argument("--seed", type=int, default=0,
                   help="seed for the degradation noise (the reference used "
                        "unseeded np.random)")
    p.add_argument("--report", action="store_true",
                   help="render the Landscape.py:270-356 2x4 matplotlib "
                        "report per image (saved, not shown)")
    p.add_argument("--compare", action="store_true",
                   help="write a side-by-side before/after composite per "
                        "image (compare-viewer replacement)")
    add_device_argument(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = start(args, __name__)
    files = collect(args.input)
    if not files:
        raise SystemExit(f"no images under {args.input}")
    ensure_dir(args.out)

    rows = []
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for i, f in enumerate(files):
        try:
            rgb = load_image_rgb(f)
            res = landscape.landscape_eval_step(torch.from_numpy(rgb).to(dev), generator=gen)
            stem = os.path.splitext(os.path.basename(f))[0]
            for k in ("enhanced", "degraded", "restored"):
                save_image(os.path.join(args.out, f"{stem}_{k}.png"), res[k])
            if args.report:
                from tpuimage_torch.io.report import landscape_report
                landscape_report(
                    os.path.join(args.out, f"{stem}_report.png"),
                    os.path.basename(f), rgb, res["enhanced"].cpu().numpy(),
                    res["degraded"].cpu().numpy(), res["restored"].cpu().numpy(),
                    float(res["psnr_enhanced"]), float(res["ssim_enhanced"]),
                    float(res["psnr_restored"]), float(res["ssim_restored"]))
            if args.compare:
                from tpuimage_torch.io.report import write_compare
                write_compare(os.path.join(args.out, f"{stem}_compare.png"),
                              rgb, res["enhanced"].cpu().numpy())
            row = {"file": os.path.basename(f),
                   "psnr_enhanced": float(res["psnr_enhanced"]),
                   "ssim_enhanced": float(res["ssim_enhanced"]),
                   "psnr_restored": float(res["psnr_restored"]),
                   "ssim_restored": float(res["ssim_restored"])}
            rows.append(row)
            print(f"[{i + 1}/{len(files)}] {row}")
        except Exception as e:  # per-image isolation (Landscape.py:236-238)
            print(f"[{i + 1}/{len(files)}] FAILED {f}: {e}")
    if not rows:
        raise SystemExit("all images failed")

    with open(os.path.join(args.out, "landscape_metrics.csv"), "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"Done. Outputs in {args.out}")


if __name__ == "__main__":
    main()
