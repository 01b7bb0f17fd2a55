"""Night-enhancement CLI (counterpart of ``tpuimage.cli.night``): the
gray and RGB variants with stage dumps and 256-bin histogram CSVs.
Adds ``--device`` (the package docstring); the gray conversion and the
histograms are the port's ops on that device."""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpuimage_torch.cli import add_device_argument, start
from tpuimage_torch.io.imageio import ensure_dir, load_image_rgb, save_image
from tpuimage_torch.ops.color import rgb_to_gray
from tpuimage_torch.ops.histogram import hist256
from tpuimage_torch.pipelines import night


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Low-light enhancement "
                                "(median3 + CLAHE), gray or RGB variant")
    p.add_argument("input")
    p.add_argument("--out", default="outputs")
    p.add_argument("--mode", choices=["gray", "rgb"], default="rgb")
    p.add_argument("--histograms", action="store_true",
                   help="write per-stage 256-bin histograms as CSV "
                        "(replaces the matplotlib panels)")
    p.add_argument("--report", action="store_true",
                   help="render the asm.py:32-51 image+histogram panels "
                        "per stage (saved, not shown)")
    p.add_argument("--compare", action="store_true",
                   help="write a side-by-side before/after composite "
                        "(compare-viewer replacement)")
    add_device_argument(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = start(args, __name__)
    rgb = torch.from_numpy(load_image_rgb(args.input)).to(dev)
    ensure_dir(args.out)
    if args.mode == "gray":
        stages = night.night_gray(rgb_to_gray(rgb))
    else:
        stages = night.night_rgb(rgb)
    for name, img in stages.items():
        save_image(os.path.join(args.out, f"night_{name}.png"), img)
        if args.histograms:
            g = img if img.dim() == 2 else rgb_to_gray(img)
            np.savetxt(os.path.join(args.out, f"night_{name}_hist.csv"),
                       hist256(g).cpu().numpy(), fmt="%d")
        if args.report:
            from tpuimage_torch.io.report import night_panel
            night_panel(os.path.join(args.out, f"night_{name}_panel.png"),
                        img.cpu().numpy(), name)
    if args.compare:
        from tpuimage_torch.io.report import write_compare
        write_compare(os.path.join(args.out, "night_compare.png"),
                      stages["original"].cpu().numpy(), stages["enhanced"].cpu().numpy())
    print(f"Done. Outputs in {args.out}")


if __name__ == "__main__":
    main()
