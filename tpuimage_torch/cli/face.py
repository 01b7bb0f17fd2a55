"""Face-enhancement CLI (counterpart of ``tpuimage.cli.face``): the
FaceEnhancement.py script workload (noise-adaptive portrait pipeline)
with stage dumps. Adds ``--device`` (the package docstring). The input is
a required argument: tpuimage's default path names a file outside the
repository. ``enhanced_face.jpg`` is a JPEG, so this CLI needs PIL."""
from __future__ import annotations

import argparse
import os

import torch

from tpuimage_torch.cli import add_device_argument, start
from tpuimage_torch.io.imageio import ensure_dir, load_image_rgb, save_image
from tpuimage_torch.pipelines.face import enhance_face


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Noise-adaptive portrait "
                                "enhancement (FaceEnhancement workload)")
    p.add_argument("input")
    p.add_argument("--out", default="outputs")
    p.add_argument("--noise-type", choices=["gaussian", "impulse", "legacy"],
                   default=None, help="override the kurtosis classifier")
    p.add_argument("--variant", choices=["script", "gui"], default="script")
    p.add_argument("--no-eyes", action="store_true", help="skip the eye pop")
    p.add_argument("--compare", action="store_true",
                   help="write a side-by-side before/after composite "
                        "(compare-viewer replacement)")
    add_device_argument(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = start(args, __name__)
    rgb = load_image_rgb(args.input)
    res = enhance_face(torch.from_numpy(rgb).to(dev), noise_type=args.noise_type,
                       eyes=[] if args.no_eyes else None, variant=args.variant)
    ensure_dir(args.out)
    save_image(os.path.join(args.out, "enhanced_face.jpg"), res["final"])
    if args.compare:
        from tpuimage_torch.io.report import write_compare
        write_compare(os.path.join(args.out, "face_compare.png"),
                      rgb, res["final"].cpu().numpy())
    for k in ("skin_mask", "skin_enhanced", "features_popped"):
        save_image(os.path.join(args.out, f"face_{k}.png"), res[k])
    print(f"noise={res['noise_type']} eyes={res['eyes']}. Outputs in {args.out}")


if __name__ == "__main__":
    main()
