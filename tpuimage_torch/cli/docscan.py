"""Document scanner CLI (counterpart of ``tpuimage.cli.docscan``), all
27 flags of DocScanner.py's main() included. Adds ``--device`` (the
package docstring); ``--gui-preset`` is the port's ``GUI_DOCUMENT_CONFIG``,
``--profile`` its ``runtime.profiling.Throughput`` bounded by ``sync``,
and ``--ocr`` goes through ``process_document``'s ``_finish_document``."""
from __future__ import annotations

import argparse
import logging
import os

from tpuimage_torch.cli import add_device_argument, start
from tpuimage_torch.io.imageio import load_image_rgb
from tpuimage_torch.pipelines import docscan


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Document scanner pipeline: preprocessing, localization, "
                    "warp, enhance (TPU-native)")
    p.add_argument("input")
    p.add_argument("--out", default="outputs")
    p.add_argument("--page", default="A4")
    p.add_argument("--scale-long", type=int, default=1600)
    p.add_argument("--bilateral-d", type=int, default=9)
    p.add_argument("--bilateral-sigma-color", type=float, default=75)
    p.add_argument("--bilateral-sigma-space", type=float, default=75)
    p.add_argument("--gaussian-ksize", type=int, default=0)
    p.add_argument("--canny-low", type=int, default=50)
    p.add_argument("--canny-high", type=int, default=150)
    p.add_argument("--min-area-ratio", type=float, default=0.2)
    p.add_argument("--max-area-ratio", type=float, default=0.98)
    p.add_argument("--illum-method", choices=["subtract", "divide"], default="subtract")
    p.add_argument("--illum-blur-frac", type=float, default=0.02)
    p.add_argument("--block-size", type=int, default=35)
    p.add_argument("--C", type=int, default=10)
    p.add_argument("--thresh-method", choices=["gaussian", "mean"], default="gaussian")
    p.add_argument("--mask-blur-ksize", type=int, default=51)
    p.add_argument("--blackhat-ksize", type=int, default=9)
    p.add_argument("--blackhat-vertical-ratio", type=float, default=2.0)
    p.add_argument("--ink-dilate-iters", type=int, default=1)
    p.add_argument("--mask-thresh-offset", type=int, default=8)
    p.add_argument("--morph-ksize", type=int, default=3)
    p.add_argument("--morph-iters", type=int, default=1)
    p.add_argument("--max-rotate", type=float, default=10.0)
    p.add_argument("--no-fallback-use-whole", dest="fallback_use_whole",
                   action="store_false", default=True)
    p.add_argument("--min-quad-area-ratio", type=float, default=0.15)
    p.add_argument("--ocr", action="store_true",
                   help="run OCR on the final binary (needs pytesseract)")
    p.add_argument("--gui-preset", action="store_true",
                   help="use the AI_classification override config that "
                        "produced the scan_03..08 goldens")
    p.add_argument("--compare", action="store_true",
                   help="write a side-by-side input/binary composite "
                        "(compare-viewer replacement)")
    p.add_argument("--profile", action="store_true",
                   help="print a per-stage wall-clock / MP/s report "
                        "(runtime.profiling.Throughput)")
    add_device_argument(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = start(args, __name__)
    if args.gui_preset:
        cfg = docscan.GUI_DOCUMENT_CONFIG
    else:
        cfg = docscan.DocScanConfig(
            page=args.page, scale_long=args.scale_long,
            bilateral_d=args.bilateral_d,
            bilateral_sigma_color=args.bilateral_sigma_color,
            bilateral_sigma_space=args.bilateral_sigma_space,
            gaussian_ksize=args.gaussian_ksize,
            canny_low=args.canny_low, canny_high=args.canny_high,
            min_area_ratio=args.min_area_ratio, max_area_ratio=args.max_area_ratio,
            illum_method=args.illum_method, illum_blur_frac=args.illum_blur_frac,
            block_size=args.block_size, C=args.C, thresh_method=args.thresh_method,
            mask_blur_ksize=args.mask_blur_ksize, blackhat_ksize=args.blackhat_ksize,
            blackhat_vertical_ratio=args.blackhat_vertical_ratio,
            ink_dilate_iters=args.ink_dilate_iters,
            mask_thresh_offset=args.mask_thresh_offset,
            morph_ksize=args.morph_ksize, morph_iters=args.morph_iters,
            max_rotate=args.max_rotate,
            fallback_use_whole=args.fallback_use_whole,
            min_quad_area_ratio=args.min_quad_area_ratio)
    if args.profile:
        from tpuimage_torch.runtime.profiling import Throughput, sync
        logging.basicConfig(level=logging.INFO, format="%(message)s")
        rgb = load_image_rgb(args.input)
        mp = rgb.shape[0] * rgb.shape[1] / 1e6
        tp = Throughput()
        with tp.stage("process_document", megapixels=mp, images=1):
            res = docscan.process_document(rgb, out_dir=args.out, config=cfg,
                                           do_ocr=args.ocr, device=dev)
            sync(res["binary"])
        tp.report()
    else:
        res = docscan.process_document(args.input, out_dir=args.out,
                                       config=cfg, do_ocr=args.ocr, device=dev)
    if args.compare:
        from tpuimage_torch.io.report import write_compare
        write_compare(os.path.join(args.out, "scan_compare.png"),
                      load_image_rgb(args.input), res["binary"].cpu().numpy(),
                      labels=("input", "scanned"))
    print(f"Done. Outputs in {args.out}")


if __name__ == "__main__":
    main()
