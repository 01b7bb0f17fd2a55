"""Classify-and-enhance CLI (counterpart of ``tpuimage.cli.classify``),
the headless AI_classification GUI flow: classify each input (CLIP if a
converted checkpoint is given, else the weighted heuristic), route it to
the matching enhancement pipeline, save it with a compression preset.
Adds ``--device`` (the package docstring); ``--clip-checkpoint`` loads
through ``classify.clip.load_from_checkpoint``."""
from __future__ import annotations

import argparse
import os

import torch

from tpuimage_torch.classify.router import classify_and_enhance
from tpuimage_torch.cli import add_device_argument, start
from tpuimage_torch.io.imageio import ensure_dir, load_image_rgb, save_image


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Scene classification + routed "
                                "enhancement (AI_classification workload, headless)")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--out", default="outputs")
    p.add_argument("--classifier", choices=["weighted", "priority"],
                   default="weighted")
    p.add_argument("--clip-checkpoint", default=None,
                   help="converted ViT-B/32 .npz (see classify.clip); "
                        "falls back to the heuristic when absent, like the "
                        "reference's ensure_model")
    p.add_argument("--compression",
                   choices=["FAST", "BALANCED", "HIGH", "MAXIMUM"],
                   default="BALANCED")
    add_device_argument(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = start(args, __name__)
    ensure_dir(args.out)

    clip_model = None
    if args.clip_checkpoint:
        from tpuimage_torch.classify.clip import load_from_checkpoint
        clip_model = load_from_checkpoint(args.clip_checkpoint, device=dev)

    for f in args.inputs:
        rgb = torch.from_numpy(load_image_rgb(f)).to(dev)
        label, probs, out = classify_and_enhance(rgb, classifier=args.classifier,
                                                 clip_model=clip_model)
        stem = os.path.splitext(os.path.basename(f))[0]
        dst = os.path.join(args.out, f"{stem}_{label}_enhanced.png")
        save_image(dst, out, compression=args.compression)
        # the reference's audit line (AI_classification.py:896)
        print(f"CONFIRMED: path={f} type={label} probs={probs} -> {dst}")


if __name__ == "__main__":
    main()
