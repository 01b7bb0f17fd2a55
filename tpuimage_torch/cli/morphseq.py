"""morph_seq CLI (counterpart of ``tpuimage.cli.morphseq``):
``python -m tpuimage_torch.cli.morphseq <input> --out outputs``. Adds
``--device`` (the package docstring)."""
from __future__ import annotations

import argparse

from tpuimage_torch.cli import add_device_argument, start
from tpuimage_torch.pipelines.morphseq import process_morph_seq


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="4-step document morphology pipeline (ksize=3)")
    p.add_argument("input")
    p.add_argument("--out", default="outputs")
    p.add_argument("--no-intermediate", dest="save_intermediate",
                   action="store_false", default=True)
    add_device_argument(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = start(args, __name__)
    process_morph_seq(args.input, out_dir=args.out,
                      save_intermediate=args.save_intermediate, device=dev)
    print(f"Done. Outputs in {args.out}")


if __name__ == "__main__":
    main()
