"""CLI entry points (counterpart of ``tpuimage.cli``): docscan, morphseq,
night, face, landscape, classify. Each has tpuimage's flags, defaults,
output files and printed lines, and ``main(argv=None)``; run as
``python -m tpuimage_torch.cli.<name> ...``.

What every one adds is ``--device`` (default ``cuda``), the port's
counterpart of ``JAX_PLATFORMS`` and the only way a CLI runs on the host.
Before the first launch it honours ``TPUIMAGE_XLA_CACHE``
(``runtime.cache``) and, on a card, claims it within
``TPUIMAGE_DEVICE_TIMEOUT`` seconds (default 600, 0 skips the claim;
``runtime.health``); without a card and without ``--device cpu`` it
raises. Files are PNG through PIL, or without PIL through ``io/png.py``;
any other format needs PIL.
"""
from __future__ import annotations

import argparse
import os

import torch


def add_device_argument(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the pipeline runs: cuda (the card, the default; "
                        "raises where there is none) or cpu (the host)")


def start(args: argparse.Namespace, name: str) -> torch.device:
    """The run's device, after the build cache and the device claim."""
    from tpuimage_torch.runtime.cache import maybe_enable_compile_cache
    maybe_enable_compile_cache()   # TPUIMAGE_XLA_CACHE opt-in
    dev = torch.device(args.device)
    timeout = float(os.environ.get("TPUIMAGE_DEVICE_TIMEOUT", "600"))
    if timeout > 0 and dev.type == "cuda":
        from tpuimage_torch.runtime.health import require_device
        require_device(timeout, what="the %s CLI" % name, device=dev)
    return dev
