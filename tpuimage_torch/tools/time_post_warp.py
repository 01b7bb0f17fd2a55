"""How far the host's noise moves the post-warp chain's wall time.

    python -m tpuimage_torch.tools.time_post_warp [LABEL]

Times ``_pre_deskew_stages`` (5 medians of 5 samples of 5 calls) and
``docscan_post_warp_batch`` (2 medians of 5 calls) on 8 seeded A4 pages
with CUDA events, three times over: in a fresh process, after a plain
ksize-255 blur has filled the caching allocator, and after
``torch.cuda.empty_cache()``. Both paths are bound by the host's launches,
so the spread of these readings is what a difference between two trees
(run it from the root of each, in one call) has to exceed. Needs a card.
"""
from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from tpuimage_torch import synth
from tpuimage_torch.ops import kernels
from tpuimage_torch.ops.color import rgb_to_gray
from tpuimage_torch.pipelines import docscan

PAGE = (1200, 849)


def _ms(fn, calls: int) -> float:
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main(argv=None) -> int:
    label = (argv if argv is not None else sys.argv[1:] or ["tree"])[0]
    cfg = docscan.GUI_DOCUMENT_CONFIG
    pages = torch.from_numpy(np.stack(
        [synth.page(100 + i, *PAGE, tilt_deg=3.0 if i % 2 else 0.0, rules=3 if i % 2 else 0)
         for i in range(8)])).to("cuda")

    def pre():
        return docscan._pre_deskew_stages(pages, cfg)

    def post():
        return docscan.docscan_post_warp_batch(pages, cfg)

    def measure(what: str) -> None:
        pre()
        post()
        torch.cuda.synchronize()
        a = [_ms(pre, 5) for _ in range(3)]
        b = [_ms(post, 1) for _ in range(2)]
        a += [_ms(pre, 5) for _ in range(2)]
        print(f"{label} {what}: pre-deskew {' '.join(f'{v:.3f}' for v in a)} ms; post-warp "
              f"{' '.join(f'{v:.2f}' for v in b)} ms", flush=True)

    measure("fresh")
    gray = rgb_to_gray(pages)
    for _ in range(3):
        kernels.gaussian_blur_u8_ref(gray, 255)
    torch.cuda.synchronize()
    measure("after the plain k=255 blur")
    torch.cuda.empty_cache()
    measure("after empty_cache")
    return 0


if __name__ == "__main__":
    sys.exit(main())
