"""morph_seq: the 4-step document morphology pipeline, ksize 3
(counterpart of ``tpuimage.pipelines.morphseq``): grayscale -> 3x3
erosion -> Otsu binarisation -> 3x3 binary closing.

On the card the chain is four launches: ``gray_erode3``, ``hist256``
with the Otsu solve, and ``binary_close3``; the per-image thresholds stay
a (B,) device tensor between them, so nothing waits on the host. On the
CPU the same wrappers take their plain versions (``rgb_to_gray`` +
``erode``, ``threshold_binary`` + ``morph_close``). Leading dims are a
batch in place of tpuimage's ``vmap``, so ``morphseq_batch`` is the same
function. ``process_morph_seq`` is the CLI's core: one image file in,
tpuimage's five PNG files out.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from tpuimage_torch.core.device import as_input
from tpuimage_torch.io.imageio import ensure_dir, load_image_rgb, save_image
from tpuimage_torch.ops import kernels
from tpuimage_torch.ops.histogram import hist256_batch, otsu_from_hist

KSIZE = 3          # the 3x3 rectangle the erode and the close use
ITERATIONS = 1


def morphseq_stages(rgb, device=None) -> Dict[str, torch.Tensor]:
    """uint8 (..., H, W, 3) RGB -> stage dict with tpuimage's keys
    (``original``, ``step1_gray``, ``step2_eroded``, ``step3_otsu``,
    ``step4_closed``). An array goes to ``device`` (default the card,
    which must exist); a tensor runs where it is."""
    x = as_input(rgb, device)
    lead, (h, w) = x.shape[:-3], x.shape[-3:-1]
    flat = x.reshape(-1, h, w, 3).contiguous()
    gray, eroded = kernels.gray_erode3(flat)
    thresh = otsu_from_hist(hist256_batch(eroded))
    otsu, closed = kernels.binary_close3(eroded, thresh)
    shape = lead + (h, w)
    return {"original": x, "step1_gray": gray.reshape(shape),
            "step2_eroded": eroded.reshape(shape), "step3_otsu": otsu.reshape(shape),
            "step4_closed": closed.reshape(shape)}


morphseq_batch = morphseq_stages


_STAGE_FILES = (("morphseq_01_gray.png", "step1_gray"), ("morphseq_02_eroded.png", "step2_eroded"),
                ("morphseq_03_otsu.png", "step3_otsu"), ("morphseq_04_closed.png", "step4_closed"))


def process_morph_seq(input_path, out_dir: str = "outputs", save_intermediate: bool = True,
                      device=None) -> Dict[str, np.ndarray]:
    """The reference CLI's core: load ``input_path``, run the stages on
    ``device`` (default the card), write ``morphseq_01_gray.png`` ..
    ``morphseq_04_closed.png`` (with ``save_intermediate``) and
    ``morphseq_closed.png`` into ``out_dir``; returns the stages as host
    arrays."""
    stages = morphseq_stages(load_image_rgb(input_path), device=device)
    stages = {k: v.cpu().numpy() for k, v in stages.items()}
    ensure_dir(out_dir)
    if save_intermediate:
        for name, key in _STAGE_FILES:
            save_image(os.path.join(out_dir, name), stages[key])
    save_image(os.path.join(out_dir, "morphseq_closed.png"), stages["step4_closed"])
    return stages
