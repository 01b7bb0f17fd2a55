"""morph_seq: the 4-step document morphology pipeline, ksize 3
(counterpart of ``tpuimage.pipelines.morphseq``): grayscale -> 3x3
erosion -> Otsu binarisation -> 3x3 binary closing.

On the card the chain is four launches: ``gray_erode3``, ``hist256``
with the Otsu solve, and ``binary_close3``; the per-image thresholds stay
a (B,) device tensor between them, so nothing waits on the host. On the
CPU the same wrappers take their plain versions (``rgb_to_gray`` +
``erode``, ``threshold_binary`` + ``morph_close``). Leading dims are a
batch in place of tpuimage's ``vmap``, so ``morphseq_batch`` is the same
function. ``process_morph_seq`` and the CLI read and write image files
and are not ported.
"""
from __future__ import annotations

from typing import Dict

import torch

from tpuimage_torch.core.device import as_input
from tpuimage_torch.ops import kernels
from tpuimage_torch.ops.histogram import hist256_batch, otsu_from_hist


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
