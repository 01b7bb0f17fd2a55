"""Label -> enhancement-pipeline routing, the reference GUI's serve path
(counterpart of ``tpuimage.classify.router``).

The confirmed label goes to one of the four enhancement pipelines, each
with the GUI's overrides. The images come back as uint8 tensors on the
device the entry ran on.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from tpuimage_torch.classify.heuristic import classify_priority, classify_weighted
from tpuimage_torch.core.device import as_input
from tpuimage_torch.ops.color import gray_to_rgb
from tpuimage_torch.pipelines import docscan
from tpuimage_torch.pipelines.face import enhance_face
from tpuimage_torch.pipelines.landscape import landscape_gui
from tpuimage_torch.pipelines.night import night_rgb


def enhance_for_label(label: str, rgb, device=None) -> torch.Tensor:
    """The enhanced (H, W, 3) uint8 RGB image the GUI shows for ``label``.
    An array goes to ``device`` (default the card); a tensor runs where it
    is."""
    x = as_input(rgb, device)
    if label == "nightscape":
        return night_rgb(x)["enhanced"]
    if label == "landscape":
        return landscape_gui(x)
    if label == "face":
        return enhance_face(x, variant="gui")["final"]
    if label == "document":
        # DocScanner with the GUI's config; the GUI shows the binary page as RGB
        res = docscan.process_document(x, out_dir=None, save_stages=False,
                                       config=docscan.GUI_DOCUMENT_CONFIG)
        return gray_to_rgb(res["binary"])
    raise ValueError(f"unknown label {label!r}")


def classify_and_enhance(rgb, classifier: str = "weighted", clip_model=None,
                         device=None) -> Tuple[str, Dict[str, float], torch.Tensor]:
    """The GUI's whole flow: classify (CLIP when a model is given, else the
    heuristic, as the reference falls back when open_clip is missing),
    then route -> (label, probabilities, enhanced image)."""
    x = as_input(rgb, device)
    if clip_model is not None:
        label, probs = clip_model.predict_array(x)
    elif classifier == "priority":
        label, probs = classify_priority(x), {}
    else:
        label, probs = classify_weighted(x)
    return label, probs, enhance_for_label(label, x)
