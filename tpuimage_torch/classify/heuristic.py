"""Scene classifiers: priority (classification.py) and weighted
(AI_classification.py) — counterpart of ``tpuimage.classify.heuristic``.

Both keep the reference's rules and thresholds. One cue program on the
device computes each image's Otsu binary and white ratio (``hist256``),
its Canny edges and its Hough line count (``rank_extract``,
``hough_votes``); the host finds the large rectangle in the fetched
binary (``detect.contours``) and the faces in the fetched gray image
(``detect.haar``), as the reference does, and takes the brightness as
the float64 mean of that gray image.

tpuimage's ``CUE_SCHEDULE`` (``canny_impl``, ``theta_pack``, ``unroll``,
``vote_lo``) picks among schedules of its TPU vote kernel and of XLA's
hysteresis that all give the same bits. The port has one Canny and one
vote kernel, so it takes none of these knobs.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch

from tpuimage_torch.core.device import as_input
from tpuimage_torch.detect import contours as cnt
from tpuimage_torch.detect.haar import detect_faces, detect_faces_batch
from tpuimage_torch.ops.color import rgb_to_gray
from tpuimage_torch.ops.edges import canny
from tpuimage_torch.ops.hough import hough_line_count
from tpuimage_torch.ops.threshold import threshold_otsu

LABELS = ["nightscape", "landscape", "document", "face"]


def cue_budget(h: int, w: int) -> int:
    """The cue's Hough edge budget: 9/16 of the pixels capped at 512k, and
    at least 128 * h, so that a full-height vertical line keeps all its
    votes (tpuimage's 128-wide bands put a column's h pixels in one band)."""
    return max(min((h * w * 9) // 16, 524288), 128 * h)


def device_cues(stack: torch.Tensor):
    """The cue program on a same-shape (B, H, W, 3) RGB or (B, H, W) gray
    uint8 stack -> (white_ratio (B,) float32, line_count (B,) int32, binary
    (B, H, W) uint8, overflow (B,) bool, gray (B, H, W) uint8).

    ``white_ratio`` is tpuimage's f32 mean of ``binary == 255`` as XLA
    computes it, the exact count times the f32 reciprocal of the pixel
    count. ``line_count`` is min(#peaks > 150, 256) of the Canny (50, 150)
    edges; ``overflow`` flags an edge budget too small for the image."""
    gray = rgb_to_gray(stack) if stack.dim() == 4 else stack
    _, binary = threshold_otsu(gray)
    h, w = int(gray.shape[-2]), int(gray.shape[-1])
    count = (binary == 255).sum(dim=(-2, -1), dtype=torch.int32).to(torch.float32)
    white_ratio = count * float(np.float32(1.0) / np.float32(h * w))
    line_count, overflow = hough_line_count(canny(gray, 50, 150), threshold=150,
                                            max_lines=256, max_edges=cue_budget(h, w))
    return white_ratio, line_count, binary, overflow, gray


def _large_rect(binary: np.ndarray) -> bool:
    """classification.py's rectangle cue: any external contour of the Otsu
    binary covering >= 30% of the image whose polygon has 4 corners."""
    img_area = float(binary.shape[0] * binary.shape[1])
    for c in cnt.find_external_contours(binary):
        if cnt.contour_area(c) < 0.3 * img_area:
            continue
        approx = cnt.approx_poly_dp(c, 0.02 * cnt.arc_length(c, True), True)
        if len(approx) == 4:
            return True
    return False


def _warn_overflow():
    warnings.warn("hough edge budget overflowed on a classifier cue "
                  "image: line_count is an undercount", RuntimeWarning)


def _priority_rule(fc: int, white_ratio: float, lines_count: int,
                   large_rect: bool, bmean: float) -> str:
    """classification.py's decision ladder (shared by the single and batch
    forms so the thresholds cannot desynchronize)."""
    if fc > 0:
        return "face"
    if white_ratio >= 0.5 and (lines_count >= 50 or large_rect):
        return "document"
    return "nightscape" if bmean < 80.0 else "landscape"


def _weighted_rule(fc: int, white_ratio: float, lines_count: int,
                   large_rect: bool, bmean: float):
    """AI_classification.py's additive scores -> (label, probs) (shared by
    the single and batch forms)."""
    scores: Dict[str, float] = {k: 0.0 for k in LABELS}
    if fc > 0:
        scores["face"] += 1.0 + 0.5 * min(fc, 3)
    scores["document"] += (white_ratio - 0.5) * 2.0
    if lines_count >= 50:
        scores["document"] += 0.5
    if large_rect:
        scores["document"] += 0.5
    if bmean < 80:
        scores["nightscape"] += (80 - bmean) / 80.0
    else:
        scores["landscape"] += (bmean - 80) / 80.0
    label = max(scores.items(), key=lambda kv: kv[1])[0]
    total = sum(v for v in scores.values() if v > 0) or 1.0
    probs = {k: max(v, 0.0) / total for k, v in scores.items()}
    return label, probs


def _gray_host(x: torch.Tensor) -> np.ndarray:
    return rgb_to_gray(x).cpu().numpy()


def _document_cues_of(x: torch.Tensor) -> Tuple[float, int, bool]:
    white_ratio, line_count, binary, overflow, _ = device_cues(x[None])
    if bool(overflow[0]):
        _warn_overflow()
    return (float(white_ratio[0]), int(line_count[0]),
            _large_rect(binary[0].cpu().numpy()))


def document_cues(rgb, device=None) -> Tuple[float, int, bool]:
    """classification.py's document_score cues of one (H, W, 3) uint8 RGB
    image: (white_ratio, line count, large rectangle). An array goes to
    ``device`` (default the card); a tensor runs where it is."""
    return _document_cues_of(as_input(rgb, device))


def classify_priority(rgb, device=None) -> str:
    """classification.py's classify_image: face > document > the
    brightness split at 80. A face skips the cue program, as in the
    reference."""
    x = as_input(rgb, device)
    gray = _gray_host(x)
    fc = len(detect_faces(gray))
    if fc > 0:
        return "face"
    white_ratio, lines_count, large_rect = _document_cues_of(x)
    return _priority_rule(fc, white_ratio, lines_count, large_rect, float(gray.mean()))


def classify_weighted(rgb, device=None) -> Tuple[str, Dict[str, float]]:
    """AI_classification.py's classify_heuristic: additive scores, the
    argmax label and the positive scores normalised into probabilities."""
    x = as_input(rgb, device)
    gray = _gray_host(x)
    fc = len(detect_faces(gray))
    white_ratio, lines_count, large_rect = _document_cues_of(x)
    return _weighted_rule(fc, white_ratio, lines_count, large_rect, float(gray.mean()))


def _batch_cues(rgbs, device=None) -> List[tuple]:
    """The cues of a list of images: one cue program per group of
    same-shape images (it also gives the gray images Haar reads), then
    one Haar pass over all of them. Returns per image (bmean, face count,
    white_ratio, line count, large rectangle)."""
    xs = [as_input(r, device) for r in rgbs]
    n = len(xs)
    grays: List[np.ndarray] = [None] * n
    wrs, lcs, rects = [0.0] * n, [0] * n, [False] * n
    by_shape: Dict[tuple, list] = {}
    for i, x in enumerate(xs):
        by_shape.setdefault(tuple(x.shape), []).append(i)
    for idxs in by_shape.values():
        wr, lc, binary, ovf, gray = device_cues(torch.stack([xs[i] for i in idxs]))
        if bool(ovf.any()):
            _warn_overflow()
        wr, lc = wr.cpu().numpy(), lc.cpu().numpy()
        binary, gray = binary.cpu().numpy(), gray.cpu().numpy()
        for j, i in enumerate(idxs):
            grays[i] = gray[j]
            wrs[i], lcs[i] = float(wr[j]), int(lc[j])
            rects[i] = _large_rect(binary[j])
    faces = detect_faces_batch(grays)
    return [(float(grays[i].mean()), len(faces[i]), wrs[i], lcs[i], rects[i])
            for i in range(n)]


def classify_priority_batch(rgbs, device=None) -> list:
    """classify_priority over a list of images (batched cues, one Haar
    pass); the same labels as the per-image form."""
    return [_priority_rule(fc, wr, lc, rect, bmean)
            for bmean, fc, wr, lc, rect in _batch_cues(rgbs, device)]


def classify_weighted_batch(rgbs, device=None) -> list:
    """classify_weighted over a list of images -> [(label, probs), ...],
    the same as the per-image form."""
    return [_weighted_rule(fc, wr, lc, rect, bmean)
            for bmean, fc, wr, lc, rect in _batch_cues(rgbs, device)]
