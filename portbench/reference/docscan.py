"""DocScanner's served path on one photo or one page, frozen from the
port's ``pipelines/docscan.py``: localize (Canny, deterministic Hough
segments, the host quad fit), the use-whole test, the warp or the
INTER_AREA resize, then the post-warp program (illumination, stretch,
ink mask with two Otsu solves, adaptive threshold, weighting, Canny ->
Hough deskew angle -> rotation, cleanup)."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from portbench.reference.detect import contours as cnt
from portbench.reference.ops import geometry, kernels
from portbench.reference.ops.arith import normalize_minmax, normalize_minmax_lut
from portbench.reference.ops.color import rgb_to_gray
from portbench.reference.ops.draw import draw_segments
from portbench.reference.ops.edges import canny
from portbench.reference.ops.histogram import hist256_batch, otsu_from_hist
from portbench.reference.ops.hough import hough_fold_median_angle, hough_lines_p_det
from portbench.reference.ops.morphology import morph_blackhat, morph_close, structuring_element
from portbench.reference.ops.threshold import adaptive_threshold

@dataclasses.dataclass(frozen=True)
class DocScanConfig:
    """All tunables of the reference DocScanner (same fields and defaults
    as ``tpuimage.pipelines.docscan.DocScanConfig``)."""
    page: str = "A4"
    scale_long: int = 1600
    bilateral_d: int = 9
    bilateral_sigma_color: float = 75.0
    bilateral_sigma_space: float = 75.0
    gaussian_ksize: int = 0
    canny_low: int = 50
    canny_high: int = 150
    min_area_ratio: float = 0.2
    max_area_ratio: float = 0.98
    illum_method: str = "subtract"
    illum_blur_frac: float = 0.02
    block_size: int = 35
    C: int = 10
    thresh_method: str = "gaussian"
    mask_blur_ksize: int = 51
    blackhat_ksize: int = 9
    blackhat_vertical_ratio: float = 2.0
    ink_dilate_iters: int = 1
    mask_thresh_offset: int = 8
    morph_ksize: int = 3
    morph_iters: int = 1
    max_rotate: float = 10.0
    fallback_use_whole: bool = True
    min_quad_area_ratio: float = 0.15
    # deskew Hough edge budget; 0 = the density-scaled default
    deskew_max_edges: int = 0


def illum_ksize(h: int, w: int, c: DocScanConfig) -> int:
    base = max(15, int(round(min(h, w) * c.illum_blur_frac)))
    return base + (base % 2 == 0)


def mask_ksize(c: DocScanConfig) -> int:
    return c.mask_blur_ksize + (c.mask_blur_ksize % 2 == 0)


def adaptive_block(c: DocScanConfig) -> int:
    return c.block_size + (c.block_size % 2 == 0)


def blackhat_se(c: DocScanConfig) -> np.ndarray:
    bk = max(c.blackhat_ksize, 3)
    bk += (bk % 2 == 0)
    bh_h = max(3, int(round(bk * c.blackhat_vertical_ratio)))
    bh_h += (bh_h % 2 == 0)
    return structuring_element("rect", (bk, bh_h))


INK_DILATE_SE = structuring_element("rect", (2, 2))


def _raw_otsu_threshold(hist_raw: torch.Tensor, mask_thresh_offset) -> torch.Tensor:
    """Thresholds on RAW uint8 planes equivalent to the reference's
    Otsu(-offset) threshold of their NORM_MINMAX-normalized planes.

    normalize_minmax is a monotone per-value map, so the normalized
    histogram is the raw one pushed through the LUT (an integer
    ``scatter_add``), and ``norm(x) > t`` pulls back to ``x > T`` with
    ``T = #{v : lut[v] <= t} - 1``. hist_raw: (B, 256) -> (B,) float32."""
    nz = (hist_raw > 0).to(torch.uint8)
    smin = torch.argmax(nz, dim=-1).to(torch.float32)
    smax = (255 - torch.argmax(torch.flip(nz, dims=(-1,)), dim=-1)).to(torch.float32)
    lut = normalize_minmax_lut(smin, smax)                          # (B, 256)
    hist_n = torch.zeros(hist_raw.shape, dtype=torch.int64, device=hist_raw.device)
    hist_n.scatter_add_(-1, lut.to(torch.int64), hist_raw.to(torch.int64))
    t_eff = torch.clamp(torch.round(otsu_from_hist(hist_n)) - mask_thresh_offset,
                        min=0)
    below = (lut.to(torch.float32) <= t_eff[..., None]).to(torch.int32)
    return (below.sum(dim=-1) - 1).to(torch.float32)


def _illumination(gray: torch.Tensor, c: DocScanConfig) -> torch.Tensor:
    """Illumination correction of (B, H, W) gray pages, then NORM_MINMAX:
    the Q8.8 blur and divide / subtract fused in one ``gauss_chain``
    launch."""
    h, w = int(gray.shape[-2]), int(gray.shape[-1])
    mode = "divide" if c.illum_method.lower() == "divide" else "subtract"
    return normalize_minmax(kernels.gauss_chain(gray, illum_ksize(h, w, c), mode))


def _ink_planes(stretched: torch.Tensor, c: DocScanConfig):
    """The two RAW planes the ink mask thresholds: blur - page, and the
    vertical blackhat."""
    return (kernels.gauss_chain(stretched, mask_ksize(c), "sub"),
            morph_blackhat(stretched, blackhat_se(c)))


def _pre_deskew_stages(warped: torch.Tensor, config: DocScanConfig) -> Dict[str, torch.Tensor]:
    """Stages 04-06b of a (B, H, W, 3) page batch: illumination, stretch,
    ink mask, adaptive threshold, mask weighting -> (B, H, W) planes.

    tpuimage's fused form (its ``impl="pallas"``): three ``gauss_chain``
    launches, ``blackhat_rect``, ``hist256`` and ``inkmask_weighted``, with
    eager gray, NORM_MINMAX and the Otsu pullback between them. Nothing is
    read back to the host."""
    c = config
    illum = _illumination(rgb_to_gray(warped), c)
    # contrast stretch: illum is already NORM_MINMAX output, so a second
    # min-max stretch is the identity
    stretched = illum

    # ink mask: Otsu thresholds of the RAW planes, pulled back through the
    # normalize LUT (see _raw_otsu_threshold); both histograms in one call
    sub_raw, bh_raw = _ink_planes(stretched, c)
    hists = hist256_batch(torch.stack([sub_raw, bh_raw], dim=1)
                          .reshape(2 * illum.shape[0], -1)).reshape(-1, 2, 256)
    t_sub = _raw_otsu_threshold(hists[:, 0], c.mask_thresh_offset)
    t_bh = _raw_otsu_threshold(hists[:, 1], c.mask_thresh_offset)

    if c.thresh_method == "gaussian":
        base_bin = kernels.gauss_chain(stretched, adaptive_block(c), "adaptive", C=c.C)
    else:
        base_bin = adaptive_threshold(stretched, 255, c.thresh_method,
                                      adaptive_block(c), c.C)

    ink_mask, weighted = kernels.inkmask_weighted(sub_raw, bh_raw, base_bin, t_sub, t_bh,
                                                  c.ink_dilate_iters)
    return {"illum": illum, "stretch": stretched, "inkmask": ink_mask,
            "adapt": base_bin, "weighted": weighted}


def _deskew_angle(binary: torch.Tensor, canny_low: int, canny_high: int,
                  max_rotate: float, max_edges: int = 0):
    """Canny -> HoughLines(threshold 150) -> median of fold-to-[-90, 90)
    angles, zeroed where |median| > max_rotate. (B, H, W) -> ((B,) f32
    angle, (B,) bool edge-budget overflow)."""
    edges = canny(binary, canny_low, canny_high)
    med, overflow = hough_fold_median_angle(edges, threshold=150, return_overflow=True,
                                            max_edges=max_edges)
    return torch.where(torch.abs(med) > max_rotate, torch.zeros_like(med), med), overflow


def _morph_cleanup(desk: torch.Tensor, config: DocScanConfig) -> torch.Tensor:
    """Close only, skipped for ksize <= 1."""
    c = config
    if c.morph_ksize > 1 and c.morph_iters > 0:
        se = structuring_element("rect", (c.morph_ksize, c.morph_ksize))
        return morph_close(desk, se, iterations=c.morph_iters)
    return desk


def docscan_post_warp_batch(warped_batch: torch.Tensor,
                            config: DocScanConfig) -> Dict[str, torch.Tensor]:
    """The post-warp program (stages 04-08) over a (B, H, W, 3) uint8 page
    batch -> dict of (B, H, W) stage planes plus (B,) ``deskew_angle`` and
    ``deskew_overflow``. Only the pages whose angle is not 0 are rotated;
    angle 0 is an exact identity."""
    c = config
    pre = _pre_deskew_stages(warped_batch, c)
    weighted = pre["weighted"]
    angles, overflows = _deskew_angle(weighted, c.canny_low, c.canny_high,
                                      c.max_rotate, c.deskew_max_edges)
    rot = torch.nonzero(angles != 0.0).flatten()
    desk = weighted
    if rot.numel():
        desk = weighted.clone()
        desk[rot] = geometry.rotate_pages(weighted[rot], angles[rot], c.max_rotate)
    clean = _morph_cleanup(desk, c)
    return {**pre, "deskew": desk, "clean": clean, "deskew_angle": angles,
            "deskew_overflow": overflows}


def _localize_device_batch(rgbs: torch.Tensor, canny_low: int, canny_high: int):
    """Device half of localize over a (B, H, W, 3) stack: Canny edges and
    deterministic Hough segments (threshold 80, minLineLength 80) ->
    (edges (B, H, W) u8, segs (B, 128, 4) f32, ok (B, 128) bool)."""
    edges = canny(rgb_to_gray(rgbs), canny_low, canny_high)
    segs, ok = hough_lines_p_det(edges, threshold=80, min_line_length=80.0,
                                 max_lines=128)
    return edges, segs, ok


def order_quad_points(pts: np.ndarray) -> np.ndarray:
    """TL/TR/BR/BL by coordinate sum/difference."""
    pts = np.asarray(pts, dtype=np.float32).reshape(4, 2)
    s = pts.sum(axis=1)
    d = pts[:, 1] - pts[:, 0]
    out = np.zeros((4, 2), dtype=np.float32)
    out[0] = pts[np.argmin(s)]
    out[2] = pts[np.argmax(s)]
    out[1] = pts[np.argmin(d)]
    out[3] = pts[np.argmax(d)]
    return out


def _largest_quadrilateral(contour_list) -> Optional[np.ndarray]:
    """approxPolyDP(0.02*peri), keep 4-gons, largest area."""
    best, max_area = None, 0.0
    for c in contour_list:
        if len(c) < 4:
            continue
        peri = cnt.arc_length(c, closed=True)
        approx = cnt.approx_poly_dp(c, 0.02 * peri, closed=True)
        if len(approx) == 4:
            area = cnt.contour_area(approx)
            if area > max_area:
                max_area, best = area, approx
    return None if best is None else np.asarray(best, dtype=np.float32).reshape(4, 2)


def _quad_from_localize(edges: np.ndarray, segs: np.ndarray, ok: np.ndarray,
                        shape, config: DocScanConfig) -> Optional[np.ndarray]:
    """Host half of localize: draw the segments over the edge map, trace
    external contours, pick the largest quadrilateral."""
    line_img = draw_segments(edges.shape, segs[ok], thickness=2)
    contour_list = cnt.find_external_contours(edges | line_img)
    img_area = shape[0] * shape[1]
    areas = cnt.contour_areas(contour_list) / max(img_area, 1)
    filtered = [c for c, a in zip(contour_list, areas)
                if config.min_area_ratio <= a <= config.max_area_ratio]
    quad = _largest_quadrilateral(filtered if filtered else contour_list)
    if quad is None:
        if not contour_list:
            return None
        c = max(contour_list, key=cnt.contour_area)
        quad = cnt.box_points(cnt.min_area_rect(c))
    return order_quad_points(quad)


def _warp_target_size(quad: np.ndarray, page: str, scale_long: int) -> Tuple[int, int]:
    """Page ratio x portrait test -> (th, tw)."""
    tl, tr, br, bl = quad
    width = max(int(np.linalg.norm(tr - tl)), int(np.linalg.norm(br - bl)))
    height = max(int(np.linalg.norm(bl - tl)), int(np.linalg.norm(br - tr)))
    portrait = height >= width
    pu = page.upper()
    if pu in ("A4", "A3", "A5"):
        ratio = math.sqrt(2.0)
    elif pu == "LETTER":
        ratio = 11.0 / 8.5
    else:
        ratio = height / max(width, 1)
    if portrait:
        th = scale_long
        tw = int(round(th / ratio))
    else:
        tw = scale_long
        th = int(round(tw * ratio))
    return th, tw


def _use_whole(quad: Optional[np.ndarray], shape, config: DocScanConfig) -> bool:
    """The use-whole fallback: no quad, or one covering less than
    ``min_quad_area_ratio`` of the (H, W) photo."""
    return quad is None or cnt.contour_area(quad) / max(
        int(shape[0]) * int(shape[1]), 1) < config.min_quad_area_ratio


def _page_homography(quad: np.ndarray, th: int, tw: int) -> np.ndarray:
    """The float64 homography taking ``quad`` to the (th, tw) page
    rectangle."""
    dst = np.array([[0, 0], [tw - 1, 0], [tw - 1, th - 1], [0, th - 1]], dtype=np.float32)
    return geometry.get_perspective_transform(quad.astype(np.float32), dst)


def _inverse_homography(quad: np.ndarray, th: int, tw: int) -> np.ndarray:
    """float64 inverse of :func:`_page_homography` (what the warp samples
    through)."""
    return np.linalg.inv(_page_homography(quad, th, tw))



def scan_photo(rgb: torch.Tensor, config: DocScanConfig) -> dict:
    """One (H, W, 3) uint8 photo through scan_batch's four phases (no
    ``fallback_common_shape``): ``{quad, use_whole, binary, deskew_angle,
    deskew_overflow}`` with ``binary`` a numpy array."""
    c = config
    edges, segs, ok = _localize_device_batch(rgb[None], c.canny_low, c.canny_high)
    quad = _quad_from_localize(edges[0].cpu().numpy(), segs[0].cpu().numpy(),
                               ok[0].cpu().numpy(), tuple(rgb.shape[:2]), c)
    use_whole = _use_whole(quad, rgb.shape, c)
    if use_whole:
        page = geometry.resize_long_side(rgb, c.scale_long, interpolation="area")
    else:
        th, tw = _warp_target_size(quad, c.page, c.scale_long)
        minv = torch.from_numpy(_inverse_homography(quad, th, tw).astype(np.float32))
        page = geometry.warp_perspective_batch(rgb[None], minv[None].to(rgb.device), th, tw)[0]
    out = docscan_post_warp_batch(page[None].contiguous(), c)
    return {"quad": quad, "use_whole": use_whole, "binary": out["clean"][0].cpu().numpy(),
            "deskew_angle": float(out["deskew_angle"][0]),
            "deskew_overflow": bool(out["deskew_overflow"][0])}
