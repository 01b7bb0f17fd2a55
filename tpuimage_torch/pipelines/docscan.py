"""DocScanner on PyTorch (counterpart of ``tpuimage.pipelines.docscan``):
the one-document path ``process_document`` and the serving paths
``scan_batch`` and ``scan_stream``.

``process_document`` follows the reference CLI: ``preprocess`` (gray ->
the ``bilateral`` kernel -> an optional Gaussian; dumped as scan_01),
``localize_document`` (device Canny + Hough segments, host quad fit),
``perspective_warp`` or the use-whole INTER_AREA resize, then the
post-warp stages of one page; with an ``out_dir`` it writes tpuimage's
stage files scan_01 .. scan_08.

``scan_batch`` runs four phases over a list of RGB photos, named after
tpuimage's:

1. ``_scan_load_localize`` (device): load, group by input shape, one
   upload and one localize call (gray -> Canny -> Hough segments) per
   group;
2. ``_scan_quad_fit`` (host, then device): fetch the edge maps and
   segments, the contour walk and quad fit per image, the homography
   solves; then the quad pages warp to the page geometry (A4 portrait at
   scale_long: 1200x849) and use-whole pages resize (INTER_AREA), with
   their aspect kept or, under ``fallback_common_shape``, to the page
   geometry;
3. ``_scan_postwarp_dispatch`` (device): ``docscan_post_warp_batch`` per
   page shape (illumination, stretch, ink mask with two Otsu solves,
   adaptive threshold, weighting, Canny -> Hough deskew angle -> rotation
   of the pages whose angle is not 0, cleanup); results stay on the card;
4. ``_scan_fetch`` (host): copy the results back, per-request dicts.

``scan_stream`` runs the same phases over a stream of batches, phase 1 of
the next batch on a load thread and phase 4 of an earlier one on a fetch
thread while the caller's thread fits quads, so host and card overlap;
``scan_batch(pipeline_chunk=k)`` drives one call through it in
sub-batches. Both localize and deskew compact their edge maps with the
``rank_extract`` kernel before the ``hough_votes`` kernel.

With ``mesh=`` the serving paths run phase 3 data-parallel over the
mesh's shards, and with ``space_mesh=`` process_document runs the
post-warp stages H-sharded (``runtime.mesh``, ``runtime.spatial``); the
results equal the unsharded calls'.

While a profiler runs, ``scan_batch`` records the span
``docscan.scan_batch`` over its phases (``docscan.load_localize``,
``docscan.quad_fit``, ``docscan.post_warp``, ``docscan.fetch``), the quad
fit one ``docscan.fit_quad`` a photo, and ``docscan_post_warp_batch``
its stages (``runtime.profiling``); ``scan_stream`` gives each batch one
call id that its phases carry across threads. ``docscan.quads`` and
``docscan.quad_fallbacks`` count the quad fits and their min-area-rect
fallbacks.

Per-request failures are isolated as in tpuimage: a host-side failure
marks its own request, a failed batched device call marks its group.
Nothing here imports the JAX package: the host-only helpers are the
port's copies (``tpuimage_torch.detect.contours``, ``tpuimage_torch.ops.draw``,
``tpuimage_torch.io.imageio``), and PIL is imported only to read or write
image files.
"""
from __future__ import annotations

import dataclasses
import math
import os
import warnings
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpuimage_torch.core.device import as_input, resolve_device
from tpuimage_torch.detect import contours as cnt
from tpuimage_torch.io import imageio
from tpuimage_torch.ops import geometry, kernels
from tpuimage_torch.ops.arith import normalize_minmax, normalize_minmax_lut
from tpuimage_torch.ops.bilateral import bilateral_filter
from tpuimage_torch.ops.color import rgb_to_gray
from tpuimage_torch.ops.draw import draw_polyline_overlay, draw_segments
from tpuimage_torch.ops.edges import canny
from tpuimage_torch.ops.filters import gaussian_blur_u8
from tpuimage_torch.ops.histogram import hist256_batch, otsu_from_hist
from tpuimage_torch.ops.hough import hough_fold_median_angle, hough_lines_p_det
from tpuimage_torch.ops.morphology import morph_blackhat, morph_close, structuring_element
from tpuimage_torch.ops.threshold import adaptive_threshold
from tpuimage_torch.runtime import spatial
from tpuimage_torch.runtime.mesh import canonical_device, run_data_parallel
from tpuimage_torch.runtime.profiling import count, new_call, span


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


# The GUI override config that produced the committed scan_03..08 goldens.
GUI_DOCUMENT_CONFIG = DocScanConfig(
    scale_long=1200, illum_method="divide", illum_blur_frac=0.05,
    block_size=31, C=3, canny_low=30, canny_high=100,
    morph_ksize=1, morph_iters=0)


# ---------------------------------------------------------------------------
# static sizes of the post-warp stages (also read by convert.static_tables)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# post-warp program
# ---------------------------------------------------------------------------

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
    with span("docscan.post_warp"):
        with span("docscan.pre_deskew"):
            pre = _pre_deskew_stages(warped_batch, c)
        weighted = pre["weighted"]
        with span("docscan.deskew_angle"):
            angles, overflows = _deskew_angle(weighted, c.canny_low, c.canny_high,
                                              c.max_rotate, c.deskew_max_edges)
        with span("docscan.rotate"):   # the nonzero waits for the card
            rot = torch.nonzero(angles != 0.0).flatten()
            desk = weighted
            if rot.numel():
                desk = weighted.clone()
                desk[rot] = geometry.rotate_pages(weighted[rot], angles[rot], c.max_rotate)
        with span("docscan.morph_cleanup"):
            clean = _morph_cleanup(desk, c)
    return {**pre, "deskew": desk, "clean": clean, "deskew_angle": angles,
            "deskew_overflow": overflows}


def docscan_post_warp(warped_rgb: torch.Tensor,
                      config: DocScanConfig) -> Dict[str, torch.Tensor]:
    """docscan_post_warp_batch of one (H, W, 3) page; unbatched outputs."""
    out = docscan_post_warp_batch(warped_rgb[None], config)
    return {k: v[0] for k, v in out.items()}


# ---------------------------------------------------------------------------
# localize (device) + quad fit (host)
# ---------------------------------------------------------------------------

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
    external contours, pick the largest quadrilateral, or else the
    min-area rectangle of the largest contour (counted as
    ``docscan.quads`` and ``docscan.quad_fallbacks``)."""
    count("docscan.quads")
    with span("docscan.fit_quad"):
        with span("docscan.draw_segments"):
            line_img = draw_segments(edges.shape, segs[ok], thickness=2)
        with span("docscan.find_contours"):
            contour_list = cnt.find_external_contours(edges | line_img)
        img_area = shape[0] * shape[1]
        areas = cnt.contour_areas(contour_list) / max(img_area, 1)
        filtered = [c for c, a in zip(contour_list, areas)
                    if config.min_area_ratio <= a <= config.max_area_ratio]
        with span("docscan.approx_quads"):
            quad = _largest_quadrilateral(filtered if filtered else contour_list)
        if quad is None:
            if not contour_list:
                return None
            count("docscan.quad_fallbacks")
            with span("docscan.min_area_rect"):
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


# ---------------------------------------------------------------------------
# stage ops of process_document
# ---------------------------------------------------------------------------

def preprocess(rgb, d: int = 9, sigma_color: float = 75.0, sigma_space: float = 75.0,
               gaussian_ksize: int = 0, device=None) -> torch.Tensor:
    """Gray -> bilateral -> optional Gaussian of an (H, W, 3) RGB or (H, W)
    gray uint8 image: the ``bilateral`` kernel, then, for
    ``gaussian_ksize > 1``, ``gaussian_blur_u8``. A tensor runs where it
    is (or on ``device``), an array on ``resolve_device(device)``."""
    x = as_input(rgb, device)
    gray = rgb_to_gray(x) if x.dim() == 3 else x
    out = bilateral_filter(gray, d, sigma_color, sigma_space)
    if gaussian_ksize and gaussian_ksize > 1:
        out = gaussian_blur_u8(out, ksize=gaussian_ksize)
    return out


def _localize_parse(edges: torch.Tensor, segs: torch.Tensor, ok: torch.Tensor,
                    config: DocScanConfig) -> list:
    """Host half of the batched localize: fetch the edge maps and segments
    and fit each image's quad. A failed fit is isolated to its image: its
    entry is the exception."""
    with span("docscan.localize_read"):
        edges, segs, ok = edges.cpu().numpy(), segs.cpu().numpy(), ok.cpu().numpy()
    out = []
    for j in range(edges.shape[0]):
        try:
            out.append(_quad_from_localize(edges[j], segs[j], ok[j], edges.shape[1:3], config))
        except Exception as e:  # noqa: BLE001 — per-request isolation
            out.append(e)
    return out


def localize_batch(rgbs, config: DocScanConfig, device=None) -> list:
    """Localize over a same-shape (B, H, W, 3) stack: one batched device
    call (Canny + Hough segments), then the host quad fit of each image.
    Returns per image its quad, None, or the exception of a failed fit."""
    stack = as_input(rgbs, device)
    return _localize_parse(*_localize_device_batch(stack, config.canny_low, config.canny_high),
                           config)


def localize_document(rgb, config: DocScanConfig, device=None) -> Optional[np.ndarray]:
    """The document quad of one (H, W, 3) photo (TL, TR, BR, BL), or None."""
    x = as_input(rgb, device)
    edges, segs, ok = _localize_device_batch(x[None], config.canny_low, config.canny_high)
    return _quad_from_localize(edges[0].cpu().numpy(), segs[0].cpu().numpy(),
                               ok[0].cpu().numpy(), tuple(x.shape[:2]), config)


def _use_whole(quad: Optional[np.ndarray], shape, config: DocScanConfig) -> bool:
    """The use-whole fallback: no quad, or one covering less than
    ``min_quad_area_ratio`` of the (H, W) photo."""
    return quad is None or cnt.contour_area(quad) / max(
        int(shape[0]) * int(shape[1]), 1) < config.min_quad_area_ratio


def _fallback_common_size(shape, page: str, scale_long: int) -> Tuple[int, int]:
    """The page geometry a use-whole page is resized to under
    ``scan_batch(fallback_common_shape=True)``: _warp_target_size's
    page-ratio formula with the portrait test taken from the input's own
    aspect (A-series sqrt(2) for a custom ``page``, which has no quad to
    take a ratio from)."""
    h, w = int(shape[0]), int(shape[1])
    ratio = 11.0 / 8.5 if page.upper() == "LETTER" else math.sqrt(2.0)
    if h >= w:
        return scale_long, int(round(scale_long / ratio))
    return int(round(scale_long * ratio)), scale_long


def _page_homography(quad: np.ndarray, th: int, tw: int) -> np.ndarray:
    """The float64 homography taking ``quad`` to the (th, tw) page
    rectangle."""
    dst = np.array([[0, 0], [tw - 1, 0], [tw - 1, th - 1], [0, th - 1]], dtype=np.float32)
    return geometry.get_perspective_transform(quad.astype(np.float32), dst)


def _inverse_homography(quad: np.ndarray, th: int, tw: int) -> np.ndarray:
    """float64 inverse of :func:`_page_homography` (what the warp samples
    through)."""
    return np.linalg.inv(_page_homography(quad, th, tw))


def perspective_warp(rgb, quad: np.ndarray, page: str = "A4", scale_long: int = 1600,
                     device=None) -> torch.Tensor:
    """The quad's homography to the fixed page rectangle: (th, tw[, 3])
    uint8, bilinear with a constant-0 border, rounded op by op as
    tpuimage's ``perspective_warp`` runs its ``warp_perspective`` (no
    jit)."""
    th, tw = _warp_target_size(quad, page, scale_long)
    return geometry.warp_perspective(as_input(rgb, device), _page_homography(quad, th, tw),
                                     th, tw)


# ---------------------------------------------------------------------------
# process_document: the reference CLI's one-document contract
# ---------------------------------------------------------------------------

_STAGE_FILES = (("scan_04_illum.png", "illum"), ("scan_05_stretch.png", "stretch"),
                ("scan_05a_inkmask.png", "inkmask"), ("scan_06_adapt.png", "adapt"),
                ("scan_06b_weighted.png", "weighted"), ("scan_07_deskew.png", "deskew"),
                ("scan_08_clean.png", "clean"))


def process_document(input_path, out_dir: Optional[str] = "outputs",
                     config: DocScanConfig = DocScanConfig(), save_stages: bool = True,
                     do_ocr: bool = False, space_mesh=None, device=None) -> dict:
    """One document: preprocess, localize, warp (or the use-whole
    fallback), the post-warp stages. Returns ``{quad, warped, binary,
    use_whole, stages}`` (tensors on the device the stages ran on) and,
    with ``out_dir`` and ``save_stages``, writes tpuimage's stage files
    ``scan_01_pre.png`` .. ``scan_08_clean.png`` there (through PIL, or
    without it through ``io/png.py``). ``input_path``: an image path (a
    PNG, or any format PIL reads), or an RGB uint8 (H, W, 3) array or
    tensor.

    device: as ``scan_batch``'s (default the card). ``space_mesh``: a
    ``runtime.mesh.Mesh`` with a "space" axis; the post-warp stages then
    run H-sharded over it (``runtime.spatial.docscan_post_warp_spatial``,
    every stage equal to the unsharded program's) where the warped height
    divides the axis, and unsharded with a warning where it does not. The
    front end then runs on ``device``, by default the mesh's first
    device; ValueError where ``device`` is not one of the mesh's."""
    if space_mesh is not None:
        device = _front_device(device, space_mesh)
    if isinstance(input_path, (str, os.PathLike)):
        input_path = imageio.load_image_rgb(input_path)
    rgb = as_input(input_path, device)
    c = config

    def dump(name, img):
        if save_stages and out_dir:
            imageio.save_image(os.path.join(out_dir, name), img)

    dump("scan_01_pre.png", preprocess(rgb, c.bilateral_d, c.bilateral_sigma_color,
                                       c.bilateral_sigma_space, c.gaussian_ksize))

    quad = localize_document(rgb, c)
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    use_whole = _use_whole(quad, (h, w), c)
    if use_whole and not c.fallback_use_whole:
        raise RuntimeError("Quad too small or missing, and fallback disabled.")

    if save_stages and out_dir:
        if use_whole:
            full = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], np.float32)
            overlay = draw_polyline_overlay(rgb.cpu().numpy(), full, color=(255, 165, 0))
        else:
            overlay = draw_polyline_overlay(rgb.cpu().numpy(), quad, color=(0, 255, 0))
        dump("scan_02_quad.png", overlay)

    if use_whole:
        warped = geometry.resize_long_side(rgb, c.scale_long, interpolation="area")
    else:
        warped = perspective_warp(rgb, quad, page=c.page, scale_long=c.scale_long)
    dump("scan_03_warped.png", warped)

    stages = None
    if space_mesh is not None:
        n = space_mesh.shape["space"]
        if int(warped.shape[0]) % n == 0:
            stages = spatial.docscan_post_warp_spatial(warped, c, space_mesh)
        else:
            warnings.warn(f"warped height {int(warped.shape[0])} does not "
                          f"divide the space axis ({n}); running the "
                          "post-warp stages unsharded")
    if stages is None:
        stages = docscan_post_warp(warped.contiguous(), c)
    for name, key in _STAGE_FILES:
        dump(name, stages[key])

    result = {"quad": quad, "warped": warped, "binary": stages["clean"],
              "use_whole": use_whole, "stages": stages}
    if bool(stages["deskew_overflow"]):
        warnings.warn("Hough edge budget overflowed during deskew: the "
                      "deskew angle is computed from an undercounted vote "
                      "accumulator; rerun with a larger "
                      "DocScanConfig.deskew_max_edges.")
    return _finish_document(result, out_dir, do_ocr)


def _finish_document(result: dict, out_dir: Optional[str], do_ocr: bool) -> dict:
    """Optional host OCR of the clean page (pytesseract, imported here);
    a failure is recorded as ``ocr_error``."""
    if do_ocr:
        try:
            import pytesseract
            text = pytesseract.image_to_string(result["binary"].cpu().numpy(),
                                               config="--psm 6")
            if out_dir:
                with open(os.path.join(out_dir, "scan_ocr.txt"), "w", encoding="utf-8") as f:
                    f.write(text)
            result["ocr_text"] = text
        except Exception as e:  # noqa: BLE001 — OCR is optional
            result["ocr_error"] = str(e)
    return result


# ---------------------------------------------------------------------------
# serving: scan_batch and scan_stream share four phases
# ---------------------------------------------------------------------------

def _as_rgb_tensor(item) -> torch.Tensor:
    if isinstance(item, (str, os.PathLike)):
        item = imageio.load_image_rgb(item)
    t = item if isinstance(item, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(item))
    if t.dtype != torch.uint8 or t.dim() != 3 or t.shape[2] != 3:
        raise ValueError(f"expected a uint8 HxWx3 RGB image, got "
                         f"{t.dtype} {tuple(t.shape)}")
    return t


def _scan_load_localize(inputs, config: DocScanConfig, device: torch.device,
                        call: Optional[int] = None) -> dict:
    """Phase 1: load, group by shape, one upload and one localize call per
    group. The edge maps and segments stay on the device, as does each
    group's stack for the warp. ``call``: the call id of a batch of
    ``scan_stream`` (``profiling.new_call``), kept in the state for the
    later phases' spans."""
    with span("docscan.load_localize", call):
        n = len(inputs)
        rgbs: list = [None] * n
        metas: list = [None] * n
        for i, item in enumerate(inputs):
            try:
                rgbs[i] = _as_rgb_tensor(item)
            except Exception as e:  # noqa: BLE001 — per-request isolation
                metas[i] = {"error": str(e)}
        by_shape: Dict[tuple, list] = {}
        for i, rgb in enumerate(rgbs):
            if rgb is not None:
                by_shape.setdefault(tuple(rgb.shape), []).append(i)
        stacks: Dict[tuple, tuple] = {}   # shape -> (device stack, {idx: row})
        loc: Dict[tuple, tuple] = {}      # shape -> (edges, segs, ok) on the device
        for shape, idxs in by_shape.items():
            try:
                stack = torch.stack([rgbs[i].to(device) for i in idxs])
                stacks[shape] = (stack, {i: j for j, i in enumerate(idxs)})
                loc[shape] = _localize_device_batch(stack, config.canny_low, config.canny_high)
            except Exception as e:  # noqa: BLE001 — batched device call: whole group
                for i in idxs:
                    metas[i] = {"error": str(e)}
                    rgbs[i] = None
    return {"n": n, "rgbs": rgbs, "metas": metas, "by_shape": by_shape,
            "stacks": stacks, "loc": loc, "call": call}


def _scan_quad_fit(state: dict, config: DocScanConfig, fallback_common_shape: bool) -> None:
    """Phase 2: fetch the localize outputs, fit the quads on the host,
    solve the homographies, then warp the quad pages in one batched call
    per (input shape, target shape) and resize the use-whole pages.
    Leaves ``state['pages']`` on the device."""
    with span("docscan.quad_fit", state["call"]):
        quads = _scan_fit_quads(state, config)
        with span("docscan.warp"):
            _scan_warp(state, quads, config, fallback_common_shape)


def _scan_fit_quads(state: dict, config: DocScanConfig) -> list:
    """Phase 2's host half: each photo's quad, None, or its error in
    ``state['metas']``."""
    rgbs, metas = state["rgbs"], state["metas"]
    quads: list = [None] * state["n"]
    for shape, idxs in state["by_shape"].items():
        if shape not in state["loc"]:
            continue   # the group failed in phase 1
        try:
            found = _localize_parse(*state["loc"][shape], config)
        except Exception as e:  # noqa: BLE001 — batched device call: whole group
            found = [e] * len(idxs)
        for i, q in zip(idxs, found):
            if isinstance(q, Exception):
                metas[i] = {"error": str(q)}
                rgbs[i] = None
            else:
                quads[i] = q
    del state["loc"]
    return quads


def _scan_warp(state: dict, quads: list, config: DocScanConfig,
               fallback_common_shape: bool) -> None:
    """Phase 2's device half: the homographies, the batch warp of the quad
    pages and the use-whole resizes."""
    rgbs, metas, stacks = state["rgbs"], state["metas"], state["stacks"]
    pages: list = [None] * state["n"]
    warp_groups: Dict[tuple, list] = {}
    for i, rgb in enumerate(rgbs):
        if rgb is None:
            continue
        try:
            quad = quads[i]
            use_whole = _use_whole(quad, rgb.shape, config)
            metas[i] = {"quad": quad, "use_whole": use_whole}
            stack, pos = stacks[tuple(rgb.shape)]
            if not use_whole:
                th, tw = _warp_target_size(quad, config.page, config.scale_long)
                warp_groups.setdefault((tuple(rgb.shape), th, tw), []).append(i)
            elif fallback_common_shape:
                th, tw = _fallback_common_size(rgb.shape, config.page, config.scale_long)
                pages[i] = geometry.resize(stack[pos[i]], th, tw, "area")
                metas[i]["fallback_resized_to"] = (th, tw)
            else:
                pages[i] = geometry.resize_long_side(stack[pos[i]], config.scale_long,
                                                     interpolation="area")
        except Exception as e:  # noqa: BLE001 — per-request isolation
            metas[i] = {"error": str(e)}
    for (shape, th, tw), idxs in warp_groups.items():
        minvs, good = [], []
        for i in idxs:
            try:   # a degenerate quad must not poison its group
                minvs.append(_inverse_homography(metas[i]["quad"], th, tw))
                good.append(i)
            except Exception as e:  # noqa: BLE001 — per-request isolation
                metas[i] = {"error": str(e)}
        if not good:
            continue
        try:
            stack, pos = stacks[shape]
            rows = torch.tensor([pos[i] for i in good], device=stack.device)
            minv = torch.from_numpy(np.stack(minvs).astype(np.float32)).to(stack.device)
            warped = geometry.warp_perspective_batch(stack.index_select(0, rows),
                                                     minv, th, tw)
            for j, i in enumerate(good):
                pages[i] = warped[j]
        except Exception as e:  # noqa: BLE001 — batched device call: whole group
            for i in good:
                metas[i] = {"error": str(e)}
    state["pages"] = pages
    del state["stacks"]


_SERVED = ("clean", "deskew_angle", "deskew_overflow")


def _post_warp_served(batch: torch.Tensor, config: DocScanConfig, mesh) -> dict:
    """The post-warp outputs a request gets, of one page-shape group: on
    the group's device, or data-parallel over a mesh (the group padded to
    a multiple of the mesh's size by repeating its last page, each shard
    on its device; gathered on the mesh's first device, the pad
    dropped)."""
    def run(b):
        out = docscan_post_warp_batch(b, config)
        return {k: out[k] for k in _SERVED}
    return run(batch) if mesh is None else run_data_parallel(run, batch, mesh)


def _scan_postwarp_dispatch(state: dict, config: DocScanConfig, mesh=None) -> None:
    """Phase 3: the post-warp program per page shape (data-parallel over
    ``mesh`` when one is given). Each group's clean pages, angles and
    overflow flags stay on the device in ``state['groups']``."""
    pages, metas = state["pages"], state["metas"]
    groups = []
    for shape in {tuple(p.shape) for p in pages if p is not None}:
        idxs = [i for i, p in enumerate(pages)
                if p is not None and tuple(p.shape) == shape]
        try:
            out = _post_warp_served(torch.stack([pages[i] for i in idxs]), config, mesh)
        except Exception as e:  # noqa: BLE001 — batched device call: whole group
            for i in idxs:
                metas[i] = {"error": str(e)}
            continue
        groups.append((idxs, out["clean"], out["deskew_angle"], out["deskew_overflow"]))
    state["groups"] = groups
    del state["pages"]


def _scan_fetch(state: dict) -> list:
    """Phase 4: copy each group's results to the host and build the
    per-request dicts."""
    with span("docscan.fetch", state["call"]):
        metas = state["metas"]
        out_by_idx = {}
        for idxs, clean, angles, oflow in state["groups"]:
            try:
                clean, angles, oflow = (clean.cpu().numpy(), angles.cpu().numpy(),
                                        oflow.cpu().numpy())
            except Exception as e:  # noqa: BLE001 — batched device call: whole group
                for i in idxs:
                    metas[i] = {"error": str(e)}
                continue
            for j, i in enumerate(idxs):
                out_by_idx[i] = (clean[j], float(angles[j]), bool(oflow[j]))
        results = []
        for i, meta in enumerate(metas):
            if "error" in meta:
                results.append(meta)
            else:
                binary, angle, oflow = out_by_idx[i]
                results.append({**meta, "binary": binary, "deskew_angle": angle,
                                "deskew_overflow": oflow})
        return results


def _front_device(device, mesh) -> torch.device:
    """Where the unsharded phases run: ``resolve_device(device)``, or with
    a mesh its first device by default; ValueError where both are given
    and ``device`` is not one of the mesh's devices."""
    if mesh is None:
        return resolve_device(device)
    if device is None:
        return mesh.devices.flat[0]
    dev = canonical_device(resolve_device(device))
    if dev not in set(mesh.devices.flat):
        raise ValueError(f"device {dev} is not a device of the mesh {mesh}")
    return dev


def _auto_pipeline_chunk(n: int) -> int:
    """Sub-batch size for scan_batch's pipelining when the caller gives
    none: 0 (off). On an H100 the stream measured no faster than a loop of
    scan_batch calls (PERF.md): the host quad fit, which it cannot
    overlap, is most of a batch."""
    del n
    return 0


def scan_batch(inputs, config: DocScanConfig = GUI_DOCUMENT_CONFIG,
               device=None, mesh=None, fallback_common_shape: bool = False,
               pipeline_chunk: Optional[int] = None) -> list:
    """Batched serving path over a list of uint8 HWC RGB ndarrays or
    tensors (or image paths). Returns, per request, tpuimage's dict
    ``{quad, use_whole, binary, deskew_overflow}`` plus the page's
    ``deskew_angle``, or ``{error}``.

    device: where the device phases run (default: ``cuda``; raises
    RuntimeError when there is no CUDA device, so a caller who wants the
    host passes ``device="cpu"``).

    mesh: a ``runtime.mesh.Mesh``; the post-warp program then runs
    data-parallel over all its shards, each page-shape group padded to a
    multiple of the mesh's size by repeating its last page, and the
    results are the unsharded call's. The other phases run on ``device``,
    by default the mesh's first device; ValueError where ``device`` is not
    one of the mesh's.

    fallback_common_shape=True resizes use-whole pages (INTER_AREA, no
    padding) to the page geometry (``_fallback_common_size``) instead of
    keeping their aspect, so they share the quad pages' shape groups; such
    a page's dict carries ``fallback_resized_to``.

    pipeline_chunk: a positive value smaller than len(inputs) splits the
    call into sub-batches of that many images, driven through
    scan_stream so that one sub-batch's host work overlaps the device
    work of the one before; None takes ``_auto_pipeline_chunk`` (off).
    Per-request results are the same either way."""
    dev = _front_device(device, mesh)
    n = len(inputs)
    k = _auto_pipeline_chunk(n) if pipeline_chunk is None else int(pipeline_chunk)
    if 0 < k < n:
        out: list = []
        for res in scan_stream([inputs[i:i + k] for i in range(0, n, k)], config,
                               device=dev, mesh=mesh,
                               fallback_common_shape=fallback_common_shape):
            out.extend(res)
        return out
    with span("docscan.scan_batch"):
        state = _scan_load_localize(inputs, config, dev)
        _scan_quad_fit(state, config, fallback_common_shape)
        _scan_postwarp_dispatch(state, config, mesh)
        return _scan_fetch(state)


def scan_stream(batches, config: DocScanConfig = GUI_DOCUMENT_CONFIG, device=None,
                mesh=None, fallback_common_shape: bool = False, prefetch: bool = True):
    """Pipelined serving over an iterable of batches: a generator that
    yields scan_batch's result list for each batch, in input order, with
    the same per-request results, but runs the four phases across
    batches so that host and device work overlap:

        phase 1 of batch i         (on the load thread with ``prefetch``)
        phase 3 of batch i-1       post-warp, queued on the device
        phase 4 of batch i-2       (on the fetch thread with ``prefetch``)
        phase 2 of batch i         host quad fit, homography solves, warp

    At most two batches are in flight plus one being prepared. With
    ``prefetch=False`` every phase runs on the calling thread in the same
    order. The kernels' launch counters are locked, and phases of
    different batches touch disjoint state. Closing the generator early
    cancels the queued work; a phase already running on a worker thread
    finishes in the background. ``device`` and ``mesh`` as in
    scan_batch (checked when this is called, not at the first batch)."""
    return _scan_stream(iter(batches), config, _front_device(device, mesh), mesh,
                        fallback_common_shape, prefetch)


def _scan_stream(it, config: DocScanConfig, dev: torch.device, mesh,
                 fallback_common_shape: bool, prefetch: bool):
    ready = None          # quad fit done, post-warp not yet dispatched
    inflight = deque()    # post-warp dispatched, results not fetched
    fetches = deque()     # fetch futures (or results), input order
    ex = fex = None
    if prefetch:
        ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="scan_stream_load")
        fex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="scan_stream_fetch")
    pending = None
    try:
        def next_state():
            """Phase 1 of the next batch, on the load thread if any."""
            try:
                inputs = next(it)
            except StopIteration:
                return None
            call = new_call()   # the batch's spans share it across threads
            if ex is None:
                return _scan_load_localize(inputs, config, dev, call)
            return ex.submit(_scan_load_localize, inputs, config, dev, call)

        def start_fetch(st):
            return _scan_fetch(st) if fex is None else fex.submit(_scan_fetch, st)

        def emit(f):
            return f if fex is None else f.result()

        pending = next_state()
        while pending is not None:
            state = pending.result() if ex is not None else pending
            pending = next_state()   # overlaps everything below
            if ready is not None:
                _scan_postwarp_dispatch(ready, config, mesh)
                inflight.append(ready)
            while len(inflight) > 1:
                # hand (i-2)'s fetch over before the quad fit, so that the
                # copy rides under the host work; emit a batch only once a
                # newer fetch is queued behind it
                fetches.append(start_fetch(inflight.popleft()))
            _scan_quad_fit(state, config, fallback_common_shape)
            while len(fetches) > 1:
                yield emit(fetches.popleft())
            ready = state
        if ready is not None:
            _scan_postwarp_dispatch(ready, config, mesh)
            inflight.append(ready)
        while inflight:
            fetches.append(start_fetch(inflight.popleft()))
        while fetches:
            yield emit(fetches.popleft())
    finally:
        if ex is not None:
            # a queued phase 1 is cancelled; a running one cannot be and
            # finishes in the background
            if isinstance(pending, Future):
                pending.cancel()
            ex.shutdown(wait=False, cancel_futures=True)
        if fex is not None:
            for f in fetches:
                f.cancel()
            fex.shutdown(wait=False, cancel_futures=True)
