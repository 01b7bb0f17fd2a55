"""Sharded pipelines with global statistics (counterpart of
``tpuimage.runtime.spatial``): night and DocScanner's post-warp stages
with each image's rows split over a mesh axis (``runtime.mesh``), for
pages too large for one card.

- Global reductions over a shard list: :func:`global_hist256` (the
  ``hist256`` kernel on each shard, then ``psum``), :func:`global_min`,
  :func:`global_max` and :func:`global_normalize_minmax` (the port's
  NORM_MINMAX table, one rounding, from the min and max over all shards).
- :func:`night_gray_spatial`, :func:`night_rgb_spatial`: median 3 on a
  1-row halo, each shard's own tile rows' CLAHE LUTs (the ``hist256``
  kernel), the LUT table gathered, and the ``clahe_apply`` kernel with the
  shard's rows of the global row blend table. That is the same kernel
  with the same arithmetic as the unsharded ``night_gray`` / ``night_rgb``,
  so the outputs are equal byte for byte (night RGB against the
  unsharded composition with ``lab_to_rgb(impl="lut")``). tiles_y must
  divide by the shard count, so shard boundaries fall on tile rows.
- :func:`docscan_post_warp_spatial` and its data x space batch form:
  DocScanner's stages 04-08 on the port's kernels, equal to
  ``pipelines.docscan.docscan_post_warp`` on every stage. Each stencil
  runs on a block with its neighbours' rows as deep as its reach; a shard
  at the image's top or bottom takes no rows on that side, so each
  kernel's own border (reflect-101, replicate or constant, as in its
  unsharded call) acts where the image really ends (halo border
  ``"none"``). NORM_MINMAX takes the global min and max; the two Otsu
  thresholds come from summed raw histograms; Canny's hysteresis runs
  each shard to its local fixpoint, then one hop over a 1-row halo, until
  no shard changes; the Hough accumulator is the sum of each shard's
  votes with its first row added to ``ys``; a rotation gathers the page
  on each device, rotates it there and takes the shard's rows back.

Inputs may be arrays or tensors on any device; shards go to the mesh's
devices and the stage outputs come back gathered on the first device of
the mesh axis.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from tpuimage_torch.ops import edges, geometry, hough, kernels
from tpuimage_torch.ops.arith import normalize_minmax_lut
from tpuimage_torch.ops.color import lab_to_rgb, rgb_to_gray, rgb_to_lab
from tpuimage_torch.ops.histogram import (blend_tables_on, hist256, hist256_batch,
                                          tile_luts_from_counts)
from tpuimage_torch.ops.median import median_blur
from tpuimage_torch.ops.morphology import morph_blackhat, morph_close, structuring_element
from tpuimage_torch.ops.threshold import adaptive_threshold
from tpuimage_torch.runtime.mesh import (Mesh, all_gather, any_shard, broadcast, crop_halo,
                                         gather_to, halo_exchange, pmax, pmin, psum, split_to)

ROWS = 1   # the row axis of the (B, h_local, W[, 3]) shards below


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def _exchange(shards, halo: int, border: str = "none"):
    return halo_exchange(shards, halo, border, axis=ROWS)


def _crop(blocks, halo: int, border: str = "none") -> List[torch.Tensor]:
    return [b.contiguous() for b in crop_halo(blocks, halo, border, ROWS)]


# ---------------------------------------------------------------------------
# global reductions over a shard list
# ---------------------------------------------------------------------------

def global_hist256(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The 256-bin histogram of the whole sharded uint8 array: the
    ``hist256`` kernel on each shard, then ``psum``. Exact integer counts,
    on each shard's device; Otsu of a sharded image is
    ``otsu_from_hist(global_hist256(shards)[0])``."""
    return psum([hist256(x) for x in shards])


def global_min(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return pmin([torch.amin(x) for x in shards])


def global_max(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return pmax([torch.amax(x) for x in shards])


def global_normalize_minmax(shards: Sequence[torch.Tensor], alpha: float = 0.0,
                            beta: float = 255.0) -> List[torch.Tensor]:
    """cv2.normalize(NORM_MINMAX) of each (H, W) plane of an image whose
    rows are split over the shards ((..., h_local, W) uint8 each), with
    each plane's min and max taken over all its rows: the port's
    ``normalize_minmax`` table (one rounding) built once on the first
    shard's device and gathered per pixel, so sharded equals unsharded."""
    rows = [x.reshape(-1, x.shape[-2] * x.shape[-1]) for x in shards]
    lo = pmin([torch.amin(r, dim=1) for r in rows])[0]
    hi = pmax([torch.amax(r, dim=1) for r in rows])[0]
    luts = broadcast(normalize_minmax_lut(lo, hi, alpha, beta), shards)
    return [torch.gather(lut, 1, r.to(torch.int64)).reshape(x.shape)
            for lut, r, x in zip(luts, rows, shards)]


# ---------------------------------------------------------------------------
# sharded night
# ---------------------------------------------------------------------------

def _night_check(h: int, w: int, n: int, tiles_x: int, tiles_y: int, space_axis: str) -> None:
    if h % tiles_y or w % tiles_x:
        raise ValueError("sharded CLAHE needs tile-divisible dims (pad on host first)")
    if tiles_y % n:
        raise ValueError(f"tiles_y={tiles_y} must be divisible by the {space_axis} axis ({n})")


def _clahe_sharded(planes: Sequence[torch.Tensor], h: int, w: int, clip_limit: float,
                   tiles_x: int, tiles_y: int) -> List[torch.Tensor]:
    """CLAHE of (B, H, W) planes whose rows are split over the shards at
    tile-row boundaries: each shard's tile LUTs from its own rows, the
    (B, ty, tx, 256) table gathered, then ``clahe_apply`` with the shard's
    rows of the global row table."""
    th, tw = h // tiles_y, w // tiles_x
    tyl = tiles_y // len(planes)
    local = []
    for p in planes:
        b = p.shape[0]
        tiles = (p.reshape(b, tyl, th, tiles_x, tw).permute(0, 1, 3, 2, 4)
                 .reshape(b * tyl * tiles_x, th * tw).contiguous())
        luts = tile_luts_from_counts(hist256_batch(tiles), clip_limit, th * tw)
        local.append(luts.reshape(b, tyl, tiles_x, 256))
    out = []
    for i, (p, luts) in enumerate(zip(planes, all_gather(local, dim=1))):
        rows, cols = blend_tables_on(h, w, th, tw, tiles_y, tiles_x, p.device)
        hl = p.shape[1]
        out.append(kernels.clahe_apply(p.contiguous(), luts,
                                       rows[i * hl:(i + 1) * hl].contiguous(), cols))
    return out


def night_gray_spatial(gray, mesh: Mesh, space_axis: str = "space", clip_limit: float = 2.0,
                       tiles_x: int = 8, tiles_y: int = 8) -> Dict[str, torch.Tensor]:
    """NightLandscapeEnhancement (median 3, CLAHE) on uint8 (..., H, W)
    planes with H split over ``space_axis``; equal to the port's
    ``night_gray`` byte for byte. Needs H and W divisible by the tile grid
    and tiles_y by the axis size. Stage dict as night_gray's, on the
    axis' first device."""
    x = _as_tensor(gray)
    devs = mesh.axis_devices(space_axis)
    h, w = int(x.shape[-2]), int(x.shape[-1])
    _night_check(h, w, len(devs), tiles_x, tiles_y, space_axis)
    shards = split_to(x.reshape(-1, h, w), devs, ROWS)
    filt = _crop([median_blur(b, 3) for b in _exchange(shards, 1, "replicate")], 1, "replicate")
    enh = _clahe_sharded(filt, h, w, clip_limit, tiles_x, tiles_y)
    lead = devs[0]
    return {"original": x.to(lead), "filtered": gather_to(filt, lead, ROWS).reshape(x.shape),
            "enhanced": gather_to(enh, lead, ROWS).reshape(x.shape)}


def night_rgb_spatial(rgb, mesh: Mesh, space_axis: str = "space", clip_limit: float = 2.0,
                      tiles_x: int = 8, tiles_y: int = 8) -> Dict[str, torch.Tensor]:
    """The port's ``night_rgb`` on uint8 (..., H, W, 3) RGB with H split
    over ``space_axis``: median 3 on a 1-row halo, ``rgb_to_lab``, the
    sharded CLAHE on L, then the integer Lab -> RGB
    (``lab_to_rgb(impl="lut")``), so equal byte for byte to the unsharded
    composition with that Lab -> RGB. Divisibility as
    :func:`night_gray_spatial`."""
    x = _as_tensor(rgb)
    devs = mesh.axis_devices(space_axis)
    h, w = int(x.shape[-3]), int(x.shape[-2])
    _night_check(h, w, len(devs), tiles_x, tiles_y, space_axis)
    shards = split_to(x.reshape(-1, h, w, 3), devs, ROWS)
    filt = _crop([median_blur(b, 3, channels_last=True) for b in _exchange(shards, 1, "replicate")],
                 1, "replicate")
    labs = [rgb_to_lab(f) for f in filt]
    l_enh = _clahe_sharded([lab[..., 0] for lab in labs], h, w, clip_limit, tiles_x, tiles_y)
    enh = [lab_to_rgb(torch.cat([le[..., None], lab[..., 1:]], dim=-1), impl="lut")
           for le, lab in zip(l_enh, labs)]
    lead = devs[0]
    return {"original": x.to(lead), "filtered": gather_to(filt, lead, ROWS).reshape(x.shape),
            "enhanced": gather_to(enh, lead, ROWS).reshape(x.shape)}


# ---------------------------------------------------------------------------
# sharded DocScanner post-warp
# ---------------------------------------------------------------------------

def _hysteresis_sharded(strong: List[torch.Tensor], weak: List[torch.Tensor],
                        max_iters: int) -> List[torch.Tensor]:
    """Canny hysteresis to the global weak-reachability fixpoint: each
    round runs every shard to its local fixpoint, then one hop over a
    1-row halo of the strong maps; rounds go on while any shard changed
    (one flag read a round). Growth is monotone within weak-reachability,
    so this reaches the unsharded fixpoint."""
    changed, i = True, 0
    while changed and i < max_iters:
        new = [edges._hysteresis(s, wk, max_iters) for s, wk in zip(strong, weak)]
        grown = crop_halo([edges.dilate8_bool(b) for b in _exchange(new, 1)], 1, "none", ROWS)
        strong = [nw | (wk & g) for nw, wk, g in zip(new, weak, grown)]
        changed = any_shard([(s != nw).any() for s, nw in zip(strong, new)])
        i += 1
    return strong


def _hough_votes_sharded(edges_local: torch.Tensor, y0: int, full_h: int, w: int):
    """One shard's Hough votes in the global (full_h, w) binning: its
    edges compacted (``rank_extract``) within tpuimage's per-shard budget,
    ``y0`` added to ``ys``, then ``hough_votes``. The sum over the shards
    equals the unsharded accumulator (integer votes). Returns ((B, numrho,
    180) int32, (B,) bool overflow)."""
    numrho = (w + full_h) * 2 + 1
    _, hl, wl = edges_local.shape
    k = min(max(131072, (hl * wl * 3) // 16), 524288, hl * wl)
    xs, ys, counts, overflow = hough.compact_edges(edges_local, k)
    cos_np, sin_np = hough.hough_tables()
    dev = edges_local.device
    acc = kernels.hough_votes(xs, ys + y0, counts, torch.from_numpy(cos_np).to(dev),
                              torch.from_numpy(sin_np).to(dev), numrho, (numrho - 1) // 2)
    return acc, overflow


def _make_post_warp_local(config, h: int, w: int, n: int, space_axis: str):
    """The three phases of the sharded post-warp over one row of shards,
    as tpuimage splits them: ``pre`` (stages 04-06b and the deskew angle),
    ``rotate_local`` and ``post`` (the close). Validates the halos: each
    must be smaller than the shard height, as tpuimage asserts."""
    from tpuimage_torch.pipelines import docscan as ds   # docscan imports this module
    c = config
    if h % n:
        raise ValueError(f"H={h} must divide the {space_axis} axis ({n})")
    hl = h // n
    illum_k, mask_k, block = ds.illum_ksize(h, w, c), ds.mask_ksize(c), ds.adaptive_block(c)
    se = ds.blackhat_se(c)
    vb = se.shape[0] - 1                                # the close inside the blackhat
    close_halo = 2 * c.morph_iters * (c.morph_ksize // 2)
    ink_halo = max(mask_k // 2, vb, block // 2)         # the ink planes and the adaptive threshold
    mask_halo = c.ink_dilate_iters + 2                  # the 2x2 dilations and Canny's reach
    for name, hal in (("illum", illum_k // 2), ("ink", mask_k // 2), ("blackhat", vb),
                      ("adapt", block // 2), ("cleanup", close_halo), ("inkmask", mask_halo)):
        if hal >= hl:
            raise ValueError(f"{name} halo {hal} >= shard height {hl}: use "
                             f"fewer shards or a taller page")
    mode = "divide" if c.illum_method.lower() == "divide" else "subtract"

    def adapt(x):
        if c.thresh_method == "gaussian":
            return kernels.gauss_chain(x, block, "adaptive", C=c.C)
        return adaptive_threshold(x, 255, c.thresh_method, block, c.C)

    def pre(rgb: List[torch.Tensor]) -> dict:
        """(B, hl, W, 3) page shards -> stage shards and the (B,) angle and
        overflow on the first shard's device."""
        gray = [rgb_to_gray(x) for x in rgb]
        r = illum_k // 2
        tmp = _crop([kernels.gauss_chain(b, illum_k, mode) for b in _exchange(gray, r)], r)
        illum = global_normalize_minmax(tmp)

        r = ink_halo
        blocks = _exchange(illum, r)
        sub_raw = _crop([kernels.gauss_chain(b, mask_k, "sub") for b in blocks], r)
        bh_raw = _crop([morph_blackhat(b, se) for b in blocks], r)
        base_bin = _crop([adapt(b) for b in blocks], r)

        hists = psum([hist256_batch(torch.stack([s, b], dim=1).reshape(2 * s.shape[0], -1))
                      .reshape(-1, 2, 256) for s, b in zip(sub_raw, bh_raw)])[0]
        t_sub = broadcast(ds._raw_otsu_threshold(hists[:, 0], c.mask_thresh_offset), rgb)
        t_bh = broadcast(ds._raw_otsu_threshold(hists[:, 1], c.mask_thresh_offset), rgb)

        e, it = mask_halo, c.ink_dilate_iters
        outs = [kernels.inkmask_weighted(s, b, a, ts, tb, it) for s, b, a, ts, tb in
                zip(_exchange(sub_raw, e), _exchange(bh_raw, e), _exchange(base_bin, e),
                    t_sub, t_bh)]
        ink_mask = _crop([m for m, _ in outs], e)
        weighted = _crop([wt for _, wt in outs], e)
        cands = [edges.canny_pre(b, c.canny_low, c.canny_high)
                 for b in crop_halo([wt for _, wt in outs], it, "none", ROWS)]
        strong = _crop([s for s, _ in cands], 2)
        weak = _crop([wk for _, wk in cands], 2)
        strong = _hysteresis_sharded(strong, weak, h + w)

        votes, oflows = zip(*[_hough_votes_sharded(s.to(torch.uint8) * 255, i * hl, h, w)
                              for i, s in enumerate(strong)])
        med = hough.fold_median_from_acc(psum(list(votes))[0], 150)
        angle = torch.where(torch.abs(med) > c.max_rotate, torch.zeros_like(med), med)
        overflow = pmax([o.to(torch.uint8) for o in oflows])[0] > 0
        return {"illum": illum, "stretch": illum, "inkmask": ink_mask, "adapt": base_bin,
                "weighted": weighted, "deskew_angle": angle, "deskew_overflow": overflow}

    def rotate_local(weighted: List[torch.Tensor], angle: torch.Tensor) -> List[torch.Tensor]:
        """The pages whose angle is not 0 rotated as the unsharded program
        rotates them: the page gathered on each device (one rotation a
        device), each shard's rows taken back. Reads the angles' nonzero
        set to the host once."""
        rot = torch.nonzero(angle != 0.0).flatten()
        if not rot.numel():
            return weighted
        done: dict = {}
        out = []
        for i, (full, x, a, rr) in enumerate(zip(all_gather(weighted, dim=ROWS), weighted,
                                                 broadcast(angle, weighted),
                                                 broadcast(rot, weighted))):
            if x.device not in done:
                d = full.clone()
                d[rr] = geometry.rotate_pages(full[rr], a[rr], c.max_rotate)
                done[x.device] = d
            out.append(done[x.device][:, i * hl:(i + 1) * hl].contiguous())
        return out

    def post(desk: List[torch.Tensor]) -> List[torch.Tensor]:
        """The morph cleanup (close) on the deskewed shards."""
        if c.morph_ksize > 1 and c.morph_iters > 0:
            close_se = structuring_element("rect", (c.morph_ksize, c.morph_ksize))
            r = close_halo
            return _crop([morph_close(b, close_se, iterations=c.morph_iters)
                          for b in _exchange(desk, r)], r)
        return desk

    return pre, rotate_local, post


_PLANES = ("illum", "stretch", "inkmask", "adapt", "weighted", "deskew", "clean")


def _post_warp_rows(batch: torch.Tensor, config, devices, space_axis: str) -> dict:
    """The sharded post-warp of a (B, H, W, 3) batch over one row of
    devices -> per-key shard lists and the (B,) angle and overflow."""
    h, w = int(batch.shape[1]), int(batch.shape[2])
    pre, rotate_local, post = _make_post_warp_local(config, h, w, len(devices), space_axis)
    s = pre(split_to(batch, devices, ROWS))
    desk = rotate_local(s["weighted"], s["deskew_angle"])
    return {**s, "deskew": desk, "clean": post(desk)}


def _gathered(parts: Sequence[dict], lead: torch.device) -> Dict[str, torch.Tensor]:
    """Rows of each data row's shard lists gathered, data rows stacked."""
    out = {}
    for k in _PLANES:
        if k == "stretch":
            out[k] = out["illum"]
        else:
            out[k] = torch.cat([gather_to(q[k], lead, ROWS) for q in parts])
    for k in ("deskew_angle", "deskew_overflow"):
        out[k] = torch.cat([q[k].to(lead) for q in parts])
    return out


def docscan_post_warp_spatial(warped_rgb, config, mesh: Mesh,
                              space_axis: str = "space") -> Dict[str, torch.Tensor]:
    """DocScanner's stages 04-08 (``docscan_post_warp``) on one (H, W, 3)
    uint8 page with H split over ``space_axis``; every stage equal to the
    unsharded program's. Needs H divisible by the axis size and every
    halo smaller than the shard height (ValueError otherwise). The stages
    come back on the axis' first device; (H, W) planes, scalar angle and
    overflow.

    The deskew's edge budget is tpuimage's, one a shard
    (:func:`_hough_votes_sharded`), not ``deskew_max_edges``: where the
    unsharded program's budget overflows and no shard's does, this run
    counts every edge (overflow False) and equals the unsharded run
    given a budget of every pixel."""
    x = _as_tensor(warped_rgb)
    devs = mesh.axis_devices(space_axis)
    out = _gathered([_post_warp_rows(x[None], config, devs, space_axis)], devs[0])
    return {k: v[0] for k, v in out.items()}


def docscan_post_warp_spatial_batch(batch_rgb, config, mesh: Mesh, data_axis: str = "data",
                                    space_axis: str = "space") -> Dict[str, torch.Tensor]:
    """The data x space form of :func:`docscan_post_warp_spatial`: the
    (B, H, W, 3) batch split over ``data_axis``, each page's rows over
    ``space_axis``. Each data row rotates only its pages whose angle is
    not 0, and skips the rotation when every angle is 0, as the unsharded
    ``docscan_post_warp_batch`` does. Each page equals its unsharded run.
    Needs B divisible by the data axis and H by the space axis; outputs
    (B, ...) on the mesh's first device."""
    x = _as_tensor(batch_rgb)
    grid = mesh.grid(data_axis, space_axis)
    nd = grid.shape[0]
    if x.shape[0] % nd:
        raise ValueError(f"batch {x.shape[0]} must divide the {data_axis} axis ({nd})")
    bl = x.shape[0] // nd
    parts = [_post_warp_rows(x[i * bl:(i + 1) * bl], config, list(grid[i]), space_axis)
             for i in range(nd)]
    return _gathered(parts, grid[0, 0])
