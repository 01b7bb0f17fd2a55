"""Haar cascade object detection (Viola-Jones) on the host (counterpart of
``tpuimage.detect.haar``: its numpy evaluator and, through
``tpuimage_torch.native``, its C++ one, value for value).

Replaces cv2.CascadeClassifier.detectMultiScale at the reference's call
sites: eyes (haarcascade_eye.xml, scale 1.1, minNeighbors 5, minSize
30x30) and faces (haarcascade_frontalface_default.xml, scale 1.1,
minNeighbors 5, minSize 40x40). Detection is a routing step whose windows
shrink level by level, and its arithmetic is integer-exact, so it stays
on the host: the face pipeline fetches the gray image and hands the boxes
back.

Evaluation: each window carries the flat offset of its own integral image
plus that level's row stride, so every feature rect is 4 gathers
regardless of scale. Phase 1 runs the variance norm and the first 6
(bulk-killer) stages per pyramid level, densely on the window grid for
the first 4, so every temp array stays level-local; phase 2 pools each
image's survivors across its levels and runs the remaining stages once.
The native evaluator instead exits each window early, one call per level.
Both give identical candidates in the same order (level-major, then y,
then x), so the grouping (OpenCV's groupRectangles) sees identical input.

Cascade XMLs are the stock OpenCV data files, looked up in the system's
``/usr/share/opencv4/haarcascades`` first and then in this package's
``data/`` (which carries ``haarcascade_eye.xml``); the parser reads the
``opencv-cascade-classifier`` stump format.
"""
from __future__ import annotations

import functools
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

import numpy as np


# stages evaluated densely on a level's full window grid, and the windows
# of one cache tile of that grid (tpuimage's defaults)
_DENSE_STAGE_COUNT = 4
_DENSE_TILE_WINDOWS = 32768

_CASCADE_SEARCH_PATHS = [
    "/usr/share/opencv4/haarcascades",
    os.path.join(os.path.dirname(__file__), "data"),
]


def find_cascade(name: str) -> str:
    for base in _CASCADE_SEARCH_PATHS:
        p = os.path.join(base, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"cascade {name!r} not found in {_CASCADE_SEARCH_PATHS}")


class HaarCascade:
    """Parsed stump cascade: packed numpy arrays ready for dense eval."""

    def __init__(self, xml_path: str):
        root = ET.parse(xml_path).getroot()
        c = root.find("cascade")
        if c is None or c.get("type_id") != "opencv-cascade-classifier":
            raise ValueError(f"{xml_path}: not a new-format cascade")
        self.win_h = int(c.findtext("height"))
        self.win_w = int(c.findtext("width"))

        feats = []
        for f in c.find("features"):
            rects = []
            for r in f.find("rects"):
                x, y, w, h, wt = r.text.split()
                rects.append((int(x), int(y), int(w), int(h), float(wt)))
            while len(rects) < 3:
                rects.append((0, 0, 0, 0, 0.0))
            feats.append(rects)
        self.rects = np.asarray(feats, dtype=np.float32)  # (F, 3, 5)

        stage_thresholds = []
        stage_slices = []
        feat_idx, node_thr, leaves = [], [], []
        for st in c.find("stages"):
            stage_thresholds.append(float(st.findtext("stageThreshold")))
            start = len(feat_idx)
            for wc in st.find("weakClassifiers"):
                nodes = wc.findtext("internalNodes").split()
                lv = wc.findtext("leafValues").split()
                assert nodes[0] == "0" and nodes[1] == "-1", "stump cascade only"
                feat_idx.append(int(nodes[2]))
                node_thr.append(float(nodes[3]))
                leaves.append((float(lv[0]), float(lv[1])))
            stage_slices.append((start, len(feat_idx)))
        self.stage_thresholds = np.asarray(stage_thresholds, dtype=np.float32)
        self.stage_slices = stage_slices
        self.feat_idx = np.asarray(feat_idx, dtype=np.int32)
        self.node_thr = np.asarray(node_thr, dtype=np.float32)
        self.leaves = np.asarray(leaves, dtype=np.float32)  # (W, 2)


@functools.lru_cache(maxsize=8)
def load_cascade(name: str) -> HaarCascade:
    return HaarCascade(find_cascade(name))


# ---------------------------------------------------------------------------
# the multi-scale pass + grouping (host, mirrors OpenCV)
# ---------------------------------------------------------------------------

def _group_rectangles(rects: List[Tuple[int, int, int, int]], group_threshold: int,
                      eps: float = 0.2) -> List[Tuple[int, int, int, int]]:
    """cv2.groupRectangles: union-find clustering by the eps-similarity
    predicate, average rect per class, neighbor-count + containment filters."""
    n = len(rects)
    if n == 0:
        return []
    R = np.asarray(rects, dtype=np.float64)

    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        for j in range(i + 1, n):
            delta = eps * (min(R[i, 2], R[j, 2]) + min(R[i, 3], R[j, 3])) * 0.5
            if (abs(R[i, 0] - R[j, 0]) <= delta and abs(R[i, 1] - R[j, 1]) <= delta
                    and abs(R[i, 0] + R[i, 2] - R[j, 0] - R[j, 2]) <= delta
                    and abs(R[i, 1] + R[i, 3] - R[j, 1] - R[j, 3]) <= delta):
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[rj] = ri

    classes: Dict[int, List[int]] = {}
    for i in range(n):
        classes.setdefault(find(i), []).append(i)

    rrects, weights = [], []
    for members in classes.values():
        m = R[np.asarray(members)]
        nm = len(members)
        avg = np.rint(m.mean(axis=0)).astype(np.int64)
        rrects.append(avg)
        weights.append(nm)

    out = []
    for i, (r1, n1) in enumerate(zip(rrects, weights)):
        if n1 <= group_threshold:
            continue
        keep = True
        for j, (r2, n2) in enumerate(zip(rrects, weights)):
            if i == j:
                continue
            dx = int(r2[2] * eps)
            dy = int(r2[3] * eps)
            if (n2 > max(3, n1)
                    and r1[0] >= r2[0] - dx and r1[1] >= r2[1] - dy
                    and r1[0] + r1[2] <= r2[0] + r2[2] + dx
                    and r1[1] + r1[3] <= r2[1] + r2[3] + dy):
                keep = False
                break
        if keep:
            out.append((int(r1[0]), int(r1[1]), int(r1[2]), int(r1[3])))
    return out


def _resize_linear_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize INTER_LINEAR on uint8 gray, host numpy (Q11 fixed point —
    same math as tpuimage_torch.ops.geometry._resize_linear_u8)."""
    from tpuimage_torch.ops.geometry import _linear_coeffs_1d
    h, w = img.shape
    sy, wy1, wy2 = _linear_coeffs_1d(out_h, h)
    sx, wx1, wx2 = _linear_coeffs_1d(out_w, w)
    x = img.astype(np.float32)
    row = x[:, sx] * wx1 + x[:, np.minimum(sx + 1, w - 1)] * wx2
    acc = row[sy] * wy1[:, None] + row[np.minimum(sy + 1, h - 1)] * wy2[:, None]
    return np.clip(np.floor((acc + 2.0 ** 21) / 2.0 ** 22), 0, 255).astype(np.uint8)


def _pyramid_levels(H: int, W: int, wh: int, ww: int, scale_factor: float,
                    min_size, max_size):
    """OpenCV's detectMultiScale pyramid schedule: (factor, sh, sw, win_w,
    win_h, step) per level, identical for the numpy and native evaluators."""
    factor = 1.0
    while True:
        win_w = int(round(ww * factor))
        win_h = int(round(wh * factor))
        sw, sh = int(round(W / factor)), int(round(H / factor))
        if sw - ww <= 0 or sh - wh <= 0:
            break
        if max_size and (win_w > max_size[0] or win_h > max_size[1]):
            break
        if not (win_w < min_size[0] or win_h < min_size[1]):
            yield factor, sh, sw, win_w, win_h, (1 if factor > 2.0 else 2)
        factor *= scale_factor


def _native_pack(casc: HaarCascade):
    """Flat ctypes-ready views of the cascade (cached on the object)."""
    if not hasattr(casc, "_native_arrays"):
        import ctypes
        rects = np.ascontiguousarray(casc.rects[:, :, :4], dtype=np.int32)
        wts = np.ascontiguousarray(casc.rects[:, :, 4], dtype=np.float32)
        bounds = np.asarray([s0 for s0, _ in casc.stage_slices]
                            + [casc.stage_slices[-1][1]], dtype=np.int32)
        p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
        casc._native_arrays = (
            # keep the arrays alive alongside their pointers
            (rects, wts, bounds),
            (p(rects, ctypes.c_int32), p(wts, ctypes.c_float),
             p(casc.feat_idx, ctypes.c_int32),
             p(casc.node_thr, ctypes.c_float),
             p(casc.leaves, ctypes.c_float),
             p(casc.stage_thresholds, ctypes.c_float),
             p(bounds, ctypes.c_int32)))
    return casc._native_arrays[1]


def _detect_batch_native(lib, grays, casc: HaarCascade, scale_factor: float,
                         min_neighbors: int, min_size, max_size):
    """Per-window early-exit cascade in C++ (native/haar.cpp): one call per
    pyramid level, resize + rect grouping stay in Python. Candidate order
    (level-major, then y, then x) matches the numpy evaluator, so grouping —
    whose class means depend on member order — sees identical input."""
    import ctypes
    wh, ww = casc.win_h, casc.win_w
    cr, cw, cfi, cnt, clv, cst, cbd = _native_pack(casc)
    n_stages = len(casc.stage_slices)
    cap = 1 << 16
    out = np.empty(cap * 2, dtype=np.int32)
    results = []
    for gray in grays:
        gray = np.ascontiguousarray(gray, dtype=np.uint8)
        H, W = gray.shape
        # integral scratch sized to the largest level, reused level-to-level
        # (fresh multi-MB numpy allocations churn pages)
        ii_s = np.empty((H + 1) * (W + 1), dtype=np.int32)
        sq_s = np.empty((H + 1) * (W + 1), dtype=np.float64)
        cands: List[Tuple[int, int, int, int]] = []
        for factor, sh, sw, win_w, win_h, step in _pyramid_levels(
                H, W, wh, ww, scale_factor, min_size, max_size):
            scaled = _resize_linear_np(gray, sh, sw)
            while True:
                n = lib.tpuimage_haar_level(
                    scaled.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    sh, sw, wh, ww, step, cr, cw, cfi, cnt, clv, cst, cbd,
                    n_stages,
                    ii_s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    sq_s.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    cap)
                if n >= 0:
                    break
                cap *= 2
                out = np.empty(cap * 2, dtype=np.int32)
            if n:
                xy = out[:2 * n].reshape(-1, 2)
                xs = np.rint(xy[:, 0] * factor).astype(np.int64)
                ys = np.rint(xy[:, 1] * factor).astype(np.int64)
                cands.extend((int(x), int(y), win_w, win_h)
                             for x, y in zip(xs, ys))
        results.append(_group_rectangles(cands, min_neighbors))
    return results


def detect_multi_scale_batch(grays, cascade_name: str,
                             scale_factor: float = 1.1,
                             min_neighbors: int = 5,
                             min_size: Tuple[int, int] = (0, 0),
                             max_size: Tuple[int, int] | None = None,
                             impl: str = "auto",
                             ) -> List[List[Tuple[int, int, int, int]]]:
    """detectMultiScale over a LIST of gray images with ONE cascade pass.

    Each window carries the flat offset of its own integral image and that
    level's row stride, so the rect sums stay 4 gathers per feature rect,
    and the late stages run once over each image's pooled survivors.
    Identical windows, identical float64 math, identical candidate order
    (image-major, then scale, then y-major origin), so results match
    detect_multi_scale exactly, and tpuimage's detector too.

    impl: "native" forces the C++ per-window early-exit evaluator
    (native/haar.cpp — ~10-20x the vectorized numpy form, identical
    results), "numpy" forces the vectorized fallback, "auto" prefers
    native when the toolchain/library is available.
    """
    if impl not in ("auto", "native", "numpy"):
        raise ValueError(f"impl must be auto|native|numpy, got {impl!r}")
    casc = load_cascade(cascade_name)
    # the native evaluator's int32 integral image requires 255*H*W < 2^31
    # (~8.4 MP); larger inputs take the numpy path with an int64 integral
    fits_i32 = all(255 * g.shape[0] * g.shape[1] < 2 ** 31
                   for g in (np.asarray(g) for g in grays))
    if impl != "numpy" and fits_i32:
        from tpuimage_torch.native import load_native
        lib = load_native()
        if lib is not None and hasattr(lib, "tpuimage_haar_level"):
            return _detect_batch_native(lib, grays, casc, scale_factor,
                                        min_neighbors, min_size, max_size)
        if impl == "native":
            raise RuntimeError("native haar library unavailable "
                               "(g++ build failed?)")
    elif impl == "native":
        raise ValueError("impl='native' requires every image < ~8.4 MP "
                         "(int32 integral-image bound)")
    wh, ww = casc.win_h, casc.win_w
    R = casc.rects  # (F, 3, 5)

    def rect_sum(flat, off, st, rx, ry, rw, rh):
        o = off + ry * st + rx
        return (flat[o + rh * st + rw] - flat[o + rw]
                - flat[o + rh * st] + flat[o])

    def run_stages(flat, alive, strd, nf_a, s_from, s_to):
        """Evaluate cascade stages [s_from, s_to); returns the survivor
        boolean keep-masks stagewise-compacted into one index array."""
        idx = np.arange(len(alive), dtype=np.int64)
        for (s0, s1), sthr in list(zip(casc.stage_slices,
                                       casc.stage_thresholds))[s_from:s_to]:
            if len(idx) == 0:
                break
            a, st_, nf_ = alive[idx], strd[idx], nf_a[idx]
            ssum = np.zeros(len(idx), dtype=np.float64)
            for wci in range(s0, s1):
                fi = int(casc.feat_idx[wci])
                val = np.zeros(len(idx), dtype=np.float64)
                for (rx, ry, rw, rh, wt) in R[fi]:
                    if wt == 0.0:
                        continue
                    val += wt * rect_sum(flat, a, st_,
                                         int(rx), int(ry), int(rw), int(rh))
                ssum += np.where(val < casc.node_thr[wci] * nf_,
                                 casc.leaves[wci, 0], casc.leaves[wci, 1])
            idx = idx[ssum >= sthr]
        return idx

    # Two-phase evaluation. Phase 1 runs the variance normalization and the
    # first few (bulk-killer) stages per PYRAMID LEVEL, while that level's
    # integral image and window arrays are the only live allocations: the
    # early stages see the huge window sets (a 1280x963 image opens ~1.5M
    # windows), and evaluating them over the whole batch's concatenation
    # would make every temp array O(total windows). Per-level temps are
    # bounded by one level's window count, and the level sets are big
    # enough that numpy dispatch overhead stays negligible. Phase 2 pools
    # the ~3-7% survivors of an image's levels and runs the remaining ~19
    # stages ONCE over the pooled set, where per-level loops would pay
    # ~n_levels * n_stages tiny numpy calls on sets of a few hundred.
    n_stages = len(casc.stage_slices)
    phase1 = min(6, n_stages)
    # stages evaluated DENSELY on the full window grid before compacting
    # to survivors; must be <= phase1
    _DENSE_STAGES = min(_DENSE_STAGE_COUNT, phase1)
    _DENSE_TILE = _DENSE_TILE_WINDOWS

    results: List[List[Tuple[int, int, int, int]]] = [[] for _ in grays]
    nw_, nh_ = ww - 2, wh - 2
    area = float(nw_ * nh_)
    for img_idx, gray in enumerate(grays):
        # phase-2 pooling is per IMAGE (its ~n_levels survivor sets join one
        # array; no cross-image concatenation): pooling the whole batch's
        # integral pyramids into one flat array (~57 MB/megapixel-image)
        # was measured slower than this per-image loop on large images —
        # the survivors' gathers and the concat copy churn hundreds of MB
        # of fresh pages. Per-image keeps every allocation bounded by one
        # pyramid while still amortizing the cascade tail over all levels.
        ii_parts: List[np.ndarray] = []     # sq is level-local only: the
                                            # variance norm completes in
                                            # phase 1, so sqf is never pooled
        alive_parts: List[np.ndarray] = []  # survivors' flat origin + offset
        stride_parts: List[np.ndarray] = []
        nf_parts: List[np.ndarray] = []
        meta_parts: List[np.ndarray] = []   # (x_out, y_out, win_w, win_h)
        offset = 0
        gray = np.asarray(gray)
        H, W = gray.shape
        for factor, sh, sw, win_w, win_h, step in _pyramid_levels(
                H, W, wh, ww, scale_factor, min_size, max_size):
            scaled = _resize_linear_np(gray, sh, sw)
            # ii in int32 when 255*W*H < 2^31 (all rect-sum intermediates
            # then stay within int32; int64 beyond) — halves the
            # gather/slice traffic vs float64 and every value is the same
            # exact integer, so results are bit-identical. sq needs the
            # 255^2*N range, stays float64 and is level-local (variance
            # normalization completes densely below).
            ii_dt = np.int32 if 255 * sh * sw < 2 ** 31 else np.int64
            ii = np.zeros((sh + 1, sw + 1), dtype=ii_dt)
            sq = np.zeros((sh + 1, sw + 1), dtype=np.float64)
            np.cumsum(np.cumsum(scaled, 0, dtype=ii_dt), 1,
                      out=ii[1:, 1:])
            x = scaled.astype(np.float64)
            np.cumsum(np.cumsum(x * x, 0), 1, out=sq[1:, 1:])
            stride = sw + 1
            oh, ow = sh - wh + 1, sw - ww + 1

            # Window origins form a REGULAR grid, so a rect sum over every
            # origin is pure SLICE arithmetic on the 2-D integral image —
            # no index arrays, no gathers. Two facts shape the form (both
            # measured for tpuimage's copy): (a) step-2 strided slice
            # reads run ~4x below contiguous speed, so ii is split ONCE
            # per level into step^2 contiguous phase copies and every
            # rect corner becomes a contiguous-row slice of its phase;
            # (b) full-grid f64 passes are DRAM-bound (~200us each at
            # 295k windows) while <=2 MB working sets run 3-5x faster, so
            # the stage loop is cache-TILED over grid-row blocks — all
            # per-feature temps stay L2-resident and use numpy's small
            # allocator (no mmap page churn). Identical operand values
            # and association order as the gathered form, so survivor
            # sets are bit-identical.
            gh = len(range(0, oh, step))
            gw = len(range(0, ow, step))
            phases = [[np.ascontiguousarray(ii[py::step, px::step])
                       for px in range(step)] for py in range(step)]

            vs = (ii[1+nh_:1+nh_+oh:step, 1+nw_:1+nw_+ow:step]
                  - ii[1:1+oh:step, 1+nw_:1+nw_+ow:step]
                  - ii[1+nh_:1+nh_+oh:step, 1:1+ow:step]
                  + ii[1:1+oh:step, 1:1+ow:step]).astype(np.float64)
            vq = (sq[1+nh_:1+nh_+oh:step, 1+nw_:1+nw_+ow:step]
                  - sq[1:1+oh:step, 1+nw_:1+nw_+ow:step]
                  - sq[1+nh_:1+nh_+oh:step, 1:1+ow:step]
                  + sq[1:1+oh:step, 1:1+ow:step])
            nf2 = vq * area - vs * vs
            nf = np.sqrt(np.maximum(nf2, 0.0))
            alive2d = nf2 > 0

            def corner(dy, dx, r0, r1):
                return phases[dy % step][dx % step][
                    dy // step + r0:dy // step + r1,
                    dx // step:dx // step + gw]

            dense_stages = list(zip(casc.stage_slices,
                                    casc.stage_thresholds))[:_DENSE_STAGES]
            tr = max(1, _DENSE_TILE // max(gw, 1))  # rows per cache tile
            for r0 in range(0, gh, tr):
                r1 = min(r0 + tr, gh)
                alive_t = alive2d[r0:r1]
                nf_t = nf[r0:r1]
                for (s0, s1), sthr in dense_stages:
                    if not alive_t.any():
                        break
                    ssum = np.zeros((r1 - r0, gw))
                    for wci in range(s0, s1):
                        fi = int(casc.feat_idx[wci])
                        val = None
                        for (rx, ry, rw, rh, wt) in R[fi]:
                            if wt == 0.0:
                                continue
                            rx, ry, rw, rh = int(rx), int(ry), int(rw), int(rh)
                            rect = (corner(ry + rh, rx + rw, r0, r1)
                                    - corner(ry, rx + rw, r0, r1)
                                    - corner(ry + rh, rx, r0, r1)
                                    + corner(ry, rx, r0, r1))
                            # 0.0 + wt*rect == wt*rect: same accumulation
                            # as the gathered val-starts-at-zero form
                            v = wt * rect
                            val = v if val is None else val + v
                        ssum += np.where(val < casc.node_thr[wci] * nf_t,
                                         casc.leaves[wci, 0],
                                         casc.leaves[wci, 1])
                    alive_t &= ssum >= sthr

            # compact to survivors (C-order ravel == the old y-major,
            # then-x window order), finish phase 1 gathered
            iif = ii.ravel()
            keep = np.flatnonzero(alive2d.ravel())
            gw = alive2d.shape[1]
            oxk = (keep % gw).astype(np.int64) * step
            oyk = (keep // gw).astype(np.int64) * step
            base_k = oyk * stride + oxk
            strd_k = np.full(len(keep), stride, dtype=np.int64)
            nf_k = nf.ravel()[keep]
            surv = run_stages(iif, base_k, strd_k, nf_k,
                              _DENSE_STAGES, phase1)
            ii_parts.append(iif)
            if len(surv):
                alive_parts.append(base_k[surv] + offset)
                stride_parts.append(strd_k[surv])
                nf_parts.append(nf_k[surv])
                meta = np.empty((len(surv), 4), dtype=np.int64)
                meta[:, 0] = np.rint(oxk[surv] * factor)
                meta[:, 1] = np.rint(oyk[surv] * factor)
                meta[:, 2] = win_w
                meta[:, 3] = win_h
                meta_parts.append(meta)
            offset += ii.size

        if not alive_parts:
            continue
        iif = np.concatenate(ii_parts)
        alive = np.concatenate(alive_parts)
        strd = np.concatenate(stride_parts)
        nf_a = np.concatenate(nf_parts)
        meta = np.concatenate(meta_parts)

        surv = run_stages(iif, alive, strd, nf_a, phase1, n_stages)
        for x, y, w_, h_ in meta[surv]:
            results[img_idx].append((int(x), int(y), int(w_), int(h_)))
    return [_group_rectangles(cands, min_neighbors) for cands in results]


def detect_multi_scale(gray: np.ndarray, cascade_name: str,
                       scale_factor: float = 1.1, min_neighbors: int = 5,
                       min_size: Tuple[int, int] = (0, 0),
                       max_size: Tuple[int, int] | None = None,
                       ) -> List[Tuple[int, int, int, int]]:
    """cv2.CascadeClassifier(cascade).detectMultiScale equivalent.

    Returns a list of (x, y, w, h) like the reference call sites expect.
    The single-image form of detect_multi_scale_batch (one shared cascade
    pass over all pyramid levels).
    """
    return detect_multi_scale_batch([gray], cascade_name,
                                    scale_factor=scale_factor,
                                    min_neighbors=min_neighbors,
                                    min_size=min_size, max_size=max_size)[0]


def detect_eyes(gray: np.ndarray) -> List[Tuple[int, int, int, int]]:
    """FaceEnhancement.py:177-182 parameters."""
    return detect_multi_scale(gray, "haarcascade_eye.xml",
                              scale_factor=1.1, min_neighbors=5,
                              min_size=(30, 30))


def detect_faces(gray: np.ndarray) -> List[Tuple[int, int, int, int]]:
    """classification.py:52-57 / AI_classification.py:120-127 parameters."""
    return detect_multi_scale(gray, "haarcascade_frontalface_default.xml",
                              scale_factor=1.1, min_neighbors=5,
                              min_size=(40, 40))


def detect_faces_batch(grays) -> List[List[Tuple[int, int, int, int]]]:
    """Multi-image face detection in one cascade pass (classify/serving
    batch path — identical results to per-image detect_faces)."""
    return detect_multi_scale_batch(grays, "haarcascade_frontalface_default.xml",
                                    scale_factor=1.1, min_neighbors=5,
                                    min_size=(40, 40))


def detect_eyes_batch(grays) -> List[List[Tuple[int, int, int, int]]]:
    """Multi-image eye detection in one cascade pass (FaceEnhancement
    batch serving)."""
    return detect_multi_scale_batch(grays, "haarcascade_eye.xml",
                                    scale_factor=1.1, min_neighbors=5,
                                    min_size=(30, 30))
