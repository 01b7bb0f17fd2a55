"""Contour extraction and polygon ops (host-side numpy): the quad fit of
DocScanner's localize. A copy of ``tpuimage.detect.contours`` (the same
values: cv2.findContours RETR_EXTERNAL / contourArea / arcLength /
approxPolyDP / minAreaRect / boxPoints), carried in the port so that its
serving path imports nothing of the JAX package. The border following
uses the C++ tracer of ``tpuimage_torch.native`` when it builds, with the
numpy implementation below as the value-identical fallback; so does the
convex hull of ``min_area_rect``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from tpuimage_torch.runtime.profiling import count

# Moore neighborhood in OpenCV's clockwise order starting East
_DIRS = np.array([(0, 1), (-1, 1), (-1, 0), (-1, -1),
                  (0, -1), (1, -1), (1, 0), (1, 1)], dtype=np.int64)


def find_external_contours(binary: np.ndarray) -> List[np.ndarray]:
    """Outer border following (cv2.RETR_EXTERNAL semantics): returns a list
    of (N, 2) int arrays of (x, y) points, 8-connected borders of each
    connected component of nonzero pixels.

    Uses the C++ tracer (tpuimage_torch.native) when available — ~100x the pure
    Python loop on megapixel edge maps — with this numpy implementation as
    the value-identical fallback."""
    native = _find_external_contours_native(binary)
    if native is not None:
        return native
    img = (np.asarray(binary) != 0).astype(np.int8)
    h, w = img.shape
    padded = np.zeros((h + 2, w + 2), dtype=np.int8)
    padded[1:-1, 1:-1] = img
    visited = np.zeros_like(padded, dtype=bool)
    contours: List[np.ndarray] = []

    # border start: pixel is 1 and pixel to the left is 0, and not already
    # part of a traced outer border
    for y in range(1, h + 1):
        row = padded[y]
        xs = np.nonzero((row[1:-1] == 1) & (row[0:-2] == 0))[0] + 1
        for x in xs:
            if visited[y, x]:
                continue
            contour = _trace_border(padded, visited, y, x)
            contours.append(contour)
    return contours


def _find_external_contours_native(binary: np.ndarray):
    """ctypes path into native/contours.cpp; None if unavailable."""
    import ctypes
    from tpuimage_torch.native import load_native
    lib = load_native()
    if lib is None:
        return None
    img = np.ascontiguousarray((np.asarray(binary) != 0).astype(np.uint8))
    h, w = img.shape
    max_points = int(img.size) + 16
    max_contours = max_points // 2 + 1
    pts = np.empty(2 * max_points, dtype=np.int64)
    offs = np.empty(max_contours + 1, dtype=np.int64)
    n = lib.tpuimage_trace_contours(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_points,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_contours)
    if n < 0:
        return None
    xy = pts[:2 * int(offs[n])].reshape(-1, 2)
    return [xy[offs[i]:offs[i + 1]].copy() for i in range(int(n))]


def _trace_border(padded: np.ndarray, visited: np.ndarray,
                  y0: int, x0: int) -> np.ndarray:
    """Moore-neighbour tracing from (y0, x0), entering from the West."""
    pts = []
    # find first nonzero neighbor searching clockwise from West(dir 4)+1
    b = (y0, x0)
    visited[y0, x0] = True
    prev_dir = 4  # came from the west
    start = b
    first_next = None
    cur = b
    while True:
        pts.append((cur[1] - 1, cur[0] - 1))  # store as (x, y), unpad
        found = False
        # search neighbors clockwise starting just after the backtrack dir
        for k in range(1, 9):
            d = (prev_dir + k) % 8
            ny, nx = cur[0] + _DIRS[d][0], cur[1] + _DIRS[d][1]
            if padded[ny, nx]:
                visited[ny, nx] = True
                nxt = (ny, nx)
                prev_dir = (d + 4) % 8  # backtrack direction
                found = True
                break
        if not found:
            break  # isolated pixel
        if cur == start and first_next is None:
            first_next = nxt
        elif cur == start and nxt == first_next:
            break  # closed the loop
        cur = nxt
        if len(pts) > padded.size:
            break  # safety
    return np.asarray(pts, dtype=np.int64)


def contour_area(contour: np.ndarray) -> float:
    """cv2.contourArea: |shoelace|/2 over the closed polygon."""
    pts = np.asarray(contour, dtype=np.float64).reshape(-1, 2)
    x, y = pts[:, 0], pts[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2.0)


def contour_areas(contour_list) -> np.ndarray:
    """Vectorized contour_area over a list: one concatenated shoelace pass
    with np.add.reduceat instead of a Python loop (the docscan localize
    area filter walks 1000+ tiny contours per page; 41 -> ~1 ms/image).
    Identical values to per-contour contour_area (f64 sums of integer
    coordinate products are exact below 2^53)."""
    if not contour_list:
        return np.zeros(0, np.float64)
    lens = np.asarray([len(np.asarray(c).reshape(-1, 2))
                       for c in contour_list], np.int64)
    pts = np.concatenate([np.asarray(c, np.float64).reshape(-1, 2)
                          for c in contour_list])
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    nxt = np.arange(len(pts)) + 1
    nxt[starts + lens - 1] = starts                     # wrap within contour
    x, y = pts[:, 0], pts[:, 1]
    term = x * y[nxt] - y * x[nxt]
    return np.abs(np.add.reduceat(term, starts)) / 2.0


def arc_length(contour: np.ndarray, closed: bool = True) -> float:
    """cv2.arcLength."""
    pts = np.asarray(contour, dtype=np.float64).reshape(-1, 2)
    d = np.diff(np.vstack([pts, pts[:1]]) if closed else pts, axis=0)
    return float(np.sqrt((d ** 2).sum(axis=1)).sum())


def approx_poly_dp(contour: np.ndarray, epsilon: float,
                   closed: bool = True) -> np.ndarray:
    """cv2.approxPolyDP reconstruction (closed-curve variant).

    Reverse-engineered against cv2 5.0 as oracle (no source consulted):
    1. Seeding: three farthest-point iterations with a cyclic scan from
       the accumulated position; the final position is the output start
       vertex and the final relative offset marks the second seed.
    2. Stack DP over the two wrapped slices, comparing unnormalized
       cross^2 <= eps^2 * |chord|^2 (a zero-length chord therefore never
       splits — cv2's behavior on backtracking spur contours).
    3. A single cleanup pass over the result: midpoint m between kept
       neighbor a and next point b is dropped when
       cross(m-a, b-a)^2 <= 0.5 * eps^2 * |b-a|^2 and the projection of
       m lies inside chord a-b (0 <= (m-a).(b-m) <= |b-a|^2).

    Validated on 723 real-image contours (Otsu shapes of the committed
    reference images, eps = 0.02*arcLength): 713/723 byte-identical to
    cv2.approxPolyDP; the 10 residuals are single-vertex tie-break
    differences on noisy spur blobs (identical vertex counts; convex
    document quads — the DocScanner/classifier consumers — are all
    exact). See tests/test_docscan.py::TestApproxPolyDP.
    """
    pts = np.asarray(contour).reshape(-1, 2)
    if not np.issubdtype(pts.dtype, np.floating):
        pts = pts.astype(np.int64)
    n = len(pts)
    if n <= 2:
        return pts

    if not closed:
        eps2 = float(epsilon) * float(epsilon)
        keep = [0, n - 1]
        stack = [(0, n - 1)]
        while stack:
            a, b = stack.pop()
            if b - a <= 1:
                continue
            pa, pb = pts[a].astype(np.float64), pts[b].astype(np.float64)
            rel = pts[a + 1:b].astype(np.float64) - pa
            ab = pb - pa
            denom = ab[0] * ab[0] + ab[1] * ab[1]
            cross = ab[0] * rel[:, 1] - ab[1] * rel[:, 0]
            c2 = cross * cross
            k = int(np.argmax(c2))
            if c2[k] > eps2 * denom:
                mid = a + 1 + k
                keep.append(mid)
                stack.append((mid, b))
                stack.append((a, mid))
        return pts[sorted(set(keep))]

    eps2 = float(epsilon) * float(epsilon)

    # --- phase 1: seeding ---
    pos = 0
    rs = 0
    max_dist = 0.0
    for _ in range(3):
        pos = (pos + rs) % n
        order = (pos + np.arange(1, n)) % n
        d = ((pts[order] - pts[pos]) ** 2).sum(axis=1).astype(np.float64)
        j = int(np.argmax(d))        # first max in cyclic scan order
        max_dist = float(d[j])
        rs = j + 1
    if max_dist <= eps2:
        return pts[pos:pos + 1]

    # --- phase 2: stack DP over wrapped slices ---
    split = pos + rs
    stack = [(split, pos + n), (pos, split)]
    kept = []
    while stack:
        a, b = stack.pop()
        if b - a <= 1:
            kept.append(a)
            continue
        pa = pts[a % n].astype(np.float64)
        pb = pts[b % n].astype(np.float64)
        idx = np.arange(a + 1, b) % n
        rel = pts[idx].astype(np.float64) - pa
        ab = pb - pa
        denom = ab[0] * ab[0] + ab[1] * ab[1]
        cross = ab[0] * rel[:, 1] - ab[1] * rel[:, 0]
        c2 = cross * cross
        k = int(np.argmax(c2))
        if c2[k] <= eps2 * denom:
            kept.append(a)
        else:
            mid = a + 1 + k
            stack.append((mid, b))
            stack.append((a, mid))
    kept.sort()
    out = pts[[i % n for i in kept]]

    # --- phase 3: cleanup pass ---
    res = list(range(len(out)))
    i = 0
    while len(res) > 2 and i < len(res):
        a = out[res[(i - 1) % len(res)]].astype(np.float64)
        m = out[res[i]].astype(np.float64)
        b = out[res[(i + 1) % len(res)]].astype(np.float64)
        ab = b - a
        rel = m - a
        cross = rel[0] * ab[1] - rel[1] * ab[0]
        d2 = ab[0] * ab[0] + ab[1] * ab[1]
        sip = rel[0] * (b[0] - m[0]) + rel[1] * (b[1] - m[1])
        if d2 and cross * cross <= 0.5 * eps2 * d2 and d2 >= sip >= 0:
            res.pop(i)
        else:
            i += 1
    return out[res]


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain; returns hull points CCW (y-down image coords).

    Uses the C++ hull (tpuimage_torch.native) when available, counted as
    ``contours.hull_native``: byte-equal to this numpy body, which stays
    the fallback and takes non-finite coordinates and negative zeros; on
    integer contours it first drops the points strictly inside the four
    extreme points' quadrilateral (of a frame border's ~180k points,
    5-7k remain to sort)."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    native = _convex_hull_native(pts)
    if native is not None:
        return native
    pts = np.unique(pts, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(pp):
        out = []
        for p in pp:
            while len(out) >= 2:
                u = out[-1] - out[-2]
                v = p - out[-2]
                if u[0] * v[1] - u[1] * v[0] > 0:
                    break
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def _convex_hull_native(pts: np.ndarray):
    """ctypes path into native/contours.cpp; None if unavailable or the
    input is one the numpy body takes."""
    import ctypes
    from tpuimage_torch.native import load_native
    lib = load_native()
    if lib is None or not len(pts):
        return None
    pts = np.ascontiguousarray(pts)
    out = np.empty((2 * len(pts), 2), dtype=np.float64)
    f64p = ctypes.POINTER(ctypes.c_double)
    k = lib.tpuimage_hull(pts.ctypes.data_as(f64p), len(pts), out.ctypes.data_as(f64p))
    if k < 0:
        return None
    count("contours.hull_native")
    return out[:k].copy()


def min_area_rect(points: np.ndarray) -> Tuple[Tuple[float, float], Tuple[float, float], float]:
    """cv2.minAreaRect via rotating calipers over the convex hull:
    returns ((cx, cy), (w, h), angle_deg)."""
    hull = convex_hull(points)
    n = len(hull)
    if n == 1:
        return (tuple(hull[0]), (0.0, 0.0), 0.0)
    if n == 2:
        c = hull.mean(axis=0)
        d = hull[1] - hull[0]
        return ((float(c[0]), float(c[1])), (float(np.hypot(*d)), 0.0),
                float(np.degrees(np.arctan2(d[1], d[0]))))
    best = None
    for i in range(n):
        e = hull[(i + 1) % n] - hull[i]
        L = np.hypot(*e)
        if L == 0:
            continue
        ux = e / L
        uy = np.array([-ux[1], ux[0]])
        proj_x = (hull - hull[i]) @ ux
        proj_y = (hull - hull[i]) @ uy
        w = proj_x.max() - proj_x.min()
        h = proj_y.max() - proj_y.min()
        area = w * h
        if best is None or area < best[0]:
            cx = hull[i] + ux * (proj_x.max() + proj_x.min()) / 2 + uy * (proj_y.max() + proj_y.min()) / 2
            ang = np.degrees(np.arctan2(ux[1], ux[0]))
            best = (area, (float(cx[0]), float(cx[1])), (float(w), float(h)), float(ang))
    return best[1], best[2], best[3]


def box_points(rect) -> np.ndarray:
    """cv2.boxPoints: 4 corners of a rotated rect."""
    (cx, cy), (w, h), ang = rect
    a = np.deg2rad(ang)
    ux = np.array([np.cos(a), np.sin(a)])
    uy = np.array([-np.sin(a), np.cos(a)])
    c = np.array([cx, cy])
    hw, hh = w / 2.0, h / 2.0
    return np.asarray([c - ux * hw - uy * hh, c + ux * hw - uy * hh,
                       c + ux * hw + uy * hh, c - ux * hw + uy * hh],
                      dtype=np.float32)
