// Native host-side sequential algorithms of DocScanner's quad fit, for
// tpuimage_torch: a copy of tpuimage/native/contours.cpp (outer-border
// following over binary edge maps, the cv2.findContours replacement, and
// the thick-segment rasterizer), and the convex hull of the min-area-rect
// fallback. Exposed with a plain C ABI, built with
// g++ at first use and loaded via ctypes (tpuimage_torch.native);
// detect/contours.py and ops/draw.py keep value-identical numpy fallbacks.
//
// Algorithm: Moore-neighbour tracing of the outer border of each
// 8-connected component, scanning rows for unvisited left-edge starts —
// the same traversal as the Python reference implementation in
// detect/contours.py (kept value-identical; see test_native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// clockwise from East, matching detect/contours.py _DIRS
const int DY[8] = {0, -1, -1, -1, 0, 1, 1, 1};
const int DX[8] = {1, 1, 0, -1, -1, -1, 0, 1};

}  // namespace

extern "C" {

// Trace all outer borders of nonzero pixels in img (h*w, row-major).
// Outputs:
//   out_points  : int64 buffer of capacity 2*max_points, filled with x,y pairs
//   out_offsets : int64 buffer of capacity max_contours+1; contour i spans
//                 points [out_offsets[i], out_offsets[i+1])
// Returns the number of contours written (clipped at max_contours), or -1 if
// the point buffer overflowed.
int64_t tpuimage_trace_contours(const uint8_t* img, int64_t h, int64_t w,
                                int64_t* out_points, int64_t max_points,
                                int64_t* out_offsets, int64_t max_contours) {
    const int64_t W = w + 2;
    const int64_t H = h + 2;
    std::vector<uint8_t> padded(static_cast<size_t>(W) * H, 0);
    std::vector<uint8_t> visited(static_cast<size_t>(W) * H, 0);
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* src = img + y * w;
        uint8_t* dst = padded.data() + (y + 1) * W + 1;
        for (int64_t x = 0; x < w; ++x) dst[x] = src[x] ? 1 : 0;
    }

    int64_t n_contours = 0;
    int64_t n_points = 0;
    out_offsets[0] = 0;

    for (int64_t y = 1; y <= h; ++y) {
        const uint8_t* row = padded.data() + y * W;
        for (int64_t x = 1; x <= w; ++x) {
            if (!(row[x] == 1 && row[x - 1] == 0)) continue;
            if (visited[y * W + x]) continue;
            if (n_contours >= max_contours) return n_contours;

            // Moore trace from (y, x), entering from the West
            int64_t cy = y, cx = x;
            visited[cy * W + cx] = 1;
            int prev_dir = 4;
            const int64_t sy = cy, sx = cx;
            int64_t fny = -1, fnx = -1;  // first next after start
            bool have_first = false;

            while (true) {
                if (n_points >= max_points) return -1;
                out_points[2 * n_points] = cx - 1;
                out_points[2 * n_points + 1] = cy - 1;
                ++n_points;

                bool found = false;
                int64_t ny = 0, nx = 0;
                for (int k = 1; k <= 8; ++k) {
                    const int d = (prev_dir + k) & 7;
                    ny = cy + DY[d];
                    nx = cx + DX[d];
                    if (padded[ny * W + nx]) {
                        visited[ny * W + nx] = 1;
                        prev_dir = (d + 4) & 7;
                        found = true;
                        break;
                    }
                }
                if (!found) break;  // isolated pixel
                if (cy == sy && cx == sx && !have_first) {
                    fny = ny; fnx = nx; have_first = true;
                } else if (cy == sy && cx == sx && ny == fny && nx == fnx) {
                    break;  // closed the loop
                }
                cy = ny; cx = nx;
                if (n_points > static_cast<int64_t>(padded.size())) break;
            }
            out_offsets[++n_contours] = n_points;
        }
    }
    return n_contours;
}

}  // extern "C"

extern "C" {

// Rasterize thick segments: for each (x1,y1,x2,y2) in segs (n x 4,
// float64), set out[y*w+x] = 255 for every pixel whose center lies within
// distance r of the segment — the SAME f64 point-to-segment predicate as
// tpuimage.ops.draw.draw_segments's numpy form (value-identical; see
// test_native.py), but scanning only a tight per-row window around the
// capsule instead of the whole bounding box (~50x fewer predicate
// evaluations for long diagonal segments).
void tpuimage_draw_segments(const double* segs, int64_t n,
                            uint8_t* out, int64_t h, int64_t w, double r) {
  const double r2 = r * r;
  for (int64_t s = 0; s < n; ++s) {
    const double x1 = segs[4 * s], y1 = segs[4 * s + 1];
    const double x2 = segs[4 * s + 2], y2 = segs[4 * s + 3];
    const double dx = x2 - x1, dy = y2 - y1;
    const double L2 = dx * dx + dy * dy;
    int64_t lo_y = (int64_t)std::floor(std::min(y1, y2) - r - 1);
    int64_t hi_y = (int64_t)std::ceil(std::max(y1, y2) + r + 1);
    if (lo_y < 0) lo_y = 0;
    if (hi_y > h - 1) hi_y = h - 1;
    for (int64_t y = lo_y; y <= hi_y; ++y) {
      // conservative t-range whose segment points have |y_pt - y| <= r
      double t1 = 0.0, t2 = 1.0;
      if (dy > 1e-12 || dy < -1e-12) {
        double ta = (y - r - y1) / dy, tb = (y + r - y1) / dy;
        t1 = std::max(0.0, std::min(ta, tb));
        t2 = std::min(1.0, std::max(ta, tb));
        if (t1 > t2) continue;
      }
      const double xa = x1 + t1 * dx, xb = x1 + t2 * dx;
      int64_t lo_x = (int64_t)std::floor(std::min(xa, xb) - r - 1);
      int64_t hi_x = (int64_t)std::ceil(std::max(xa, xb) + r + 1);
      if (lo_x < 0) lo_x = 0;
      if (hi_x > w - 1) hi_x = w - 1;
      uint8_t* row = out + y * w;
      for (int64_t x = lo_x; x <= hi_x; ++x) {
        double d2;
        if (L2 == 0.0) {
          const double ex = x - x1, ey = y - y1;
          d2 = ex * ex + ey * ey;
        } else {
          double t = ((x - x1) * dx + (y - y1) * dy) / L2;
          t = t < 0.0 ? 0.0 : (t > 1.0 ? 1.0 : t);
          const double ex = x - (x1 + t * dx), ey = y - (y1 + t * dy);
          d2 = ex * ex + ey * ey;
        }
        if (d2 <= r2) row[x] = 255;
      }
    }
  }
}

}  // extern "C"

namespace {

struct Pt { double x, y; };

// Below this magnitude on integer-valued coordinates every difference is an
// integer under 2^26, every product of two differences under 2^52, so each
// cross product's sign (the prefilter's and the chain's) is exact.
const double kExactBelow = 33554432.0;  // 2^25

// u0*v1 - u1*v0 with u = a - o, v = p - o: the numpy chain's form and order
inline double cross(const Pt& o, const Pt& a, const Pt& p) {
    const double u0 = a.x - o.x, u1 = a.y - o.y;
    const double v0 = p.x - o.x, v1 = p.y - o.y;
    return u0 * v1 - u1 * v0;
}

}  // namespace

extern "C" {

// Convex hull of n (x, y) points (float64, row-major), byte-equal to the
// numpy convex_hull of detect/contours.py: the points sorted by x, then y,
// without duplicates (np.unique(axis=0)); two or fewer returned as they are;
// else Andrew's monotone chain popping on cross <= 0, lower chain then upper,
// each without its last point. Writes the hull's rows to out (capacity 2*n
// rows) and returns their number, or -1 where a coordinate is non-finite or a
// negative zero (the numpy body takes those).
//
// Where every coordinate is an integer below 2^25 in magnitude, the points
// strictly inside the quadrilateral of the four extreme points (least and
// greatest x + y and x - y; Akl-Toussaint) are dropped before the sort: none
// is a hull vertex, and with exact signs the chain's output depends only on
// the vertices. A contour's interior thus costs one pass, not a sort.
int64_t tpuimage_hull(const double* pts, int64_t n, double* out) {
    bool exact = true;
    int64_t ia = 0, ib = 0, ic = 0, id = 0;  // min s, max d, max s, min d
    double smin = 0, smax = 0, dmin = 0, dmax = 0;
    for (int64_t i = 0; i < n; ++i) {
        const double x = pts[2 * i], y = pts[2 * i + 1];
        if (!std::isfinite(x) || !std::isfinite(y)) return -1;
        if ((x == 0.0 && std::signbit(x)) || (y == 0.0 && std::signbit(y))) return -1;
        if (!(std::fabs(x) < kExactBelow && std::fabs(y) < kExactBelow
              && x == std::floor(x) && y == std::floor(y))) exact = false;
        const double s = x + y, d = x - y;
        if (i == 0) { smin = smax = s; dmin = dmax = d; continue; }
        if (s < smin) { smin = s; ia = i; }
        if (s > smax) { smax = s; ic = i; }
        if (d > dmax) { dmax = d; ib = i; }
        if (d < dmin) { dmin = d; id = i; }
    }
    std::vector<Pt> v;
    if (exact && n > 4) {
        const Pt a{pts[2 * ia], pts[2 * ia + 1]}, b{pts[2 * ib], pts[2 * ib + 1]};
        const Pt c{pts[2 * ic], pts[2 * ic + 1]}, d{pts[2 * id], pts[2 * id + 1]};
        for (int64_t i = 0; i < n; ++i) {
            const Pt p{pts[2 * i], pts[2 * i + 1]};
            // a, b, c, d turn counter-clockwise for x right, y up: inside
            // strictly is positive against all four edges
            if (cross(a, b, p) > 0 && cross(b, c, p) > 0
                && cross(c, d, p) > 0 && cross(d, a, p) > 0) continue;
            v.push_back(p);
        }
    } else {
        v.resize(static_cast<size_t>(n));
        std::memcpy(v.data(), pts, sizeof(double) * 2 * static_cast<size_t>(n));
    }
    std::sort(v.begin(), v.end(), [](const Pt& p, const Pt& q) {
        return p.x < q.x || (p.x == q.x && p.y < q.y);
    });
    v.erase(std::unique(v.begin(), v.end(), [](const Pt& p, const Pt& q) {
        return p.x == q.x && p.y == q.y;
    }), v.end());
    const int64_t m = static_cast<int64_t>(v.size());
    int64_t k = 0;
    auto emit = [&](const Pt& p) { out[2 * k] = p.x; out[2 * k + 1] = p.y; ++k; };
    if (m <= 2) {
        for (const Pt& p : v) emit(p);
        return k;
    }
    std::vector<Pt> h;
    h.reserve(static_cast<size_t>(m));
    auto push = [&](const Pt& p) {
        while (h.size() >= 2 && !(cross(h[h.size() - 2], h.back(), p) > 0)) h.pop_back();
        h.push_back(p);
    };
    for (int64_t i = 0; i < m; ++i) push(v[i]);
    for (size_t i = 0; i + 1 < h.size(); ++i) emit(h[i]);
    h.clear();
    for (int64_t i = m - 1; i >= 0; --i) push(v[i]);
    for (size_t i = 0; i + 1 < h.size(); ++i) emit(h[i]);
    return k;
}

}  // extern "C"
