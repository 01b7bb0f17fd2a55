// Native host-side sequential algorithms of DocScanner's quad fit, for
// tpuimage_torch: a copy of tpuimage/native/contours.cpp (outer-border
// following over binary edge maps, the cv2.findContours replacement, and
// the thick-segment rasterizer). Exposed with a plain C ABI, built with
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
