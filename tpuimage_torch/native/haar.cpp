// Haar cascade level evaluator (Viola-Jones, stump stages), for
// tpuimage_torch: a copy of tpuimage/native/haar.cpp, built into the port's
// host library beside contours.cpp (tpuimage_torch.native) and called by
// detect/haar.py, which keeps a value-identical numpy evaluator.
//
// The numpy evaluator is vectorized but cannot express OpenCV's real win:
// PER-WINDOW early exit — a rejected window stops paying after its failing
// stage, so the average window costs ~15-30 feature evaluations instead of
// the dense form's every-feature-everywhere.
//
// Bit-parity contract with the numpy path (tests/test_torch_haar.py holds
// both against each other and against tpuimage's detector):
//   * integral sums are exact integers (int32 window sums, f64 squares);
//   * every float op is the same IEEE double op in the same order as the
//     numpy expression (no -ffast-math, no FMA contraction):
//     val += (double)wt * rect;  val < node_thr * nf;
//     ssum += leaf (leaf chosen as float, added as double);
//   * window order is y-major then x, matching the raveled grid order.
//
// One call per pyramid level; the caller passes reusable integral
// scratch buffers.

#include <cstdint>
#include <cmath>
#include <vector>

#ifdef __AVX2__
#include <immintrin.h>
#endif

namespace {

// per-level precomputed rect: the four integral-image corner offsets
// relative to the window origin, plus the weight — removes all index
// arithmetic from the per-window loop (the table is ~140 KB, L2-resident)
struct RectOfs {
    int64_t o00, o01, o10, o11;
    float wt;
};

}  // namespace

extern "C" int64_t tpuimage_haar_level(
    const uint8_t* img, int64_t sh, int64_t sw,
    int64_t win_h, int64_t win_w, int64_t step,
    const int32_t* feat_rects,   // F*3*4  (x, y, w, h) per rect
    const float* feat_wts,       // F*3    weight per rect (0 = unused)
    const int32_t* feat_idx,     // W      feature index per weak classifier
    const float* node_thr,       // W
    const float* leaves,         // W*2    (left, right)
    const float* stage_thr,      // S
    const int32_t* stage_bounds, // S+1    cumulative weak-classifier bounds
    int64_t n_stages,
    int32_t* scratch_ii,         // (sh+1)*(sw+1) caller-reused
    double* scratch_sq,          // (sh+1)*(sw+1) caller-reused
    int32_t* out_xy,             // capacity*2 surviving origins (x, y)
    int64_t cap)
{
    const int64_t stride = sw + 1;
    int32_t* ii = scratch_ii;
    double* sq = scratch_sq;

    // integral images, zero top row / left column
    for (int64_t x = 0; x < stride; ++x) { ii[x] = 0; sq[x] = 0.0; }
    for (int64_t y = 1; y <= sh; ++y) {
        ii[y * stride] = 0;
        sq[y * stride] = 0.0;
        int64_t row = 0;
        double rowsq = 0.0;
        const uint8_t* src = img + (y - 1) * sw;
        for (int64_t x = 1; x <= sw; ++x) {
            const double v = (double)src[x - 1];
            row += src[x - 1];
            rowsq += v * v;
            ii[y * stride + x] = ii[(y - 1) * stride + x] + (int32_t)row;
            sq[y * stride + x] = sq[(y - 1) * stride + x] + rowsq;
        }
    }

    const int64_t oh = sh - win_h + 1, ow = sw - win_w + 1;
    const int64_t nw = win_w - 2, nh = win_h - 2;
    const double area = (double)(nw * nh);

    // per-weak-classifier rect table in cascade evaluation order, with
    // corner offsets baked for this level's stride
    const int64_t n_wc = stage_bounds[n_stages];
    std::vector<RectOfs> tab((size_t)n_wc * 3);
    std::vector<uint8_t> nrect((size_t)n_wc);
    for (int64_t wc = 0; wc < n_wc; ++wc) {
        const int32_t fi = feat_idx[wc];
        const int32_t* rr = feat_rects + (int64_t)fi * 12;
        const float* ww = feat_wts + (int64_t)fi * 3;
        int nr = 0;
        for (int r = 0; r < 3; ++r) {
            if (ww[r] == 0.0f)
                continue;
            const int64_t x = rr[r * 4], y = rr[r * 4 + 1];
            const int64_t w = rr[r * 4 + 2], h = rr[r * 4 + 3];
            RectOfs& t = tab[(size_t)(wc * 3 + nr)];
            t.o00 = y * stride + x;
            t.o01 = t.o00 + w;
            t.o10 = t.o00 + h * stride;
            t.o11 = t.o10 + w;
            t.wt = ww[r];
            ++nr;
        }
        nrect[(size_t)wc] = (uint8_t)nr;
    }
    const int64_t vo00 = stride + 1, vo01 = vo00 + nw;
    const int64_t vo10 = vo00 + nh * stride, vo11 = vo10 + nw;

    const uint8_t* nr = nrect.data();
    const float* lv = leaves;
    const float* nt = node_thr;

    // scalar single-window evaluation (tail windows + non-AVX2 builds)
    auto eval_one = [&](int64_t o) -> bool {
        const double vs = (double)((int64_t)ii[o + vo11] - ii[o + vo01]
                                   - ii[o + vo10] + ii[o + vo00]);
        const double vq = sq[o + vo11] - sq[o + vo01]
                        - sq[o + vo10] + sq[o + vo00];
        const double nf2 = vq * area - vs * vs;
        if (!(nf2 > 0.0))
            return false;
        const double nf = std::sqrt(nf2);
        for (int64_t s = 0; s < n_stages; ++s) {
            double ssum = 0.0;
            const int32_t w1 = stage_bounds[s + 1];
            for (int32_t wc = stage_bounds[s]; wc < w1; ++wc) {
                const RectOfs* t = tab.data() + (int64_t)wc * 3;
                const int n = nr[wc];
                double val = 0.0;
                for (int r = 0; r < n; ++r) {
                    const RectOfs& q = t[r];
                    const int32_t rs = ii[o + q.o11] - ii[o + q.o01]
                                     - ii[o + q.o10] + ii[o + q.o00];
                    val += (double)q.wt * (double)rs;
                }
                const float leaf = (val < (double)nt[wc] * nf)
                                       ? lv[wc * 2] : lv[wc * 2 + 1];
                ssum += (double)leaf;
            }
            if (!(ssum >= (double)stage_thr[s]))
                return false;
        }
        return true;
    };

    int64_t count = 0;
    auto emit = [&](int64_t ox, int64_t oy) -> bool {
        if (count >= cap)
            return false;
        out_xy[count * 2] = (int32_t)ox;
        out_xy[count * 2 + 1] = (int32_t)oy;
        ++count;
        return true;
    };

    for (int64_t oy = 0; oy < oh; oy += step) {
        const int64_t orow = oy * stride;
        int64_t ox = 0;
#ifdef __AVX2__
        // 4 adjacent windows per iteration: SIMD double lanes are IEEE
        // per-lane, so every lane computes the identical scalar result.
        // The early stages (where >40% of windows are alive and lanes are
        // rarely all-dead) vectorize ~4x; later stages pay for dead lanes
        // but carry little weight. Lanes dead from the start (nf2 <= 0)
        // produce NaN nf, whose ordered compares select the right leaf
        // arbitrarily — they are masked out of `alive` and never emitted.
        for (; ox + 3 * step < ow; ox += 4 * step) {
            const int64_t o = orow + ox;
            const __m128i lane_ofs = _mm_setr_epi32(
                0, (int)step, (int)(2 * step), (int)(3 * step));
            auto gather_i = [&](int64_t off) {
                const __m128i vi = _mm_add_epi32(
                    _mm_set1_epi32((int)(o + off)), lane_ofs);
                return _mm_i32gather_epi32(ii, vi, 4);
            };
            auto gather_d = [&](int64_t off) {
                const __m128i vi = _mm_add_epi32(
                    _mm_set1_epi32((int)(o + off)), lane_ofs);
                return _mm256_i32gather_pd(sq, vi, 8);
            };
            // variance normalization, 4 lanes
            const __m128i vsi = _mm_add_epi32(
                _mm_sub_epi32(_mm_sub_epi32(gather_i(vo11), gather_i(vo01)),
                              gather_i(vo10)),
                gather_i(vo00));
            const __m256d vs = _mm256_cvtepi32_pd(vsi);
            const __m256d vq = _mm256_add_pd(
                _mm256_sub_pd(_mm256_sub_pd(gather_d(vo11), gather_d(vo01)),
                              gather_d(vo10)),
                gather_d(vo00));
            const __m256d nf2 = _mm256_sub_pd(
                _mm256_mul_pd(vq, _mm256_set1_pd(area)),
                _mm256_mul_pd(vs, vs));
            __m256d alive = _mm256_cmp_pd(nf2, _mm256_setzero_pd(),
                                          _CMP_GT_OQ);
            if (!_mm256_movemask_pd(alive))
                continue;
            const __m256d nf = _mm256_sqrt_pd(nf2);

            for (int64_t s = 0; s < n_stages; ++s) {
                __m256d ssum = _mm256_setzero_pd();
                const int32_t w1 = stage_bounds[s + 1];
                for (int32_t wc = stage_bounds[s]; wc < w1; ++wc) {
                    const RectOfs* t = tab.data() + (int64_t)wc * 3;
                    const int n = nr[wc];
                    __m256d val = _mm256_setzero_pd();
                    for (int r = 0; r < n; ++r) {
                        const RectOfs& q = t[r];
                        const __m128i rsi = _mm_add_epi32(
                            _mm_sub_epi32(_mm_sub_epi32(gather_i(q.o11),
                                                        gather_i(q.o01)),
                                          gather_i(q.o10)),
                            gather_i(q.o00));
                        val = _mm256_add_pd(
                            val, _mm256_mul_pd(_mm256_set1_pd((double)q.wt),
                                               _mm256_cvtepi32_pd(rsi)));
                    }
                    const __m256d cm = _mm256_cmp_pd(
                        val,
                        _mm256_mul_pd(_mm256_set1_pd((double)nt[wc]), nf),
                        _CMP_LT_OQ);
                    const __m256d leaf = _mm256_blendv_pd(
                        _mm256_set1_pd((double)lv[wc * 2 + 1]),
                        _mm256_set1_pd((double)lv[wc * 2]), cm);
                    ssum = _mm256_add_pd(ssum, leaf);
                }
                alive = _mm256_and_pd(
                    alive,
                    _mm256_cmp_pd(ssum,
                                  _mm256_set1_pd((double)stage_thr[s]),
                                  _CMP_GE_OQ));
                if (!_mm256_movemask_pd(alive))
                    break;
            }
            const int m = _mm256_movemask_pd(alive);
            for (int k = 0; k < 4; ++k)
                if ((m >> k) & 1)
                    if (!emit(ox + k * step, oy))
                        return -(count + 1);
        }
#endif
        for (; ox < ow; ox += step)
            if (eval_one(orow + ox))
                if (!emit(ox, oy))
                    return -(count + 1);
    }
    return count;
}
