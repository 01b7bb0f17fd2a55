// DocScanner's ink-mask epilogue, on a batch of (B, H, W) u8 planes:
//
//   m0       = (sub > t_sub[b] || bh > t_bh[b]) ? 255 : 0   (f32 strict >)
//   ink_mask = iters 2x2 anchor-(1,1) dilations of m0 = the max of m0 over
//              [y - iters, y] x [x - iters, x], 0 outside the image
//   weighted = ink_mask == 0 ? 255 : adapt
//
// Replaces: tpuimage/ops/pallas_kernels.py inkmask_weighted_pallas (body
// _make_inkmask_kernel).
//
// The thresholds are one f32 per image on the device (the Otsu pullbacks),
// read by the kernel itself, so nothing goes back to the host between the
// histograms and this epilogue. All compares and integer maxima, so the
// kernel equals its plain version bit for bit.
//
// Bound on the H100: memory. Each pixel reads 3 bytes and writes 2; the
// work is two compares and at most (iters + 1)^2 maxima.
//
// Design, warp form (iters <= kMaxWarpIters, the TPU kernel's own limit):
// the masks are 0/255 bytes, so every maximum is an OR of words of four
// pixels. A warp owns a run of 32 x kWords words of one image's column
// grid (byte_rows.cuh: rows at any alignment read as aligned words and
// funnel-shifted; outputs written as aligned words) and walks down a strip
// of kStripRows rows, iters rows of halo above; a persistent grid of warps
// strides over (image, strip, run). Per row: m0 = two byte compares with k
// = the least byte above each threshold (least_above), the vertical
// dilation an OR with the last iters rows' m0 (a register ring), the
// horizontal one an OR of the words shifted by 1..iters bytes (the bytes
// from the left by shuffle: the run's first kInkHalo lanes are halo and
// store nothing), weighted = adapt | ~mask. When all five planes share one
// alignment (any allocation of torch's, at any width), the compares and
// the weighting work in each row's own aligned words and only m0 and the
// mask are shifted between the grids: 3 shuffles a row instead of 6. No
// shared memory, no barrier; each lane has the next kGroup rows' loads in
// flight while it works on the current ones. On the card the kernel runs
// at ~60-70% of the bound: with the loads taken away it is hardly faster,
// so what is left is the instructions a row costs (PERF.md).
// Split form (more iterations): one launch takes m0's maximum along each
// row's window into a (B, H, W) byte plane of device scratch that the
// caller provides, a second the maximum down the columns and the weighting.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "byte_rows.cuh"
#include "sm_count.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStripRows = 16;
constexpr int kGroup = 2;          // rows whose loads a lane issues together
constexpr int kWords = 2;          // words a lane holds in a row
constexpr int kBlocksPerSm = 16;
constexpr int kMaxWarpIters = 8;

__device__ __forceinline__ bool ink(const uint8_t* sub, const uint8_t* bh, long long off,
                                    float ts, float tb) {
  return (float)sub[off] > ts || (float)bh[off] > tb;
}

// The lanes left of a run, kInkHalo: their 4 kWords kInkHalo columns hold
// the ITERS columns the dilation reaches left and the 3 that a store's
// first word may start before the run.
template <int ITERS>
constexpr int kInkHalo = (ITERS + 3 + 4 * kWords - 1) / (4 * kWords);

// One warp's strip: output rows [y0, y_end) of one image (the pointers at
// its row 0) for the run whose lane 0 holds column cx0; EDGE unless the run
// lies inside the rows (run_inside); AL the planes' Alignment (kAnyAlign or
// kCoAligned: then the compares and the weighting work in each row's own
// aligned words, and only m0 and the mask cross between the grids). Rows go
// in groups of kGroup, each group's loads issued before the group before it
// is worked on.
template <int ITERS, bool EDGE, int AL>
__device__ __forceinline__ void ink_strip(const uint8_t* sub, const uint8_t* bh,
                                          const uint8_t* adapt, uint8_t* mask,
                                          uint8_t* weighted, const ByteThreshold& ts,
                                          const ByteThreshold& tb, int w, int cx0, int y0,
                                          int y_end, int lane) {
  constexpr int N = kWords, kHalo = kInkHalo<ITERS>;
  uint32_t valid[N];
#pragma unroll
  for (int j = 0; j < N; ++j) valid[j] = EDGE ? columns_in(cx0 + 4 * (N * lane + j), w) : kAllLanes;
  uint32_t ring[ITERS > 0 ? ITERS : 1][N];   // m0 of the last ITERS rows
#pragma unroll
  for (int i = 0; i < (ITERS > 0 ? ITERS : 1); ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) ring[i][j] = 0;
  }
  const int r_begin = max(y0 - ITERS, 0);
  uint32_t cs[kGroup][N], cb[kGroup][N], ca[kGroup][N];   // the words of the group worked on
  uint32_t ns[kGroup][N], nb[kGroup][N], na[kGroup][N];   // and of the next one
  auto load_group = [&](int r0, uint32_t (&s)[kGroup][N], uint32_t (&b)[kGroup][N],
                        uint32_t (&a)[kGroup][N]) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int r = r0 + i;
      const long long o = (long long)r * w;
#pragma unroll
      for (int j = 0; j < N; ++j) s[i][j] = b[i][j] = a[i][j] = 0u;
      if (r < y_end) {
        load_words<N, EDGE>(s[i], sub + o, w, cx0, lane);
        load_words<N, EDGE>(b[i], bh + o, w, cx0, lane);
        if (r >= y0) load_words<N, EDGE>(a[i], adapt + o, w, cx0, lane);
      }
    }
  };
  load_group(r_begin, cs, cb, ca);
  for (int r0 = r_begin; r0 < y_end; r0 += kGroup) {
    load_group(r0 + kGroup, ns, nb, na);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int r = r0 + i;
      const long long o = (long long)r * w;
      uint32_t m0[N], v[N], m[N], q[N];
      if (AL == kAnyAlign) {
        uint32_t vs[N], vb[N];
        realign<N>(vs, cs[i], sub + o, cx0);
        realign<N>(vb, cb[i], bh + o, cx0);
#pragma unroll
        for (int j = 0; j < N; ++j) m0[j] = ts.at(vs[j]) | tb.at(vb[j]);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) q[j] = ts.at(cs[i][j]) | tb.at(cb[i][j]);
        to_columns<N>(m0, q, grid_offset(sub + o, cx0));
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        m0[j] &= valid[j];
        v[j] = m0[j];
#pragma unroll
        for (int k = 0; k < ITERS; ++k) v[j] |= ring[k][j];
#pragma unroll
        for (int k = 0; k + 1 < ITERS; ++k) ring[k][j] = ring[k + 1][j];
        if (ITERS > 0) ring[ITERS > 0 ? ITERS - 1 : 0][j] = m0[j];
      }
      const Around<N> around(v, ITERS > 4 * N);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        m[j] = v[j];
#pragma unroll
        for (int s = 1; s <= ITERS; ++s) m[j] |= around.from_left(j, s);
      }
      const bool live = r >= y0 && r < y_end;
      if (AL == kAnyAlign) {
        store_row<N, EDGE>(mask + o, live, w, cx0, kHalo, 30, lane, m);
        realign<N>(q, ca[i], adapt + o, cx0);
#pragma unroll
        for (int j = 0; j < N; ++j) q[j] |= ~m[j];
        store_row<N, EDGE>(weighted + o, live, w, cx0, kHalo, 30, lane, q);
      } else {
        const unsigned off = grid_offset(mask + o, cx0);
        to_row_words<N>(q, m, off);
        store_words<N, EDGE>(mask + o, live, w, cx0, off, kHalo, 30, lane, q);
#pragma unroll
        for (int j = 0; j < N; ++j) q[j] = ca[i][j] | ~q[j];
        store_words<N, EDGE>(weighted + o, live, w, cx0, off, kHalo, 30, lane, q);
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        cs[i][j] = ns[i][j];
        cb[i][j] = nb[i][j];
        ca[i][j] = na[i][j];
      }
    }
  }
}

template <int ITERS>
__global__ void __launch_bounds__(kThreads)
inkmask_kernel(const uint8_t* __restrict__ sub, const uint8_t* __restrict__ bh,
               const uint8_t* __restrict__ adapt, const float* __restrict__ t_sub,
               const float* __restrict__ t_bh, uint8_t* __restrict__ mask,
               uint8_t* __restrict__ weighted, int batch, int h, int w, int align) {
  constexpr int kHalo = kInkHalo<ITERS>, kOwned = kWords * (31 - kHalo);   // lanes kHalo..30
  const int lane = threadIdx.x & 31;
  const unsigned runs = runs_for(w, kOwned), strips = (h + kStripRows - 1) / kStripRows;
  const unsigned units = (unsigned)batch * strips * runs;
  for (unsigned u = blockIdx.x * kWarps + (threadIdx.x >> 5); u < units;
       u += gridDim.x * kWarps) {
    const unsigned run = u % runs, strip = (u / runs) % strips, b = u / (runs * strips);
    const int cx0 = 4 * (kOwned * (int)run - kWords * kHalo);
    const ByteThreshold ts(t_sub[b]), tb(t_bh[b]);
    const long long plane = (long long)b * h * w;
    const int y0 = (int)strip * kStripRows, y_end = min(y0 + kStripRows, h);
    const uint8_t *s = sub + plane, *bp = bh + plane, *ap = adapt + plane;
    uint8_t *mp = mask + plane, *wp = weighted + plane;
    const bool inside = run_inside<kWords>(cx0, w);
    if (align == kAnyAlign && inside) {
      ink_strip<ITERS, false, kAnyAlign>(s, bp, ap, mp, wp, ts, tb, w, cx0, y0, y_end, lane);
    } else if (align == kAnyAlign) {
      ink_strip<ITERS, true, kAnyAlign>(s, bp, ap, mp, wp, ts, tb, w, cx0, y0, y_end, lane);
    } else if (inside) {
      ink_strip<ITERS, false, kCoAligned>(s, bp, ap, mp, wp, ts, tb, w, cx0, y0, y_end, lane);
    } else {
      ink_strip<ITERS, true, kCoAligned>(s, bp, ap, mp, wp, ts, tb, w, cx0, y0, y_end, lane);
    }
  }
}

// Split form, first launch: rowmax = any m0 in [x - iters, x] of the row.
__global__ void __launch_bounds__(kThreads)
inkmask_rows_kernel(const uint8_t* __restrict__ sub, const uint8_t* __restrict__ bh,
                    const float* __restrict__ t_sub, const float* __restrict__ t_bh,
                    uint8_t* __restrict__ rowmax, long long n, int h, int w, int iters) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int x = (int)(i % w);
    const long long b = i / ((long long)h * w);
    const float ts = t_sub[b], tb = t_bh[b];
    uint8_t m = 0;
    for (int j = max(x - iters, 0); j <= x && m == 0; ++j) {
      m = ink(sub, bh, i - x + j, ts, tb) ? 255 : 0;
    }
    rowmax[i] = m;
  }
}

// Split form, second launch: the mask = any rowmax in [y - iters, y] of
// the column, and the weighting.
__global__ void __launch_bounds__(kThreads)
inkmask_cols_kernel(const uint8_t* __restrict__ rowmax, const uint8_t* __restrict__ adapt,
                    uint8_t* __restrict__ mask, uint8_t* __restrict__ weighted, long long n,
                    int h, int w, int iters) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int y = (int)((i / w) % h);
    uint8_t m = 0;
    for (int j = max(y - iters, 0); j <= y && m == 0; ++j) m = rowmax[i - (long long)(y - j) * w];
    mask[i] = m;
    weighted[i] = m == 0 ? 255 : adapt[i];
  }
}

template <int ITERS>
void launch_warp_form(const uint8_t* sub, const uint8_t* bh, const uint8_t* adapt,
                      const float* ts, const float* tb, uint8_t* mask, uint8_t* weighted,
                      int batch, int h, int w, long long units, cudaStream_t s) {
  long long blocks = (units + kWarps - 1) / kWarps;
  if (sm_count() > 0) blocks = std::min<long long>(blocks, (long long)kBlocksPerSm * sm_count());
  inkmask_kernel<ITERS><<<(unsigned)blocks, kThreads, 0, s>>>(
      sub, bh, adapt, ts, tb, mask, weighted, batch, h, w,
      alignment_of({sub, bh, adapt, mask, weighted}, w));
}

}  // namespace

// Bytes of device scratch that tpuimage_inkmask_weighted needs for this
// call: 0 for the warp form, one byte plane for the split form.
extern "C" long long tpuimage_inkmask_scratch(int batch, int h, int w, int iters) {
  return iters > kMaxWarpIters ? (long long)batch * h * w : 0;
}

// scratch: tpuimage_inkmask_scratch() bytes on the device (may be null when
// that is 0). Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tpuimage_inkmask_weighted(const void* sub, const void* bh,
                                         const void* adapt, const void* t_sub,
                                         const void* t_bh, void* mask, void* weighted,
                                         void* scratch, int batch, int h, int w, int iters,
                                         void* stream) {
  if (iters < 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* sub_p = static_cast<const uint8_t*>(sub);
  const uint8_t* bh_p = static_cast<const uint8_t*>(bh);
  const uint8_t* adapt_p = static_cast<const uint8_t*>(adapt);
  const float* ts_p = static_cast<const float*>(t_sub);
  const float* tb_p = static_cast<const float*>(t_bh);
  uint8_t* mask_p = static_cast<uint8_t*>(mask);
  uint8_t* weighted_p = static_cast<uint8_t*>(weighted);
  if (iters > kMaxWarpIters) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const long long n = (long long)batch * h * w;
    const unsigned blocks = (unsigned)std::min<long long>((n + kThreads - 1) / kThreads, 1 << 20);
    uint8_t* rowmax = static_cast<uint8_t*>(scratch);
    inkmask_rows_kernel<<<blocks, kThreads, 0, s>>>(sub_p, bh_p, ts_p, tb_p, rowmax, n, h, w,
                                                     iters);
    inkmask_cols_kernel<<<blocks, kThreads, 0, s>>>(rowmax, adapt_p, mask_p, weighted_p, n, h,
                                                     w, iters);
    return (int)cudaGetLastError();
  }
  const long long units = (long long)batch * ((h + kStripRows - 1) / kStripRows)
                          * runs_for(w, kWords * (31 - (iters + 3 + 4 * kWords - 1)
                                                       / (4 * kWords)));   // the kernel's kOwned
  if (units > INT32_MAX) return (int)cudaErrorInvalidValue;
  switch (iters) {
#define TPUIMAGE_INKMASK_CASE(I)                                                             \
  case I:                                                                                    \
    launch_warp_form<I>(sub_p, bh_p, adapt_p, ts_p, tb_p, mask_p, weighted_p, batch, h, w,  \
                        units, s);                                                           \
    break;
    TPUIMAGE_INKMASK_CASE(0) TPUIMAGE_INKMASK_CASE(1) TPUIMAGE_INKMASK_CASE(2)
    TPUIMAGE_INKMASK_CASE(3) TPUIMAGE_INKMASK_CASE(4) TPUIMAGE_INKMASK_CASE(5)
    TPUIMAGE_INKMASK_CASE(6) TPUIMAGE_INKMASK_CASE(7) TPUIMAGE_INKMASK_CASE(8)
#undef TPUIMAGE_INKMASK_CASE
  }
  return (int)cudaGetLastError();
}
