// morph_seq's two fused stencils, on a batch of (B, H, W) planes:
//
//   gray_erode3:   (B, H, W, 3) u8 RGB -> gray and its 3x3 erosion, both
//                  (B, H, W) u8 (morph_seq steps 1-2);
//   binary_close3: the eroded plane and one threshold per image ->
//                  the binary plane (x > t ? 255 : 0) and its 3x3 closing,
//                  both (B, H, W) u8 (steps 3-4).
//
// Replaces: tpuimage/ops/pallas_kernels.py:1781 gray_erode3_pallas and
// :1809 binary_close3_pallas (bodies _make_gray_erode3_kernel and
// _make_binary_close3_kernel).
//
// Bound on the H100: memory. gray_erode3 reads 3 bytes and writes 2 per
// pixel; binary_close3 reads 1 and writes 2. The stencils are a few integer
// min/max per pixel, but a pixel's share of loads, shifts, shuffles and
// stores decides how near the bytes' time a design comes.
//
// Design: both are a warp walking down a strip of rows with several
// pixels a lane in registers (at gray_erode3_kernel and
// binary_close3_kernel): no shared tile. The TPU kernels' byte packing of RGB into int32,
// lane rolls and VMEM residency gates have no use here. Borders are
// ops.morphology's constant ones: outside the image the erosion sees 255
// and the dilation 0. Gray is OpenCV's Q15 (r*9798 + g*19235 + b*3735 +
// 16384) >> 15. The threshold compare is in f32 with a strict '>', as
// threshold_binary makes it. All integer, so both kernels equal their
// plain versions bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "byte_rows.cuh"
#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;

// gray_erode3, warp form. Taking parts of a shared-tile design away on the
// card put most of its time in a divide and a modulo an element, byte
// loads at stride 3 and nine shared byte loads a pixel, not in the bytes
// (PERF.md). Here a warp owns a run of 32 x kErodeWords words of one
// image's column grid (byte_rows.cuh; lane l holds 4 kErodeWords pixels)
// and walks down a strip of kErodeStrip output rows with one row of halo
// above and below:
// - each RGB row is read as the lane's 3 kErodeWords words (16-byte loads
//   when every row starts on a 16-byte word, else aligned words
//   funnel-shifted to the column grid, the last from the next lane);
// - gray is OpenCV's Q15 sum, two 16x8-bit dot products (dp2a) a pixel on
//   the words as they are, no byte unpacking; two pixels sit in a word as
//   16-bit halves, so every min is one __vminu2 (VIMNMX.U16x2) for two
//   pixels (the byte form, __vminu4, is six instructions);
// - the last two gray rows stay in registers for the vertical minimum and
//   the neighbours' columns come by shuffle; 255 outside the image;
// - gray and eroded rows are written as the lanes' 16-byte words where the
//   planes allow, else as the aligned words of each row's own alignment
//   (store_row); lanes 0 and 31 are halo and store nothing.
// No shared memory, no divide per element; a persistent grid of warps
// strides over (image, strip, run).
constexpr int kErodeWords = 4;     // words (4 pixels each) a lane holds in a row
constexpr int kErodeStrip = 16;    // output rows a warp walks
constexpr int kErodeGroup = 2;     // rows whose loads a lane issues together
constexpr int kErodeThreads = 128;
constexpr int kErodeBlocksPerSm = 16;
constexpr int kErodeFirst = 1, kErodeLast = 30;   // the lanes that store
constexpr int kErodeOwned = kErodeWords * (kErodeLast - kErodeFirst + 1);

// Gray (Q15, rounded) of the 4 pixels in 3 RGB words, as two words of
// 16-bit halves: p01 = g0 | g1 << 16, p23 = g2 | g3 << 16. Pixels 1 and 3
// use doubled weights, so their gray lies in bits 16-23.
__device__ __forceinline__ void gray4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t& p01,
                                      uint32_t& p23) {
  constexpr uint32_t RG = 9798u | 19235u << 16, B0 = 3735u;
  constexpr uint32_t R2 = (2u * 9798u) << 16, GB2 = 2u * 19235u | (2u * 3735u) << 16;
  const uint32_t a0 = __dp2a_hi(B0, w0, __dp2a_lo(RG, w0, 16384u));   // r g b: w0 bytes 0 1 2
  const uint32_t a1 = __dp2a_lo(GB2, w1, __dp2a_hi(R2, w0, 32768u));  // w0.3; w1 bytes 0 1
  const uint32_t a2 = __dp2a_lo(B0, w2, __dp2a_hi(RG, w1, 16384u));   // w1 bytes 2 3; w2.0
  const uint32_t a3 = __dp2a_hi(GB2, w2, __dp2a_lo(R2, w2, 32768u));  // w2 bytes 1 2 3
  p01 = (a0 >> 15) | (a1 & 0x00ff0000u);
  p23 = (a2 >> 15) | (a3 & 0x00ff0000u);
}

// The lane's 12 N bytes of an RGB row [row, row + 3 w) from column
// cx0 + 4 N lane, as 3 N words. VEC: the row and 3 cx0 are multiples of
// 4 N bytes and the lane's columns lie in the row (the caller checks).
// Else aligned words, funnel-shifted, the last from the next lane (lane
// 31's last word is not the row's); EDGE: a word with no byte of the row
// reads as 0. All lanes call unless VEC.
// Writes a lane's N words at p, a multiple of 4 N bytes.
template <int N>
__device__ __forceinline__ void store_lane(uint8_t* p, const uint32_t (&q)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(q[0], q[1], q[2], q[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(q[0], q[1]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) reinterpret_cast<uint32_t*>(p)[k] = q[k];
  }
}

template <int N, bool EDGE, bool VEC>
__device__ __forceinline__ void load_rgb(uint32_t (&p)[3 * N], const uint8_t* row, int w,
                                         int cx0, int lane) {
  const uintptr_t start = reinterpret_cast<uintptr_t>(row);
  const uintptr_t first = start + (uintptr_t)(intptr_t)(3 * cx0) + 12u * N * (unsigned)lane;
  if constexpr (VEC) {
    if constexpr (N == 4) {
      const uint4* src = reinterpret_cast<const uint4*>(first);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint4 v = __ldg(src + k);
        p[4 * k] = v.x, p[4 * k + 1] = v.y, p[4 * k + 2] = v.z, p[4 * k + 3] = v.w;
      }
    } else if constexpr (N == 2) {
      const uint2* src = reinterpret_cast<const uint2*>(first);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint2 v = __ldg(src + k);
        p[2 * k] = v.x, p[2 * k + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 3 * N; ++k) p[k] = __ldg(reinterpret_cast<const uint32_t*>(first) + k);
    }
  } else {
  const uintptr_t a = first & ~(uintptr_t)3;
  const unsigned off = (unsigned)(first & 3u);
  uint32_t q[3 * N];
#pragma unroll
  for (int j = 0; j < 3 * N; ++j) {
    const uintptr_t aj = a + 4u * j;
    q[j] = EDGE && !(aj < start + 3u * (unsigned)w && aj + 4 > start)
               ? 0u : __ldg(reinterpret_cast<const uint32_t*>(aj));
  }
  const uint32_t next = __shfl_down_sync(kAllLanes, q[0], 1);
#pragma unroll
  for (int j = 0; j < 3 * N; ++j) p[j] = __funnelshift_r(q[j], j + 1 < 3 * N ? q[j + 1] : next, 8 * off);
  }
}

// One warp's strip: output rows [y0, y_end) of one image (the pointers at
// its row 0) for the run whose lane 0 holds column cx0. VEC: every plane's
// rows start on 4 kErodeWords-byte words, so a lane's columns lie all in
// or all out of the row and it loads and stores its own words; else EDGE
// unless the run lies inside the rows (run_inside).
template <bool EDGE, bool VEC>
__device__ __forceinline__ void erode_strip(const uint8_t* rgb, uint8_t* gray, uint8_t* eroded,
                                            int h, int w, int cx0, int y0, int y_end, int lane) {
  constexpr int N = kErodeWords, G = kErodeGroup;
  const int x = cx0 + 4 * N * lane;
  const bool lane_in = !VEC || (x >= 0 && x < w);   // VEC: all 4 N columns, or none
  const bool stores = lane >= kErodeFirst && lane <= kErodeLast;
  uint32_t outside[2 * N];   // 0xff in the 16-bit halves of columns outside [0, w)
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) {
    const int c = x + 2 * k;
    outside[k] = VEC ? (lane_in ? 0u : 0x00ff00ffu)
                     : (EDGE ? (c >= 0 && c < w ? 0u : 0xffu)
                                   | (c + 1 >= 0 && c + 1 < w ? 0u : 0x00ff0000u)
                             : 0u);
  }
  // input row r gives gray row r and eroded row r - 1
  uint32_t g1[2 * N], g2[2 * N];   // gray rows r - 2, r - 1 as 16-bit halves
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) g1[k] = g2[k] = 0x00ff00ffu;
  const int r_lo = max(y0 - 1, 0), r_hi = min(y_end, h - 1);   // the rows read
  uint32_t cur[G][3 * N], nxt[G][3 * N];
  auto load_group = [&](int r0, uint32_t (&words)[G][3 * N]) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int r = r0 + i;
#pragma unroll
      for (int j = 0; j < 3 * N; ++j) words[i][j] = 0u;
      if (r >= r_lo && r <= r_hi && lane_in) {
        load_rgb<N, EDGE, VEC>(words[i], rgb + 3LL * r * w, w, cx0, lane);
      }
    }
  };
  load_group(y0 - 1, cur);
  for (int r0 = y0 - 1; r0 <= y_end; r0 += G) {
    load_group(r0 + G, nxt);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int r = r0 + i;
      const long long o = (long long)r * w;
      uint32_t g[2 * N];
      if (r >= 0 && r < h) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          gray4(cur[i][3 * k], cur[i][3 * k + 1], cur[i][3 * k + 2], g[2 * k], g[2 * k + 1]);
        }
#pragma unroll
        for (int k = 0; k < 2 * N; ++k) g[k] |= outside[k];
      } else {
#pragma unroll
        for (int k = 0; k < 2 * N; ++k) g[k] = 0x00ff00ffu;   // the erosion's border: 255
      }
      const bool live_g = r >= y0 && r < y_end;
      const bool live_e = r - 1 >= y0 && r - 1 < y_end;
      uint32_t gb[N], v[2 * N], e[2 * N], eb[N];
#pragma unroll
      for (int k = 0; k < N; ++k) gb[k] = __byte_perm(g[2 * k], g[2 * k + 1], 0x6420);
#pragma unroll
      for (int k = 0; k < 2 * N; ++k) {
        v[k] = __vminu2(__vminu2(g1[k], g2[k]), g[k]);
        g1[k] = g2[k];
        g2[k] = g[k];
      }
      const uint32_t left = __shfl_up_sync(kAllLanes, v[2 * N - 1], 1);
      const uint32_t right = __shfl_down_sync(kAllLanes, v[0], 1);
#pragma unroll
      for (int k = 0; k < 2 * N; ++k) {
        const uint32_t l = __byte_perm(k ? v[k - 1] : left, v[k], 0x5432);
        const uint32_t rr = __byte_perm(v[k], k + 1 < 2 * N ? v[k + 1] : right, 0x5432);
        e[k] = __vminu2(__vminu2(l, v[k]), rr);
      }
#pragma unroll
      for (int k = 0; k < N; ++k) eb[k] = __byte_perm(e[2 * k], e[2 * k + 1], 0x6420);
      if constexpr (VEC) {
        if (stores && lane_in) {
          if (live_g) store_lane<N>(gray + o + x, gb);
          if (live_e) store_lane<N>(eroded + (o - w) + x, eb);
        }
      } else {
        store_row<N, EDGE>(gray + o, live_g, w, cx0, kErodeFirst, kErodeLast, lane, gb);
        store_row<N, EDGE>(eroded + (o - w), live_e, w, cx0, kErodeFirst, kErodeLast, lane, eb);
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
#pragma unroll
      for (int j = 0; j < 3 * N; ++j) cur[i][j] = nxt[i][j];
    }
  }
}

__global__ void __launch_bounds__(kErodeThreads)
gray_erode3_kernel(const uint8_t* __restrict__ rgb, uint8_t* __restrict__ gray,
                   uint8_t* __restrict__ eroded, int batch, int h, int w, bool vec) {
  constexpr int kWarps = kErodeThreads / 32;
  const int lane = threadIdx.x & 31;
  const unsigned runs = runs_for(w, kErodeOwned), strips = (h + kErodeStrip - 1) / kErodeStrip;
  const unsigned units = (unsigned)batch * strips * runs;
  for (unsigned u = blockIdx.x * kWarps + (threadIdx.x >> 5); u < units;
       u += gridDim.x * kWarps) {
    const unsigned run = u % runs, strip = (u / runs) % strips, b = u / (runs * strips);
    const int cx0 = 4 * (kErodeOwned * (int)run - kErodeWords * kErodeFirst);
    const long long plane = (long long)b * h * w;
    const int y0 = (int)strip * kErodeStrip, y_end = min(y0 + kErodeStrip, h);
    const uint8_t* src = rgb + 3 * plane;
    if (vec) {
      erode_strip<false, true>(src, gray + plane, eroded + plane, h, w, cx0, y0, y_end, lane);
    } else if (run_inside<kErodeWords>(cx0, w)) {
      erode_strip<false, false>(src, gray + plane, eroded + plane, h, w, cx0, y0, y_end, lane);
    } else {
      erode_strip<true, false>(src, gray + plane, eroded + plane, h, w, cx0, y0, y_end, lane);
    }
  }
}

// binary_close3, warp form: the binary plane and the closing are 0/255
// bytes, so the dilation is an OR and the erosion an AND of words of four
// pixels. A warp owns a run of 32 x kWords words of one image's column
// grid (byte_rows.cuh: rows at any alignment read as aligned words and
// funnel-shifted, outputs written as aligned words), lane 0 a halo to the
// left and lane 31 one to the right, and walks down a strip of kStripRows
// output rows with 2 rows of halo above and below, keeping the last three
// binary and dilated rows in registers and the loads of the next kGroup
// rows in flight; a persistent grid of warps strides over (image, strip,
// run). No shared memory, no barrier. Where the planes share one
// alignment the compare and the binary store work in the rows' own words;
// at a width that is a multiple of 4 (morph_seq's 1280) nothing is
// realigned. Like the ink mask it runs at ~50-55% of its bound, held by
// the instructions a row costs, not by its bytes (PERF.md).
constexpr int kStripRows = 16;
constexpr int kGroup = 2;          // rows whose loads a lane issues together
constexpr int kWords = 2;          // words a lane holds in a row
constexpr int kBlocksPerSm = 8;
// the lanes that store: the 2 columns the closing reaches left and the 3 a
// store's first word may start before the run lie in lanes before kCloseFirst
constexpr int kCloseFirst = kWords == 1 ? 2 : 1, kCloseLast = kWords == 1 ? 29 : 30;
constexpr int kCloseOwned = kWords * (kCloseLast - kCloseFirst + 1);

// One warp's strip: output rows [y0, y_end) of one image (the pointers at
// its row 0) for the run whose lane 0 holds column cx0; EDGE unless the run
// lies inside the rows (run_inside); AL the planes' Alignment (with
// kCoAligned the compare and the binary store work in each row's own
// aligned words; with kWordAligned there is no realigning at all).
template <bool EDGE, int AL>
__device__ __forceinline__ void close_strip(const uint8_t* src, uint8_t* binary,
                                            uint8_t* closed, const ByteThreshold& t, int h,
                                            int w, int cx0, int y0, int y_end, int lane) {
  constexpr int N = kWords;
  uint32_t valid[N];
#pragma unroll
  for (int j = 0; j < N; ++j) valid[j] = EDGE ? columns_in(cx0 + 4 * (N * lane + j), w) : kAllLanes;
  // input row r gives binary row r, dilated row r - 1, closed row r - 2
  uint32_t b1[N] = {}, b2[N] = {};   // binary rows r - 2, r - 1
  uint32_t d1[N] = {}, d2[N] = {};   // dilated rows r - 3, r - 2
  const int r_last = min(y_end + 1, h - 1);   // the last row read
  uint32_t cur[kGroup][N], nxt[kGroup][N];
  auto load_group = [&](int r0, uint32_t (&words)[kGroup][N]) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int r = r0 + i;
#pragma unroll
      for (int j = 0; j < N; ++j) words[i][j] = 0u;
      if (r >= 0 && r <= r_last) {
        load_words<N, EDGE>(words[i], src + (long long)r * w, w, cx0, lane);
      }
    }
  };
  load_group(y0 - 2, cur);
  for (int r0 = y0 - 2; r0 <= y_end + 1; r0 += kGroup) {
    load_group(r0 + kGroup, nxt);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int r = r0 + i;
      const long long o = (long long)r * w;
      uint32_t bin[N], vd[N], d[N], ve[N], c[N], q[N];
      const uint32_t in_image = r >= 0 && r < h ? kAllLanes : 0u;   // the dilation's border: 0
      const bool live = r >= y0 && r < y_end;
      if (AL == kAnyAlign) {
        realign<N>(bin, cur[i], src + o, cx0);
#pragma unroll
        for (int j = 0; j < N; ++j) bin[j] = t.at(bin[j]) & valid[j] & in_image;
        store_row<N, EDGE>(binary + o, live, w, cx0, kCloseFirst, kCloseLast, lane, bin);
      } else {
        const unsigned off = AL == kWordAligned ? 0u : grid_offset(src + o, cx0);
#pragma unroll
        for (int j = 0; j < N; ++j) q[j] = t.at(cur[i][j]) & in_image;
        store_words<N, EDGE>(binary + o, live, w, cx0, off, kCloseFirst, kCloseLast, lane, q);
        if (AL == kWordAligned) {
#pragma unroll
          for (int j = 0; j < N; ++j) bin[j] = q[j];
        } else {
          to_columns<N>(bin, q, off);
        }
#pragma unroll
        for (int j = 0; j < N; ++j) bin[j] &= valid[j];
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        vd[j] = b1[j] | b2[j] | bin[j];
        b1[j] = b2[j];
        b2[j] = bin[j];
      }
      const Around<N> avd(vd, false);
      const bool dil_in = r - 1 >= 0 && r - 1 < h;   // else the erosion's border: 255
#pragma unroll
      for (int j = 0; j < N; ++j) {
        d[j] = dil_in ? (vd[j] | avd.from_left(j, 1) | avd.from_right(j) | ~valid[j])
                      : kAllLanes;
        ve[j] = d1[j] & d2[j] & d[j];
        d1[j] = d2[j];
        d2[j] = d[j];
      }
      const Around<N> ave(ve, false);
#pragma unroll
      for (int j = 0; j < N; ++j) c[j] = ve[j] & ave.from_left(j, 1) & ave.from_right(j);
      uint8_t* out = closed + (o - 2LL * w);
      const bool live_c = r - 2 >= y0 && r - 2 < y_end;
      if (AL == kWordAligned) {
        store_words<N, EDGE>(out, live_c, w, cx0, 0u, kCloseFirst, kCloseLast, lane, c);
      } else {
        store_row<N, EDGE>(out, live_c, w, cx0, kCloseFirst, kCloseLast, lane, c);
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) cur[i][j] = nxt[i][j];
    }
  }
}

template <bool EDGE>
__device__ __forceinline__ void close_strip_as(int align, const uint8_t* src, uint8_t* binary,
                                               uint8_t* closed, const ByteThreshold& t, int h,
                                               int w, int cx0, int y0, int y_end, int lane) {
  if (align == kWordAligned) {
    close_strip<EDGE, kWordAligned>(src, binary, closed, t, h, w, cx0, y0, y_end, lane);
  } else if (align == kCoAligned) {
    close_strip<EDGE, kCoAligned>(src, binary, closed, t, h, w, cx0, y0, y_end, lane);
  } else {
    close_strip<EDGE, kAnyAlign>(src, binary, closed, t, h, w, cx0, y0, y_end, lane);
  }
}

__global__ void __launch_bounds__(kThreads)
binary_close3_kernel(const uint8_t* __restrict__ src,
                     const float* __restrict__ thresh,
                     uint8_t* __restrict__ binary, uint8_t* __restrict__ closed,
                     int batch, int h, int w, int align) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const unsigned runs = runs_for(w, kCloseOwned), strips = (h + kStripRows - 1) / kStripRows;
  const unsigned units = (unsigned)batch * strips * runs;
  for (unsigned u = blockIdx.x * kWarps + (threadIdx.x >> 5); u < units;
       u += gridDim.x * kWarps) {
    const unsigned run = u % runs, strip = (u / runs) % strips, b = u / (runs * strips);
    const int cx0 = 4 * (kCloseOwned * (int)run - kWords * kCloseFirst);
    const ByteThreshold t(thresh[b]);
    const long long plane = (long long)b * h * w;
    const int y0 = (int)strip * kStripRows, y_end = min(y0 + kStripRows, h);
    if (run_inside<kWords>(cx0, w)) {
      close_strip_as<false>(align, src + plane, binary + plane, closed + plane, t, h, w, cx0,
                            y0, y_end, lane);
    } else {
      close_strip_as<true>(align, src + plane, binary + plane, closed + plane, t, h, w, cx0,
                           y0, y_end, lane);
    }
  }
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 on success).
extern "C" int tpuimage_gray_erode3(const void* rgb, void* gray, void* eroded,
                                    int batch, int h, int w, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  const long long units = (long long)batch * ((h + kErodeStrip - 1) / kErodeStrip)
                          * runs_for(w, kErodeOwned);
  if (units > INT32_MAX || 3LL * w > INT32_MAX) return (int)cudaErrorInvalidValue;
  constexpr int kWarps = kErodeThreads / 32, kVec = 4 * kErodeWords;
  long long blocks = (units + kWarps - 1) / kWarps;
  if (sm_count() > 0) blocks = std::min<long long>(blocks, (long long)kErodeBlocksPerSm * sm_count());
  const bool vec = (reinterpret_cast<uintptr_t>(rgb) | reinterpret_cast<uintptr_t>(gray)
                    | reinterpret_cast<uintptr_t>(eroded) | (uintptr_t)(unsigned)w) % kVec == 0;
  gray_erode3_kernel<<<(unsigned)blocks, kErodeThreads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<uint8_t*>(gray),
      static_cast<uint8_t*>(eroded), batch, h, w, vec);
  return (int)cudaGetLastError();
}

extern "C" int tpuimage_binary_close3(const void* src, const void* thresh,
                                      void* binary, void* closed, int batch,
                                      int h, int w, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  const long long units = (long long)batch * ((h + kStripRows - 1) / kStripRows)
                          * runs_for(w, kCloseOwned);
  if (units > INT32_MAX) return (int)cudaErrorInvalidValue;
  long long blocks = (units + kThreads / 32 - 1) / (kThreads / 32);
  if (sm_count() > 0) blocks = std::min<long long>(blocks, (long long)kBlocksPerSm * sm_count());
  binary_close3_kernel<<<(unsigned)blocks, kThreads, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const float*>(thresh),
      static_cast<uint8_t*>(binary), static_cast<uint8_t*>(closed), batch, h, w,
      alignment_of({src, binary, closed}, w));
  return (int)cudaGetLastError();
}
