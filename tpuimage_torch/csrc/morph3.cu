// morph_seq's two fused stencils, on a batch of (B, H, W) planes:
//
//   gray_erode3:   (B, H, W, 3) u8 RGB -> gray and its 3x3 erosion, both
//                  (B, H, W) u8 (morph_seq steps 1-2);
//   binary_close3: the eroded plane and one threshold per image ->
//                  the binary plane (x > t ? 255 : 0) and its 3x3 closing,
//                  both (B, H, W) u8 (steps 3-4).
//
// Replaces: tpuimage/ops/pallas_kernels.py gray_erode3_pallas and
// binary_close3_pallas (bodies _make_gray_erode3_kernel and
// _make_binary_close3_kernel).
//
// Bound on the H100: memory. gray_erode3 reads 3 bytes and writes 2 per
// pixel; binary_close3 reads 1 and writes 2. The stencils are a few integer
// min/max per pixel.
//
// Design, gray_erode3: one block per (kTileW x kTileH) output tile of one
// image, with the tile and its halo in shared memory, so each input byte
// comes from device memory about once (the halo adds ~10%). binary_close3:
// a warp walks down a strip of rows, eight pixels a lane in registers (at
// binary_close3_kernel). The TPU kernels' byte packing of RGB into int32,
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

constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ uint8_t rgb_gray(const uint8_t* p) {
  return (uint8_t)(((int)p[0] * 9798 + (int)p[1] * 19235 + (int)p[2] * 3735 +
                    16384) >> 15);
}

__global__ void __launch_bounds__(kThreads)
gray_erode3_kernel(const uint8_t* __restrict__ rgb, uint8_t* __restrict__ gray,
                   uint8_t* __restrict__ eroded, int h, int w) {
  constexpr int SW = kTileW + 2, SH = kTileH + 2;
  __shared__ uint8_t g[SH][SW];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const long long plane = (long long)b * h * w;
  for (int i = threadIdx.x; i < SH * SW; i += kThreads) {
    const int ly = i / SW, lx = i % SW;
    const int y = y0 - 1 + ly, x = x0 - 1 + lx;
    uint8_t v = 255;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const long long off = plane + (long long)y * w + x;
      v = rgb_gray(rgb + 3 * off);
      if (ly >= 1 && ly <= kTileH && lx >= 1 && lx <= kTileW) gray[off] = v;
    }
    g[ly][lx] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int ly = i / kTileW, lx = i % kTileW;
    const int y = y0 + ly, x = x0 + lx;
    if (y >= h || x >= w) continue;
    uint8_t m = 255;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) m = min(m, g[ly + dy][lx + dx]);
    }
    eroded[plane + (long long)y * w + x] = m;
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

dim3 tile_grid(int batch, int h, int w) {
  return dim3((unsigned)((w + kTileW - 1) / kTileW),
              (unsigned)((h + kTileH - 1) / kTileH), (unsigned)batch);
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 on success).
extern "C" int tpuimage_gray_erode3(const void* rgb, void* gray, void* eroded,
                                    int batch, int h, int w, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (batch > 65535 || (h + kTileH - 1) / kTileH > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  gray_erode3_kernel<<<tile_grid(batch, h, w), kThreads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<uint8_t*>(gray),
      static_cast<uint8_t*>(eroded), h, w);
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
