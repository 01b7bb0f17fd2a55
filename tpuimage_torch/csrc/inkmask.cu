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
// The thresholds are one f32 per image on the device (the Otsu pullbacks,
// integers in [-1, 255]), read by the kernel itself, so nothing goes back to
// the host between the histograms and this epilogue. All compares and
// integer maxima, so the kernel equals its plain version bit for bit.
//
// Bound on the H100: memory. Each pixel reads 3 bytes and writes 2; the
// work is two compares and at most (iters + 1)^2 maxima.
//
// Design, tiled form (iters <= kMaxTiledIters, the TPU kernel's own
// limit): one block per (kTileH x kTileW) output tile of one image; m0 over
// the tile and its halo of iters rows above and iters columns to the left
// goes to shared memory, then each pixel takes its window's maximum there.
// Split form (more iterations): one launch takes m0's maximum along each
// row's window into a (B, H, W) byte plane of device scratch that the
// caller provides, a second the maximum down the columns and the weighting.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kThreads = 256;
constexpr int kMaxTiledIters = 8;

__device__ __forceinline__ bool ink(const uint8_t* sub, const uint8_t* bh, long long off,
                                    float ts, float tb) {
  return (float)sub[off] > ts || (float)bh[off] > tb;
}

__global__ void __launch_bounds__(kThreads)
inkmask_kernel(const uint8_t* __restrict__ sub, const uint8_t* __restrict__ bh,
               const uint8_t* __restrict__ adapt, const float* __restrict__ t_sub,
               const float* __restrict__ t_bh, uint8_t* __restrict__ mask,
               uint8_t* __restrict__ weighted, int h, int w, int iters) {
  constexpr int SW = kTileW + kMaxTiledIters, SH = kTileH + kMaxTiledIters;
  __shared__ uint8_t m0[SH][SW];
  const int b = blockIdx.z;
  const float ts = t_sub[b], tb = t_bh[b];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const long long plane = (long long)b * h * w;
  const int rw = kTileW + iters, rh = kTileH + iters;
  for (int i = threadIdx.x; i < rh * rw; i += kThreads) {
    const int ly = i / rw, lx = i % rw;
    const int y = y0 - iters + ly, x = x0 - iters + lx;
    uint8_t v = 0;  // the dilation's border
    if (y >= 0 && y < h && x >= 0 && x < w) {
      v = ink(sub, bh, plane + (long long)y * w + x, ts, tb) ? 255 : 0;
    }
    m0[ly][lx] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int ly = i / kTileW, lx = i % kTileW;
    const int y = y0 + ly, x = x0 + lx;
    if (y >= h || x >= w) continue;
    uint8_t m = 0;
    for (int dy = 0; dy <= iters; ++dy) {
      for (int dx = 0; dx <= iters; ++dx) m = max(m, m0[ly + dy][lx + dx]);
    }
    const long long off = plane + (long long)y * w + x;
    mask[off] = m;
    weighted[off] = m == 0 ? 255 : adapt[off];
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

}  // namespace

// Bytes of device scratch that tpuimage_inkmask_weighted needs for this
// call: 0 for the tiled form, one byte plane for the split form.
extern "C" long long tpuimage_inkmask_scratch(int batch, int h, int w, int iters) {
  return iters > kMaxTiledIters ? (long long)batch * h * w : 0;
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
  if (iters > kMaxTiledIters) {
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
  if (batch > 65535 || (h + kTileH - 1) / kTileH > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((w + kTileW - 1) / kTileW),
                  (unsigned)((h + kTileH - 1) / kTileH), (unsigned)batch);
  inkmask_kernel<<<grid, kThreads, 0, s>>>(sub_p, bh_p, adapt_p, ts_p, tb_p, mask_p, weighted_p,
                                            h, w, iters);
  return (int)cudaGetLastError();
}
