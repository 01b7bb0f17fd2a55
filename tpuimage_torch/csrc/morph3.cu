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
// Design: one block per (kTileW x kTileH) output tile of one image, with
// the tile and its halo in shared memory, so each input byte comes from
// device memory about once (the halo adds ~10%). The TPU kernels' byte
// packing of RGB into int32, lane rolls and VMEM residency gates have no
// use here. Borders are ops.morphology's constant ones: outside the image
// the erosion sees 255 and the dilation 0. Gray is OpenCV's Q15
// (r*9798 + g*19235 + b*3735 + 16384) >> 15. The threshold compare is in
// f32 with a strict '>', as threshold_binary makes it. All integer, so
// both kernels equal their plain versions bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void __launch_bounds__(kThreads)
binary_close3_kernel(const uint8_t* __restrict__ src,
                     const float* __restrict__ thresh,
                     uint8_t* __restrict__ binary, uint8_t* __restrict__ closed,
                     int h, int w) {
  constexpr int BW = kTileW + 4, BH = kTileH + 4;  // binary, 2-pixel halo
  constexpr int DW = kTileW + 2, DH = kTileH + 2;  // dilated, 1-pixel halo
  __shared__ uint8_t bin[BH][BW];
  __shared__ uint8_t dil[DH][DW];
  const int b = blockIdx.z;
  const float t = thresh[b];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const long long plane = (long long)b * h * w;
  for (int i = threadIdx.x; i < BH * BW; i += kThreads) {
    const int ly = i / BW, lx = i % BW;
    const int y = y0 - 2 + ly, x = x0 - 2 + lx;
    uint8_t v = 0;  // the dilation's border
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const long long off = plane + (long long)y * w + x;
      v = (float)src[off] > t ? 255 : 0;
      if (ly >= 2 && ly < kTileH + 2 && lx >= 2 && lx < kTileW + 2) binary[off] = v;
    }
    bin[ly][lx] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < DH * DW; i += kThreads) {
    const int ly = i / DW, lx = i % DW;
    const int y = y0 - 1 + ly, x = x0 - 1 + lx;
    uint8_t m = 255;  // the erosion's border
    if (y >= 0 && y < h && x >= 0 && x < w) {
      m = 0;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) m = max(m, bin[ly + dy][lx + dx]);
      }
    }
    dil[ly][lx] = m;
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
      for (int dx = 0; dx < 3; ++dx) m = min(m, dil[ly + dy][lx + dx]);
    }
    closed[plane + (long long)y * w + x] = m;
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
  if (batch > 65535 || (h + kTileH - 1) / kTileH > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  binary_close3_kernel<<<tile_grid(batch, h, w), kThreads, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const float*>(thresh),
      static_cast<uint8_t*>(binary), static_cast<uint8_t*>(closed), h, w);
  return (int)cudaGetLastError();
}
