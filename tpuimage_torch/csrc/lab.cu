// RGB -> Lab, OpenCV's 8-bit fixed-point path: (P, 3) u8 -> (P, 3) u8.
//
// Replaces: tpuimage/ops/pallas_kernels.py rgb_to_lab_pallas (body
// _make_lab_kernel), the TPU kernel behind tpuimage.ops.color.rgb_to_lab on
// the night RGB path (benchmarks/micro_lab_kernel.py times a variant of the
// same function).
//
// Bound on the H100: memory. Each pixel reads 3 bytes and writes 3; the
// work per pixel is 6 table lookups and about 25 integer operations.
//
// Design: the TPU kernel turns each lookup into byte-split one-hot matrix
// products because the TPU has no fast gather; Hopper has one, in shared
// memory. Each block stages the 256-entry sRGB gamma table and the
// 3072-entry cube-root table (13 KiB of int32) into shared memory once and
// then walks the pixels of the whole batch in a grid-stride loop, so a few
// blocks per SM amortise the staging. The indices are data-dependent, which
// is why the tables are not in __constant__ memory: there a warp's distinct
// addresses are served one after another. All arithmetic is integer, so the
// result equals tpuimage's gather form bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGammaN = 256;
constexpr int kCbrtN = 3072;
constexpr int kShift = 12;   // _LAB_SHIFT
constexpr int kShift2 = 15;  // _LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
constexpr int kLScale = (116 * 255 + 50) / 100;                  // 296
constexpr int kLShift = -((16 * 255 * (1 << kShift2) + 50) / 100);

__device__ __forceinline__ int descale(int x, int n) {
  return (x + (1 << (n - 1))) >> n;
}

__device__ __forceinline__ uint8_t sat_u8(int x) {
  return (uint8_t)min(max(x, 0), 255);
}

// tables: gamma (256) | cube root (3072) | sRGB->XYZ coefficients (3x3,
// row-major, X and Z rows scaled by the D65 white point), all int32.
__global__ void __launch_bounds__(kThreads)
rgb_to_lab_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                  const int32_t* __restrict__ tables, long long n_pix) {
  __shared__ int gamma[kGammaN];
  __shared__ int cbrt[kCbrtN];
  for (int i = threadIdx.x; i < kGammaN; i += kThreads) gamma[i] = tables[i];
  for (int i = threadIdx.x; i < kCbrtN; i += kThreads) {
    cbrt[i] = tables[kGammaN + i];
  }
  int coef[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) coef[k] = __ldg(tables + kGammaN + kCbrtN + k);
  __syncthreads();

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < n_pix;
       p += stride) {
    const uint8_t* s = src + 3 * p;
    const int r = gamma[s[0]], g = gamma[s[1]], b = gamma[s[2]];
    int f[3];
#pragma unroll
    for (int row = 0; row < 3; ++row) {
      int idx = descale(r * coef[3 * row] + g * coef[3 * row + 1] +
                            b * coef[3 * row + 2],
                        kShift);
      f[row] = cbrt[min(max(idx, 0), kCbrtN - 1)];
    }
    uint8_t* d = dst + 3 * p;
    d[0] = sat_u8(descale(kLScale * f[1] + kLShift, kShift2));
    d[1] = sat_u8(descale(500 * (f[0] - f[1]) + (128 << kShift2), kShift2));
    d[2] = sat_u8(descale(200 * (f[1] - f[2]) + (128 << kShift2), kShift2));
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tpuimage_rgb_to_lab(const void* src, void* dst,
                                   const void* tables, long long n_pix,
                                   void* stream) {
  if (n_pix <= 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // about 8 resident blocks per SM, never more blocks than pixels need
  long long blocks = 8LL * sms;
  const long long needed = (n_pix + kThreads - 1) / kThreads;
  if (blocks > needed) blocks = needed;
  rgb_to_lab_kernel<<<(unsigned)blocks, kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      static_cast<const int32_t*>(tables), n_pix);
  return (int)cudaGetLastError();
}
