// Hough line vote accumulators over per-image edge coordinate lists:
// (B, K) i32 x/y + (B,) i32 counts + (T,) f32 cos/sin -> (B, numrho, T) i32.
//
// Replaces: tpuimage/ops/pallas_kernels.py hough_votes_pallas (body
// _make_hough_kernel), the TPU kernel behind
// tpuimage.ops.hough.hough_accumulator. It serves DocScanner's deskew
// (HoughLines, threshold 150, over the binarised A4 page) and localize's
// deterministic HoughLinesP (threshold 80, over the whole photo).
//
// Bound on the H100: shared-memory atomics. Each edge casts one vote per
// theta (180 per edge); the coordinate lists (8 bytes per edge) are read
// once per theta group and stay in L2. Collinear edges along one text row
// hit the same rho bin for thetas near 90 degrees, so those atomics
// serialise within a warp.
//
// Design: one block per (group of kThetas thetas, image). The group's rho
// rows live in dynamic shared memory (kThetas * numrho * 4 bytes: 64 KiB
// for an A4 page, 88 KiB for a 1600x1200 photo), zeroed, voted into with
// shared integer atomicAdd (exact in any order), then written out once.
// The TPU kernel's band layout, poisoned slots, rho windows and one-hot
// MXU contraction are TPU devices and are not carried over.
//
// Rounding: the rho of an edge must match tpuimage bit for bit. Its XLA
// path computes rint(fma(x, cos, f32(y * sin))), so the kernel spells that
// form with explicit round-to-nearest intrinsics, which nvcc never
// contracts or reorders: __float2int_rn(__fmaf_rn(x, c, __fmul_rn(y, s))).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kThetas = 4;

__global__ void __launch_bounds__(kThreads)
hough_votes_kernel(const int32_t* __restrict__ xs,
                   const int32_t* __restrict__ ys,
                   const int32_t* __restrict__ counts,
                   const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, int32_t* __restrict__ out,
                   int k, int numrho, int n_theta, int shift) {
  extern __shared__ int acc[];  // [kThetas][numrho]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kThetas;
  const int nt = min(kThetas, n_theta - t0);
  for (int i = threadIdx.x; i < kThetas * numrho; i += kThreads) acc[i] = 0;

  float c[kThetas], s[kThetas];
#pragma unroll
  for (int j = 0; j < kThetas; ++j) {
    c[j] = j < nt ? cos_t[t0 + j] : 0.f;
    s[j] = j < nt ? sin_t[t0 + j] : 0.f;
  }
  const int count = min(counts[b], k);
  const int32_t* xb = xs + (long long)b * k;
  const int32_t* yb = ys + (long long)b * k;
  __syncthreads();

  for (int e = threadIdx.x; e < count; e += kThreads) {
    const float x = (float)__ldg(xb + e);
    const float y = (float)__ldg(yb + e);
#pragma unroll
    for (int j = 0; j < kThetas; ++j) {
      const int r = __float2int_rn(__fmaf_rn(x, c[j], __fmul_rn(y, s[j]))) + shift;
      if (j < nt && (unsigned)r < (unsigned)numrho) atomicAdd(&acc[j * numrho + r], 1);
    }
  }
  __syncthreads();

  // out[b, r, t0 + j]: consecutive threads write consecutive thetas of a row
  int32_t* ob = out + (long long)b * numrho * n_theta;
  for (int i = threadIdx.x; i < nt * numrho; i += kThreads) {
    const int r = i / nt, j = i - r * nt;
    ob[(long long)r * n_theta + t0 + j] = acc[j * numrho + r];
  }
}

}  // namespace

// Every (rho, theta) entry of out is written. Returns cudaGetLastError()
// after the launch (0 on success); cudaErrorInvalidValue when the theta
// group's rho rows do not fit in shared memory.
extern "C" int tpuimage_hough_votes(const void* xs, const void* ys,
                                    const void* counts, const void* cos_t,
                                    const void* sin_t, void* out, int batch,
                                    int k, int numrho, int n_theta, int shift,
                                    void* stream) {
  if (batch <= 0 || n_theta <= 0) return 0;
  if (batch > 65535 || numrho <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t smem = (size_t)kThetas * numrho * sizeof(int);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hough_votes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n_theta + kThetas - 1) / kThetas),
                  (unsigned)batch);
  hough_votes_kernel<<<grid, kThreads, smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<const int32_t*>(ys),
      static_cast<const int32_t*>(counts), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<int32_t*>(out), k, numrho,
      n_theta, shift);
  return (int)cudaGetLastError();
}
