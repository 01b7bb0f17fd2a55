// CLAHE apply: the per-pixel bilinear blend of the four neighbouring tile
// LUTs. gray (B, H, W) u8, luts (B, ty, tx, 256) u8, R (H, ty) f32,
// C (tx, W) f32 -> (B, H, W) u8.
//
// Replaces: tpuimage/ops/pallas_kernels.py clahe_apply_pallas (body
// _make_clahe_slab_kernel), the TPU kernel behind tpuimage.ops.histogram.clahe
// on the night paths.
//
// Bound on the H100: memory. Each pixel reads 1 byte and writes 1; the
// work is 4 shared-memory byte lookups and 6 multiplies and 3 adds.
//
// Design: R and C are tpuimage's static blend matrices (clahe_blend_matrix):
// each row of R and each column of C has at most two nonzero weights, on
// adjacent tiles. The TPU kernel contracts one-hot value rows against LUT
// slabs on its matrix unit; here the image's whole LUT table (ty*tx*256
// bytes, 16 KiB for 8x8 tiles) sits in shared memory and each pixel looks
// its four values up directly. A block covers kThreads columns and kRows
// rows of one image: each thread finds its column's tile pair and weights
// in C once, the block's row pairs from R sit in shared memory, and the
// thread walks down its column. A pair is (first tile with a nonzero
// weight, the next tile or the same one at the last tile); the second
// weight is 0 when both are the same tile, so at the borders the blend
// matrix's own summed weight is used, as the matrix product uses it. The
// products and sums are spelled __fmul_rn / __fadd_rn in the plain
// version's order (rows first, then columns), which nvcc never contracts
// into an fma, so the kernel equals its plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;
constexpr int kBins = 256;

// The tile pair of one row of R (stride 1) or one column of C (stride W).
__device__ __forceinline__ void blend_pair(const float* __restrict__ m,
                                           long long stride, int n, int* t1,
                                           int* t2, float* w1, float* w2) {
  int first = 0;
  for (int a = n - 1; a >= 0; --a) {
    if (m[a * stride] != 0.0f) first = a;
  }
  const int second = min(first + 1, n - 1);
  *t1 = first;
  *t2 = second;
  *w1 = m[first * stride];
  *w2 = second != first ? m[second * stride] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
clahe_apply_kernel(const uint8_t* __restrict__ gray,
                   const uint8_t* __restrict__ luts,
                   const float* __restrict__ R, const float* __restrict__ C,
                   uint8_t* __restrict__ out, int h, int w, int ty, int tx) {
  extern __shared__ uint4 lut_s16[];
  const uint8_t* lut_s = reinterpret_cast<const uint8_t*>(lut_s16);
  __shared__ int row_t1[kRows], row_t2[kRows];
  __shared__ float row_w1[kRows], row_w2[kRows];

  const int b = blockIdx.z;
  const int n16 = ty * tx * kBins / 16;
  const uint4* lut_g =
      reinterpret_cast<const uint4*>(luts) + (long long)b * n16;
  for (int i = threadIdx.x; i < n16; i += kThreads) lut_s16[i] = __ldg(lut_g + i);
  const int y0 = blockIdx.y * kRows;
  const int rows = min(kRows, h - y0);
  if (threadIdx.x < rows) {
    const int i = threadIdx.x;
    blend_pair(R + (long long)(y0 + i) * ty, 1, ty, &row_t1[i], &row_t2[i],
               &row_w1[i], &row_w2[i]);
  }
  __syncthreads();

  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= w) return;
  int c1, c2;
  float wc1, wc2;
  blend_pair(C + x, w, tx, &c1, &c2, &wc1, &wc2);
  long long off = ((long long)b * h + y0) * w + x;
  for (int i = 0; i < rows; ++i, off += w) {
    const int v = gray[off];
    const int r1 = row_t1[i] * tx, r2 = row_t2[i] * tx;
    const float wr1 = row_w1[i], wr2 = row_w2[i];
    const float l11 = lut_s[(r1 + c1) * kBins + v];
    const float l21 = lut_s[(r2 + c1) * kBins + v];
    const float l12 = lut_s[(r1 + c2) * kBins + v];
    const float l22 = lut_s[(r2 + c2) * kBins + v];
    const float in1 = __fadd_rn(__fmul_rn(l11, wr1), __fmul_rn(l21, wr2));
    const float in2 = __fadd_rn(__fmul_rn(l12, wr1), __fmul_rn(l22, wr2));
    const float res = __fadd_rn(__fmul_rn(in1, wc1), __fmul_rn(in2, wc2));
    out[off] = (uint8_t)min(max(__float2int_rn(res), 0), 255);
  }
}

}  // namespace

// luts must be 16-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int tpuimage_clahe_apply(const void* gray, const void* luts,
                                    const void* R, const void* C, void* out,
                                    int batch, int h, int w, int ty, int tx,
                                    void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (batch > 65535 || ty <= 0 || tx <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ty * tx * kBins;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        clahe_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((w + kThreads - 1) / kThreads),
                  (unsigned)((h + kRows - 1) / kRows), (unsigned)batch);
  clahe_apply_kernel<<<grid, kThreads, smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(gray), static_cast<const uint8_t*>(luts),
      static_cast<const float*>(R), static_cast<const float*>(C),
      static_cast<uint8_t*>(out), h, w, ty, tx);
  return (int)cudaGetLastError();
}
