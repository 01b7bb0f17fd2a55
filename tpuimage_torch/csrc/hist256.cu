// 256-bin histograms of a batch of uint8 rows: (B, N) u8 -> (B, 256) i32.
//
// Replaces: tpuimage/ops/pallas_kernels.py hist256_batch_pallas (body
// _make_hist_kernel), the TPU kernel behind tpuimage.ops.histogram.hist256
// that serves DocScanner's Otsu pair (the sub_raw and blackhat planes).
//
// Bound on the H100: memory. The kernel reads 1 byte per pixel and writes
// 1 KiB per image, so the floor is N*B bytes at HBM bandwidth. The hazard
// is the data: DocScanner's planes are nearly one-valued (sub_raw and
// blackhat are mostly 0), so a plain shared-memory histogram serialises
// its atomics on one bin.
//
// Design: grid (blocks_per_image, B). Each thread loads 16 bytes at a time
// (uint4, coalesced) and, per byte, the warp first aggregates equal values
// with __match_any_sync so only one lane per distinct value issues a
// shared atomicAdd of the peer count. Each warp owns its own 256-bin
// sub-histogram in shared memory (no contention between warps); at the end
// the block sums its 8 sub-histograms and merges non-zero bins into the
// output with global atomicAdd. Integer atomics keep the counts exact in
// any order. Rows whose length is not a multiple of 16, or whose base is
// not 16-byte aligned, take the byte-load variant of the same kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr unsigned kNone = kBins;  // "no pixel" value for idle lanes

__device__ __forceinline__ void warp_add(unsigned v, unsigned* warp_hist,
                                         int lane) {
  // every lane of the warp calls this; lanes holding equal values vote once
  const unsigned peers = __match_any_sync(0xffffffffu, v);
  if (v != kNone && lane == __ffs(peers) - 1) {
    atomicAdd(&warp_hist[v], (unsigned)__popc(peers));
  }
}

template <bool kVec16>
__global__ void __launch_bounds__(kThreads)
hist256_kernel(const uint8_t* __restrict__ src, int32_t* __restrict__ out,
               long long n) {
  __shared__ unsigned hist[kWarps * kBins];
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) hist[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  unsigned* warp_hist = hist + (threadIdx.x >> 5) * kBins;
  const uint8_t* row = src + (long long)blockIdx.y * n;
  const long long stride = (long long)gridDim.x * kThreads;

  if (kVec16) {
    const uint4* row16 = reinterpret_cast<const uint4*>(row);
    const long long n16 = n / 16;
    // the loop bound is uniform across the block, so whole warps iterate
    // together, as __match_any_sync requires
    for (long long base = (long long)blockIdx.x * kThreads; base < n16;
         base += stride) {
      const long long i = base + threadIdx.x;
      const bool ok = i < n16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ok) v = __ldg(row16 + i);
      const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          warp_add(ok ? (words[w] >> (8 * b)) & 0xffu : kNone, warp_hist,
                   lane);
        }
      }
    }
  } else {
    for (long long base = (long long)blockIdx.x * kThreads; base < n;
         base += stride) {
      const long long i = base + threadIdx.x;
      warp_add(i < n ? (unsigned)row[i] : kNone, warp_hist, lane);
    }
  }
  __syncthreads();

  for (int bin = threadIdx.x; bin < kBins; bin += kThreads) {
    unsigned s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += hist[w * kBins + bin];
    if (s) atomicAdd(&out[(long long)blockIdx.y * kBins + bin], (int32_t)s);
  }
}

}  // namespace

// out must be zeroed by the caller. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int tpuimage_hist256(const void* src, void* out, long long batch,
                                long long n, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool vec16 =
      (n % 16 == 0) && (reinterpret_cast<uintptr_t>(src) % 16 == 0);
  const long long items = vec16 ? n / 16 : n;
  // about 4 resident blocks per SM over the whole batch, never more blocks
  // than a row has thread-loads
  long long per_image = (4LL * sms + batch - 1) / batch;
  const long long needed = (items + kThreads - 1) / kThreads;
  if (per_image > needed) per_image = needed;
  if (per_image < 1) per_image = 1;
  const dim3 grid((unsigned)per_image, (unsigned)batch);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  int32_t* o = static_cast<int32_t*>(out);
  if (vec16) {
    hist256_kernel<true><<<grid, kThreads, 0, s>>>(in, o, n);
  } else {
    hist256_kernel<false><<<grid, kThreads, 0, s>>>(in, o, n);
  }
  return (int)cudaGetLastError();
}
