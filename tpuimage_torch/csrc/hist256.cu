// 256-bin histograms of a batch of uint8 rows: (B, N) u8 -> (B, 256) i32.
//
// Replaces: tpuimage/ops/pallas_kernels.py hist256_batch_pallas (body
// _make_hist_kernel), the TPU kernel behind tpuimage.ops.histogram.hist256
// that serves DocScanner's Otsu pair (the sub_raw and blackhat planes),
// CLAHE's tile histograms and morph_seq's Otsu.
//
// Bound on the H100: memory. The kernel reads 1 byte per pixel and writes
// 1 KiB per row, so the floor is N*B bytes at HBM bandwidth. The hazard is
// the data: DocScanner's planes are nearly one-valued (sub_raw and blackhat
// are mostly 0), so a warp's 32 increments often land on one bin.
//
// Design: one thread block cluster of C blocks per row (C = 1 for short
// rows such as CLAHE's tiles, up to 8 for whole planes), grid (C, B), 512
// threads a block, one launch and nothing else: the kernel writes every
// count itself, so the output needs no zeroing launch.
// - Each warp owns a 256-bin sub-histogram in shared memory. Every byte is
//   one plain shared increment: nvcc compiles an atomicAdd of 1 to
//   ATOMS.POPC.INC, which merges a warp's equal bins in hardware, so
//   software aggregation (__match_any_sync, which the first version issued
//   16 times a 16-byte load) only adds work.
// - The row's 16-byte-aligned body is read as uint4, kUnroll loads in
//   flight a thread; the < 16 bytes before and after it (rows that start
//   off a boundary, lengths not a multiple of 16) are counted byte by byte
//   by block 0 of the cluster.
// - The block folds its warps' copies into one; after a cluster barrier
//   each block sums a slice of the bins over the cluster's blocks through
//   distributed shared memory and stores it: no global atomics, no memset.
//   A second barrier keeps every block's shared memory alive until read.
// - The SM count that sizes the grid is read once per device.
// Measured (tools/time_kernel_builds.py, H100 at 700 W, 20 eager calls each
// after a zeroing launch, five runs): 0.018-0.020 ms on DocScanner's 18 A4
// rows, 0.012-0.015 on 512 CLAHE tile rows, 0.013-0.019 on 8 eroded planes,
// where the first design took 0.069-0.075 / 0.030-0.031 / 0.057-0.058. That
// design without __match_any_sync took 0.012-0.019 / 0.016-0.019 /
// 0.012-0.018: the aggregation was its whole cost, but it still needs the
// zeroing launch. In this one, one shared copy a block, 256 or 1024
// threads, clusters of 16 and 1 or 8 loads in flight land within 10% but
// for one reading of clusters of 16 (-19%, not repeated); one block a row
// (no cluster) is 2.8-3.9x slower on whole planes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kUnroll = 4;       // 16-byte loads in flight a thread
constexpr int kMaxCluster = 8;   // blocks a row: the portable cluster size

__device__ __forceinline__ void count_word(uint32_t w, unsigned* hist) {
#pragma unroll
  for (int b = 0; b < 4; ++b) atomicAdd(&hist[(w >> (8 * b)) & 0xffu], 1u);
}

__global__ void __launch_bounds__(kThreads)
hist256_kernel(const uint8_t* __restrict__ src, int32_t* __restrict__ out, long long n) {
  __shared__ unsigned hist[kWarps * kBins];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), blocks = cluster.num_blocks();
  const int tid = threadIdx.x;
  for (int i = tid; i < kWarps * kBins; i += kThreads) hist[i] = 0;
  __syncthreads();

  unsigned* warp_hist = hist + (tid >> 5) * kBins;
  const uint8_t* row = src + (long long)blockIdx.y * n;
  const long long head =
      min(n, (long long)((16 - (reinterpret_cast<uintptr_t>(row) & 15u)) & 15u));
  const long long n16 = (n - head) / 16, body_end = head + 16 * n16;
  if (rank == 0 && tid < 32) {
    if (tid < head) atomicAdd(&warp_hist[row[tid]], 1u);
    if (body_end + tid < n) atomicAdd(&warp_hist[row[body_end + tid]], 1u);
  }
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  const long long stride = (long long)blocks * kThreads;
  for (long long i0 = (long long)rank * kThreads + tid; i0 < n16; i0 += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * stride < n16) v[u] = __ldg(body + i0 + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * stride < n16) {
        count_word(v[u].x, warp_hist);
        count_word(v[u].y, warp_hist);
        count_word(v[u].z, warp_hist);
        count_word(v[u].w, warp_hist);
      }
    }
  }
  __syncthreads();
  for (int bin = tid; bin < kBins; bin += kThreads) {
    unsigned s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += hist[w * kBins + bin];
    hist[bin] = s;
  }
  cluster.sync();
  const int per_block = kBins / (int)blocks;
  for (int i = tid; i < per_block; i += kThreads) {
    const int bin = (int)rank * per_block + i;
    unsigned s = 0;
    for (unsigned r = 0; r < blocks; ++r) s += *cluster.map_shared_rank(&hist[bin], r);
    out[(long long)blockIdx.y * kBins + bin] = (int32_t)s;
  }
  cluster.sync();
}

}  // namespace

// Writes all B x 256 counts (no zeroing needed). Returns the launch's CUDA
// error (0 on success).
extern "C" int tpuimage_hist256(const void* src, void* out, long long batch,
                                long long n, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // about two blocks an SM over the batch, and at least two rounds of
  // loads a thread in each block
  const long long want = (2LL * sms + batch - 1) / batch;
  const long long n16 = n / 16;
  unsigned c = 1;
  while ((int)c < kMaxCluster && c < want && 2LL * c * kThreads * kUnroll <= n16) c *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, (unsigned)batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, hist256_kernel, static_cast<const uint8_t*>(src),
                                           static_cast<int32_t*>(out), n);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
