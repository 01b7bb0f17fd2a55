// Sort-free edge compaction: from a plane of N positions x nb bands, each
// position's exclusive edge rank within its band and the edge mask, write
// ci[k, b] = the position of band b's k-th edge, for k < kk.
//
// Replaces: tpuimage/ops/pallas_kernels.py rank_extract_pallas, the
// extraction step of tpuimage.ops.hough.band_compact_coords(impl="rank").
// In the port it compacts DocScanner's Canny edge maps for the Hough votes
// (ops/hough.py compact_edges: localize and deskew), with each page's flat
// plane as one band.
//
// Semantics (the TPU kernel's): ranks come from an exclusive cumsum of the
// mask along each band, so within a band the masked ranks are 0, 1, 2, ...
// in position order and every slot k < count is written exactly once.
// Edges of rank >= kk are dropped (the lowest positions are kept); slots at
// or past a band's count keep the zeros the caller's output starts with.
// The TPU kernel's masked sums over 512-position slabs, its slab padding
// and its rank-range pruning tables are means of the TPU's vector unit; on
// the card a scatter of each kept edge's position to its slot is the whole
// function.
//
// Bound on the H100: bytes. Every mask byte is read once, the rank of each
// set position once (4 bytes), and kk * nb int32 slots written once.
//
// Design: one thread per (position, band), threads along whichever axis of
// the plane has the smaller stride (positions for DocScanner's page-major
// plane, bands for the TPU's position-major layout), so that a warp's mask
// loads are coalesced; the other axis is the grid's y (grid-stride past
// 65535). The strides are in elements, so any view of the plane (a
// transposed page-major one, say) goes in without a copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rank_extract_kernel(const int32_t* __restrict__ rank, const bool* __restrict__ mask,
                    int32_t* __restrict__ ci, long long n_fast, long long n_slow,
                    long long rank_fast, long long rank_slow, long long mask_fast,
                    long long mask_slow, bool pos_fast, long long nb, int kk) {
  const long long f = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (f >= n_fast) return;
  for (long long s = blockIdx.y; s < n_slow; s += gridDim.y) {
    if (!mask[f * mask_fast + s * mask_slow]) continue;
    const int32_t r = rank[f * rank_fast + s * rank_slow];
    if (r < 0 || r >= kk) continue;
    const long long p = pos_fast ? f : s;
    const long long b = pos_fast ? s : f;
    ci[(long long)r * nb + b] = (int32_t)p;
  }
}

}  // namespace

// rank: (n, nb) int32 with element strides (rank_sp, rank_sb); mask: (n, nb)
// bool with strides (mask_sp, mask_sb); ci: (kk, nb) int32, contiguous,
// zeroed by the caller. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int tpuimage_rank_extract(const void* rank, const void* mask, void* ci,
                                     long long n, long long nb, long long rank_sp,
                                     long long rank_sb, long long mask_sp,
                                     long long mask_sb, int kk, void* stream) {
  if (n <= 0 || nb <= 0 || kk <= 0) return 0;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool pos_fast = mask_sp <= mask_sb;
  const long long n_fast = pos_fast ? n : nb;
  const long long n_slow = pos_fast ? nb : n;
  const long long blocks_x = (n_fast + kThreads - 1) / kThreads;
  if (blocks_x > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks_y = (unsigned)(n_slow < 65535 ? n_slow : 65535);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  rank_extract_kernel<<<dim3((unsigned)blocks_x, blocks_y), kThreads, 0, s>>>(
      static_cast<const int32_t*>(rank), static_cast<const bool*>(mask),
      static_cast<int32_t*>(ci), n_fast, n_slow, pos_fast ? rank_sp : rank_sb,
      pos_fast ? rank_sb : rank_sp, pos_fast ? mask_sp : mask_sb,
      pos_fast ? mask_sb : mask_sp, pos_fast, nb, kk);
  return (int)cudaGetLastError();
}
