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
// Semantics (the TPU kernel's): rank is the exclusive cumsum of the mask
// along each band, so within a band the masked ranks are 0, 1, 2, ... in
// position order and every slot k < count is written exactly once. Edges
// of rank >= kk are dropped (the lowest positions are kept); slots at or
// past a band's count are 0. The TPU kernel's masked sums over
// 512-position slabs, its slab padding and its rank-range pruning tables
// are means of the TPU's vector unit; on the card a scatter of each kept
// edge's position to its slot is the whole function. ci may have any
// strides: the wrapper lays it out band-major (each band's slots
// contiguous) where positions are the mask's fast axis, so that the slots
// a warp fills are one run of addresses.
//
// Bound on the H100: bytes. The function needs every mask byte once and
// the kk * nb int32 slots written once; because rank is the mask's
// exclusive cumsum, a design may derive the ranks from the mask and read
// rank only where a run of positions starts.
//
// Design. The first design (one thread per position and band, a 1-byte
// mask load and a 4-byte rank load each, 31,840-60,000 blocks of 256
// threads for DocScanner's planes, a slot-major output, and a zeroing
// launch in the wrapper) spent two thirds of its time on its grid alone.
// A first redesign with 16-byte loads and warp prefix sums but the
// slot-major output then spent most of its time on the scatter: with 8
// bands a slot row is one 32-byte sector, written 4 bytes at a time by 8
// warps, about one sector write an edge (PERF.md section 6). This one:
// - Vector form (positions contiguous, mask_sp == 1: compact_edges'
//   transposed page-major plane): a warp owns a chunk of 512 positions of
//   one band, 16 a lane, read with one 16-byte load where the 16 bytes lie
//   inside the band (vectors are cut at 16-byte addresses, so a band that
//   starts off a boundary, and its end, are read byte by byte). Lane 0
//   reads the rank of the chunk's first position once; each set byte's
//   rank is that plus the set bytes before it in the chunk (a popcount
//   and a warp prefix sum). The warp stages the chunk's positions in
//   shared memory in rank order and stores its kept slots as one
//   coalesced run. A warp a chunk, at most kBlocksPerSm blocks an SM.
// - Strided form (any other strides, as tpuimage's band-fast (N, 128)
//   layout, where positions are not contiguous and a 16-byte load would
//   span bands): the first design's thread per (position, band), lanes
//   along the mask's faster axis, the rank read for each set position,
//   on a 2-D grid of whole warps. A thread a run of 32 positions reading
//   the run's first rank once was 4x slower on tpuimage's layout (PERF.md
//   section 6).
// - Both write the zeros of slots [count, kk) themselves (count =
//   rank[n-1] + mask[n-1]), so the output needs no zeroing launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 32;   // the most blocks of a launch, per SM
constexpr int kChunk = 32 * 16;    // positions of a warp's chunk in the vector form
constexpr int kCountCache = 1024;  // bands whose counts a block keeps in shared memory

// 1 in bit i for each nonzero byte i of w (a bool is 0 or 1, but any
// nonzero byte counts as set, as a bool load would read it)
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  const uint32_t hi = ((((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u) >> 7;
  return (hi * 0x01020408u) >> 24;   // bytes' low bits gathered into bits 0..3
}

struct Plane {
  const int32_t* rank;
  const uint8_t* mask;
  int32_t* ci;
  long long n, nb, rank_sp, rank_sb, mask_sp, mask_sb, ci_sk, ci_sb;
  int kk;
};

__device__ __forceinline__ int band_count(const Plane& q, long long b) {
  return q.rank[(q.n - 1) * q.rank_sp + b * q.rank_sb] +
         (q.mask[(q.n - 1) * q.mask_sp + b * q.mask_sb] != 0);
}

// slots [count_b, kk) of every band b: 0, neighbouring threads on
// neighbouring addresses: a thread a slot of every band where ci is
// band-major, a slot row's bands side by side where it is slot-major. A
// block with slots to clear reads the counts once into shared memory where
// they fit (the others return at once). Every thread of the block calls
// this.
__device__ __forceinline__ void zero_tail(const Plane& q) {
  __shared__ int s_count[kCountCache];
  // the block's and the thread's linear indices (the strided form's are 2-D)
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, threads = blockDim.x * blockDim.y;
  const long long first = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * threads;
  const long long stride = (long long)gridDim.x * gridDim.y * threads;
  const bool band_major = q.ci_sk == 1;
  const long long total = (long long)q.kk * q.nb, work = band_major ? q.kk : total;
  if (first >= work) return;   // the whole block
  const bool cached = q.nb <= kCountCache;
  if (cached) {
    for (int b = tid; b < q.nb; b += threads) s_count[b] = band_count(q, b);
    __syncthreads();
  }
  if (band_major) {
    for (long long k = first + tid; k < q.kk; k += stride)
      for (long long b = 0; b < q.nb; ++b)
        if (k >= (cached ? s_count[b] : band_count(q, b))) q.ci[k + b * q.ci_sb] = 0;
  } else {
    for (long long i = first + tid; i < total; i += stride) {
      const long long k = i / q.nb, b = i - k * q.nb;
      if (k >= (cached ? s_count[b] : band_count(q, b))) q.ci[k * q.ci_sk + b * q.ci_sb] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads) rank_extract_vec(Plane q, long long chunks) {
  __shared__ int32_t stage[kWarps][kChunk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* st = stage[warp];
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long u = (long long)blockIdx.x * kWarps + warp; u < q.nb * chunks; u += warps) {
    const long long b = u / chunks, c = u - b * chunks;
    const uint8_t* band = q.mask + b * q.mask_sb;
    const int shift = (int)(reinterpret_cast<uintptr_t>(band) & 15u);
    const long long first = c * kChunk - shift;      // position of the chunk's first byte
    const long long p0 = first > 0 ? first : 0;
    if (p0 >= q.n) continue;                          // uniform across the warp
    int base = 0;
    if (lane == 0) base = q.rank[p0 * q.rank_sp + b * q.rank_sb];
    const long long ps = first + 16LL * lane;         // this lane's 16 positions
    uint32_t bits = 0;
    if (ps >= 0 && ps + 16 <= q.n) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(band + ps));
      bits = nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 | nonzero_bytes(v.z) << 8 |
             nonzero_bytes(v.w) << 12;
    } else {
      for (int j = 0; j < 16; ++j) {
        const long long p = ps + j;
        if (p >= 0 && p < q.n && band[p] != 0) bits |= 1u << j;
      }
    }
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    base = __shfl_sync(0xffffffffu, base, 0);
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    const int kept = min(total, q.kk - base);         // slots [base, base + kept)
    if (kept <= 0) continue;                          // uniform
    for (int k = incl - cnt; bits != 0; ++k) {
      st[k] = (int32_t)(ps + __ffs(bits) - 1);
      bits &= bits - 1;
    }
    __syncwarp();
    for (int i = lane; i < kept; i += 32) q.ci[(base + i) * q.ci_sk + b * q.ci_sb] = st[i];
    __syncwarp();
  }
  zero_tail(q);
}

// a thread a (position, band), lanes along the mask's faster axis
__global__ void __launch_bounds__(kThreads) rank_extract_strided(Plane q, bool pos_fast) {
  const long long n_fast = pos_fast ? q.n : q.nb, n_slow = pos_fast ? q.nb : q.n;
  const long long f = (long long)blockIdx.x * 32 + threadIdx.x;
  for (long long sl = (long long)blockIdx.y * (kThreads / 32) + threadIdx.y;
       f < n_fast && sl < n_slow; sl += (long long)gridDim.y * (kThreads / 32)) {
    const long long p = pos_fast ? f : sl, b = pos_fast ? sl : f;
    if (q.mask[p * q.mask_sp + b * q.mask_sb] == 0) continue;
    const int r = q.rank[p * q.rank_sp + b * q.rank_sb];
    if (r < q.kk) q.ci[r * q.ci_sk + b * q.ci_sb] = (int32_t)p;
  }
  zero_tail(q);
}

}  // namespace

// rank: (n, nb) int32 with element strides (rank_sp, rank_sb), the mask's
// exclusive cumsum along each band; mask: (n, nb) bool with strides
// (mask_sp, mask_sb); ci: (kk, nb) int32 with strides (ci_sk, ci_sb), every
// slot written (no zeroing needed). Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int tpuimage_rank_extract(const void* rank, const void* mask, void* ci,
                                     long long n, long long nb, long long rank_sp,
                                     long long rank_sb, long long mask_sp, long long mask_sb,
                                     long long ci_sk, long long ci_sb, int kk, void* stream) {
  if (n <= 0 || nb <= 0 || kk <= 0) return 0;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Plane q = {static_cast<const int32_t*>(rank), static_cast<const uint8_t*>(mask),
                   static_cast<int32_t*>(ci), n, nb, rank_sp, rank_sb, mask_sp, mask_sb,
                   ci_sk, ci_sb, kk};
  const long long cap = (long long)sms * kBlocksPerSm;
  if (mask_sp == 1) {
    // + 1: a band that starts off a 16-byte boundary spills into one more chunk
    const long long chunks = (n + kChunk - 1) / kChunk + 1;
    const long long want = (nb * chunks + kWarps - 1) / kWarps;
    rank_extract_vec<<<(unsigned)(want < cap ? want : cap), kThreads, 0, s>>>(q, chunks);
  } else {
    const bool pos_fast = mask_sp <= mask_sb;
    const long long n_fast = pos_fast ? n : nb, n_slow = pos_fast ? nb : n;
    const long long gx = (n_fast + 31) / 32, gy = (n_slow + kThreads / 32 - 1) / (kThreads / 32);
    if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)gx, (unsigned)(gy < 65535 ? gy : 65535));
    rank_extract_strided<<<grid, dim3(32, kThreads / 32), 0, s>>>(q, pos_fast);
  }
  return (int)cudaGetLastError();
}
