// Hough line vote accumulators over per-image edge coordinate lists:
// (B, K) i32 x/y + (B,) i32 counts + (T,) f32 cos/sin -> (B, numrho, T) i32.
//
// Replaces: tpuimage/ops/pallas_kernels.py hough_votes_pallas (body
// _make_hough_kernel), the TPU kernel behind
// tpuimage.ops.hough.hough_accumulator. It serves DocScanner's deskew
// (HoughLines, threshold 150, over the binarised A4 page) and localize's
// deterministic HoughLinesP (threshold 80, over the whole photo).
//
// Bound on the H100: by count, 4 operations per vote (one vote per edge and
// theta) or the accumulators' bytes written once. What sets the time in
// practice, measured on the card by taking parts of the kernel away: the
// seven instructions of a vote (the rho's multiply, fused multiply-add and
// conversion; the bias and clamp; the address; the atomic) and the number
// of different bins among a warp's 32 votes (a list of random coordinates
// takes 13% longer than a text page's, a page of whole rows of edges 20%
// less). For an increment of 1 the compiler emits ATOMS.POPC.INC, which
// merges the lanes of a warp that hit one bin in hardware; lanes that hit
// different bins cost the same whether or not they share a bank (forcing
// every lane into its own bank changed nothing), and a vote of six
// instructions (the conversion as a magic-number add, folded into the
// index) ran no faster than seven. A compare and a branch around each
// atomic cost a third of the kernel's time, and re-reading the coordinate
// lists once per four thetas made the first design wait on L2.
//
// Design.
// - One wave, evenly loaded. The grid is one block of 1024 threads per SM.
//   Every block reads all the counts and gives each image a share of the
//   blocks in proportion to its edges (at least ceil(T / 32) each, so that
//   a block never has more than 32 thetas), then takes its own slice of its
//   image's thetas: 8 A4 pages of 113-139 k edges get 15 to 17 blocks each,
//   10 to 12 thetas a block, and a page with no edges 6 blocks that only
//   write zeros. A batch too large for that gets ceil(T / 32) blocks an
//   image, in several waves.
// - A block keeps its thetas' rho rows in shared memory, zeroes them, votes,
//   and writes them out once; every entry of out is written by exactly one
//   block, so nothing has to zero out first. Where the whole rows of a
//   block's thetas do not fit (a 1600x1200 photo: 5601 bins a theta), a
//   row is kept only over the bins its edges can reach: the block reduces
//   the list's bounding box, and because rho is monotone in x and in y for a
//   fixed theta (every step is a correctly rounded, monotone operation) the
//   box's four corners give the exact lowest and highest bin, about 2000
//   bins for the photo. Should even the windows not fit, the block takes
//   its thetas in rounds, as many at a time as fit.
// - A thread holds kEdges = 8 edges in registers and walks the round's
//   thetas over them: the lists are read once per round, and a theta's
//   table entry is one broadcast shared load per 8 votes.
// - No branch per vote: behind a row's bins lies one more slot, and the
//   index is clamped to it (an unsigned min), so a vote outside the window
//   or of a lane past the end of the list lands there and every atomic is
//   unconditional.
// - Write-out: 16 lanes per rho row, each storing one theta of out[b, r,
//   t0 : t0 + n], so a block with 10 to 12 thetas writes 40 to 48
//   consecutive bytes per row (zeros outside the window).
// Aggregating a warp's equal bins in software before the atomic (shuffle,
// ballot, one add per run head) was built and measured: it lost at every
// width of the theta band it was given (1.3x slower for 5 thetas around 90
// degrees, 2.0x for 23), because POPC.INC already merges them and a shuffle
// costs the shared-memory pipe what a vote does. Keep the increment the
// literal 1: with a run-time increment the compiler emits a plain ATOMS.ADD,
// which serialises equal bins (2.7x slower on text pages, 5.8x on whole
// rows). The TPU kernel's band layout, poisoned slots and one-hot MXU
// contraction are TPU devices and are not carried over; its
// rho windows are, in this data-derived form.
//
// Rounding: the rho of an edge must match tpuimage bit for bit. Its XLA
// path computes rint(fma(x, cos, f32(y * sin))), so the kernel spells that
// form with explicit round-to-nearest intrinsics, which nvcc never
// contracts or reorders: __float2int_rn(__fmaf_rn(x, c, __fmul_rn(y, s))).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kEdges = 8;          // edges a thread holds while it walks the thetas
constexpr int kMaxThetas = 32;     // thetas per block, at most
constexpr int kMaxBalanced = 1024; // images whose blocks are shared out by their edge counts
constexpr int kRowEdges = 2048;    // a theta's zeroing and write-out, counted in edges
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kWarps == 32, "the box reduction takes one partial per lane");

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// One theta of a block: its table entry, the first bin of its window as
// shift - lo (so that rho + bias is the index into its row) and the
// window's length.
struct __align__(16) Theta {
  float c, s;
  int bias;
  unsigned len;
};

__device__ __forceinline__ int rho_of(float x, float y, float c, float s) {
  return __float2int_rn(__fmaf_rn(x, c, __fmul_rn(y, s)));
}

// The votes of one chunk of kThreads * kEdges edges for the thetas
// [j0, j0 + n) of the block. TAIL: the chunk may reach past the end of the
// list, and `valid` says which of the thread's edges exist. A row has
// th.len bins and one more slot behind them, which takes every vote that
// falls outside the window or belongs to no edge.
template <bool TAIL>
__device__ __forceinline__ void vote_chunk(const float (&x)[kEdges], const float (&y)[kEdges],
                                           unsigned valid, const Theta* thetas,
                                           const int* offs, int* acc, int j0, int n) {
  for (int j = j0; j < j0 + n; ++j) {
    const Theta th = thetas[j];
    int* row = acc + offs[j];
#pragma unroll
    for (int i = 0; i < kEdges; ++i) {
      unsigned q = min((unsigned)rho_of(x[i], y[i], th.c, th.s) + (unsigned)th.bias, th.len);
      if (TAIL && !((valid >> i) & 1u)) q = th.len;
      atomicAdd(row + q, 1);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
hough_votes_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
                   const int32_t* __restrict__ counts, const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, int32_t* __restrict__ out, int batch, int k,
                   int numrho, int n_theta, int shift, int min_blocks, int cap, int windowed) {
  extern __shared__ __align__(16) int acc[];   // the round's rows, one after another
  __shared__ Theta s_theta[kMaxThetas];
  __shared__ int s_lo[kMaxThetas];
  __shared__ int s_off[kMaxThetas];
  __shared__ int s_red[4][kWarps];
  __shared__ int s_box[4];                     // x min, x max, y min, y max
  __shared__ int s_share[kMaxBalanced];        // blocks of each image beyond min_blocks
  __shared__ int s_job[3];                     // image, index among its blocks, its blocks

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // this block's image and its slice of the thetas
  const int spare = (int)gridDim.x - min_blocks * batch;   // > 0 only with batch <= kMaxBalanced
  if (spare == 0) {
    if (tid == 0) {
      s_job[0] = blockIdx.x / min_blocks, s_job[1] = blockIdx.x % min_blocks;
      s_job[2] = min_blocks;
    }
  } else {
    // share_b = spare * w_b / sum(w), rounded down; what is left over goes
    // one each to the first images. Every block computes the same shares.
    float w = 0.f;
    if (tid < batch) w = (float)(max(0, min(counts[tid], k)) + kRowEdges);
    float sum = w;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFull, sum, d);
    if (lane == 0) s_red[0][warp] = __float_as_int(sum);
    __syncthreads();
    float total = 0.f;
    for (int i = 0; i < kWarps; ++i) total += __int_as_float(s_red[0][i]);
    if (tid < batch) s_share[tid] = (int)((float)spare * (w / total) * 0.9999f);
    __syncthreads();
    if (tid == 0) {
      int given = 0;
      for (int b = 0; b < batch; ++b) given += s_share[b];
      const int left = spare - given;          // 0 <= left, shared out one by one
      int first = 0;
      for (int b = 0, l = left; b < batch; ++b) {
        const int extra = (l + batch - 1 - b) / (batch - b);   // what is left, spread evenly
        const int nb = min_blocks + s_share[b] + extra;
        l -= extra;
        if ((int)blockIdx.x < first + nb || b == batch - 1) {
          s_job[0] = b, s_job[1] = (int)blockIdx.x - first, s_job[2] = nb;
          break;
        }
        first += nb;
      }
    }
  }
  __syncthreads();
  const int b = s_job[0];
  const int t_begin = (int)((long long)s_job[1] * n_theta / s_job[2]);
  const int n_block = (int)((long long)(s_job[1] + 1) * n_theta / s_job[2]) - t_begin;
  const int count = max(0, min(counts[b], k));
  const int32_t* xb = xs + (long long)b * k;
  const int32_t* yb = ys + (long long)b * k;

  // the list's bounding box, where the rows are kept as windows
  if (windowed) {
    int box[4] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
    for (int e = tid; e < count; e += kThreads) {
      const int x = __ldg(xb + e), y = __ldg(yb + e);
      box[0] = min(box[0], x), box[1] = max(box[1], x);
      box[2] = min(box[2], y), box[3] = max(box[3], y);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      box[0] = min(box[0], __shfl_xor_sync(kFull, box[0], d));
      box[1] = max(box[1], __shfl_xor_sync(kFull, box[1], d));
      box[2] = min(box[2], __shfl_xor_sync(kFull, box[2], d));
      box[3] = max(box[3], __shfl_xor_sync(kFull, box[3], d));
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s_red[i][warp] = box[i];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int v = s_red[i][lane];               // kWarps == 32: one per lane
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          const int o = __shfl_xor_sync(kFull, v, d);
          v = (i & 1) ? max(v, o) : min(v, o);
        }
        if (lane == 0) s_box[i] = v;
      }
    }
    __syncthreads();
  }

  // each theta's row: all numrho bins, or the window of reachable bins from
  // the box's four corners
  if (tid < n_block) {
    const float c = cos_t[t_begin + tid], s = sin_t[t_begin + tid];
    long long lo = 0, hi = windowed ? 0 : numrho;
    if (windowed && count > 0) {
      long long rmin = LLONG_MAX, rmax = LLONG_MIN;
#pragma unroll
      for (int corner = 0; corner < 4; ++corner) {
        const long long r = rho_of((float)s_box[corner & 1], (float)s_box[2 + (corner >> 1)], c, s);
        rmin = min(rmin, r), rmax = max(rmax, r);
      }
      lo = min(max(rmin + shift, 0LL), (long long)numrho);
      hi = min(max(rmax + shift + 1, 0LL), (long long)numrho);
    }
    s_theta[tid] = Theta{c, s, shift - (int)lo, (unsigned)(hi - lo)};
    s_lo[tid] = (int)lo;
  }
  __syncthreads();

  int32_t* ob = out + (long long)b * numrho * n_theta;
  for (int j0 = 0; j0 < n_block;) {
    // this round: as many thetas as fit, at least one (a row is at most
    // numrho + 1 slots, and the launcher refuses a numrho beyond cap)
    int n = 0, used = 0;
    while (j0 + n < n_block && used + round4((int)s_theta[j0 + n].len + 1) <= cap) {
      if (tid == 0) s_off[j0 + n] = used;
      used += round4((int)s_theta[j0 + n].len + 1);
      ++n;
    }
    for (int i = tid; i < used / 4; i += kThreads) {
      reinterpret_cast<int4*>(acc)[i] = make_int4(0, 0, 0, 0);
    }
    __syncthreads();

    for (int base = 0; base < count; base += kThreads * kEdges) {
      float x[kEdges], y[kEdges];
      unsigned valid = 0;
#pragma unroll
      for (int i = 0; i < kEdges; ++i) {
        const int e = base + i * kThreads + tid;
        const bool ok = e < count;
        x[i] = ok ? (float)__ldg(xb + e) : 0.f;
        y[i] = ok ? (float)__ldg(yb + e) : 0.f;
        valid |= (unsigned)ok << i;
      }
      if (base + kThreads * kEdges <= count) {
        vote_chunk<false>(x, y, valid, s_theta, s_off, acc, j0, n);
      } else {
        vote_chunk<true>(x, y, valid, s_theta, s_off, acc, j0, n);
      }
    }
    __syncthreads();

    // out[b, r, t_begin + j0 + j]: 16 lanes per rho row, one theta each
    const int jl = tid & 15;
    for (int jb = 0; jb < n; jb += 16) {
      const int j = j0 + jb + jl;
      if (jb + jl < n) {
        const unsigned len = s_theta[j].len;
        const int lo = s_lo[j];
        const int* row = acc + s_off[j];
        for (int r = tid >> 4; r < numrho; r += kThreads / 16) {
          const unsigned q = (unsigned)(r - lo);
          ob[(long long)r * n_theta + t_begin + j] = q < len ? row[q] : 0;
        }
      }
    }
    __syncthreads();
    j0 += n;
  }
}

// What a launch needs to know of the current card: the dynamic shared memory
// a block may take (the kernel is opted in to all of it) and the number of
// SMs. Asked of the runtime once per card, since every such question is a
// call that costs the host, and the paths that vote are bound by the host.
struct Card {
  long long room;
  int sms;
};

cudaError_t card_limits(Card* card) {
  constexpr int kMaxCards = 64;
  static std::mutex mu;
  static Card known[kMaxCards];
  static bool have[kMaxCards];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxCards) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!have[dev]) {
    int max_smem = 0;
    cudaFuncAttributes attr;
    if ((err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (err = cudaDeviceGetAttribute(&known[dev].sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaFuncGetAttributes(&attr, hough_votes_kernel))) {
      return err;
    }
    known[dev].room = (long long)max_smem - (long long)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(hough_votes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)known[dev].room);
    if (err != cudaSuccess) return err;
    have[dev] = true;
  }
  *card = known[dev];
  return cudaSuccess;
}

}  // namespace

// Every (rho, theta) entry of out is written. Returns cudaGetLastError()
// after the launch (0 on success); cudaErrorInvalidValue when one theta's
// rho row does not fit in a block's shared memory.
extern "C" int tpuimage_hough_votes(const void* xs, const void* ys,
                                    const void* counts, const void* cos_t,
                                    const void* sin_t, void* out, int batch,
                                    int k, int numrho, int n_theta, int shift,
                                    void* stream) {
  if (batch <= 0 || n_theta <= 0) return 0;
  if (batch > 65535 || numrho <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  Card card;
  const cudaError_t err = card_limits(&card);
  if (err != cudaSuccess) return (int)err;
  const long long room = card.room;
  const long long row_bytes = 4LL * round4(numrho + 1);
  if (row_bytes > room) return (int)cudaErrorInvalidValue;
  // one wave: a block per SM, shared out among the images by the kernel
  const int min_blocks = (n_theta + kMaxThetas - 1) / kMaxThetas;
  const long long blocks =
      batch <= kMaxBalanced ? std::max<long long>(card.sms, (long long)min_blocks * batch)
                            : (long long)min_blocks * batch;
  // whole rows where a block's usual share of thetas fits at once; else
  // windows, which cost each block a pass over the list for its bounding box
  const long long usual = (n_theta * (long long)batch + blocks - 1) / blocks;
  const int windowed = row_bytes * usual > room;
  const size_t smem = (size_t)std::min(room, row_bytes * kMaxThetas);
  hough_votes_kernel<<<(unsigned)blocks, kThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<const int32_t*>(ys),
      static_cast<const int32_t*>(counts), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<int32_t*>(out), batch, k, numrho, n_theta,
      shift, min_blocks, (int)(smem / 4), windowed);
  return (int)cudaGetLastError();
}
