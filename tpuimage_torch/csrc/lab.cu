// RGB -> Lab, OpenCV's 8-bit fixed-point path: (P, 3) u8 -> (P, 3) u8.
//
// Replaces: tpuimage/ops/pallas_kernels.py rgb_to_lab_pallas (body
// _make_lab_kernel), the TPU kernel behind tpuimage.ops.color.rgb_to_lab on
// the night RGB path, landscape's Lab-L CLAHE and NLM's Lab split
// (benchmarks/micro_lab_kernel.py times a variant of the same function).
//
// Bound on the H100: memory, 3 bytes read and 3 written a pixel. The work,
// six table lookups and ~39 instructions a pixel, takes about 70% of that
// time at the card's issue rate, and the lookups share the shared-memory
// pipe with the staging below, so the design keeps both low.
//
// Design: the TPU kernel turns each lookup into byte-split one-hot matrix
// products because the TPU has no fast gather; Hopper has one, in shared
// memory (in __constant__ memory a warp's distinct addresses would be
// served one after another).
// - A warp converts runs of 512 pixels (1536 bytes: 96 aligned 16-byte
//   words, or 97 when the input starts o = 1..15 bytes past a word
//   boundary). It reads the words coalesced, lane l words l, 32 + l and
//   64 + l, stages them in shared memory, and each lane takes back its 16
//   pixels (48 bytes at a 48-byte stride, conflict-free), funnel-shifted by
//   o (the word part of o a template parameter: no register is indexed at
//   run time). The Lab bytes go back the same way, out coalesced. Loading
//   48 bytes a lane straight from device memory left each 32-byte sector
//   half used by each load and store and took 1.4x a plain copy.
// - Four pixels (three words) at a time: bytes by PRMT, saturation and
//   packing by two cvt.pack.sat a word.
// - One wave of persistent blocks walks the warp runs; each block issues
//   its first run's loads, then stages the 256-entry gamma and 3072-entry
//   cube-root tables once, so the staging hides behind them, and checks
//   that the tables keep every cube-root index inside its table (true of
//   OpenCV's); only then is the index's clamp left out.
// - Pixels past the last whole warp run are converted one a lane by the
//   grid's last warp.
// All arithmetic is integer, so the result equals tpuimage's gather form
// bit for bit, for any tables.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 3;
constexpr int kRun = 16;     // pixels a lane converts at a time: 48 bytes
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRun = 32 * kRun;  // pixels a warp converts at a time: 96 words
constexpr int kGammaN = 256;
constexpr int kCbrtN = 3072;
constexpr int kShift = 12;   // _LAB_SHIFT
constexpr int kShift2 = 15;  // _LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
constexpr int kLScale = (116 * 255 + 50) / 100;                  // 296
constexpr int kLShift = -((16 * 255 * (1 << kShift2) + 50) / 100);

struct Lab {
  int L, a, b;   // not yet saturated
};

// tables: gamma (256) | cube root (3072) | sRGB->XYZ coefficients (3x3,
// row-major, X and Z rows scaled by the D65 white point), all int32;
// gamma and cbrt in shared memory, coef in registers. CLAMP: clamp the
// cube root's index to the table (a no-op where tame_entry holds).
template <bool CLAMP>
__device__ __forceinline__ Lab lab_of(int r8, int g8, int b8, const int* gamma,
                                      const int* cbrt, const int (&coef)[9]) {
  const int r = gamma[r8], g = gamma[g8], b = gamma[b8];
  int f[3];
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    const int idx = (r * coef[3 * row] + g * coef[3 * row + 1] + b * coef[3 * row + 2] +
                     (1 << (kShift - 1))) >> kShift;
    f[row] = cbrt[CLAMP ? min(max(idx, 0), kCbrtN - 1) : idx];
  }
  return {(kLScale * f[1] + kLShift + (1 << (kShift2 - 1))) >> kShift2,
          (500 * (f[0] - f[1]) + (128 << kShift2) + (1 << (kShift2 - 1))) >> kShift2,
          (200 * (f[1] - f[2]) + (128 << kShift2) + (1 << (kShift2 - 1))) >> kShift2};
}

// x0 | x1 << 8 | x2 << 16 | x3 << 24, each saturated to [0, 255]
__device__ __forceinline__ uint32_t pack4_sat(int x0, int x1, int x2, int x3) {
  uint32_t hi, w;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;" : "=r"(hi) : "r"(x3), "r"(x2), "r"(0));
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;" : "=r"(w) : "r"(x1), "r"(x0), "r"(hi));
  return w;
}

__device__ __forceinline__ int byte_of(const uint32_t (&w)[12], int k) {
  return (int)__byte_perm(w[k >> 2], 0, 0x4440 | (k & 3));
}

// Whether the cube root's index of every pixel lies in the table: gamma
// entries g in [0, G] and coefficients >= 0 bound each row's index by
// (G (c0 + c1 + c2) + 2^11) >> 12, with no int32 overflow on the way.
// Each thread tests the gamma entries it staged.
__device__ __forceinline__ bool tame_entry(int g, const int (&coef)[9]) {
  bool ok = g >= 0;
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    const long long sum = (long long)coef[3 * row] + coef[3 * row + 1] + coef[3 * row + 2];
    ok &= coef[3 * row] >= 0 && coef[3 * row + 1] >= 0 && coef[3 * row + 2] >= 0 &&
          (long long)g * sum + (1 << (kShift - 1)) < ((long long)kCbrtN << kShift);
  }
  return ok;
}

// A lane's 12 words of its run, read from the warp's staged aligned words
// (shared memory): the run starts o = 4 Q + shift / 8 bytes past word 3 lane.
template <int Q, bool SHIFTED>
__device__ __forceinline__ void load_run(const uint4* stage, int lane, int shift,
                                         uint32_t (&w)[12]) {
  const uint4* p = stage + 3 * lane;
  uint32_t raw[16];
#pragma unroll
  for (int i = 0; i < (SHIFTED ? 4 : 3); ++i) {
    const uint4 v = p[i];
    raw[4 * i] = v.x;
    raw[4 * i + 1] = v.y;
    raw[4 * i + 2] = v.z;
    raw[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    w[j] = SHIFTED ? __funnelshift_r(raw[j + Q], raw[j + Q + 1], shift) : raw[j];
  }
}

// A lane's 16 pixels, converted in place: words 3g .. 3g + 2 hold pixels
// 4g .. 4g + 3 in and their Lab bytes out.
template <bool CLAMP>
__device__ __forceinline__ void convert_run(uint32_t (&w)[12], const int* gamma, const int* cbrt,
                                            const int (&coef)[9]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    Lab v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 12 * g + 3 * i;
      v[i] = lab_of<CLAMP>(byte_of(w, k), byte_of(w, k + 1), byte_of(w, k + 2), gamma, cbrt,
                           coef);
    }
    w[3 * g] = pack4_sat(v[0].L, v[0].a, v[0].b, v[1].L);
    w[3 * g + 1] = pack4_sat(v[1].a, v[1].b, v[2].L, v[2].a);
    w[3 * g + 2] = pack4_sat(v[2].b, v[3].L, v[3].a, v[3].b);
  }
}

// The warp's aligned words of warp run u: 96, and with SHIFTED a 97th (lane
// 0's `extra`), which holds the run's last bytes.
template <bool SHIFTED>
__device__ __forceinline__ void load_words(const uint4* __restrict__ base, long long u, int lane,
                                           uint4 (&raw)[3], uint4& extra) {
  const uint4* p = base + 3LL * 32 * u;
#pragma unroll
  for (int i = 0; i < 3; ++i) raw[i] = __ldg(p + 32 * i + lane);
  if (SHIFTED && lane == 0) extra = __ldg(p + 96);
}

// The warp's walk over its warp runs (the first one's words already in
// raw / extra), then the pixels past the last whole warp run, one a lane,
// by the grid's last warp.
template <int Q, bool SHIFTED, bool CLAMP>
__device__ __forceinline__ void walk(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                                     const uint4* __restrict__ base, long long n_pix, int shift,
                                     bool dst_aligned, const int* gamma, const int* cbrt,
                                     const int (&coef)[9], uint4* stage, uint4 (&raw)[3],
                                     uint4& extra) {
  const int lane = threadIdx.x & 31;
  const long long n_runs = n_pix / kWarpRun;
  const long long n_warps = (long long)gridDim.x * kWarps;
  const long long u0 = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  for (long long u = u0; u < n_runs; u += n_warps) {
    // coalesced words -> shared -> each lane's run of 16 pixels
#pragma unroll
    for (int i = 0; i < 3; ++i) stage[32 * i + lane] = raw[i];
    if (SHIFTED && lane == 0) stage[96] = extra;
    __syncwarp();
    uint32_t w[12];
    load_run<Q, SHIFTED>(stage, lane, shift, w);
    __syncwarp();
    if (u + n_warps < n_runs) load_words<SHIFTED>(base, u + n_warps, lane, raw, extra);
    convert_run<CLAMP>(w, gamma, cbrt, coef);
    if (dst_aligned) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        stage[3 * lane + i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
      }
      __syncwarp();
      uint4* d = reinterpret_cast<uint4*>(dst) + 3LL * 32 * u;
#pragma unroll
      for (int i = 0; i < 3; ++i) d[32 * i + lane] = stage[32 * i + lane];
      __syncwarp();
    } else {
      uint8_t* d = dst + 3LL * kWarpRun * u + 48 * lane;
#pragma unroll
      for (int k = 0; k < 48; ++k) d[k] = (uint8_t)byte_of(w, k);
    }
  }
  if (u0 == n_warps - 1) {
    for (long long p = kWarpRun * n_runs + lane; p < n_pix; p += 32) {
      const uint8_t* s = src + 3 * p;
      const Lab v = lab_of<CLAMP>(s[0], s[1], s[2], gamma, cbrt, coef);
      uint8_t* d = dst + 3 * p;
      d[0] = (uint8_t)min(max(v.L, 0), 255);
      d[1] = (uint8_t)min(max(v.a, 0), 255);
      d[2] = (uint8_t)min(max(v.b, 0), 255);
    }
  }
}

template <int Q, bool SHIFTED>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
rgb_to_lab_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                  const int32_t* __restrict__ tables, long long n_pix, int shift,
                  bool dst_aligned) {
  __shared__ int gamma[kGammaN];
  __shared__ int cbrt[kCbrtN];
  __shared__ uint4 stages[kWarps][97];
  const long long u0 = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const uint4* base = reinterpret_cast<const uint4*>(
      reinterpret_cast<uintptr_t>(src) & ~(uintptr_t)15);
  uint4 raw[3], extra = make_uint4(0, 0, 0, 0);
  if (u0 < n_pix / kWarpRun) load_words<SHIFTED>(base, u0, threadIdx.x & 31, raw, extra);
  int coef[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) coef[k] = __ldg(tables + kGammaN + kCbrtN + k);
  bool ok = true;
  for (int i = threadIdx.x; i < kGammaN; i += kThreads) {
    gamma[i] = __ldg(tables + i);
    ok &= tame_entry(gamma[i], coef);
  }
  for (int i = threadIdx.x; i < kCbrtN; i += kThreads) cbrt[i] = __ldg(tables + kGammaN + i);
  uint4* stage = stages[threadIdx.x >> 5];
  if (__syncthreads_and(ok)) {
    walk<Q, SHIFTED, false>(src, dst, base, n_pix, shift, dst_aligned, gamma, cbrt, coef, stage,
                            raw, extra);
  } else {
    walk<Q, SHIFTED, true>(src, dst, base, n_pix, shift, dst_aligned, gamma, cbrt, coef, stage,
                           raw, extra);
  }
}

template <int Q, bool SHIFTED>
void launch(unsigned blocks, cudaStream_t stream, const void* src, void* dst, const void* tables,
            long long n_pix, int shift, bool dst_aligned) {
  rgb_to_lab_kernel<Q, SHIFTED><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      static_cast<const int32_t*>(tables), n_pix, shift, dst_aligned);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tpuimage_rgb_to_lab(const void* src, void* dst,
                                   const void* tables, long long n_pix,
                                   void* stream) {
  if (n_pix <= 0) return 0;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // one wave: never more blocks than the warp runs need, at least one (its
  // last warp converts the pixels past the last warp run)
  long long blocks = (long long)kBlocksPerSm * sms;
  const long long needed = (n_pix / kWarpRun + kWarps - 1) / kWarps;
  if (blocks > needed) blocks = needed > 0 ? needed : 1;
  const int o = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  const int shift = 8 * (o & 3);
  const bool dst_aligned = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned g = (unsigned)blocks;
  switch (o == 0 ? -1 : o >> 2) {
    case -1: launch<0, false>(g, s, src, dst, tables, n_pix, 0, dst_aligned); break;
    case 0: launch<0, true>(g, s, src, dst, tables, n_pix, shift, dst_aligned); break;
    case 1: launch<1, true>(g, s, src, dst, tables, n_pix, shift, dst_aligned); break;
    case 2: launch<2, true>(g, s, src, dst, tables, n_pix, shift, dst_aligned); break;
    default: launch<3, true>(g, s, src, dst, tables, n_pix, shift, dst_aligned); break;
  }
  return (int)cudaGetLastError();
}
