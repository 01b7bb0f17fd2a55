// The separable Gaussian of DocScanner's post-warp chain, on a batch of
// (B, H, W) u8 planes, with the stage that consumes the blur fused in as an
// epilogue (one template, one instantiation per epilogue):
//
//   none:     cv2.GaussianBlur 8u (the blur itself);
//   divide:   cv2.divide(src, blur, scale=255)       (illumination, divide);
//   subtract: saturate(src - blur)                   (illumination, subtract);
//   sub:      saturate(blur - src)                   (the ink background);
//   adaptive: cv2.adaptiveThreshold GAUSSIAN_C, THRESH_BINARY, maxval 255:
//             src - cvRound(mean) > -idelta ? 255 : 0.
//
// Replaces: tpuimage/ops/pallas_kernels.py gaussian_blur_u8_pallas (body
// _make_sepconv_band_kernel; the "none" epilogue) and gauss_chain_pallas
// (body _make_gauss_chain_kernel; the other four).
//
// Numerics. none/divide/subtract/sub use OpenCV's Q8.8 integer taps with a
// reflect-101 border: the sums are accumulated in int32 (the taps sum to
// 256, so a sum is at most 255 * 256 * 256 < 2^31 and exact) and rounded as
// (acc + 32768) >> 16, which equals the plain version's f32 form, whose
// integers stay below 2^24. divide is an exact integer quotient, rounded
// half to even, 0 where the blur is 0 (div255_round_half_even; the TPU
// kernel's f32 quotient candidate exists only because Mosaic has no vector
// integer divide).
// adaptive is the one float stage: f32 taps, a replicate border, and
// OpenCV's symmetric order, vertical pass first: acc = x[r]*k[r];
// acc += (x[r-i] + x[r+i]) * k[r+i] for i = 1..r, then the same along the
// row over the kept vertical results. Every product and sum is spelled
// __fmul_rn / __fadd_rn, which nvcc never contracts into an fma, so the mean
// rounds exactly where the plain version's separate ops round.
//
// Bound on the H100. The Q8.8 modes: bytes, 2 a pixel (0.0049 ms for 8 A4
// planes at 3.35 TB/s): their 2 (2r + 1) products a pixel are u8 x u8, and
// at the int8 tensor cores' rate they take a seventh of that. The adaptive
// mode: operations, 1 + 3r f32 operations per pixel and pass in an order
// that is pinned (0.0112 ms at ksize 31). A direct form is set by neither:
// it makes one shared-memory load per tap and sum, and an SM serves 32 lanes
// of shared load a clock. Both tiled forms below take the taps out of the
// load path; which one runs is decided from the mode and ksize alone. What
// is left between the tensor-core form and its bound (it reaches about an
// eighth of it) is the tile's load, not the products: see its last item.
//
// Common to both tiled forms (ksize <= kMaxTiledKsize): one block of 256
// threads per (kTileH x kTileW) = 64 x 128 output tile of one image. The
// tile and its halo of r pixels sit in shared memory as bytes, borders
// folded in. A warp takes 8 rows at a time and a lane one word of four
// pixels in each, so 16 loads are in flight per lane; where the four pixels
// lie inside the image row they come as aligned 32-bit words from device
// memory, funnel-shifted to the tile's own word grid (849-pixel rows start
// off a word boundary), and only border words are folded byte by byte. The
// halo is read (64 + 2r)(128 + 2r) / (64 * 128) = 2.2 times at r = 21,
// through L2. Results are staged in shared memory and leave in rows, 32
// consecutive bytes per warp store.
//
// Tensor-core form (gauss_mma_kernel): the four Q8.8 modes at ksize <= 81.
// The 2-D sum is an exact integer in either order of the passes, the taps
// are bytes, so both passes are band-matrix products on the int8 tensor
// cores (mma.sync m16n8k32, u8 x u8 -> s32), chained through registers:
// - A warp owns a strip of 16 columns and walks down it in units of 16
//   rows. The horizontal pass comes first: H^T (16 output columns x 8 rows)
//   = band (16 x K) * tile^T (K x 8), K = 32 KS >= 16 + 2r input columns in
//   KS = 1, 2 or 3 steps. The B operand of that product is the row-major
//   byte tile as it lies in shared memory: one aligned word per lane and
//   half step, 2 KS loads per lane for 128 row sums. At ksize 43 that is
//   1.7 shared loads per output pixel (the halo rows included), 3 with the
//   epilogue's source pixel and the staged result, against the direct
//   form's 200. The tile's pitch is 4 mod 8 words, so the 8 rows x 4 words
//   of such a load fall into 32 different banks.
// - A row sum is at most 255 * 256, two bytes. Its accumulator registers,
//   split by two byte permutes into low and high bytes, ARE the A operand
//   of the vertical product V^T (16 columns x 8 output rows) = H^T (16 x K)
//   * band^T (K x 8): the order of the contraction index is free, so the
//   band operand is built in the order the accumulators give (slot 4t + e
//   of a unit is its row 2t + (e & 1) + 8 (e >> 1)). The row sums never
//   leave the registers; a window of 2 KS units slides down the strip, and
//   V = 256 * (the high bytes' product) + (the low bytes' product).
// - Both band operands are constants of the lane, built once from four
//   copies of the taps in shared memory, shifted by a byte each, so that
//   any four (or two) consecutive taps are one aligned load.
// - A tap of 256 (ksize 1, a tiny sigma) does not fit a byte. The taps are
//   >= 0 and sum to 256 (the wrapper checks it), so such a tap is the only
//   one and the sum is 65536 times the pixel it points at: the kernel finds
//   it while it loads the taps and takes that pixel instead of the product.
// - The divide epilogue has no division: floor((2 * 255 c + blur) / (2
//   blur)) by a multiply-high with one of 256 magic numbers kept in shared
//   memory, and a tie where that division leaves no remainder.
// - 64 registers, four blocks an SM (KS = 3: 80 and three). Measured at
//   ksize 43 with clock64 around a block's phases: 65% of its clocks go to
//   loading the tile (four round trips, 2.2 times the planes through L2,
//   and the blocks of a wave load at the same time), 26% to the products
//   and the epilogue (40% in the divide mode), 7% to storing.
//
// Sliding-window form (gauss_sep_kernel): the adaptive mode, whose f32 order
// is pinned, and the Q8.8 modes at 83 <= ksize <= 255, where the band would
// take more registers than a thread has. Three blocks an SM (80 registers,
// 63 KB of shared memory at ksize 43). On 8 A4 planes the Q8.8 blur takes
// 0.135 / 0.246 / 0.611 ms at ksize 83 / 127 / 255, where the direct form
// took 0.485 / 0.861 / 3.98 and the split form below takes 1.67 / 2.52 /
// 5.00 (tools/time_kernel_builds.py gauss_sep, one call on an H100 at 700 W).
// - Register blocking, both passes. A thread computes kR = 8 consecutive
//   outputs along the pass from two windows held in registers: for tap pair
//   j the left window holds x[o - j] and the right one x[o + j] for its 8
//   outputs o. Stepping j moves the left window down by one element and the
//   right one up by one, so a step loads ONE new element per window and the
//   pair's two taps (8 bytes), and reuses them for all 8 outputs. The step
//   loop is unrolled 8 times, which turns the windows' rotation into
//   constant register indices (nothing is indexed dynamically, nothing
//   spills). A thread carries two lines at once: two adjacent columns in
//   the vertical pass (one 16-bit load feeds both), the rows `lane` and
//   `lane + 32` in the horizontal one. Shared loads per tap and output:
//   3 / 32 in the vertical pass and 5 / 32 in the horizontal one, about 12
//   per output pixel at ksize 43 where the direct form made 200; 72% of
//   the inner loop's instructions are the multiply-adds.
// - Arithmetic in f32 for every mode. The adaptive mode's order is pinned
//   (above) and the tap loop is outermost, so each output sees exactly that
//   order. The Q8.8 modes' sums are exact integers below 2^24 whatever the
//   order (taps are >= 0 and sum to 256: a partial sum is at most 255 * 256
//   after one pass and 255 * 65536 after two), so they run as f32 fused
//   multiply-adds, twice the rate of the integer pipe, and convert back to
//   int32 exactly for the epilogue. The Q8.8 taps are not symmetric (error
//   diffusion), so each side keeps its own tap. Bytes become floats by a
//   byte permute into the mantissa of a power of two (load_cols), not by a
//   conversion instruction.
// - The vertical sums go to shared memory as f32 with an odd row pitch; the
//   horizontal pass puts a warp's lanes on 32 different rows, so its window
//   loads hit 32 different banks. Results are written over the tile's
//   centre bytes.
// - Measured with parts taken away: the two passes are 94% of the time. They
//   sustain 11 T multiply-adds a second where a bare loop of the same shape
//   sustains 29 T on this card: about 2.2 instructions a clock and SM of 4,
//   and taking their shared loads away changes that by under a fifth.
//
// Split form (wider kernels, whose halo outgrows shared memory): the
// vertical pass of every pixel goes to a (B, H, W) buffer of sums in device
// memory that the caller provides, then a second launch runs the
// horizontal pass and the epilogue from it. Both read through the caches
// and sum tap by tap (int32 in the Q8.8 modes). The same exact integers,
// and in the adaptive mode the same order, so all forms give the same
// bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace {

constexpr int kTileW = 128;
constexpr int kTileH = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 8;       // outputs a thread computes along a pass from one pair of windows
constexpr int kVCols = 2;   // adjacent columns a thread of the vertical pass carries
constexpr int kLoadRows = 8;   // rows of the tile a warp loads at a time
constexpr int kMaxTiledKsize = 255;   // 219 KB of shared memory at r = 127
constexpr int kMaxCards = 64;         // devices the launch remembers its opt-in for
static_assert(kTileH == 64 && kTileW % kR == 0, "the horizontal pass gives a lane two of 64 rows");

enum Mode : int { kNone = 0, kDivide = 1, kSubtract = 2, kSub = 3, kAdaptive = 4 };

template <int MODE>
using Acc = typename std::conditional<MODE == kAdaptive, float, int>::type;

// numpy's "reflect" pad (cv2's BORDER_REFLECT_101) of index i into [0, n),
// for any pad width: the reflection is periodic with period 2(n - 1).
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  i = abs(i) % p;
  return i < n ? i : p - i;
}

__device__ __forceinline__ int replicate(int i, int n) { return min(max(i, 0), n - 1); }

template <int MODE>
__device__ __forceinline__ int fold(int i, int n) {
  return MODE == kAdaptive ? replicate(i, n) : reflect101(i, n);
}

// cv2.divide(num, den, scale=255) on u8 values: exact quotient, rounded
// half to even, 0 where den is 0 (ops.arith.divide_u8), without a division:
// with a = 2 * 255 num + den, floor(a / 2 den) is the quotient rounded half
// up, and it was a tie exactly where that division leaves no remainder. The
// floor is the high word of a * magic, magic = ceil(2^32 / 2 den): exact
// because a * (magic * 2 den - 2^32) < 130,305 * 510 < 2^32. magic is 0 for
// den 0, which gives 0. A kernel keeps the 256 magic numbers in shared
// memory (the integer division that makes one costs more than the rest).
__device__ __forceinline__ uint32_t div255_magic(uint32_t den) {
  return den ? 0xFFFFFFFFu / (2u * den) + 1u : 0u;
}

__device__ __forceinline__ void build_div255_magic(uint32_t* table) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) table[i] = div255_magic(i);
}

__device__ __forceinline__ int div255_round_half_even(uint32_t num, uint32_t den,
                                                      uint32_t magic) {
  const uint32_t a = 510u * num + den;
  const uint32_t q = __umulhi(a, magic);
  const uint32_t tie = a == q * (2u * den);
  return (int)min(q - (tie & q & 1u), 255u);
}

// The split form's pass over a window of 2r + 1 values, get(j) for j in
// [0, 2r]: the Q8.8 modes' int32 sum, or the adaptive mode's symmetric f32
// sum.
template <int MODE, class Get>
__device__ __forceinline__ Acc<MODE> window_sum(Get get, const Acc<MODE>* tap, int r) {
  if constexpr (MODE == kAdaptive) {
    float acc = __fmul_rn((float)get(r), tap[r]);
    for (int j = 1; j <= r; ++j) {
      const float pair = __fadd_rn((float)get(r - j), (float)get(r + j));
      acc = __fadd_rn(acc, __fmul_rn(pair, tap[r + j]));
    }
    return acc;
  } else {
    int acc = 0;
    for (int j = 0; j <= 2 * r; ++j) acc += (int)get(j) * tap[j];
    return acc;
  }
}

// The consumer of the blur in the Q8.8 modes: c is the source pixel, magic
// the divide mode's table (build_div255_magic).
template <int MODE>
__device__ __forceinline__ uint8_t consume(int c, int blur, const uint32_t* magic) {
  if constexpr (MODE == kNone) {
    return (uint8_t)blur;
  } else if constexpr (MODE == kDivide) {
    return (uint8_t)div255_round_half_even(c, blur, magic[blur]);
  } else if constexpr (MODE == kSubtract) {
    return (uint8_t)max(c - blur, 0);
  } else {  // kSub
    return (uint8_t)max(blur - c, 0);
  }
}

// From the 2-D sum acc of the source pixel c to the output byte.
template <int MODE>
__device__ __forceinline__ uint8_t epilogue(int c, Acc<MODE> acc, int idelta,
                                                const uint32_t* magic) {
  if constexpr (MODE == kAdaptive) {
    const int mean = (int)fminf(fmaxf(rintf(acc), 0.0f), 255.0f);
    return c - mean > -idelta ? 255 : 0;
  } else {
    return consume<MODE>(c, min(max((acc + 32768) >> 16, 0), 255), magic);
  }
}

// --- the sliding-window form ------------------------------------------------

__host__ __device__ constexpr int round_up_r(int n) { return (n + kR - 1) / kR * kR; }

// Row pitch of the byte tile: whole words, an odd number of them, so that a
// warp whose lanes sit on 32 different rows hits 32 different banks. The
// vertical sums' pitch is one float more (odd, for the same reason).
__host__ __device__ constexpr int pitch_bytes(int r) {
  return 4 * (((kTileW + 2 * r + 3) / 4) | 1);
}

__host__ __device__ constexpr size_t smem_bytes(int r) {
  return 8 * (size_t)(r + 1) + 4 * (size_t)kTileH * (pitch_bytes(r) + 1) +
         (size_t)(kTileH + 2 * r) * pitch_bytes(r);
}

// NC adjacent bytes at p (aligned to NC) as floats, without a conversion
// instruction: a byte permute drops the byte into the mantissa of a power of
// two. The adaptive mode takes 2^23 + v and subtracts 2^23: v, exactly. The
// Q8.8 modes take 2^15 + v as it is (byte 1 of the mantissa): their taps sum
// to 256, so a column's sum comes out 2^23 too high, still an exact integer
// below 2^24, and the vertical pass subtracts 2^23 once per sum instead.
constexpr float kQ8Bias = 32768.0f * 256.0f;   // 2^15 per pixel, times the taps' sum

template <int MODE, int NC>
__device__ __forceinline__ void load_cols(const uint8_t* p, float (&v)[NC]) {
  static_assert(NC == 1 || NC == 2 || NC == 4, "columns per thread");
  uint32_t word;
  if constexpr (NC == 4) {
    word = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (NC == 2) {
    word = *reinterpret_cast<const uint16_t*>(p);
  } else {
    word = *p;
  }
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    if constexpr (MODE == kAdaptive) {
      v[n] = __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7650 + n)), 8388608.0f);
    } else {
      v[n] = __uint_as_float(__byte_perm(word, 0x47000000u, 0x7604 + (n << 4)));
    }
  }
}

// acc += left * tap.x + right * tap.y: exact fused multiply-adds in the
// Q8.8 modes; OpenCV's symmetric f32 step, each operation rounded on its
// own, in the adaptive mode (tap.x == tap.y there).
template <int MODE>
__device__ __forceinline__ float tap_step(float acc, float left, float right, float2 tap) {
  if constexpr (MODE == kAdaptive) {
    return __fadd_rn(acc, __fmul_rn(__fadd_rn(left, right), tap.y));
  } else {
    return __fmaf_rn(right, tap.y, __fmaf_rn(left, tap.x, acc));
  }
}

// Up to kR steps j = j0 + 1 .. j0 + kR of the windows. On entry lw[n][o]
// holds x[o - j0] and rw[n][o] holds x[o + j0]; step t loads x[-j] into the
// left window's slot kR - t and x[kR - 1 + j] into the right one's slot
// t - 1, after which output o finds x[o - j] in slot (o - t) mod kR and
// x[o + j] in slot (o + t) mod kR. After kR steps the slots are back in
// order; the last group stops after step j = r. (One body for whole and
// partial groups keeps the unrolled code small enough for the instruction
// cache; the test per step is a uniform branch.)
template <int MODE, int NC, class Load>
__device__ __forceinline__ void window_steps(Load load, const float2* tap, int j0, int r,
                                             float (&lw)[NC][kR], float (&rw)[NC][kR],
                                             float (&acc)[NC][kR]) {
#pragma unroll
  for (int t = 1; t <= kR; ++t) {
    const int j = j0 + t;
    if (j > r) break;
    float v[NC];
    load(-j, v);
#pragma unroll
    for (int n = 0; n < NC; ++n) lw[n][(kR - t) % kR] = v[n];
    load(kR - 1 + j, v);
#pragma unroll
    for (int n = 0; n < NC; ++n) rw[n][(t - 1) % kR] = v[n];
    const float2 k = tap[j];
#pragma unroll
    for (int o = 0; o < kR; ++o) {
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        acc[n][o] = tap_step<MODE>(acc[n][o], lw[n][(o - t + kR) % kR], rw[n][(o + t) % kR], k);
      }
    }
  }
}

// One pass for kR consecutive outputs (of NC adjacent lines): load(pos, v)
// gives the pass's input at pos, counted from output 0's own position, for
// pos in [-r, kR - 1 + r]. acc[n][o] = x[o] * k[r], then for j = 1..r
// += x[o - j] * k[r - j] + x[o + j] * k[r + j] (tap_step's form).
template <int MODE, int NC, class Load>
__device__ __forceinline__ void sliding_pass(Load load, const float2* tap, int r,
                                             float (&acc)[NC][kR]) {
  float lw[NC][kR], rw[NC][kR];
  const float k0 = tap[0].y;
#pragma unroll
  for (int o = 0; o < kR; ++o) {
    float v[NC];
    load(o, v);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      lw[n][o] = rw[n][o] = v[n];
      acc[n][o] = __fmul_rn(v[n], k0);
    }
  }
  for (int j0 = 0; j0 < r; j0 += kR) window_steps<MODE, NC>(load, tap, j0, r, lw, rw, acc);
}

// The haloed tile, rows y0 - r .. y0 - r + sh - 1 and columns x0 - r ..
// x0 - r + sw - 1 of one plane with the border folded in, as bytes at a
// pitch of pitch_b (whole words): a warp takes kLoadRows rows at a time, a
// lane a word of four pixels in each, so that a lane has 2 * kLoadRows loads
// in flight.
template <int MODE>
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ img, uint8_t* in,
                                          int pitch_b, int x0, int y0, int r, int sw, int sh,
                                          int h, int w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row0 = warp * kLoadRows; row0 < sh; row0 += kWarps * kLoadRows) {
    const uint8_t* srow[kLoadRows];
#pragma unroll
    for (int i = 0; i < kLoadRows; ++i) {
      srow[i] = img + (long long)fold<MODE>(y0 - r + min(row0 + i, sh - 1), h) * w;
    }
    for (int cw = lane; 4 * cw < sw; cw += 32) {
      const int x = x0 - r + 4 * cw;
      uint32_t word[kLoadRows];
      if (x >= 0 && x + 3 < w) {
        uint32_t lo[kLoadRows], hi[kLoadRows];
        unsigned off[kLoadRows];
#pragma unroll
        for (int i = 0; i < kLoadRows; ++i) {
          const uint8_t* p = srow[i] + x;
          off[i] = (unsigned)(reinterpret_cast<uintptr_t>(p) & 3u);
          const uint32_t* q = reinterpret_cast<const uint32_t*>(p - off[i]);
          lo[i] = __ldg(q);
          hi[i] = __ldg(q + (off[i] ? 1 : 0));   // the word that holds p[3]
        }
#pragma unroll
        for (int i = 0; i < kLoadRows; ++i) word[i] = __funnelshift_r(lo[i], hi[i], 8 * off[i]);
      } else {
#pragma unroll
        for (int i = 0; i < kLoadRows; ++i) {
          word[i] = 0;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            word[i] |= (uint32_t)srow[i][fold<MODE>(x + c, w)] << (8 * c);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kLoadRows; ++i) {
        if (row0 + i < sh) reinterpret_cast<uint32_t*>(in + (row0 + i) * pitch_b)[cw] = word[i];
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 3)
gauss_sep_kernel(const uint8_t* __restrict__ src, const Acc<MODE>* __restrict__ taps,
                 uint8_t* __restrict__ dst, int h, int w, int r, int idelta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch_b = pitch_bytes(r), pitch_v = pitch_b + 1;
  __shared__ uint32_t s_magic[MODE == kDivide ? 256 : 1];   // the divide mode's table
  float2* tap = reinterpret_cast<float2*>(smem);                  // [r + 1]: (k[r - j], k[r + j])
  float* vbuf = reinterpret_cast<float*>(tap + r + 1);            // kTileH x pitch_v
  uint8_t* in = reinterpret_cast<uint8_t*>(vbuf + kTileH * pitch_v);   // (kTileH + 2r) x pitch_b

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  // the tile's extent, in whole groups of kR outputs: what lies past the
  // image is computed from folded pixels and not stored
  const int tw = min(kTileW, round_up_r(w - x0)), th = min(kTileH, round_up_r(h - y0));
  const int sw = tw + 2 * r, sh = th + 2 * r;
  const long long plane = (long long)blockIdx.z * h * w;

  for (int j = tid; j <= r; j += kThreads) {
    tap[j] = make_float2((float)taps[r - j], (float)taps[r + j]);
  }
  if constexpr (MODE == kDivide) build_div255_magic(s_magic);
  load_tile<MODE>(src + plane, in, pitch_b, x0, y0, r, sw, sh, h, w);
  __syncthreads();

  // vertical pass: kR rows x kVCols columns per thread, over the tile's
  // rows and every column of the haloed tile
  const int ncg = (sw + kVCols - 1) / kVCols;
  for (int u = tid; u < (th / kR) * ncg; u += kThreads) {
    const int rg = u / ncg, cg = u - rg * ncg;
    const int centre = rg * kR + r;           // the tile row of output 0's own pixel
    const uint8_t* col = in + centre * pitch_b + cg * kVCols;
    float acc[kVCols][kR];
    sliding_pass<MODE, kVCols>(
        [&](int pos, float (&v)[kVCols]) { load_cols<MODE, kVCols>(col + pos * pitch_b, v); },
        tap, r, acc);
    float* vout = vbuf + rg * kR * pitch_v + cg * kVCols;
#pragma unroll
    for (int o = 0; o < kR; ++o) {
#pragma unroll
      for (int n = 0; n < kVCols; ++n) {
        vout[o * pitch_v + n] = MODE == kAdaptive ? acc[n][o] : __fsub_rn(acc[n][o], kQ8Bias);
      }
    }
  }
  __syncthreads();

  // horizontal pass and the epilogue: a warp takes 64 rows x kR outputs, a
  // lane the rows `lane` and `lane + 32`; the results replace the tile's
  // centre bytes
  const int nxc = tw / kR;
  for (int u = warp; u < nxc; u += kWarps) {
    if (x0 + u * kR >= w) continue;
    const int centre = u * kR + r;
    // a row past the tile repeats its last row and is not stored
    const int rows[2] = {min(lane, th - 1), min(lane + 32, th - 1)};
    const float* vrow0 = vbuf + rows[0] * pitch_v + centre;
    const float* vrow1 = vbuf + rows[1] * pitch_v + centre;
    float acc[2][kR];
    sliding_pass<MODE, 2>([&](int pos, float (&v)[2]) { v[0] = vrow0[pos], v[1] = vrow1[pos]; },
                          tap, r, acc);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (lane + 32 * n >= th) continue;
      uint8_t* px = in + (rows[n] + r) * pitch_b + centre;
      uint8_t res[kR];
#pragma unroll
      for (int o = 0; o < kR; ++o) {
        if constexpr (MODE == kAdaptive) {
          res[o] = epilogue<MODE>(px[o], acc[n][o], idelta, s_magic);
        } else {
          res[o] = epilogue<MODE>(px[o], __float2int_rn(acc[n][o]), idelta, s_magic);
        }
      }
#pragma unroll
      for (int o = 0; o < kR; ++o) px[o] = res[o];
    }
  }
  __syncthreads();

  const int vw = min(kTileW, w - x0), vh = min(kTileH, h - y0);
  for (int row = warp; row < vh; row += kWarps) {
    const uint8_t* res = in + (row + r) * pitch_b + r;
    uint8_t* drow = dst + plane + (long long)(y0 + row) * w + x0;
    for (int x = lane; x < vw; x += 32) drow[x] = res[x];
  }
}

// --- the tensor-core form (Q8.8 modes, ksize <= 2 * kMmaMaxR + 1) -----------

constexpr int kMmaMaxR = 40;       // three 32-wide steps span 16 outputs and their taps
constexpr int kTapCopy = 128;      // bytes of one shifted copy of the tap band
// Row pitch of the staged results: 33 words, so that the four rows a warp's
// store touches fall into different banks.
constexpr int kOutPitch = kTileW + 4;

__host__ __device__ constexpr int mma_steps(int r) { return (16 + 2 * r + 31) / 32; }
// Row pitch of the byte tile: the last warp's strip reads 32 * KS columns
// from column kTileW - 16 on. In words it is 4 mod 8, so the 8 rows x 4 words
// of an operand load fall into 32 different banks.
__host__ __device__ constexpr int mma_pitch(int ks) { return kTileW - 16 + 32 * ks; }
__host__ __device__ constexpr size_t mma_smem_bytes(int r) {
  return 4 * kTapCopy + (size_t)kTileH * kOutPitch +
         (size_t)((kTileH + 2 * r + 15) / 16 * 16) * mma_pitch(mma_steps(r));
}

// D = A (16 x 32, u8, row-major) * B (32 x 8, u8, column-major) + D, exact in
// int32. Lane l = 4g + t holds: A registers {row g, row g + 8} x {columns 4t
// .. 4t + 3, 16 + 4t .. 16 + 4t + 3} (row index fastest); B registers rows 4t
// .. 4t + 3 and 16 + 4t .. of column g; D rows {g, g + 8} x columns {2t,
// 2t + 1} (column fastest).
__device__ __forceinline__ void mma_u8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The Q8.8 modes as two chained band products on the int8 tensor cores. A
// warp owns a strip of 16 columns of the tile and walks down it in units of
// 16 rows. Horizontal pass first (the 2-D sum is an exact integer in either
// order): H^T (16 columns x 8 rows) = band(taps) (16 x 32 KS) * tile^T, whose
// B operand is the row-major byte tile as it lies in shared memory. The
// result's registers, split into low and high bytes (a row sum is at most
// 255 * 256), ARE the A operand of the vertical product V^T (16 columns x 8
// rows) = H^T (16 x 32 KS) * band^T, because the order of the contraction
// index is free: slot 4t + e of a 16-row unit is its row 2t + (e & 1) +
// 8 (e >> 1), and the band operand is built in that order. So the row sums
// never leave the registers; a window of 2 KS units slides down the strip.
template <int MODE, int KS>
__global__ void __launch_bounds__(kThreads, KS <= 2 ? 4 : 3)
gauss_mma_kernel(const uint8_t* __restrict__ src, const int* __restrict__ taps,
                 uint8_t* __restrict__ dst, int h, int w, int r) {
  static_assert(MODE != kAdaptive, "the adaptive mode's f32 order is pinned");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_big;
  __shared__ uint32_t s_magic[MODE == kDivide ? 256 : 1];   // the divide mode's table
  constexpr int pitch = mma_pitch(KS);
  uint8_t* band = smem;                            // 4 copies, copy s at byte i: tap i + s - 16
  uint8_t* outb = band + 4 * kTapCopy;             // kTileH x kOutPitch results
  uint8_t* in = outb + kTileH * kOutPitch;         // the haloed tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int tw = min(kTileW, (w - x0 + 15) & ~15), th = min(kTileH, (h - y0 + 15) & ~15);
  const int sw = tw + 2 * r, sh = th + 2 * r;
  const long long plane = (long long)blockIdx.z * h * w;

  // the taps as bytes, zero outside the kernel, in four copies shifted by
  // one byte each, so that any 4 (or 2) consecutive taps are one aligned
  // load; fetched before the tile and stored after it, behind its latency
  static_assert(4 * kTapCopy == 2 * kThreads, "two bytes of the tap copies per thread");
  int tapv[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int i = tid + c * kThreads, j = (i & (kTapCopy - 1)) + i / kTapCopy - 16;
    tapv[c] = j >= 0 && j <= 2 * r ? __ldg(taps + j) : 0;
  }
  if constexpr (MODE == kDivide) build_div255_magic(s_magic);
  load_tile<MODE>(src + plane, in, pitch, x0, y0, r, sw, sh, h, w);
  // The products also read what load_tile does not write: the words behind
  // the tile's sw columns up to the last strip's 32 KS, and the rows from sh
  // up to the next whole unit of 16. Those slots meet zero taps only (the
  // band is zero outside the kernel), and any byte times 0 is 0, so the sums
  // do not depend on them; zeroing them first was measured and cost 4-7% at
  // ksize 43 and 51, so they are left as they are.
  // a tap of 256 (ksize 1, a tiny sigma) does not fit a byte: the taps are
  // >= 0 and sum to 256, so it is the only one, and the 2-D sum is 65536
  // times the pixel it points at (below)
  bool mine = false;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int i = tid + c * kThreads;
    band[i] = (uint8_t)min(tapv[c], 255);
    if (tapv[c] > 255 && i < kTapCopy) s_big = i - 16, mine = true;
  }
  const int big = __syncthreads_or(mine) ? s_big : -1;

  const int cbase = warp * 16;
  if (cbase < tw && x0 + cbase < w) {
    auto taps4 = [&](int p) {   // taps p .. p + 3 as bytes of a word
      const int i = p + 16;
      return reinterpret_cast<const uint32_t*>(band + (i & 3) * kTapCopy)[i >> 2];
    };
    auto taps2 = [&](int p) -> uint32_t {
      const int i = p + 16;
      return reinterpret_cast<const uint16_t*>(band + (i & 1) * kTapCopy)[i >> 1];
    };
    // band(taps) as the A operand of the horizontal product: element (m, k)
    // is tap k - m, the weight of tile column cbase + k in output column m
    uint32_t ah[KS][4];
    // band^T as the B operand of the vertical one, for the two groups q of 8
    // output rows of a unit: slot k's row less the output row 8q + g
    uint32_t bv[KS][2][2];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[s][i] = taps4(32 * s + 16 * (i >> 1) + 4 * t - g - 8 * (i & 1));
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int hb = 0; hb < 2; ++hb) {
          const int p = 32 * s + 16 * hb + 2 * t - 8 * q - g;
          bv[s][q][hb] = taps2(p) | (taps2(p + 8) << 16);
        }
      }
    }

    // the window of row sums: per unit, low bytes for output columns g and
    // g + 8, then high bytes
    uint32_t win[2 * KS][4];
#pragma unroll
    for (int i = 0; i < 2 * KS; ++i) win[i][0] = win[i][1] = win[i][2] = win[i][3] = 0;
    const int units = th / 16 + 2 * KS - 1;
    for (int u = 0; u < units; ++u) {
#pragma unroll
      for (int i = 0; i + 1 < 2 * KS; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) win[i][e] = win[i + 1][e];
      }
      uint32_t pk[2][2] = {{0, 0}, {0, 0}};
      if (16 * u < sh) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          int hsum[4] = {0, 0, 0, 0};
          const uint32_t* row =
              reinterpret_cast<const uint32_t*>(in + (16 * u + 8 * nt + g) * pitch + cbase) + t;
#pragma unroll
          for (int s = 0; s < KS; ++s) {
            mma_u8(hsum, ah[s][0], ah[s][1], ah[s][2], ah[s][3], row[8 * s], row[8 * s + 4]);
          }
          pk[nt][0] = __byte_perm(hsum[0], hsum[1], 0x5410);
          pk[nt][1] = __byte_perm(hsum[2], hsum[3], 0x5410);
        }
      }
      win[2 * KS - 1][0] = __byte_perm(pk[0][0], pk[1][0], 0x6420);
      win[2 * KS - 1][1] = __byte_perm(pk[0][1], pk[1][1], 0x6420);
      win[2 * KS - 1][2] = __byte_perm(pk[0][0], pk[1][0], 0x7531);
      win[2 * KS - 1][3] = __byte_perm(pk[0][1], pk[1][1], 0x7531);
      if (u < 2 * KS - 1) continue;
      const int orow = 16 * (u - (2 * KS - 1));   // the unit of output rows the window now spans
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        int lo[4] = {32768, 32768, 32768, 32768}, hi[4] = {0, 0, 0, 0};   // the rounding's half
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          mma_u8(lo, win[2 * s][0], win[2 * s][1], win[2 * s + 1][0], win[2 * s + 1][1],
                 bv[s][q][0], bv[s][q][1]);
          mma_u8(hi, win[2 * s][2], win[2 * s][3], win[2 * s + 1][2], win[2 * s + 1][3],
                 bv[s][q][0], bv[s][q][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = orow + 8 * q + 2 * t + (e & 1), col = cbase + g + 8 * (e >> 1);
          // 32768 <= acc <= 255 * 65536 + 32768: the blur is acc's third byte
          int acc = (hi[e] << 8) + lo[e];
          if (big >= 0) acc = ((int)in[(row + big) * pitch + col + big] << 16) + 32768;
          outb[row * kOutPitch + col] =
              consume<MODE>(in[(row + r) * pitch + col + r], acc >> 16, s_magic);
        }
      }
    }
  }
  __syncthreads();

  const int vw = min(kTileW, w - x0), vh = min(kTileH, h - y0);
#pragma unroll 2
  for (int row = warp; row < vh; row += kWarps) {
    const uint8_t* res = outb + row * kOutPitch;
    uint8_t* drow = dst + plane + (long long)(y0 + row) * w + x0;
    uint8_t v[kTileW / 32];
#pragma unroll
    for (int c = 0; c < kTileW / 32; ++c) v[c] = res[lane + 32 * c];
#pragma unroll
    for (int c = 0; c < kTileW / 32; ++c) {
      if (lane + 32 * c < vw) drow[lane + 32 * c] = v[c];
    }
  }
}

template <int MODE, int KS>
int launch_mma(const uint8_t* src, const int* taps, uint8_t* dst, dim3 grid, int h, int w, int r,
               cudaStream_t stream) {
  gauss_mma_kernel<MODE, KS>
      <<<grid, kThreads, mma_smem_bytes(r), stream>>>(src, taps, dst, h, w, r);
  return (int)cudaGetLastError();
}

// The split form's vertical pass: vsum[b, y, x] = the column sum at (y, x).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
gauss_vpass_kernel(const uint8_t* __restrict__ src, const Acc<MODE>* __restrict__ taps,
                   Acc<MODE>* __restrict__ vsum, long long n, int h, int w, int r) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int x = (int)(i % w), y = (int)((i / w) % h);
    const uint8_t* col = src + (i - x - (long long)y * w) + x;   // column x of the plane
    vsum[i] = window_sum<MODE>(
        [&](int j) { return col[(long long)fold<MODE>(y - r + j, h) * w]; }, taps, r);
  }
}

// The split form's horizontal pass over vsum's rows, and the epilogue.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
gauss_hpass_kernel(const uint8_t* __restrict__ src, const Acc<MODE>* __restrict__ taps,
                   const Acc<MODE>* __restrict__ vsum, uint8_t* __restrict__ dst, long long n,
                   int w, int r, int idelta) {
  __shared__ uint32_t s_magic[MODE == kDivide ? 256 : 1];   // the divide mode's table
  if constexpr (MODE == kDivide) {
    build_div255_magic(s_magic);
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int x = (int)(i % w);
    const Acc<MODE>* row = vsum + (i - x);
    const Acc<MODE> acc = window_sum<MODE>(
        [&](int j) { return row[fold<MODE>(x - r + j, w)]; }, taps, r);
    dst[i] = epilogue<MODE>(src[i], acc, idelta, s_magic);
  }
}

template <int MODE>
int launch(const void* src_v, const void* taps_v, void* dst_v, void* scratch, int batch,
           int h, int w, int r, int idelta, cudaStream_t stream) {
  const uint8_t* src = static_cast<const uint8_t*>(src_v);
  const Acc<MODE>* taps = static_cast<const Acc<MODE>*>(taps_v);
  uint8_t* dst = static_cast<uint8_t*>(dst_v);
  if (2 * r + 1 > kMaxTiledKsize) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const long long n = (long long)batch * h * w;
    const unsigned blocks = (unsigned)std::min<long long>((n + kThreads - 1) / kThreads, 1 << 20);
    Acc<MODE>* vsum = static_cast<Acc<MODE>*>(scratch);
    gauss_vpass_kernel<MODE><<<blocks, kThreads, 0, stream>>>(src, taps, vsum, n, h, w, r);
    gauss_hpass_kernel<MODE><<<blocks, kThreads, 0, stream>>>(src, taps, vsum, dst, n, w, r,
                                                              idelta);
    return (int)cudaGetLastError();
  }
  if (batch > 65535 || (h + kTileH - 1) / kTileH > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((w + kTileW - 1) / kTileW),
                  (unsigned)((h + kTileH - 1) / kTileH), (unsigned)batch);
  if constexpr (MODE != kAdaptive) {
    static_assert(mma_smem_bytes(kMmaMaxR) <= 48 * 1024, "no opt-in for the tensor-core form");
    if (r <= kMmaMaxR) {
      switch (mma_steps(r)) {
        case 1: return launch_mma<MODE, 1>(src, taps, dst, grid, h, w, r, stream);
        case 2: return launch_mma<MODE, 2>(src, taps, dst, grid, h, w, r, stream);
        default: return launch_mma<MODE, 3>(src, taps, dst, grid, h, w, r, stream);
      }
    }
  }
  // opted in to the widest tile's shared memory once per card and mode (the
  // attribute is per device; setting it again is harmless but costs the host)
  static std::atomic<bool> opted_in[kMaxCards];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxCards) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(gauss_sep_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(kMaxTiledKsize / 2));
    if (e != cudaSuccess) return (int)e;
    opted_in[dev].store(true, std::memory_order_release);
  }
  const size_t smem = smem_bytes(r);
  gauss_sep_kernel<MODE><<<grid, kThreads, smem, stream>>>(src, taps, dst, h, w, r, idelta);
  return (int)cudaGetLastError();
}

__global__ void divide_table_kernel(uint8_t* __restrict__ out) {
  __shared__ uint32_t s_magic[256];
  build_div255_magic(s_magic);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 256 * 256) out[i] = (uint8_t)div255_round_half_even(i >> 8, i & 255, s_magic[i & 255]);
}

}  // namespace

// Bytes of device scratch that tpuimage_gauss_sep needs for this call: 0 for
// the tiled form, 4 per pixel (the vertical sums) for the split form.
extern "C" long long tpuimage_gauss_sep_scratch(int batch, int h, int w, int ksize) {
  return ksize > kMaxTiledKsize ? 4LL * batch * h * w : 0;
}

// taps: ksize int32 Q8.8 taps (modes 0-3) or ksize float32 taps (mode 4),
// on the device; scratch: tpuimage_gauss_sep_scratch() bytes on the device
// (may be null when that is 0). Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int tpuimage_gauss_sep(const void* src, const void* taps, void* dst, void* scratch,
                                  int batch, int h, int w, int ksize, int mode, int idelta,
                                  void* stream) {
  if (ksize < 1 || ksize % 2 == 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  const int r = ksize / 2;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (mode) {
    case kNone: return launch<kNone>(src, taps, dst, scratch, batch, h, w, r, idelta, s);
    case kDivide: return launch<kDivide>(src, taps, dst, scratch, batch, h, w, r, idelta, s);
    case kSubtract:
      return launch<kSubtract>(src, taps, dst, scratch, batch, h, w, r, idelta, s);
    case kSub: return launch<kSub>(src, taps, dst, scratch, batch, h, w, r, idelta, s);
    case kAdaptive:
      return launch<kAdaptive>(src, taps, dst, scratch, batch, h, w, r, idelta, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[num * 256 + den] = the divide epilogue of (num, den), for all 65,536
// pairs: the same device function the kernel runs, for testing on the card.
extern "C" int tpuimage_divide_table(void* out, void* stream) {
  divide_table_kernel<<<256, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
