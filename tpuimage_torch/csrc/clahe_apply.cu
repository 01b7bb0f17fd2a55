// CLAHE apply: the per-pixel bilinear blend of the four neighbouring tile
// LUTs. gray (B, H, W) u8, luts (B, ty, tx, 256) u8, rows (H, 3) f32,
// cols (W, 3) f32 -> (B, H, W) u8.
//
// Replaces: tpuimage/ops/pallas_kernels.py:1132 clahe_apply_pallas (body
// _make_clahe_slab_kernel), the TPU kernel behind tpuimage.ops.histogram.clahe
// on the night paths.
//
// Bound on the H100: memory, 1 byte read and 1 written a pixel (the LUTs
// and tables are ~1% more); the work a pixel is four table lookups, 6
// multiplies, 3 adds and a rounding, which at ~20 instructions a pixel
// comes close to the bytes' time (~0.006 ms at 1280x853 x 8), so the
// design counts instructions and set-up latency too.
//
// The blend is cv2's (CLAHE_Interpolation_Body), in its order and
// roundings: (l11*xa1 + l12*xa)*ya1 + (l21*xa1 + l22*xa)*ya, columns
// first, each product and sum rounded to f32 (__fmul_rn / __fadd_rn, which
// nvcc never contracts), then cvRound and the clamp. Blend tables: a row
// (t1, t2, a) of `rows` per image row and of `cols` per column
// (histogram.clahe_blend_table): the two tiles and the fraction; the other
// weight is 1 - a. At the image's edges both tiles are the same one and
// cv2 still takes two products, which the tables keep.
//
// Design. Taking parts of earlier designs away on the card showed what
// holds this kernel: one byte in flight a thread a step, the quarter-rate
// byte-to-float conversions (I2F), and each block's set-up latency when
// the blocks run in several waves (PERF.md). So:
// - One wave: the rows of each (image, 256 columns) are split among as
//   many blocks as the SMs hold (4 each), 66 rows at 1280x853 x 8. A
//   thread holds a word of 4 pixels of every 4th row of its block and
//   keeps the next group of 4 rows' loads in flight; the first group is
//   issued before the set-up.
// - Set-up, once a block: its rows' and columns' table entries (a thread a
//   row or column), each tile pair's key k, the pair (max(k, 0), min(k + 1,
//   n - 1)) that cv2's tables hold (k from -1 at the top or left edge to
//   n - 1 at the bottom or right), the range of key quads they reach (2 x
//   3 at 8x8 tiles on 1280x853), and only those quads staged, each as one
//   32-bit word a level holding the four LUT values (r1 c1, r2 c1, r1 c2,
//   r2 c2): a pixel costs one shared 32-bit lookup and no table is staged
//   whole. A block whose quads exceed the budget (tiles a few pixels wide)
//   or whose tables hold another pair reads the four values from the LUTs
//   in device memory instead, so any ty x tx and any table works.
// - Each byte becomes the float 2^23 + v by one byte permute, and
//   fma(2^23 + v, w, -2^23 w) = round(v w): exactly __fmul_rn(v, w) for
//   finite w (|w| < 2^100), with the column weights (1 - xa, xa) and their
//   -2^23 multiples held in registers. Then the row blend, a clamp to [0,
//   255] and a round-to-nearest-even by adding 1.5 * 2^23: cvRound and the
//   clamp, in the order that gives the same byte. The clamp is left out
//   where every fraction of the block lies in [0, 1]: the blend then stays
//   in [0, 255.001]. So the kernel equals its plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 64;                    // words of 4 pixels a block spans
constexpr int kCols = 4 * kChunks;             // 256 columns a block
constexpr int kPhases = kThreads / kChunks;    // threads a word: rows phase + kPhases i
constexpr int kGroup = 4;                      // rows a thread loads together, a group ahead
constexpr int kMaxRows = kThreads;             // rows a block (a thread a row for the pairs)
constexpr int kBlocksPerSm = 4;                // the register budget: 64 a thread
constexpr int kQuads = 16;                     // tile quads a block may stage (16 KiB)
constexpr int kBins = 256;
constexpr float kTwo23 = 8388608.0f;           // 2^23: the float 2^23 + v holds the byte v
constexpr float kRound = 12582912.0f;          // 1.5 * 2^23: adding it rounds to an integer

constexpr int kNoKey = INT32_MIN;              // a tile pair not of cv2's form

static_assert(kCols == kThreads, "a thread a column for the tables");

// Entry i of a blend table with n tiles: the tiles (clamped into [0, n)),
// the fraction a, and the pair's key: the k with (t1, t2) = (max(k, 0),
// min(k + 1, n - 1)), or kNoKey.
__device__ __forceinline__ void table_entry(const float* __restrict__ tab, long long i, int n,
                                            int* t1, int* t2, int* key, float* a) {
  const float f1 = tab[3 * i], f2 = tab[3 * i + 1];
  *a = tab[3 * i + 2];
  const int u1 = f1 >= 0.0f ? __float2int_rz(fminf(f1, (float)(n - 1))) : 0;
  const int u2 = f2 >= 0.0f ? __float2int_rz(fminf(f2, (float)(n - 1))) : 0;
  int k = kNoKey;
  if (u2 == u1 + 1) {
    k = u1;
  } else if (u1 == u2 && u1 == 0) {
    k = -1;
  } else if (u1 == u2 && u1 == n - 1) {
    k = n - 1;
  }
  *t1 = u1, *t2 = u2, *key = k;
}

// Byte k of q as the float 2^23 + q.k.
__device__ __forceinline__ float byte_float(uint32_t q, int k) {
  return __int_as_float(__byte_perm(q, 0x4b000000u, 0x7540 + k));
}

// The blended byte (in the low byte of the result) of the four LUT values
// in q (l11, l21, l12, l22) with the column's weights cw = (xa1, xa,
// -2^23 xa1, -2^23 xa) and the row's rw = (ya1, ya): fma(2^23 + l, w,
// -2^23 w) is round(l w).
// CLAMP false: the caller knows res lies in [0, 255.5), where the clamp
// changes nothing.
template <bool CLAMP>
__device__ __forceinline__ uint32_t blend(uint32_t q, const float4& cw, const float2& rw) {
  const float top = __fadd_rn(__fmaf_rn(byte_float(q, 0), cw.x, cw.z),
                              __fmaf_rn(byte_float(q, 2), cw.y, cw.w));
  const float bot = __fadd_rn(__fmaf_rn(byte_float(q, 1), cw.x, cw.z),
                              __fmaf_rn(byte_float(q, 3), cw.y, cw.w));
  float res = __fadd_rn(__fmul_rn(top, rw.x), __fmul_rn(bot, rw.y));
  if (CLAMP) res = fminf(fmaxf(res, 0.0f), 255.0f);
  return (uint32_t)__float_as_int(__fadd_rn(res, kRound));
}

// The weights (1 - a, a, -2^23 (1 - a), -2^23 a) of a fraction a, and
// whether a lies in [0, 1], where every blend stays in [0, 255.5) and the
// clamp is a no-op (false for NaN).
__device__ __forceinline__ float4 weights(float a) {
  const float a1 = __fsub_rn(1.0f, a);
  return make_float4(a1, a, __fmul_rn(-kTwo23, a1), __fmul_rn(-kTwo23, a));
}
__device__ __forceinline__ bool tame(float a) { return a >= 0.0f && a <= 1.0f; }

// The 4 bytes at p, `left` (>= 1) of them in the row: one word (V 4: p
// and the row's width multiples of 4) or bytes (V 1; those past the row
// read as 0).
template <int V>
__device__ __forceinline__ uint32_t load_word(const uint8_t* p, int left) {
  if constexpr (V == 4) {
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  } else {
    uint32_t q = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < left) q |= (uint32_t)__ldg(p + i) << (8 * i);
    }
    return q;
  }
}

template <int V>
__device__ __forceinline__ void store_word(uint8_t* p, int left, uint32_t o) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(p) = o;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < left) p[i] = (uint8_t)(o >> (8 * i));
    }
  }
}

// A thread's columns: the quad column (a byte offset into the staged
// quads) and the weights.
struct Cols {
  int q[4];
  float4 w[4];
};

// A thread's rows: its word in its first row of the source and of the
// output, the step to its next row (kPhases rows), how many rows it has
// and the columns left in the row from its word (w - x).
struct Rows {
  const uint8_t* src;
  uint8_t* dst;
  long long step;
  int n, left;
};

template <int V>
__device__ __forceinline__ void load_rows(const Rows& rs, int i0, uint32_t (&px)[kGroup]) {
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    px[i] = i0 + i < rs.n ? load_word<V>(rs.src + (i0 + i) * rs.step, rs.left) : 0u;
  }
}

// The rows through the staged quads; row_off[kPhases i] is row i's word
// offset into them, row_w[kPhases i] its weights.
template <int V, bool CLAMP>
__device__ __forceinline__ void rows_from_quads(const Rows& rs, const Cols& cols,
                                                uint32_t (&cur)[kGroup], const uint32_t* quads,
                                                const int* row_off, const float2* row_w) {
  for (int i0 = 0; i0 < rs.n; i0 += kGroup) {
    uint32_t nxt[kGroup];
    load_rows<V>(rs, i0 + kGroup, nxt);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (i0 + i >= rs.n) break;
      const int base = row_off[kPhases * (i0 + i)];
      const float2 rw = row_w[kPhases * (i0 + i)];
      uint32_t res[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t v = __byte_perm(cur[i], 0, 0x4440 + j);
        res[j] = blend<CLAMP>(quads[base + cols.q[j] + (int)v], cols.w[j], rw);
      }
      store_word<V>(rs.dst + (i0 + i) * rs.step, rs.left,
                    __byte_perm(__byte_perm(res[0], res[1], 0x0040),
                                __byte_perm(res[2], res[3], 0x0040), 0x5410));
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) cur[i] = nxt[i];
  }
}

// The rows through the LUTs in device memory (a block whose quads exceed
// the budget or whose tables hold other pairs); row_t1[kPhases i] and
// row_t2[kPhases i] are row i's tiles, col_t1[c[j]], col_t2[c[j]] and
// col_w[c[j]] those of this thread's column j (read from shared memory at
// each pixel, which keeps this path's registers below the staged path's).
template <int V>
__device__ __forceinline__ void rows_from_luts(const Rows& rs, const int (&c)[4],
                                               uint32_t (&cur)[kGroup], const uint8_t* lut,
                                               const int* row_t1, const int* row_t2,
                                               const float2* row_w, const int* col_t1,
                                               const int* col_t2, const float4* col_w, int tx) {
  for (int i0 = 0; i0 < rs.n; i0 += kGroup) {
    uint32_t nxt[kGroup];
    load_rows<V>(rs, i0 + kGroup, nxt);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (i0 + i >= rs.n) break;
      const int r1 = row_t1[kPhases * (i0 + i)], r2 = row_t2[kPhases * (i0 + i)];
      const float2 rw = row_w[kPhases * (i0 + i)];
      uint32_t res[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* l = lut + ((cur[i] >> (8 * j)) & 0xff);
        const int c1 = col_t1[c[j]], c2 = col_t2[c[j]];
        const uint32_t q = (uint32_t)__ldg(l + (r1 * tx + c1) * kBins)
                           | (uint32_t)__ldg(l + (r2 * tx + c1) * kBins) << 8
                           | (uint32_t)__ldg(l + (r1 * tx + c2) * kBins) << 16
                           | (uint32_t)__ldg(l + (r2 * tx + c2) * kBins) << 24;
        res[j] = blend<true>(q, col_w[c[j]], rw);
      }
      store_word<V>(rs.dst + (i0 + i) * rs.step, rs.left,
                    __byte_perm(__byte_perm(res[0], res[1], 0x0040),
                                __byte_perm(res[2], res[3], 0x0040), 0x5410));
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) cur[i] = nxt[i];
  }
}

// One block: rows [y0, y0 + rows) (rows <= kMaxRows) x 256 columns of one
// image; a thread the word of 4 columns x at rows y0 + phase + kPhases i.
template <int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
clahe_apply_kernel(const uint8_t* __restrict__ gray, const uint8_t* __restrict__ luts,
                   const float* __restrict__ R, const float* __restrict__ C,
                   uint8_t* __restrict__ out, int h, int w, int ty, int tx, int block_rows) {
  __shared__ uint4 quad_s4[kQuads * kBins / 4];
  __shared__ int col_t1[kCols], col_t2[kCols], col_key[kCols];
  __shared__ int row_t1[kMaxRows], row_t2[kMaxRows], row_off[kMaxRows];
  __shared__ float4 col_w[kCols];
  __shared__ float2 row_w[kMaxRows];
  __shared__ int4 range_s[kThreads / 32];
  __shared__ int flags_s[kThreads / 32];

  const int t = threadIdx.x, phase = t / kChunks;
  const int b = blockIdx.z, y0 = blockIdx.y * block_rows, xb = blockIdx.x * kCols;
  const int rows = min(block_rows, h - y0), x = xb + 4 * (t % kChunks);
  const bool col_in = x < w;
  const uint8_t* src = gray + (long long)b * h * w + (long long)y0 * w;
  uint8_t* dst = out + (long long)b * h * w + (long long)y0 * w;

  // 1. the first group of this thread's rows in flight before anything else
  uint32_t cur[kGroup] = {};
  if (col_in) {
    load_rows<V>(Rows{src + (long long)phase * w + x, nullptr, (long long)kPhases * w,
                      (rows - phase + kPhases - 1) / kPhases, w - x}, 0, cur);
  }

  // 2. the block's row and column table entries, and the range of keys
  //    they reach
  int rmin = INT32_MAX, rmax = INT32_MIN, cmin = INT32_MAX, cmax = INT32_MIN;
  bool tame_w = true, keyed = true;
  if (t < rows) {
    int t1, t2, k;
    float a;
    table_entry(R, y0 + t, ty, &t1, &t2, &k, &a);
    const float4 wt = weights(a);
    row_t1[t] = t1, row_t2[t] = t2, row_off[t] = k, row_w[t] = make_float2(wt.x, wt.y);
    rmin = rmax = k;
    tame_w = tame(a);
    keyed = k != kNoKey;
  }
  if (xb + t < w) {
    int t1, t2, k;
    float a;
    table_entry(C, xb + t, tx, &t1, &t2, &k, &a);
    col_t1[t] = t1, col_t2[t] = t2, col_key[t] = k, col_w[t] = weights(a);
    cmin = cmax = k;
    tame_w = tame_w && tame(a);
    keyed = keyed && k != kNoKey;
  }
  {
    const unsigned all = 0xffffffffu;
    const int4 r = make_int4(__reduce_min_sync(all, rmin), __reduce_max_sync(all, rmax),
                             __reduce_min_sync(all, cmin), __reduce_max_sync(all, cmax));
    const int flags = (__all_sync(all, tame_w) ? 1 : 0) | (__all_sync(all, keyed) ? 2 : 0);
    if (t % 32 == 0) range_s[t / 32] = r, flags_s[t / 32] = flags;
  }
  __syncthreads();
  bool clamp = false, all_keyed = true;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) {
    const int4 r = range_s[k];
    rmin = min(rmin, r.x), rmax = max(rmax, r.y), cmin = min(cmin, r.z), cmax = max(cmax, r.w);
    clamp = clamp || !(flags_s[k] & 1);
    all_keyed = all_keyed && (flags_s[k] & 2);
  }
  // the same in every thread; the spans are only read where all_keyed
  const long long cspan = (long long)cmax - cmin + 1;
  const bool staged = all_keyed && ((long long)rmax - rmin + 1) * cspan <= kQuads;
  // each row's word offset into the staged quads
  if (staged && t < rows) row_off[t] = (row_off[t] - rmin) * (int)cspan * kBins;
  const uint8_t* lut = luts + (long long)b * ty * tx * kBins;

  // 3. the quads: for 4 levels of one quad, a word of each tile, transposed
  if (staged) {
    const int groups = (rmax - rmin + 1) * (int)cspan * (kBins / 4);
    for (int g = t; g < groups; g += kThreads) {
      const int q = g / (kBins / 4), v4 = 4 * (g % (kBins / 4));
      const int kr = rmin + q / (int)cspan, kc = cmin + q % (int)cspan;
      const int r1 = max(kr, 0), r2 = min(kr + 1, ty - 1);
      const int c1 = max(kc, 0), c2 = min(kc + 1, tx - 1);
      auto word = [&](int r, int c) {
        return __ldg(reinterpret_cast<const uint32_t*>(lut + (r * tx + c) * kBins + v4));
      };
      const uint32_t a = word(r1, c1), bb = word(r2, c1), c = word(r1, c2), d = word(r2, c2);
      const uint32_t ab_lo = __byte_perm(a, bb, 0x5140), ab_hi = __byte_perm(a, bb, 0x7362);
      const uint32_t cd_lo = __byte_perm(c, d, 0x5140), cd_hi = __byte_perm(c, d, 0x7362);
      quad_s4[g] = make_uint4(__byte_perm(ab_lo, cd_lo, 0x5410), __byte_perm(ab_lo, cd_lo, 0x7632),
                              __byte_perm(ab_hi, cd_hi, 0x5410), __byte_perm(ab_hi, cd_hi, 0x7632));
    }
  }
  __syncthreads();
  if (!col_in) return;

  // 4. this thread's columns (those past the row reuse the last one's):
  //    for the staged quads, the quad column (a byte offset into them)
  //    and the weights
  int c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j] = min(x + j, w - 1) - xb;
  const Rows rs{src + (long long)phase * w + x, dst + (long long)phase * w + x,
                (long long)kPhases * w, (rows - phase + kPhases - 1) / kPhases, w - x};
  if (!staged) {
    rows_from_luts<V>(rs, c, cur, lut, row_t1 + phase, row_t2 + phase, row_w + phase, col_t1,
                      col_t2, col_w, tx);
    return;
  }
  Cols cols;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cols.q[j] = (col_key[c[j]] - cmin) * kBins;
    cols.w[j] = col_w[c[j]];
  }
  const auto* quads = reinterpret_cast<const uint32_t*>(quad_s4);
  if (clamp) {
    rows_from_quads<V, true>(rs, cols, cur, quads, row_off + phase, row_w + phase);
  } else {
    rows_from_quads<V, false>(rs, cols, cur, quads, row_off + phase, row_w + phase);
  }
}

}  // namespace

// luts must be 16-byte aligned (the wrapper checks); R and C are the row
// (H, 3) and column (W, 3) blend tables. Returns cudaGetLastError() after the launch (0
// on success).
extern "C" int tpuimage_clahe_apply(const void* gray, const void* luts,
                                    const void* R, const void* C, void* out,
                                    int batch, int h, int w, int ty, int tx,
                                    void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (batch > 65535 || ty <= 0 || tx <= 0) return (int)cudaErrorInvalidValue;
  // one wave: the rows of each (image, 256 columns) split among as many
  // blocks as the SMs hold at kBlocksPerSm, at most kMaxRows rows a block
  const long long slabs = (w + kCols - 1) / kCols;
  long long parts = sm_count() > 0 ? (long long)kBlocksPerSm * sm_count() / (slabs * batch) : 1;
  parts = std::max<long long>(std::min<long long>(parts, h), (h + kMaxRows - 1) / kMaxRows);
  const int block_rows = (int)((h + parts - 1) / parts);
  parts = (h + block_rows - 1) / block_rows;
  if (parts > 65535 || slabs > INT32_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)slabs, (unsigned)parts, (unsigned)batch);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const uint8_t*>(gray);
  const auto* l = static_cast<const uint8_t*>(luts);
  const auto* r = static_cast<const float*>(R);
  const auto* c = static_cast<const float*>(C);
  auto* o = static_cast<uint8_t*>(out);
  // whole words where both planes' rows start on one
  if ((reinterpret_cast<uintptr_t>(gray) | reinterpret_cast<uintptr_t>(out)
       | (uintptr_t)(unsigned)w) % 4 == 0) {
    clahe_apply_kernel<4><<<grid, kThreads, 0, s>>>(g, l, r, c, o, h, w, ty, tx, block_rows);
  } else {
    clahe_apply_kernel<1><<<grid, kThreads, 0, s>>>(g, l, r, c, o, h, w, ty, tx, block_rows);
  }
  return (int)cudaGetLastError();
}
