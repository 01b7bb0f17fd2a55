// Rows of u8 planes as 32-bit words, for the byte-mask stencils that a
// warp walks down a strip of rows (inkmask.cu, binary_close3 in morph3.cu).
//
// A warp owns a run of 32 N words of one image's column grid: lane l holds
// the N words at columns cx0 + 4 N l .. cx0 + 4 N (l + 1) - 1 (cx0 may be
// negative: halo lanes left of the image). Rows start at any byte address
// (an odd width, a view at an odd offset), so each row of an input is read
// as the 32 N aligned words from the one that holds column cx0, and each
// word of the column grid is funnel-shifted from two of them, the last of
// a lane's from its right neighbour's first; lane 31 has no right
// neighbour, so its last word is not the row's and the kernels give lane
// 31 nothing to store. Each row of an output is written as the aligned
// words of its own alignment, each word by exactly one warp, with bytes at
// the row's ends. Nothing outside [row, row + w) is written; a word that
// holds no byte of the row is not read.
//
// The helpers hold no branch around a shuffle, so a kernel can keep a
// group of rows in one straight line of code that the compiler
// interleaves.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr unsigned kAllLanes = 0xffffffffu;

// The least byte value v with (float)v > t: a strict f32 compare of bytes
// with t is then v >= k. 0 for t < 0, 256 (no byte) for t >= 255 or NaN.
__device__ __forceinline__ int least_above(float t) {
  if (!(t >= 0.0f)) return t != t ? 256 : 0;
  if (t >= 255.0f) return 256;
  return (int)floorf(t) + 1;
}

// A compare of bytes with an f32 threshold t: at(x) has 0xff in each byte
// of x that is > t, else 0.
struct ByteThreshold {
  uint32_t k4, on;   // least_above(t) in each byte (255 when none is); 0 when none is
  __device__ __forceinline__ explicit ByteThreshold(float t) {
    const int k = least_above(t);
    k4 = 0x01010101u * (uint32_t)min(k, 255);
    on = k > 255 ? 0u : kAllLanes;
  }
  __device__ __forceinline__ uint32_t at(uint32_t x) const { return __vcmpgeu4(x, k4) & on; }
};

// 0xff in each byte of the word at columns cx .. cx + 3 that lies in [0, w).
__device__ __forceinline__ uint32_t columns_in(int cx, int w) {
  if (cx >= 0 && cx + 3 < w) return kAllLanes;
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (cx + i >= 0 && cx + i < w) m |= 0xffu << (8 * i);
  }
  return m;
}

// Whether a run of 32 N words whose lane 0 holds column cx0 lies inside
// rows of w bytes: then every word it reads holds bytes of the row and
// every word it writes lies in the row (EDGE false below).
template <int N>
__device__ __forceinline__ bool run_inside(int cx0, int w) {
  return cx0 >= 0 && cx0 + 128 * N <= w;
}

// The lane's N aligned words of the row [row, row + w) for a run whose
// lane 0 holds column cx0. EDGE: a word with no byte of the row reads as 0.
template <int N, bool EDGE>
__device__ __forceinline__ void load_words(uint32_t (&q)[N], const uint8_t* row, int w,
                                           int cx0, int lane) {
  const uintptr_t start = reinterpret_cast<uintptr_t>(row);
  const uintptr_t a = ((start + (uintptr_t)(intptr_t)cx0) & ~(uintptr_t)3)
                      + 4u * N * (unsigned)lane;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uintptr_t aj = a + 4u * j;
    q[j] = EDGE && !(aj < start + w && aj + 4 > start)
               ? 0u : __ldg(reinterpret_cast<const uint32_t*>(aj));
  }
}

// The byte offset of column cx0 of the row in its aligned word: the shift
// between the row's aligned words and the column grid.
__device__ __forceinline__ unsigned grid_offset(const void* row, int cx0) {
  return (unsigned)(reinterpret_cast<uintptr_t>(row) + (uintptr_t)(intptr_t)cx0) & 3u;
}

// The lane's words of the column grid from the row's aligned words q
// (load_words) at offset `off` (grid_offset); bytes outside the row are
// whatever those words held there, or 0: the caller masks them. All lanes
// call.
template <int N>
__device__ __forceinline__ void to_columns(uint32_t (&v)[N], const uint32_t (&q)[N],
                                           unsigned off) {
  const uint32_t next = __shfl_down_sync(kAllLanes, q[0], 1);
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = __funnelshift_r(q[j], j + 1 < N ? q[j + 1] : next, 8 * off);
}

template <int N>
__device__ __forceinline__ void realign(uint32_t (&v)[N], const uint32_t (&q)[N],
                                        const uint8_t* row, int cx0) {
  to_columns<N>(v, q, grid_offset(row, cx0));
}

// The inverse: the row's aligned words (the words of load_words' grid) at
// offset `off` from the column-grid words v; each takes the top `off`
// bytes of the grid word before it and the low 4 - off of its own. All
// lanes call.
template <int N>
__device__ __forceinline__ void to_row_words(uint32_t (&q)[N], const uint32_t (&v)[N],
                                             unsigned off) {
  const uint32_t prev = __shfl_up_sync(kAllLanes, v[N - 1], 1);
#pragma unroll
  for (int j = 0; j < N; ++j) q[j] = __funnelshift_rc(j ? v[j - 1] : prev, v[j], 32 - 8 * off);
}

// Writes the row's aligned words q (load_words' grid: lane l's word j at
// column cx0 - off + 4 (N l + j)) of the lanes in [first, last] if `live`;
// EDGE: only the columns in [0, w) (a run inside the row has none outside).
template <int N, bool EDGE>
__device__ __forceinline__ void store_words(uint8_t* row, bool live, int w, int cx0,
                                            unsigned off, int first, int last, int lane,
                                            const uint32_t (&q)[N]) {
  if (!live || lane < first || lane > last) return;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = cx0 - (int)off + 4 * (N * lane + j);
    if (!EDGE || (c >= 0 && c + 3 < w)) {
      *reinterpret_cast<uint32_t*>(row + c) = q[j];
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (c + i >= 0 && c + i < w) row[c + i] = (uint8_t)(q[j] >> (8 * i));
      }
    }
  }
}

// The row's words with the lane's neighbours' words: ext[0, N) the words
// of the lane two before (filled only when `far`), ext[N, 2N) of the lane
// before, ext[2N, 3N) the lane's own, ext[3N] the next lane's first. All
// lanes call.
template <int N>
struct Around {
  uint32_t ext[3 * N + 1];
  __device__ __forceinline__ Around(const uint32_t (&v)[N], bool far) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      ext[2 * N + j] = v[j];
      ext[N + j] = __shfl_up_sync(kAllLanes, v[j], 1);
      ext[j] = far ? __shfl_up_sync(kAllLanes, v[j], 2) : 0u;
    }
    ext[3 * N] = __shfl_down_sync(kAllLanes, v[0], 1);
  }
  // Word j of the row shifted right by s bytes (column c takes c - s),
  // s < 4 (N + 1) + 4 (far) ... as far as ext reaches.
  __device__ __forceinline__ uint32_t from_left(int j, int s) const {
    const int p = 2 * N + j - s / 4, r = s % 4;
    return r == 0 ? ext[p] : __funnelshift_l(ext[p - 1], ext[p], 8 * r);
  }
  // Word j of the row shifted left by 1 byte (column c takes c + 1).
  __device__ __forceinline__ uint32_t from_right(int j) const {
    return __funnelshift_r(ext[2 * N + j], ext[2 * N + j + 1], 8);
  }
};

// Writes the run's column-grid words v to one output row if `live`. With
// x0 = cx0 + 4 N first (the first owned lane's column) and a = (row + x0)
// & 3, lane l in [first, last] writes the N aligned words from column x0 -
// a + 4 N (l - first): each the top a bytes of the word before it in the
// grid and the low 4 - a of its own, so runs of a row that start 4 N (last
// - first + 1) columns apart write each aligned word once. EDGE: columns
// outside [0, w) are left alone (a run inside the row has none). All lanes
// call.
template <int N, bool EDGE>
__device__ __forceinline__ void store_row(uint8_t* row, bool live, int w, int cx0, int first,
                                          int last, int lane, const uint32_t (&v)[N]) {
  const unsigned off = grid_offset(row, cx0);   // that of x0 too: 4 N first apart
  uint32_t q[N];
  to_row_words<N>(q, v, off);
  store_words<N, EDGE>(row, live, w, cx0, off, first, last, lane, q);
}

// How a kernel's planes lie: kAnyAlign, each plane's rows at their own
// offsets (every input row realigned to the column grid, every output row
// realigned back); kCoAligned, all planes' bases at one offset mod 4, so
// every row of every plane shares grid_offset and a kernel may work in the
// row's own aligned words where no neighbour is involved; kWordAligned,
// that offset 0 for every row (bases and width multiples of 4): the
// column grid is the rows' own word grid.
enum Alignment { kAnyAlign = 0, kCoAligned = 1, kWordAligned = 2 };

__host__ __forceinline__ Alignment alignment_of(std::initializer_list<const void*> planes,
                                                int w) {
  const uintptr_t first = reinterpret_cast<uintptr_t>(*planes.begin()) & 3u;
  for (const void* p : planes) {
    if ((reinterpret_cast<uintptr_t>(p) & 3u) != first) return kAnyAlign;
  }
  return first == 0 && w % 4 == 0 ? kWordAligned : kCoAligned;
}

// The number of runs of `owned` stored words that cover a row of w bytes
// at any alignment (the first run's words start up to 3 bytes before
// column 0).
__host__ __device__ __forceinline__ int runs_for(int w, int owned) {
  return (w + 3 + 4 * owned - 1) / (4 * owned);
}

}  // namespace
