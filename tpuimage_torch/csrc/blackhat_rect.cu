// cv2.MORPH_BLACKHAT with a full odd kw x kh rectangle, on a batch of
// (B, H, W) u8 planes: saturate(close(src) - src), close = erode(dilate(src)).
//
// Replaces: tpuimage/ops/pallas_kernels.py blackhat_rect_pallas (body
// _make_blackhat_kernel), the ink mask's vertical 9x19 blackhat.
//
// Borders are ops.morphology's constant ones, as two separate pads: the
// dilation sees 0 outside the image, and the erosion pads the DILATED image
// with 255 (not the dilation of the padding), so every dilated value at an
// out-of-image position is reset to 255 before the erosion, as the TPU
// kernel's where(valid, d, 255) does. Both pads are the identities of their
// extreme, so each 1-D window is just clipped to the image. All integer
// min/max, so the kernel equals its plain version bit for bit. close >= src
// everywhere (each window of the erosion holds a dilated value whose window
// holds the pixel), so the saturation never clips.
//
// Bound on the H100: memory. Each pixel reads 1 byte and writes 1 (0.0049 ms
// for 8 A4 planes); the separable extremes need about 3 compares per pixel
// and 1-D pass (van Herk / Gil-Werman), far below the card's rate.
//
// Design, tiled form (while the tile fits a block's shared memory). One
// block of 256 threads per kTileH x kTileW output tile of one image; all
// data stays in shared memory between the load and the store:
// - Load: the 16-byte-aligned chunks that hold the source tile and its halo
//   of 2 rx columns and 2 ry rows (S) go to shared memory by cp.async, all
//   in flight at once; one more pass shifts each row to the tile's word grid
//   (849-pixel rows start off any boundary) and zeroes what lies outside the
//   image.
// - Four 1-D passes: the dilation's vertical max (S -> A), its horizontal
//   max (A -> D, out-of-image positions set to 255), the erosion's vertical
//   min (D -> A) and its horizontal min, which subtracts the source and
//   stages the result in D; the staged rows leave as aligned words.
// - Two pixels per operation: pixels are widened to 16 bits and paired in a
//   32-bit register, and one max.u16x2 / min.u16x2 (__vmaxu2 / __vminu2, one
//   VIMNMX.U16x2 each; __vmaxu4 on packed bytes compiles to six
//   instructions on sm_90a) serves both.
// - Vertical passes: a thread takes a word of four source columns (two
//   registers) and 16 consecutive rows, with van Herk's split: the suffix
//   extremes of in[0 .. 14], the core OP(in[15 .. k-1]) that every one of the
//   16 windows holds, the prefix extremes of in[k .. k+14]: k + 42 operations
//   and k + 15 loads for 16 outputs (shorter windows take k - 1 operations
//   an output). They write 16-bit pixels, so that the horizontal passes read
//   two pixels a word with no byte shifts.
// - Horizontal passes: a thread takes 8 pixel pairs of one row, consecutive
//   threads consecutive rows (odd word pitches put the 32 rows of a warp in
//   32 banks). Pair m covers pixels [2m, 2m + 2 rx] and [2m + 1, 2m + 1 + 2
//   rx]: OP(H[m], word m + rx, the half-word shift [H[m].hi, H[m+1].lo])
//   with H[m] = OP(words m .. m + rx - 1). The path's rx 4 has its own
//   unrolled pass; other radii take H from direct windows (rx < 8) or the
//   van Herk split.
// - Work items (line, run) are walked with a carried step, so no loop
//   divides by a runtime count.
// Measured on 8 A4 planes at 9x19 (tools/time_kernel_builds.py, H100 at
// 700 W): 0.040 ms, where the first design's direct windows took 0.19; of it the load
// ~0.011, the store ~0.010, the horizontal passes ~0.008, the vertical ones
// ~0.007 (each the time saved without it). Byte pixels two rows a register
// in the horizontal passes took 0.050 (their shared loads conflicted), word
// loads of the source two in flight a thread 0.044; taller, wider or
// narrower tiles were slower. Column strips of 2-10 tiles that a block
// walks down (the 4 ry halo rows carried in shared memory, the next tile's
// rows in flight by cp.async while one is computed) took 0.0445-0.0844, the
// longer strips the slower: at 4 tiles a strip, 7 x 5 x 8 blocks at 3 an
// SM (the separate landing buffer) keep fewer loads in flight than 1,064
// tiles at 4 an SM, whose blocks overlap each other's loads and passes.
//
// Split form (rectangles whose tile does not fit, e.g. 129x255): the four
// 1-D passes, one launch each, through two (B, H, W) byte planes of device
// scratch that the caller provides, each pass a window clipped to the image.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTileW = 128;               // a multiple of 2 kRunH
constexpr int kTileH = 64;                // >= kRunV
constexpr int kThreads = 256;
constexpr int kRunV = 16;                  // output rows a thread, vertical passes
constexpr int kRunH = 8;                   // output pixel pairs a thread, horizontal passes
constexpr size_t kMaxSmem = 227 * 1024;    // sm_90's opt-in shared memory per block

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
// a pitch in 32-bit words, made odd so that 32 rows fall into 32 banks
__host__ __device__ constexpr int odd_words(int words) { return words | 1; }

// The tile's buffers for a rectangle of radii (rx, ry). S holds the source
// as bytes (rows from y0 - 2 ry, columns from x0 - 2 rx, wa wide); A the
// dilation's vertical max as 16-bit pixels (rows from y0 - ry, S's
// columns); D the dilation as bytes (A's rows, columns from x0 - rx, wd
// wide). The erosion's vertical min (kTileH rows of D's columns, 16-bit)
// reuses A, and the staged output (kTileH rows at pitch kTileW + 4) D.
// Pitches in 32-bit words: ps (S), pa (A), pd (D), pe (the erosion's min).
struct Geometry {
  int rx, ry, wd, wa, sh, dh, ps, pa, pd, pe, nch;
  __host__ __device__ Geometry(int kw, int kh)
      : rx(kw / 2), ry(kh / 2), wd(round_up(kTileW + 2 * (kw / 2), 2 * kRunH)),
        wa(round_up(wd + 2 * rx, 4)), sh(kTileH + 4 * ry), dh(kTileH + 2 * ry),
        ps(odd_words(wa / 4)), pa(odd_words(wa / 2)), pd(odd_words(wd / 4)),
        pe(odd_words(wd / 2)), nch((wa + 15) / 16 + 1) {}
  __host__ __device__ size_t bytes_s() const { return round_up(4 * sh * ps, 16); }
  // A also holds the source's raw 16-byte chunks (nch a row) while it loads
  __host__ __device__ size_t bytes_a() const {
    const size_t dil = 4 * (size_t)dh * pa, ero = 4 * (size_t)kTileH * pe,
                 raw = 16 * (size_t)sh * nch;
    const size_t m = dil > ero ? dil : ero;
    return m > raw ? m : raw;
  }
  __host__ __device__ size_t bytes_d() const {
    const size_t dil = 4 * (size_t)dh * pd, stage = (size_t)kTileH * (kTileW + 4);
    return dil > stage ? dil : stage;
  }
  __host__ __device__ size_t smem_bytes() const { return bytes_s() + bytes_a() + bytes_d(); }
};

template <bool MAX>
__device__ __forceinline__ uint32_t op2(uint32_t a, uint32_t b) {
  return MAX ? __vmaxu2(a, b) : __vminu2(a, b);
}

// Four pixels as two registers of two 16-bit lanes.
struct Px4 {
  uint32_t lo, hi;
};

template <bool MAX>
__device__ __forceinline__ Px4 op4(Px4 a, Px4 b) {
  return {op2<MAX>(a.lo, b.lo), op2<MAX>(a.hi, b.hi)};
}

__device__ __forceinline__ Px4 widen(uint32_t w) {
  return {__byte_perm(w, 0u, 0x4140), __byte_perm(w, 0u, 0x4342)};
}

// the two bytes of a pixel pair, as the low half of a word
__device__ __forceinline__ uint32_t narrow2(uint32_t p) { return __byte_perm(p, 0u, 0x4420); }

// A (line, run) walk over n_lines x n_runs work items, item = start +
// t * kThreads, carried without a division per step.
struct Walk {
  int line, run, d_line, d_run, n_lines;
  __device__ Walk(int n_lines_, int start)
      : line(start % n_lines_), run(start / n_lines_), d_line(kThreads % n_lines_),
        d_run(kThreads / n_lines_), n_lines(n_lines_) {}
  __device__ void next() {
    line += d_line;
    run += d_run;
    if (line >= n_lines) {
      line -= n_lines;
      ++run;
    }
  }
};

// out[i] = OP(in[i .. i + k - 1]) for i in [0, R): ld(j) gives in[j], st(i,
// v) takes out[i]. Van Herk's split for k >= R, direct windows below.
template <int R, bool MAX, class T, class Op, class Ld, class St>
__device__ __forceinline__ void window_run(int k, Op op, Ld ld, St st) {
  if (k < R) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      T acc = ld(i);
      for (int j = 1; j < k; ++j) acc = op(acc, ld(i + j));
      st(i, acc);
    }
    return;
  }
  T core = ld(R - 1);
  for (int j = R; j < k; ++j) core = op(core, ld(j));
  T suf[R - 1];
  suf[R - 2] = ld(R - 2);
#pragma unroll
  for (int i = R - 3; i >= 0; --i) suf[i] = op(ld(i), suf[i + 1]);
  st(0, op(suf[0], core));
  T pre = ld(k);
#pragma unroll
  for (int i = 1; i < R; ++i) {
    if (i > 1) pre = op(pre, ld(k + i - 1));
    st(i, i < R - 1 ? op(op(suf[i], core), pre) : op(core, pre));
  }
}

// A vertical pass over n_words byte-word columns of `in` (word pitch pin):
// rows [0, n_out) of the window extremes down each column, from rows [0,
// n_out + k - 1), to `out` as 16-bit pixels (two words a column, word
// pitch pout). n_out >= kRunV; the last run of a column is moved up to end
// at n_out (the rows it shares with the run before are written twice, with
// the same values).
template <bool MAX>
__device__ __forceinline__ void vertical_pass(int tid, const uint32_t* in, int pin,
                                              uint32_t* out, int pout, int n_words,
                                              int n_out, int k) {
  const int n_runs = (n_out + kRunV - 1) / kRunV;
  Walk it(n_words, tid);
  for (; it.run < n_runs; it.next()) {
    const int y0 = min(it.run * kRunV, n_out - kRunV);
    const uint32_t* src = in + y0 * pin + it.line;
    uint32_t* dst = out + y0 * pout + 2 * it.line;
    window_run<kRunV, MAX, Px4>(
        k, [](Px4 x, Px4 y) { return op4<MAX>(x, y); },
        [&](int j) { return widen(src[j * pin]); },
        [&](int i, Px4 v) {
          dst[i * pout] = v.lo;
          dst[i * pout + 1] = v.hi;
        });
  }
}

// One thread's run of a horizontal pass: pixel pairs m0 .. m0 + kRunH - 1
// of one row of 16-bit pixels (word j = pixels 2j, 2j + 1), each pixel the
// extreme of the 2 rx + 1 input pixels from its own column on. With H[m] =
// OP(words m .. m + rx - 1): out[m] = OP(H[m], word m + rx, the half-word
// shift [H[m].hi, H[m+1].lo]), which covers [2m, 2m + 2 rx] in the low lane
// and [2m + 1, 2m + 1 + 2 rx] in the high one. RX: rx at compile time
// (0, or the path's 4), or -1 for a runtime rx >= 1.
template <bool MAX, int RX, class St>
__device__ __forceinline__ void horizontal_run(const uint32_t* row, int m0, int rx, St st) {
  auto op = [](uint32_t x, uint32_t y) { return op2<MAX>(x, y); };
  uint32_t h[kRunH + 1];
  if constexpr (RX == 0) {
#pragma unroll
    for (int i = 0; i < kRunH; ++i) st(m0 + i, row[m0 + i]);
    return;
  } else if constexpr (RX > 0) {
    uint32_t e[kRunH + RX];
#pragma unroll
    for (int j = 0; j < kRunH + RX; ++j) e[j] = row[m0 + j];
#pragma unroll
    for (int i = 0; i <= kRunH; ++i) {
      h[i] = e[i];
#pragma unroll
      for (int j = 1; j < RX; ++j) h[i] = op(h[i], e[i + j]);
    }
#pragma unroll
    for (int i = 0; i < kRunH; ++i) {
      st(m0 + i, op(op(h[i], e[i + RX]), __byte_perm(h[i], h[i + 1], 0x5432)));
    }
    return;
  } else {
  window_run<kRunH, MAX, uint32_t>(rx, op, [&](int j) { return row[m0 + j]; },
                                   [&](int i, uint32_t v) { h[i] = v; });
  h[kRunH] = row[m0 + kRunH];
  for (int j = 1; j < rx; ++j) h[kRunH] = op(h[kRunH], row[m0 + kRunH + j]);
#pragma unroll
  for (int i = 0; i < kRunH; ++i) {
    st(m0 + i, op(op(h[i], row[m0 + i + rx]), __byte_perm(h[i], h[i + 1], 0x5432)));
  }
  }
}

// A horizontal pass: pixel pairs [0, n_pairs) of rows [0, n_rows) of `in`
// (16-bit pixels, word pitch pin), a thread a row and kRunH pairs at a time
// (consecutive threads on consecutive rows: an odd pitch puts them in
// different banks); each result goes to st(row, pair, v).
template <bool MAX, int RX, class St>
__device__ __forceinline__ void horizontal_rows(int tid, const uint32_t* in, int pin, int n_rows,
                                                int n_pairs, int rx, St st) {
  Walk it(n_rows, tid);
  for (; it.run < n_pairs / kRunH; it.next()) {
    const int r = it.line;
    horizontal_run<MAX, RX>(in + r * pin, it.run * kRunH, rx,
                            [&](int m, uint32_t v) { st(r, m, v); });
  }
}

// The ink mask's 9-wide rectangle (rx 4) has its pass unrolled, its input
// words in registers: 0.0410-0.0411 ms on 8 A4 planes at 9x19, where the
// runtime radius takes 0.0504-0.0505 (tools/time_kernel_builds.py, H100 at
// 700 W, two runs). rx 0 (no horizontal window) copies.
template <bool MAX, class St>
__device__ __forceinline__ void horizontal_pass(int tid, const uint32_t* in, int pin, int n_rows,
                                                int n_pairs, int rx, St st) {
  if (rx == 4) {
    horizontal_rows<MAX, 4>(tid, in, pin, n_rows, n_pairs, rx, st);
  } else if (rx == 0) {
    horizontal_rows<MAX, 0>(tid, in, pin, n_rows, n_pairs, rx, st);
  } else {
    horizontal_rows<MAX, -1>(tid, in, pin, n_rows, n_pairs, rx, st);
  }
}

// 16 bytes from device to shared memory without a register on the way;
// src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void copy16_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The source rows [y0 - 2 ry, y0 + kTileH + 2 ry), columns [x0 - 2 rx,
// x0 - 2 rx + wa) of one plane, in two steps. fetch_source copies the
// 16-byte-aligned chunks that hold each row's columns into `raw` (nch a
// row; chunks with no byte of the image row are zeros), all in flight at
// once; align_source then shifts each row to S's word grid and zeroes what
// lies outside the image. (Word loads, two in flight a thread, took a third
// of the kernel's time.)
__device__ __forceinline__ const uint8_t* source_row(const uint8_t* img, int y, int h, int w) {
  return img + (long long)min(max(y, 0), h - 1) * w;   // a real row, also for y outside
}

__device__ __forceinline__ void fetch_source(int tid, const uint8_t* __restrict__ img,
                                             uint8_t* raw, const Geometry& g, int x0, int y0,
                                             int h, int w) {
  const int xs = x0 - 2 * g.rx, ys = y0 - 2 * g.ry;
  const int lo = max(xs, 0), hi = min(xs + g.wa, w);   // the image columns the tile reads
  Walk it(g.nch, tid);
  for (; it.run < g.sh; it.next()) {
    const int y = ys + it.run;
    const uint8_t* row = source_row(img, y, h, w);
    const uint8_t* chunk = reinterpret_cast<const uint8_t*>(
        (reinterpret_cast<uintptr_t>(row) + xs) & ~(uintptr_t)15) + 16 * it.line;
    const bool any = y >= 0 && y < h && chunk < row + hi && chunk + 16 > row + lo;
    copy16_async(raw + 16 * (it.run * g.nch + it.line), any ? chunk : img, any ? 16 : 0);
  }
  copy_async_wait_all();
}

__device__ __forceinline__ void align_source(int tid, const uint8_t* __restrict__ img,
                                             const uint8_t* raw, uint32_t* s, const Geometry& g,
                                             int x0, int y0, int h, int w) {
  const int xs = x0 - 2 * g.rx, ys = y0 - 2 * g.ry;
  Walk it(g.wa / 4, tid);
  for (; it.run < g.sh; it.next()) {
    const int y = ys + it.run, x = xs + 4 * it.line;
    const int o = (int)((reinterpret_cast<uintptr_t>(source_row(img, y, h, w)) + xs) & 15u)
                  + 4 * it.line;
    const uint32_t* r = reinterpret_cast<const uint32_t*>(raw + 16 * it.run * g.nch);
    uint32_t word = __funnelshift_r(r[o >> 2], r[(o >> 2) + 1], 8 * (o & 3));
    if (y < 0 || y >= h) {
      word = 0;
    } else if (x < 0 || x + 3 >= w) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (x + c < 0 || x + c >= w) word &= ~(0xffu << (8 * c));
      }
    }
    s[it.run * g.ps + it.line] = word;
  }
}

// The staged output (kTileH rows at pitch kTileW + 4) to rows y0.. and
// columns x0.. of the plane: aligned words inside each row, bytes at its ends.
__device__ __forceinline__ void store_output(int tid, const uint8_t* stage, uint8_t* img,
                                             int x0, int y0, int h, int w) {
  const int pitch = kTileW + 4, len = min(kTileW, w - x0);
  const int n_slots = kTileW / 4 + 2;          // a word may straddle either end
  Walk it(n_slots, tid);
  for (; it.run < kTileH; it.next()) {
    const int y = y0 + it.run;
    if (y >= h) continue;
    uint8_t* row = img + (long long)y * w + x0;
    const uint8_t* srow = stage + it.run * pitch;
    const int head = (int)((4 - (reinterpret_cast<uintptr_t>(row) & 3u)) & 3u);
    const int c = head + 4 * (it.line - 1);     // slot 0: the head bytes
    if (it.line == 0) {
      for (int i = 0; i < min(head, len); ++i) row[i] = srow[i];
    } else if (c + 4 <= len) {
      const uint32_t* sw = reinterpret_cast<const uint32_t*>(srow);
      const int o = c >> 2, sh = 8 * (c & 3);
      *reinterpret_cast<uint32_t*>(row + c) = __funnelshift_r(sw[o], sw[o + 1], sh);
    } else if (c < len && c + 4 > len && c >= head) {
      for (int i = c; i < len; ++i) row[i] = srow[i];   // the tail bytes
    }
  }
}

__global__ void __launch_bounds__(kThreads)
blackhat_rect_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                     int h, int w, int kw, int kh) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Geometry g(kw, kh);
  uint32_t* s = reinterpret_cast<uint32_t*>(smem);
  uint32_t* a = reinterpret_cast<uint32_t*>(smem + g.bytes_s());
  uint8_t* d = smem + g.bytes_s() + g.bytes_a();
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const long long plane = (long long)blockIdx.z * h * w;

  fetch_source(tid, src + plane, reinterpret_cast<uint8_t*>(a), g, x0, y0, h, w);
  __syncthreads();
  align_source(tid, src + plane, reinterpret_cast<const uint8_t*>(a), s, g, x0, y0, h, w);
  __syncthreads();
  // dilation, vertical: S -> A (16-bit), D's rows
  vertical_pass<true>(tid, s, g.ps, a, g.pa, g.wa / 4, g.dh, kh);
  __syncthreads();
  // dilation, horizontal: A -> D (bytes), then 255 at every position outside the image
  const int xd = x0 - g.rx, yd = y0 - g.ry;
  const bool inside = xd >= 0 && yd >= 0 && xd + g.wd <= w && yd + g.dh <= h;
  horizontal_pass<true>(tid, a, g.pa, g.dh, g.wd / 2, g.rx, [&](int r, int m, uint32_t v) {
    if (!inside) {
      const int x = xd + 2 * m, y = yd + r;
      if (y < 0 || y >= h || x < 0 || x >= w) v |= 0xffu;
      if (y < 0 || y >= h || x + 1 < 0 || x + 1 >= w) v |= 0xff0000u;
    }
    reinterpret_cast<uint16_t*>(d + 4 * r * g.pd)[m] = (uint16_t)narrow2(v);
  });
  __syncthreads();
  // erosion, vertical: D -> A (16-bit, kTileH rows at pitch pe)
  vertical_pass<false>(tid, reinterpret_cast<const uint32_t*>(d), g.pd, a, g.pe, g.wd / 4,
                       kTileH, kh);
  __syncthreads();
  // erosion, horizontal, minus the source (close >= src: no lane borrows),
  // staged in D
  const uint8_t* center = reinterpret_cast<const uint8_t*>(s) + 2 * g.ry * 4 * g.ps + 2 * g.rx;
  horizontal_pass<false>(tid, a, g.pe, kTileH, kTileW / 2, g.rx, [&](int r, int m, uint32_t v) {
    const uint32_t x = widen(reinterpret_cast<const uint16_t*>(center + r * 4 * g.ps)[m]).lo;
    reinterpret_cast<uint16_t*>(d + r * (kTileW + 4))[m] = (uint16_t)narrow2(__vmaxu2(v, x) - x);
  });
  __syncthreads();
  store_output(tid, d, dst + plane, x0, y0, h, w);
}

// One 1-D pass of the split form: the max (MAX) or min over [p - rad,
// p + rad] of the pixel's column (VERT) or row, clipped to the image; the
// last pass subtracts the source.
template <bool VERT, bool MAX, bool LAST>
__global__ void __launch_bounds__(kThreads)
extreme_pass_kernel(const uint8_t* __restrict__ in, const uint8_t* __restrict__ src,
                    uint8_t* __restrict__ out, long long n, int h, int w, int rad) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int x = (int)(i % w);
    const int pos = VERT ? (int)((i / w) % h) : x, len = VERT ? h : w;
    const long long step = VERT ? w : 1;
    const uint8_t* line = in + i - pos * step;
    uint8_t m = MAX ? 0 : 255;
    const int hi = min(pos + rad, len - 1);
    for (int j = max(pos - rad, 0); j <= hi; ++j) {
      m = MAX ? max(m, line[j * step]) : min(m, line[j * step]);
    }
    out[i] = LAST ? (uint8_t)max((int)m - (int)src[i], 0) : m;
  }
}

}  // namespace

// Bytes of device scratch that tpuimage_blackhat_rect needs for this call: 0
// for the tiled form, two byte planes for the split form.
extern "C" long long tpuimage_blackhat_rect_scratch(int batch, int h, int w, int kw, int kh) {
  return Geometry(kw, kh).smem_bytes() <= kMaxSmem ? 0 : 2LL * batch * h * w;
}

// scratch: tpuimage_blackhat_rect_scratch() bytes on the device (may be null
// when that is 0). Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tpuimage_blackhat_rect(const void* src_v, void* dst_v, void* scratch, int batch,
                                      int h, int w, int kw, int kh, void* stream) {
  if (kw < 1 || kh < 1 || kw % 2 == 0 || kh % 2 == 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  const uint8_t* src = static_cast<const uint8_t*>(src_v);
  uint8_t* dst = static_cast<uint8_t*>(dst_v);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = Geometry(kw, kh).smem_bytes();
  if (smem > kMaxSmem) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const long long n = (long long)batch * h * w;
    const unsigned blocks = (unsigned)std::min<long long>((n + kThreads - 1) / kThreads, 1 << 20);
    uint8_t* a = static_cast<uint8_t*>(scratch);
    uint8_t* b = a + n;
    const int ry = kh / 2, rx = kw / 2;
    extreme_pass_kernel<true, true, false><<<blocks, kThreads, 0, s>>>(src, src, a, n, h, w, ry);
    extreme_pass_kernel<false, true, false><<<blocks, kThreads, 0, s>>>(a, src, b, n, h, w, rx);
    extreme_pass_kernel<true, false, false><<<blocks, kThreads, 0, s>>>(b, src, a, n, h, w, ry);
    extreme_pass_kernel<false, false, true><<<blocks, kThreads, 0, s>>>(a, src, dst, n, h, w, rx);
    return (int)cudaGetLastError();
  }
  if (batch > 65535 || (h + kTileH - 1) / kTileH > 65535) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blackhat_rect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((w + kTileW - 1) / kTileW),
                  (unsigned)((h + kTileH - 1) / kTileH), (unsigned)batch);
  blackhat_rect_kernel<<<grid, kThreads, smem, s>>>(src, dst, h, w, kw, kh);
  return (int)cudaGetLastError();
}
