// cv2.bilateralFilter 8u on a batch of (B, H, W) gray or (B, H, W, 3)
// colour uint8 images, reflect-101 border.
//
// Replaces: tpuimage/ops/pallas_kernels.py bilateral_gray_pallas (body
// _make_bilateral_band_kernel), the TPU kernel behind DocScanner's
// preprocess (tpuimage.ops.bilateral.bilateral_filter on gray images), and
// for colour the scan form of the same op (landscape, face).
//
// Numerics, the plain version's (ops/kernels.py bilateral_ref) op for op.
// For each tap t of the table, in table order (row-major dy then dx over
// the circular tap set, as tpuimage's _tap_offsets lists them):
//   d   = |v - c|, summed over the channels for colour (an exact integer);
//   wgt = lut[d] * sw[t]                  (lut: exp(d*d*gc), built by the
//                                          caller on the same device);
//   num = num + v * wgt;  den = den + wgt (per channel for num).
// Then out = rint(num / den), clamped to 0..255 (cvRound). Every product
// and sum is spelled __fmul_rn / __fadd_rn, which nvcc never contracts into
// an fma, and the quotient is __fdiv_rn (IEEE), so each rounds where the
// plain version's separate tensor ops round: kernel and plain version are
// equal bit for bit on the card. The colour weight comes from the table,
// so the kernel evaluates no exp.
//
// Bound on the H100: operations. Per pixel and tap, gray: |diff|, the
// table lookup, two multiplies and two adds, against 2 bytes moved per
// pixel; colour: three |diff| and their sum, the lookup, the weight's
// multiply and per channel a multiply and an add, and the weights' add.
// DocScanner's d = 9 has 49 taps, face's d = -1, sigma_space 10 (radius
// 15) 709. The multiplies and adds must stay unfused (no fma) to keep the
// plain version's roundings, so they issue at half the rate that the
// bound's 67 T/s (which counts an fma as two operations) assumes: a kernel
// that did nothing but that arithmetic would read ~50% of the bound.
//
// Design. The first design (one thread per pixel, 32 x 16 tiles, a block
// per tile) spent, per pixel and tap, shared loads of the tap's offset and
// weight and of the pixel's byte, an int -> float conversion and the
// table gather beside its four float operations, and a third of its time
// on gray in the per-block prologue (tables, halo tile with a modulo per
// byte) that a block of 512 pixels could not amortise (PERF.md section 6).
// This one:
// - a thread computes a run of kRun = 8 adjacent pixels of a row, so each
//   tap row's bytes are read from shared memory and made float once per
//   run (by an or and an add, not a conversion) and held in registers
//   while the row's taps walk over them: per pixel and tap what is left is
//   the table gather, its address and the four float operations, each
//   pixel's sums still in tap order;
// - the tap table is cut into chunks of up to kChunk taps of one row with
//   consecutive dx (any table works: a break in dy or dx starts a chunk),
//   found once per block and kept as one packed word a tap; the space
//   weights are read through the L1 cache, one load a tap a run;
// - gray reads its weights from a symmetric table of v - c (511 entries),
//   so the address is one add from the centre's base; colour's L1 distance
//   is one byte-wise sum of absolute differences (__vsadu4, one VABSDIFF4);
// - blocks are persistent (as many as fit on the card at once) and walk
//   the tiles of the batch, so the tables are loaded once a block; tiles
//   inside the image load their halo without reflection arithmetic.
// What is left (PERF.md section 6): the gather's bank conflicts (a
// conflict-free stand-in is 11% faster on gray, 29% on face's colour; 8,
// 16 or 32 copies of the table lose that again to occupancy), and the
// tile loads between the barriers.
// Two forms: the fast one, 64 x 32 (gray, 256 threads, 3 blocks an SM) or
// 64 x 16 (colour, 128 threads) pixels a tile; and where its tile and
// tables do not fit in shared memory (gray radius past 111, colour past
// 86), the fallback with the first design's 32 x 16 tile, which stores
// only what the first design stored (its tile, a table of 256 or 766
// weights, 4 bytes a tap where it kept 8), so every table and radius the
// first design took still fits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace {

constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may use
constexpr int kRun = 8;            // adjacent pixels of a row a thread computes
constexpr int kChunk = 9;          // taps of one row walked over one register window
constexpr int kMaxRadius = 255;    // a tap's dy and dx fit 9 bits

// numpy's "reflect" pad (cv2's BORDER_REFLECT_101) of index i into [0, n),
// for any pad width (each step shrinks |i|)
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  while ((unsigned)i >= (unsigned)n) i = i < 0 ? -i : 2 * (n - 1) - i;
  return i;
}

// the float value of a byte without a conversion instruction (a quarter of
// the add rate on the H100): 2^23 + b holds b in its low mantissa bits, and
// taking 2^23 away is exact
__device__ __forceinline__ float byte_to_float(uint32_t b) {
  return __fadd_rn(__uint_as_float(0x4B000000u | b), -8388608.f);
}

// a 32-bit shared-memory address the compiler cannot fold back into index
// arithmetic (it would rebuild (v - c + 255) * 4 from the parts), and an f32
// load through it: one add a gather address
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm("" : "+r"(x));
  return x;
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

// entries of the weight table: gray 511 (symmetric, v - c + 255) in the
// fast form, 256 (|v - c|) in the fallback; colour 766
__host__ __device__ constexpr int lut_entries(int chans, bool fast) {
  return chans == 1 ? (fast ? 511 : 256) : 766;
}

size_t smem_bytes(int chans, bool fast, int tile_w, int tile_h, int radius, int ntaps) {
  return sizeof(float) * lut_entries(chans, fast) + sizeof(uint32_t) * (size_t)ntaps +
         (size_t)chans * (tile_w + 2 * radius) * (tile_h + 2 * radius);
}

// C channels; a block of TX x TY threads, each owning kRun adjacent pixels
// of a row (tile TX * kRun x TY), at least MINB blocks an SM (a cap on the
// registers); FAST: gray's symmetric weight table and its one-add gather
// address, else the fallback's |v - c| table.
template <int C, int TX, int TY, bool FAST, int MINB>
__global__ void __launch_bounds__(TX * TY, MINB)
bilateral_kernel(const uint8_t* __restrict__ src, const int* __restrict__ taps,
                 const float* __restrict__ space_w, const float* __restrict__ lut,
                 uint8_t* __restrict__ out, int h, int w, int radius, int ntaps,
                 long long tiles_x, long long tiles_y, long long ntiles) {
  constexpr int kThreads = TX * TY, kWarps = kThreads / 32;
  constexpr int kTileW = TX * kRun, kTileH = TY;
  constexpr bool SYM = FAST && C == 1;
  constexpr int kLut = lut_entries(C, FAST);
  constexpr int kWin = kRun + kChunk - 1;   // pixels of a chunk's window
  static_assert(kThreads % 32 == 0, "whole warps");
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_lut = reinterpret_cast<float*>(smem);
  uint32_t* s_info = reinterpret_cast<uint32_t*>(s_lut + kLut);
  uint8_t* s_img = reinterpret_cast<uint8_t*>(s_info + ntaps);
  const int tw = kTileW + 2 * radius, th = kTileH + 2 * radius, pitch = C * tw;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // once a block: the weight table, and per tap (dy, dx) and the length of
  // the chunk that would start there (consecutive dx in one row, <= kChunk)
  for (int i = tid; i < kLut; i += kThreads) s_lut[i] = lut[SYM ? abs(i - 255) : i];
  for (int t = tid; t < ntaps; t += kThreads) {
    const int dy = taps[2 * t], dx = taps[2 * t + 1];
    int n = 1;
    while (n < kChunk && t + n < ntaps && taps[2 * (t + n)] == dy &&
           taps[2 * (t + n) + 1] == dx + n)
      ++n;
    s_info[t] = (uint32_t)(dy + 256) | (uint32_t)(dx + 256) << 9 | (uint32_t)n << 18;
  }

  const int lx = tid % TX, ly = tid / TX;
  const long long plane = tiles_x * tiles_y;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long z = tile / plane;
    const int ty = (int)((tile - z * plane) / tiles_x);
    const int tx = (int)(tile - z * plane - ty * tiles_x);
    const int x0 = tx * kTileW - radius, y0 = ty * kTileH - radius;
    const uint8_t* img = src + z * h * w * C;
    __syncthreads();   // the tables are in place; every read of the last tile is done
    // the tile and its halo, a warp a row; a tile inside the image copies
    // its rows, one at the border reflects each row and column
    // (unrolled, so that a thread has several loads in flight)
    if (x0 >= 0 && y0 >= 0 && x0 + tw <= w && y0 + th <= h) {
#pragma unroll 2
      for (int yy = warp; yy < th; yy += kWarps) {
        const uint8_t* srow = img + ((long long)(y0 + yy) * w + x0) * C;
#pragma unroll 4
        for (int i = lane; i < pitch; i += 32) s_img[yy * pitch + i] = srow[i];
      }
    } else {
#pragma unroll 2
      for (int yy = warp; yy < th; yy += kWarps) {
        const uint8_t* srow = img + (long long)reflect101(y0 + yy, h) * w * C;
#pragma unroll 4
        for (int xx = lane; xx < tw; xx += 32) {
          const uint8_t* p = srow + reflect101(x0 + xx, w) * C;
#pragma unroll
          for (int c = 0; c < C; ++c) s_img[yy * pitch + xx * C + c] = p[c];
        }
      }
    }
    __syncthreads();

    // this thread's kRun pixels: centres, and per tap row a register window
    const uint8_t* base = s_img + ly * pitch + lx * kRun * C;
    const uint8_t* ctr = base + radius * pitch + radius * C;
    int cv[kRun];            // gray: the centre; colour: its bytes packed
    uint32_t lc[kRun];       // gray, fast form: the shared address of the centre's row
    float num[kRun][C], den[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if constexpr (C == 1) {
        cv[i] = ctr[i];
        lc[i] = opaque((uint32_t)__cvta_generic_to_shared(s_lut + 255 - cv[i]));
      } else {
        cv[i] = ctr[3 * i] | ctr[3 * i + 1] << 8 | ctr[3 * i + 2] << 16;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) num[i][c] = 0.f;
      den[i] = 0.f;
    }
    for (int t = 0; t < ntaps;) {
      const uint32_t inf = s_info[t];
      const int dy = (int)(inf & 511u) - 256, dx = (int)((inf >> 9) & 511u) - 256;
      const int n = (int)(inf >> 18);
      const uint8_t* row = base + (radius + dy) * pitch + (radius + dx) * C;
      uint32_t v[kWin];       // gray: the byte (fast: its offset in the table); colour: packed
      float vf[kWin][C];
#pragma unroll
      for (int e = 0; e < kWin; ++e) {
        if (e < kRun - 1 + n) {
          if constexpr (C == 1) {
            const uint32_t b = row[e];
            v[e] = SYM ? b << 2 : b;
            vf[e][0] = byte_to_float(b);
          } else {
            const uint32_t b0 = row[3 * e], b1 = row[3 * e + 1], b2 = row[3 * e + 2];
            v[e] = b0 | b1 << 8 | b2 << 16;
            vf[e][0] = byte_to_float(b0);
            vf[e][1] = byte_to_float(b1);
            vf[e][2] = byte_to_float(b2);
          }
        }
      }
      float sw[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j < n) sw[j] = __ldg(space_w + t + j);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < n) {
#pragma unroll
          for (int i = 0; i < kRun; ++i) {
            const int e = i + j;
            float lw;
            if constexpr (C == 1 && SYM) lw = lds_f32(lc[i] + v[e]);
            else if constexpr (C == 1) lw = s_lut[abs((int)v[e] - cv[i])];
            else lw = s_lut[__vsadu4(v[e], (unsigned)cv[i])];
            const float wgt = __fmul_rn(lw, sw[j]);
#pragma unroll
            for (int c = 0; c < C; ++c) num[i][c] = __fadd_rn(num[i][c], __fmul_rn(vf[e][c], wgt));
            den[i] = __fadd_rn(den[i], wgt);
          }
        }
      }
      t += n;
    }
    const int y = ty * kTileH + ly;
    if (y < h) {
      uint8_t* o = out + ((z * h + y) * w + (long long)tx * kTileW + lx * kRun) * C;
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        if (tx * kTileW + lx * kRun + i < w) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float q = rintf(__fdiv_rn(num[i][c], den[i]));
            o[i * C + c] = (uint8_t)fminf(fmaxf(q, 0.f), 255.f);
          }
        }
      }
    }
  }
}

template <int C, int TX, int TY, bool FAST, int MINB>
int launch(const void* src, const void* taps, const void* space_w, const void* lut, void* out,
           int batch, int h, int w, int radius, int ntaps, size_t smem, int sms,
           cudaStream_t s) {
  auto kernel = bilateral_kernel<C, TX, TY, FAST, MINB>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TX * TY, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long tiles_x = (w + TX * kRun - 1) / (TX * kRun), tiles_y = (h + TY - 1) / TY;
  const long long ntiles = tiles_x * tiles_y * batch;
  const long long resident = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(ntiles < resident ? ntiles : resident);
  kernel<<<grid, TX * TY, smem, s>>>(
      static_cast<const uint8_t*>(src), static_cast<const int*>(taps),
      static_cast<const float*>(space_w), static_cast<const float*>(lut),
      static_cast<uint8_t*>(out), h, w, radius, ntaps, tiles_x, tiles_y, ntiles);
  return (int)cudaGetLastError();
}

// the fast form (tile kRun * TX x TY, gray's symmetric table) where it fits in
// shared memory, else the fallback: the first design's 32 x 16 tile and a
// single table, which fits wherever the first design's did
template <int C, int TX, int TY, int MINB>
int dispatch(const void* src, const void* taps, const void* space_w, const void* lut,
             void* out, int batch, int h, int w, int radius, int ntaps, cudaStream_t s) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const size_t fast = smem_bytes(C, true, kRun * TX, TY, radius, ntaps);
  if (fast <= (size_t)kMaxSmem)
    return launch<C, TX, TY, true, MINB>(src, taps, space_w, lut, out, batch, h, w, radius, ntaps,
                                         fast, sms, s);
  const size_t fallback = smem_bytes(C, false, 32, 16, radius, ntaps);
  if (fallback > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return launch<C, 32 / kRun, 16, false, 8>(src, taps, space_w, lut, out, batch, h, w, radius,
                                            ntaps, fallback, sms, s);
}

}  // namespace

// src, out: (batch, h, w, chans) uint8, chans 1 or 3; taps: (ntaps, 2) int32
// (dy, dx), each within radius; space_w: (ntaps,) f32; lut: (nlut,) f32,
// nlut >= 255 * chans + 1. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for arguments the kernel does not take
// (a halo tile past 227 KB of shared memory: with the op's circular tap
// sets, gray radius above 115 and colour above 90; the first design
// stopped at 87 and 74).
extern "C" int tpuimage_bilateral(const void* src, const void* taps, const void* space_w,
                                  const void* lut, void* out, int batch, int h, int w,
                                  int chans, int radius, int ntaps, int nlut, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (batch > 65535 || radius < 0 || radius > kMaxRadius || ntaps < 1 ||
      nlut < 255 * chans + 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (chans == 1)
    return dispatch<1, 8, 32, 3>(src, taps, space_w, lut, out, batch, h, w, radius, ntaps, s);
  if (chans == 3)
    return dispatch<3, 8, 16, 4>(src, taps, space_w, lut, out, batch, h, w, radius, ntaps, s);
  return (int)cudaErrorInvalidValue;
}
