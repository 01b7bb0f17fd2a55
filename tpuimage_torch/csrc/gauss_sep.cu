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
// half to even, 0 where the blur is 0 (the TPU kernel's f32 quotient
// candidate exists only because Mosaic has no vector integer divide).
// adaptive is the one float stage: f32 taps, a replicate border, and
// OpenCV's symmetric order, vertical pass first: acc = x[r]*k[r];
// acc += (x[r-i] + x[r+i]) * k[r+i] for i = 1..r, then the same along the
// row over the kept vertical results. Every product and sum is spelled
// __fmul_rn / __fadd_rn, which nvcc never contracts into an fma, so the mean
// rounds exactly where the plain version's separate ops round.
//
// Bound on the H100: operations. Per pixel and pass, r pair adds and r + 1
// multiply-adds (ksize 43 and 51 on an A4 page; the adaptive mode's
// 1 + 3r float ops), against 2 bytes moved.
//
// Design, tiled form (ksize <= kMaxTiledKsize): one block per
// (kTileH x kTileW) output tile of one image. The tile and its halo of r
// pixels on each side sit in shared memory as bytes (borders folded in as
// they are loaded), the vertical pass writes a kTileH x (kTileW + 2r)
// buffer of int32 or f32 sums into shared memory, and the horizontal pass
// and the epilogue read it. Each input byte comes from device memory about
// (1 + 2r/kTileH)(1 + 2r/kTileW) times, through L2.
//
// Split form (wider kernels, whose halo outgrows shared memory): the
// vertical pass of every pixel goes to a (B, H, W) buffer of sums in device
// memory that the caller provides, then a second launch runs the
// horizontal pass and the epilogue from it. Both read through the caches.
// Same sums in the same order, so both forms give the same bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kTileW = 128;
constexpr int kTileH = 32;
constexpr int kThreads = 256;
constexpr int kMaxTiledKsize = 255;   // 159 KB of shared memory at r = 127

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
// half to even, 0 where den is 0 (ops.arith.divide_u8).
__device__ __forceinline__ int div255_round_half_even(int num, int den) {
  if (den == 0) return 0;
  const int n = num * 255;
  int q = n / den;
  const int rem = n - q * den;
  q += (2 * rem > den) || (2 * rem == den && (q & 1));
  return min(q, 255);
}

// One pass over a window of 2r + 1 values, get(j) for j in [0, 2r]: the
// Q8.8 modes' int32 sum, or the adaptive mode's symmetric f32 sum.
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

// The consumer of the blur: c is the source pixel, acc its 2-D sum.
template <int MODE>
__device__ __forceinline__ uint8_t epilogue(int c, Acc<MODE> acc, int idelta) {
  if constexpr (MODE == kAdaptive) {
    const int mean = (int)fminf(fmaxf(rintf(acc), 0.0f), 255.0f);
    return c - mean > -idelta ? 255 : 0;
  } else {
    const int blur = min(max((acc + 32768) >> 16, 0), 255);
    if constexpr (MODE == kNone) {
      return (uint8_t)blur;
    } else if constexpr (MODE == kDivide) {
      return (uint8_t)div255_round_half_even(c, blur);
    } else if constexpr (MODE == kSubtract) {
      return (uint8_t)max(c - blur, 0);
    } else {  // kSub
      return (uint8_t)max(blur - c, 0);
    }
  }
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ constexpr size_t smem_bytes(int r) {
  return 4 * (size_t)round4(2 * r + 1) + 4 * (size_t)kTileH * (kTileW + 2 * r) +
         (size_t)(kTileH + 2 * r) * (kTileW + 2 * r);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gauss_sep_kernel(const uint8_t* __restrict__ src, const Acc<MODE>* __restrict__ taps,
                 uint8_t* __restrict__ dst, int h, int w, int r, int idelta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = 2 * r + 1;
  const int sw = kTileW + 2 * r, sh = kTileH + 2 * r;
  Acc<MODE>* tap = reinterpret_cast<Acc<MODE>*>(smem);
  Acc<MODE>* vbuf = tap + round4(k);                             // kTileH x sw
  uint8_t* in = reinterpret_cast<uint8_t*>(vbuf + kTileH * sw);  // sh x sw

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const long long plane = (long long)b * h * w;
  for (int i = threadIdx.x; i < k; i += kThreads) tap[i] = taps[i];
  for (int i = threadIdx.x; i < sh * sw; i += kThreads) {
    const int y = fold<MODE>(y0 - r + i / sw, h), x = fold<MODE>(x0 - r + i % sw, w);
    in[i] = src[plane + (long long)y * w + x];
  }
  __syncthreads();

  // vertical pass: every column of the haloed tile, the tile's rows
  for (int i = threadIdx.x; i < kTileH * sw; i += kThreads) {
    const uint8_t* col = in + i;  // row ly of the output is row ly of `in` + r
    vbuf[i] = window_sum<MODE>([&](int j) { return col[j * sw]; }, tap, r);
  }
  __syncthreads();

  // horizontal pass and the epilogue
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int ly = i / kTileW, lx = i % kTileW;
    const int y = y0 + ly, x = x0 + lx;
    if (y >= h || x >= w) continue;
    const Acc<MODE>* row = vbuf + ly * sw + lx;
    const Acc<MODE> acc = window_sum<MODE>([&](int j) { return row[j]; }, tap, r);
    dst[plane + (long long)y * w + x] = epilogue<MODE>(in[(ly + r) * sw + lx + r], acc, idelta);
  }
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
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int x = (int)(i % w);
    const Acc<MODE>* row = vsum + (i - x);
    const Acc<MODE> acc = window_sum<MODE>(
        [&](int j) { return row[fold<MODE>(x - r + j, w)]; }, taps, r);
    dst[i] = epilogue<MODE>(src[i], acc, idelta);
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
  const size_t smem = smem_bytes(r);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gauss_sep_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((w + kTileW - 1) / kTileW),
                  (unsigned)((h + kTileH - 1) / kTileH), (unsigned)batch);
  gauss_sep_kernel<MODE><<<grid, kThreads, smem, stream>>>(src, taps, dst, h, w, r, idelta);
  return (int)cudaGetLastError();
}

__global__ void divide_table_kernel(uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 256 * 256) out[i] = (uint8_t)div255_round_half_even(i >> 8, i & 255);
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
