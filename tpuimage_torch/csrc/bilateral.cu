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
// table lookup, two multiplies and two adds against 2 bytes moved per
// pixel; DocScanner's d = 9 has 49 taps, face's d = -1, sigma_space 10
// (radius 15) about 700.
//
// Design: one thread per output pixel; one block per kTileW x kTileH tile
// of one image (the batch is the grid's z axis). The block stages in shared
// memory the colour table, the tap table (as offsets into the tile, with
// the space weights) and its input tile with a halo of `radius` on each
// side, as bytes, the reflect-101 border folded into the halo loads (for
// any radius, also wider than the image). Tap reads are uniform across a
// warp (broadcast); table reads are by each lane's own distance.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kThreads = kTileW * kTileH;
constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may use

// numpy's "reflect" pad (cv2's BORDER_REFLECT_101) of index i into [0, n),
// for any pad width: the reflection is periodic with period 2(n - 1).
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  i = abs(i) % p;
  return i < n ? i : p - i;
}

size_t smem_bytes(int chans, int radius, int ntaps, int nlut) {
  const size_t tile = (size_t)(kTileW + 2 * radius) * (kTileH + 2 * radius) * chans;
  return sizeof(float) * (size_t)nlut + (sizeof(float) + sizeof(int)) * (size_t)ntaps + tile;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
bilateral_kernel(const uint8_t* __restrict__ src, const int* __restrict__ taps,
                 const float* __restrict__ space_w, const float* __restrict__ lut,
                 uint8_t* __restrict__ out, int h, int w, int radius, int ntaps,
                 int nlut) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tw = kTileW + 2 * radius;
  const int th = kTileH + 2 * radius;
  float* s_lut = reinterpret_cast<float*>(smem);
  float* s_sw = s_lut + nlut;
  int* s_off = reinterpret_cast<int*>(s_sw + ntaps);
  uint8_t* s_img = reinterpret_cast<uint8_t*>(s_off + ntaps);

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < nlut; i += kThreads) s_lut[i] = lut[i];
  for (int t = tid; t < ntaps; t += kThreads) {
    s_sw[t] = space_w[t];
    s_off[t] = (taps[2 * t] * tw + taps[2 * t + 1]) * C;
  }
  const int x0 = blockIdx.x * kTileW - radius;
  const int y0 = blockIdx.y * kTileH - radius;
  const uint8_t* img = src + (long long)blockIdx.z * h * w * C;
  for (int i = tid; i < th * tw; i += kThreads) {
    const int yy = i / tw;
    const int xx = i - yy * tw;
    const uint8_t* p =
        img + ((long long)reflect101(y0 + yy, h) * w + reflect101(x0 + xx, w)) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) s_img[i * C + c] = p[c];
  }
  __syncthreads();

  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  if (x >= w || y >= h) return;
  const uint8_t* ctr = s_img + ((threadIdx.y + radius) * tw + threadIdx.x + radius) * C;
  int cv[C];
  float num[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    cv[c] = ctr[c];
    num[c] = 0.f;
  }
  float den = 0.f;
  for (int t = 0; t < ntaps; ++t) {
    const uint8_t* v = ctr + s_off[t];
    int vv[C];
    int d = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      vv[c] = v[c];
      d += abs(vv[c] - cv[c]);
    }
    const float wgt = __fmul_rn(s_lut[d], s_sw[t]);
#pragma unroll
    for (int c = 0; c < C; ++c) num[c] = __fadd_rn(num[c], __fmul_rn((float)vv[c], wgt));
    den = __fadd_rn(den, wgt);
  }
  uint8_t* o = out + (((long long)blockIdx.z * h + y) * w + x) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float q = rintf(__fdiv_rn(num[c], den));
    o[c] = (uint8_t)fminf(fmaxf(q, 0.f), 255.f);
  }
}

template <int C>
int launch(const void* src, const void* taps, const void* space_w, const void* lut,
           void* out, int batch, int h, int w, int radius, int ntaps, int nlut,
           cudaStream_t s) {
  const size_t smem = smem_bytes(C, radius, ntaps, nlut);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bilateral_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch);
  bilateral_kernel<C><<<grid, dim3(kTileW, kTileH), smem, s>>>(
      static_cast<const uint8_t*>(src), static_cast<const int*>(taps),
      static_cast<const float*>(space_w), static_cast<const float*>(lut),
      static_cast<uint8_t*>(out), h, w, radius, ntaps, nlut);
  return (int)cudaGetLastError();
}

}  // namespace

// src, out: (batch, h, w, chans) uint8, chans 1 or 3; taps: (ntaps, 2) int32
// (dy, dx), each within radius; space_w: (ntaps,) f32; lut: (nlut,) f32,
// nlut >= 255 * chans + 1. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for arguments the kernel does not take
// (a halo tile past 227 KB of shared memory: radius above ~120 for colour).
extern "C" int tpuimage_bilateral(const void* src, const void* taps, const void* space_w,
                                  const void* lut, void* out, int batch, int h, int w,
                                  int chans, int radius, int ntaps, int nlut, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (batch > 65535 || radius < 0 || ntaps < 1 || nlut < 255 * chans + 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (chans == 1) return launch<1>(src, taps, space_w, lut, out, batch, h, w, radius, ntaps, nlut, s);
  if (chans == 3) return launch<3>(src, taps, space_w, lut, out, batch, h, w, radius, ntaps, nlut, s);
  return (int)cudaErrorInvalidValue;
}
