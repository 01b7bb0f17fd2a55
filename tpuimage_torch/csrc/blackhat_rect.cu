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
// kernel's where(valid, d, 255) does. All integer min/max, so the kernel
// equals its plain version bit for bit.
//
// Bound on the H100: memory. Each pixel reads 1 byte and writes 1; the
// separable extremes are (kh - 1) + (kw - 1) compares per pixel for each of
// the two passes, or ~3 per 1-D pass in a van Herk form.
//
// Design, tiled form (while the buffers fit the block's shared memory): one
// block per (kTileH x kTileW) output tile of one image. The tile with a
// halo of (kh - 1) rows and (kw - 1) columns on each side is loaded into
// shared memory once; the four 1-D passes (dilate down the columns, along
// the rows, then erode the same way) each shrink the region by the window's
// reach and write the next shared buffer, and the last one subtracts the
// source.
//
// Split form (larger rectangles): the same four 1-D passes, one launch
// each, through two (B, H, W) byte planes of device scratch that the caller
// provides. The padding values are the identities of max (0) and min (255),
// so each pass just clips its window to the image.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;   // sm_90's opt-in shared memory per block

__host__ __device__ constexpr size_t smem_bytes(int kw, int kh) {
  const int ry = kh / 2, rx = kw / 2;
  const size_t sw = kTileW + 4 * rx, sh = kTileH + 4 * ry;
  const size_t dh = kTileH + 2 * ry, dw = kTileW + 2 * rx;
  return sh * sw + dh * sw + dh * dw + (size_t)kTileH * dw;
}

__global__ void __launch_bounds__(kThreads)
blackhat_rect_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                     int h, int w, int kw, int kh) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ry = kh / 2, rx = kw / 2;
  // s:  the source, rows [y0 - 2ry, y0 + TH + 2ry), cols [x0 - 2rx, x0 + TW + 2rx)
  // dv: s's column maxima, rows [y0 - ry, y0 + TH + ry), s's columns
  // d:  the dilation, dv's rows, cols [x0 - rx, x0 + TW + rx)
  // ev: d's column minima, rows [y0, y0 + TH), d's columns
  const int sw = kTileW + 4 * rx, sh = kTileH + 4 * ry;
  const int dh = kTileH + 2 * ry, dw = kTileW + 2 * rx;
  uint8_t* s = smem;
  uint8_t* dv = s + sh * sw;
  uint8_t* d = dv + dh * sw;
  uint8_t* ev = d + dh * dw;

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const long long plane = (long long)b * h * w;
  for (int i = threadIdx.x; i < sh * sw; i += kThreads) {
    const int y = y0 - 2 * ry + i / sw, x = x0 - 2 * rx + i % sw;
    s[i] = (y >= 0 && y < h && x >= 0 && x < w) ? src[plane + (long long)y * w + x] : 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < dh * sw; i += kThreads) {
    uint8_t m = 0;
    for (int j = 0; j < kh; ++j) m = max(m, s[i + j * sw]);
    dv[i] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < dh * dw; i += kThreads) {
    const int ly = i / dw, lx = i % dw;
    const int y = y0 - ry + ly, x = x0 - rx + lx;
    uint8_t m = 255;  // the erosion's border
    if (y >= 0 && y < h && x >= 0 && x < w) {
      m = 0;
      const uint8_t* p = dv + ly * sw + lx;
      for (int j = 0; j < kw; ++j) m = max(m, p[j]);
    }
    d[i] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileH * dw; i += kThreads) {
    uint8_t m = 255;
    for (int j = 0; j < kh; ++j) m = min(m, d[i + j * dw]);
    ev[i] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int ly = i / kTileW, lx = i % kTileW;
    const int y = y0 + ly, x = x0 + lx;
    if (y >= h || x >= w) continue;
    uint8_t m = 255;
    const uint8_t* p = ev + ly * dw + lx;
    for (int j = 0; j < kw; ++j) m = min(m, p[j]);
    const int v = s[(ly + 2 * ry) * sw + lx + 2 * rx];
    dst[plane + (long long)y * w + x] = (uint8_t)max((int)m - v, 0);
  }
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
  return smem_bytes(kw, kh) <= kMaxSmem ? 0 : 2LL * batch * h * w;
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
  const size_t smem = smem_bytes(kw, kh);
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
