// cv2.Canny (aperture 3) on a batch of (B, H, W) u8 planes, in two kernels:
//
//   canny_pre_kernel:        Sobel 3x3 with a reflect-101 border, the L1
//                            magnitude |dx| + |dy| (or the squared L2 one
//                            dx*dx + dy*dy), cv2's sector non-maximum
//                            suppression (TG22 in Q15, the magnitude 0
//                            outside the image) and the double threshold,
//                            in one pass -> the strong and weak bool maps;
//   canny_hysteresis_kernel: one convergence check of the hysteresis: 8
//                            synchronous steps new = new | (weak &
//                            dilate8(new)), neighbours outside the image
//                            unset, in one launch; a device flag is set
//                            where the check changed any pixel.
//
// Replaces no TPU kernel: tpuimage has no Pallas kernel for Canny, and the
// port ran ops/edges.py's eager form op for op (two Sobel passes of six
// shifted products, eight shifted copies of the magnitude, about twelve
// launches a hysteresis step). It was added because that form was the
// largest block of eager glue on DocScanner's route, in card bytes and in
// host launches; the eager form is kept as the plain versions
// (ops/kernels.py canny_pre_ref, hysteresis_check_ref).
//
// Exactness: Sobel sums, magnitudes and the Q15 sector products are
// integers below 2^24, exact in f32 in any order, except tg67x = tg22x +
// xs * 65536, which reaches 2^26 and rounds; it is formed as the plain
// version forms it, two f32 roundings (__fmul_rn / __fadd_rn, no
// contraction). Thresholds come as the f32 values the plain version's
// compares use. Everything else is integer or bit logic, so both kernels
// equal their plain versions bit for bit.
//
// Bound on the H100: memory. canny_pre reads 1 byte and writes 2 a pixel;
// a check reads 2 and writes 1 (the three maps of 8 A4 pages, 24 MB, fit
// the 50 MB L2 between launches).
//
// Design, canny_pre: a block of 32 x 8 threads owns a 64 x 32 tile. The
// gray tile with a 2-pixel halo goes to shared memory (reflect-101
// indices at the image's edge, as pad2d pads), then dx, dy and the
// magnitude of the tile with a 1-pixel halo (0 outside the image and in
// rows outside row_valid), then each pixel's sector test against its
// neighbours' magnitudes in shared memory and both thresholds.
//
// Design, hysteresis: the maps are bit-packed, one 32-bit word a run of 32
// pixels (bit i = column 32 j + i). A block of 8 warps owns 30 words x 48
// rows of output and loads 32 words x 64 rows: one word and 8 rows of halo
// on every side, as far as 8 steps reach. Each warp holds 8 rows, lane j
// word j, in registers; the words are packed by ballots over coalesced
// byte loads, 4 words of 8 rows of both maps in flight a lane. A step is the 3x3 OR of the bits: the horizontal part with
// shifts and the neighbouring lanes' words by shuffle, the vertical part
// with the rows above and below, across warps through a shared-memory ring
// of each warp's first and last rows (one barrier a step). The 6 inner
// warps' 30 inner lanes then write their pixels as 0 / `on` bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxGridZ = 65535;

// canny_pre's tile
constexpr int kPreBX = 32, kPreBY = 8;
constexpr int kPreTW = 64, kPreTH = 32;
constexpr int kTG22 = 13573;   // cv2: tan(22.5 deg) * 2^15, rounded

// cv2's BORDER_REFLECT_101 index of i in [-1, n] (n == 1: 0); indices
// further out are clamped into the plane (their values are never used).
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return min(max(i, 0), n - 1);
}

template <bool L2>
__global__ void __launch_bounds__(kPreBX * kPreBY)
canny_pre_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ row_valid,
                 uint8_t* __restrict__ strong, uint8_t* __restrict__ weak, int h, int w,
                 float low_t, float high_t) {
  __shared__ uint8_t g[kPreTH + 4][kPreTW + 4];          // gray from (y0 - 2, x0 - 2)
  __shared__ float mag[kPreTH + 2][kPreTW + 2];          // magnitude from (y0 - 1, x0 - 1)
  __shared__ int16_t sdx[kPreTH][kPreTW], sdy[kPreTH][kPreTW];
  const int x0 = blockIdx.x * kPreTW, y0 = blockIdx.y * kPreTH;
  const long long plane = (long long)blockIdx.z * h * w;
  const uint8_t* img = src + plane;

  for (int r = threadIdx.y; r < kPreTH + 4; r += kPreBY) {
    const long long row = (long long)reflect101(y0 - 2 + r, h) * w;
    for (int c = threadIdx.x; c < kPreTW + 4; c += kPreBX) {
      g[r][c] = img[row + reflect101(x0 - 2 + c, w)];
    }
  }
  __syncthreads();

  for (int r = threadIdx.y; r < kPreTH + 2; r += kPreBY) {
    const int y = y0 - 1 + r;
    const bool row_in = y >= 0 && y < h && (row_valid == nullptr || row_valid[y]);
    for (int c = threadIdx.x; c < kPreTW + 2; c += kPreBX) {
      const int x = x0 - 1 + c;
      const int a = g[r][c], b = g[r][c + 1], cc = g[r][c + 2];
      const int d = g[r + 1][c], f = g[r + 1][c + 2];
      const int gg = g[r + 2][c], hh = g[r + 2][c + 1], ii = g[r + 2][c + 2];
      const int dx = (cc - a) + 2 * (f - d) + (ii - gg);
      const int dy = (gg + 2 * hh + ii) - (a + 2 * b + cc);
      const int m = L2 ? dx * dx + dy * dy : abs(dx) + abs(dy);
      mag[r][c] = row_in && x >= 0 && x < w ? (float)m : 0.0f;
      if (r >= 1 && r <= kPreTH && c >= 1 && c <= kPreTW) {
        sdx[r - 1][c - 1] = (int16_t)dx;
        sdy[r - 1][c - 1] = (int16_t)dy;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < (kPreTH / kPreBY) * (kPreTW / kPreBX); ++k) {
    const int i = threadIdx.y + kPreBY * (k / (kPreTW / kPreBX));
    const int j = threadIdx.x + kPreBX * (k % (kPreTW / kPreBX));
    const int y = y0 + i, x = x0 + j;
    if (y >= h || x >= w) continue;
    const int dx = sdx[i][j], dy = sdy[i][j];
    const float m = mag[i + 1][j + 1];
    const float xs = (float)abs(dx);
    const float ys = __fmul_rn((float)abs(dy), 32768.0f);
    const float tg22x = __fmul_rn(xs, (float)kTG22);
    const float tg67x = __fadd_rn(tg22x, __fmul_rn(xs, 65536.0f));
    bool keep;
    if (ys < tg22x) {
      keep = m > mag[i + 1][j] && m >= mag[i + 1][j + 2];
    } else if (ys > tg67x) {
      keep = m > mag[i][j + 1] && m >= mag[i + 2][j + 1];
    } else {
      const bool same = dx * dy >= 0;
      const float d1 = same ? mag[i][j] : mag[i][j + 2];
      const float d2 = same ? mag[i + 2][j + 2] : mag[i + 2][j];
      keep = m > d1 && m >= d2;
    }
    const bool cand = keep && m > low_t;
    const bool st = cand && m > high_t;
    const long long o = plane + (long long)y * w + x;
    strong[o] = st;
    weak[o] = cand && !st;
  }
}

// the hysteresis check's block
constexpr int kSteps = 8;                       // = kernels.HYSTERESIS_STEPS
constexpr int kHysWarps = 8, kHysRows = 8;      // rows a warp holds
constexpr int kHysOutRows = kHysWarps * kHysRows - 2 * kSteps;   // 48
constexpr int kHysOutWords = 30;                // lanes 1 .. 30
constexpr int kLoadWords = 4;                   // words whose loads a lane issues together
static_assert(kHysRows >= kSteps, "the first and last warps' rows are the vertical halo");

// The 1x3 OR of a row of words: bit i of lane j takes bits i - 1 .. i + 1,
// across the lanes' borders; nothing beyond lanes 0 and 31.
__device__ __forceinline__ uint32_t hdilate(uint32_t v, int lane) {
  uint32_t l = __shfl_up_sync(kAll, v, 1), r = __shfl_down_sync(kAll, v, 1);
  l = lane == 0 ? 0u : l;
  r = lane == 31 ? 0u : r;
  return v | (v << 1) | (v >> 1) | (l >> 31) | (r << 31);
}

__global__ void __launch_bounds__(kHysWarps * 32)
canny_hysteresis_kernel(const uint8_t* __restrict__ s_in, const uint8_t* __restrict__ weak,
                        uint8_t* __restrict__ out, int* __restrict__ flags, int slot, int h,
                        int w, uint8_t on) {
  __shared__ uint32_t tile[2][kHysWarps][kHysRows][32];   // ballots of s and weak
  __shared__ uint32_t ring[2][kHysWarps][2][32];          // first / last rows, by step parity
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * 32 * kHysOutWords - 32;     // lane 0's first column
  const int y0 = blockIdx.y * kHysOutRows - kSteps + wp * kHysRows;   // the warp's first row
  const long long plane = (long long)blockIdx.z * h * w;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0) {
    flags[slot ^ 1] = 0;
  }

  // kLoadWords words of kHysRows rows of both maps in flight a lane, then
  // their ballots; lane 0 keeps each word
#pragma unroll 1
  for (int j0 = 0; j0 < 32; j0 += kLoadWords) {
    uint8_t sv[kLoadWords][kHysRows], kv[kLoadWords][kHysRows];
#pragma unroll
    for (int u = 0; u < kLoadWords; ++u) {
      const int x = x0 + 32 * (j0 + u) + lane;
      const bool xin = x >= 0 && x < w;
#pragma unroll
      for (int r = 0; r < kHysRows; ++r) {
        const int y = y0 + r;
        const bool in = xin && y >= 0 && y < h;
        const long long o = plane + (long long)y * w + x;
        sv[u][r] = in ? s_in[o] : 0;
        kv[u][r] = in ? weak[o] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadWords; ++u) {
#pragma unroll
      for (int r = 0; r < kHysRows; ++r) {
        const uint32_t bs = __ballot_sync(kAll, sv[u][r] != 0);
        const uint32_t bk = __ballot_sync(kAll, kv[u][r] != 0);
        if (lane == 0) {
          tile[0][wp][r][j0 + u] = bs;
          tile[1][wp][r][j0 + u] = bk;
        }
      }
    }
  }
  __syncwarp();
  uint32_t s[kHysRows], k[kHysRows], s0[kHysRows];
#pragma unroll
  for (int r = 0; r < kHysRows; ++r) {
    s[r] = s0[r] = tile[0][wp][r][lane];
    k[r] = tile[1][wp][r][lane];
  }

#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    ring[t & 1][wp][0][lane] = s[0];
    ring[t & 1][wp][1][lane] = s[kHysRows - 1];
    __syncthreads();
    const uint32_t above = wp > 0 ? ring[t & 1][wp - 1][1][lane] : 0u;
    const uint32_t below = wp < kHysWarps - 1 ? ring[t & 1][wp + 1][0][lane] : 0u;
    uint32_t hd[kHysRows + 2];
    hd[0] = hdilate(above, lane);
#pragma unroll
    for (int r = 0; r < kHysRows; ++r) hd[r + 1] = hdilate(s[r], lane);
    hd[kHysRows + 1] = hdilate(below, lane);
#pragma unroll
    for (int r = 0; r < kHysRows; ++r) s[r] |= k[r] & (hd[r] | hd[r + 1] | hd[r + 2]);
  }

  bool changed = false;
  if (wp >= 1 && wp < kHysWarps - 1) {                   // rows kSteps .. kSteps + 47
#pragma unroll
    for (int r = 0; r < kHysRows; ++r) {
      const int y = y0 + r;
      if (y >= h) break;
      changed |= lane >= 1 && lane <= kHysOutWords && s[r] != s0[r];
      uint8_t* row = out + plane + (long long)y * w;
      for (int j = 1; j <= kHysOutWords; ++j) {
        const int x = x0 + 32 * j + lane;
        if (x0 + 32 * j >= w) break;
        const uint32_t word = __shfl_sync(kAll, s[r], j);
        if (x < w) row[x] = (word >> lane) & 1u ? on : 0;
      }
    }
  }
  if (__any_sync(kAll, changed) && lane == 0) flags[slot] = 1;
}

}  // namespace

extern "C" int tpuimage_canny_pre(const void* src, const void* row_valid, void* strong,
                                  void* weak, int batch, int h, int w, int l2, float low_t,
                                  float high_t, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  const long long n = (long long)h * w;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 block(kPreBX, kPreBY);
  for (int b0 = 0; b0 < batch; b0 += kMaxGridZ) {
    const dim3 grid((w + kPreTW - 1) / kPreTW, (h + kPreTH - 1) / kPreTH,
                    (unsigned)min(batch - b0, kMaxGridZ));
    const long long o = (long long)b0 * n;
    auto* s = static_cast<const uint8_t*>(src) + o;
    auto* rv = static_cast<const uint8_t*>(row_valid);
    auto* so = static_cast<uint8_t*>(strong) + o;
    auto* wo = static_cast<uint8_t*>(weak) + o;
    if (l2) {
      canny_pre_kernel<true><<<grid, block, 0, st>>>(s, rv, so, wo, h, w, low_t, high_t);
    } else {
      canny_pre_kernel<false><<<grid, block, 0, st>>>(s, rv, so, wo, h, w, low_t, high_t);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" int tpuimage_canny_hysteresis(const void* s, const void* weak, void* out,
                                         void* flags, int slot, int batch, int h, int w,
                                         int on, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (slot < 0 || slot > 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)h * w;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  for (int b0 = 0; b0 < batch; b0 += kMaxGridZ) {
    const dim3 grid((w + 32 * kHysOutWords - 1) / (32 * kHysOutWords),
                    (h + kHysOutRows - 1) / kHysOutRows, (unsigned)min(batch - b0, kMaxGridZ));
    const long long o = (long long)b0 * n;
    canny_hysteresis_kernel<<<grid, kHysWarps * 32, 0, st>>>(
        static_cast<const uint8_t*>(s) + o, static_cast<const uint8_t*>(weak) + o,
        static_cast<uint8_t*>(out) + o, static_cast<int*>(flags), slot, h, w, (uint8_t)on);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
