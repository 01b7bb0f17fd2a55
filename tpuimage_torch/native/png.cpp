// PNG row reconstruction for tpuimage_torch.io.png: undoes the five
// filters of the PNG specification (section 9) on 8-bit samples. The
// Average and Paeth filters depend on the reconstructed byte to the left,
// a chain numpy cannot vectorise; io/png.py keeps the value-identical
// Python loop as the fallback. Exposed with a plain C ABI, built with g++
// at first use and loaded via ctypes (tpuimage_torch.native).

#include <cstdint>
#include <cstdlib>

extern "C" {

// ftypes: h filter-type bytes (each 0-4, checked by the caller); data: h
// rows of stride bytes, the filter byte removed; bpp: bytes a pixel
// (1-4). out (h * stride) receives the reconstructed rows.
void tpuimage_png_unfilter(const uint8_t* ftypes, const uint8_t* data, int64_t h,
                           int64_t stride, int64_t bpp, uint8_t* out) {
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* x = data + r * stride;
    uint8_t* o = out + r * stride;
    const uint8_t* up = r > 0 ? out + (r - 1) * stride : nullptr;
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? o[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int pred = 0;
      switch (ftypes[r]) {
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: break;
      }
      o[i] = static_cast<uint8_t>(x[i] + pred);
    }
  }
}

}  // extern "C"
