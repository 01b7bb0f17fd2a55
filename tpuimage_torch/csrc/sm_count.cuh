// The current device's SM count, read from the runtime once per device
// (0 where it cannot be read): the kernels that size a persistent grid or
// a share of blocks to the card include it.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;

int sm_count() {
  static int cached[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    cached[dev] = sms;
  }
  return cached[dev];
}

}  // namespace
