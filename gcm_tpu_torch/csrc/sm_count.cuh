// The number of SMs of a card, which the launchers size their grids by.
#pragma once

#include <cuda_runtime.h>

// SMs of `device`, asked once per device (132, an H100 SXM's, where the
// query fails).
inline int sm_count(int device) {
  static int cached[64] = {};
  const bool cacheable = device >= 0 && device < 64;
  if (cacheable && cached[device]) return cached[device];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess || n < 1)
    n = 132;
  if (cacheable) cached[device] = n;
  return n;
}
