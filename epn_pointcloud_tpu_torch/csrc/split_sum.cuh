// The second launch of the dW reductions (inter_conv_bwd.cu, intra_conv.cu):
// each block of the first launch wrote the partial dW of its row range to a
// workspace [splits, n]; this adds the partials in a fixed order, so dW
// rounds the same way on every run (no atomics).

#pragma once

#include <cuda_runtime.h>

namespace {

// out[i] = sum_s part[s][i], s in order
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int splits,
                                  size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
  out[i] = s;
}

inline int launch_sum_splits(const float* part, float* out, int splits,
                             size_t n, cudaStream_t stream) {
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, out, splits, n);
  return (int)cudaGetLastError();
}

}  // namespace
