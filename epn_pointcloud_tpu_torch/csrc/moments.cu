// Per-lane moment sums of a [b, rows, L] activation (norm statistics):
//
//   sum[b, l] = sum_r x[b, r, l],   sumsq[b, l] = sum_r x[b, r, l]^2
//
// in fp32, from fp32 or bf16 input. The callers fold the per-lane sums to
// per-(b, c) statistics (nn/layers.py, InstanceNorm) in plain PyTorch.
//
// Replaces: epn_pointcloud_tpu/ops/pallas/moments.py, moments_sums
// (_moments_fwd -> _kernel), which walks row tiles in order and carries the
// sums in its output block across grid steps. Blocks of a CUDA grid run in
// no order, so here a block owns a column of lanes over all rows instead.
//
// What bounds it on the H100: device memory. It reads x once (b=32
// flagship layer 0: 32 * 512 * 3840 bf16, 126 MB, ~38 us at 3.35 TB/s) and
// does 3 fp32 operations an element.
//
// Design: a block is 64 x 8 threads over 128 lanes; each thread owns two
// neighbouring lanes (one 4- or 8-byte load a row) and every 8th row. The
// eight partial sums of a lane are then added in shared memory in a fixed
// order: deterministic, no atomics.

#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

constexpr int TX = 64;   // lane pairs a block
constexpr int TY = 8;    // row phases a block

template <typename T>
__global__ void __launch_bounds__(TX * TY)
moments_kernel(const T* __restrict__ x, float* __restrict__ sum,
               float* __restrict__ sumsq, int rows, int L) {
  __shared__ float s_s[TY][2 * TX];
  __shared__ float s_q[TY][2 * TX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int l = (blockIdx.x * TX + tx) * 2;
  const int b = blockIdx.y;
  float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
  if (l < L) {
    const T* xp = x + (size_t)b * rows * L + l;
    for (int r = ty; r < rows; r += TY) {
      const float2 v = epn::load2(xp + (size_t)r * L);
      s0 += v.x;
      s1 += v.y;
      q0 = fmaf(v.x, v.x, q0);
      q1 = fmaf(v.y, v.y, q1);
    }
  }
  s_s[ty][2 * tx] = s0;
  s_s[ty][2 * tx + 1] = s1;
  s_q[ty][2 * tx] = q0;
  s_q[ty][2 * tx + 1] = q1;
  __syncthreads();
  // 512 threads, 128 lanes x {sum, sumsq}: the first 256 finish one each
  const int t = ty * TX + tx;
  if (t < 4 * TX) {
    const int j = t % (2 * TX);
    const int lane = blockIdx.x * 2 * TX + j;
    if (lane < L) {
      float (*src)[2 * TX] = t < 2 * TX ? s_s : s_q;
      float acc = 0.f;
#pragma unroll
      for (int y = 0; y < TY; ++y) acc += src[y][j];
      (t < 2 * TX ? sum : sumsq)[(size_t)b * L + lane] = acc;
    }
  }
}

template <typename T>
int launch(const void* x, float* sum, float* sumsq, int b, int rows, int L,
           cudaStream_t s) {
  dim3 grid((L / 2 + TX - 1) / TX, b);
  moments_kernel<T><<<grid, dim3(TX, TY), 0, s>>>((const T*)x, sum, sumsq,
                                                  rows, L);
  return (int)cudaGetLastError();
}

}  // namespace

// x [b, rows, L] (fp32, or bf16 when bf16 != 0), L even; sum, sumsq [b, L]
// fp32.
extern "C" int epn_moments(const void* x, void* sum, void* sumsq, int b,
                           int rows, int L, int bf16, void* stream) {
  if (L % 2 != 0 || b < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return launch<epn::bf16>(x, (float*)sum, (float*)sumsq, b, rows, L, s);
  }
  return launch<float>(x, (float*)sum, (float*)sumsq, b, rows, L, s);
}
