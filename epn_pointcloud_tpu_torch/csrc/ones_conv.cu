// Block-0 inter conv on the occupancy-ones input: the anchor-weight sum
//
//   F[b, p, a, k] = sum_n relu(1 - |gx[b, p, n] - R_a kappa_k|^2 / sigma)
//
// over the layer-0 ball-query neighbors (every gathered feature is 1, so
// the neighbor contraction is the weight sum; the learned [K, D] product
// runs outside as one matrix product). |gx - rk|^2 is expanded as
// (|gx|^2 + |kappa|^2) - 2 gx . rk, exactly as the inter conv kernels do
// (inter_conv_common.cuh), in fp32; F is written in fp32 or bf16.
//
// Replaces: epn_pointcloud_tpu/ops/pallas/ones_conv.py, ones_weight_sum
// (_ones_fwd -> _kernel). The TPU kernel selects neighbor coordinates with a
// one-hot MXU product from a hi/lo bf16 coordinate table and pads the lanes
// to 128 with sentinel kernel points; none of that comes over: here the
// neighbors' fp32 coordinates are read directly. Its VJP is zero (F depends
// on the coordinates only), so there is no backward kernel.
//
// What bounds it on the H100: arithmetic. Each (point, neighbor, anchor,
// kernel point) costs ~10 fp32 operations (b=32 flagship layer 0: 32 * 512
// * 32 * 1440 weights, ~7.5 GFLOP, ~0.11 ms at the 67 TFLOP/s fp32 peak),
// against 2.4 MB of coordinates in and 94 MB (fp32) / 47 MB (bf16) of F out
// (~28 / 14 us at 3.35 TB/s).
//
// Design: a block owns PTS points. It stages their neighbors' (x, y, z,
// |gx|^2) in shared memory (every thread then reads the same element: a
// broadcast), and each thread owns output lanes l = a * K + k strided by
// the block size, keeps R_a kappa_k and |kappa_k|^2 of its lane in
// registers, and sums the weights over the neighbors of each point. Stores
// of neighboring lanes are contiguous.

#include <cuda_runtime.h>

#include "elem.cuh"
#include "inter_conv_common.cuh"

namespace {

constexpr int PTS = 8;        // points a block
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ones_conv_kernel(const float* __restrict__ gx, const float* __restrict__ rk,
                 const float* __restrict__ k2, T* __restrict__ out,
                 int n_pts, int nn, int L, int K, float inv_sigma) {
  extern __shared__ float4 s_g[];  // [PTS][nn] (x, y, z, |gx|^2)
  const int pt0 = blockIdx.x * PTS;
  const int np = min(PTS, n_pts - pt0);
  for (int e = threadIdx.x; e < np * nn; e += kThreads) {
    const size_t src = (size_t)pt0 * nn + e;
    const float x = gx[3 * src], y = gx[3 * src + 1], z = gx[3 * src + 2];
    s_g[e] = make_float4(x, y, z, (x * x + y * y) + z * z);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += kThreads) {
    const float4 r = make_float4(rk[3 * l], rk[3 * l + 1], rk[3 * l + 2],
                                 k2[l % K]);
    for (int i = 0; i < np; ++i) {
      const float4* g = s_g + i * nn;
      float acc = 0.f;
#pragma unroll 8
      for (int n = 0; n < nn; ++n) {
        acc += epn_inter::anchor_weight(g[n], r, inv_sigma);
      }
      epn::store1(out + (size_t)(pt0 + i) * L + l, acc);
    }
  }
}

template <typename T>
int launch(const float* gx, const float* rk, const float* k2, void* out,
           int n_pts, int nn, int na, int K, float sigma, cudaStream_t s) {
  const size_t smem = (size_t)PTS * nn * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ones_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ones_conv_kernel<T><<<(n_pts + PTS - 1) / PTS, kThreads, smem, s>>>(
      gx, rk, k2, (T*)out, n_pts, nn, na * K, K, 1.f / sigma);
  return (int)cudaGetLastError();
}

}  // namespace

// gx [b, p2, nn, 3] fp32 neighbor coordinates relative to their centers,
// rk [na, K, 3], k2 [K], out [b, p2, na, K] (fp32, or bf16 when bf16 != 0).
extern "C" int epn_ones_conv(const void* gx, const void* rk, const void* k2,
                             void* out, int b, int p2, int nn, int na, int K,
                             float sigma, int bf16, void* stream) {
  if (nn < 1 || (size_t)nn * PTS * sizeof(float4) > 227 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gx;
  const float* r = (const float*)rk;
  const float* kk = (const float*)k2;
  if (bf16) return launch<epn::bf16>(g, r, kk, out, b * p2, nn, na, K, sigma, s);
  return launch<float>(g, r, kk, out, b * p2, nn, na, K, sigma, s);
}
