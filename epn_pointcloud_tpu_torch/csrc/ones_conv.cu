// Block-0 inter conv on the occupancy-ones input: the anchor-weight sum
//
//   F[b, p, a, k] = sum_n relu(1 - |gx[b, p, n] - R_a kappa_k|^2 / sigma)
//
// over the layer-0 ball-query neighbors (every gathered feature is 1, so
// the neighbor contraction is the weight sum; the learned [K, D] product
// runs outside as one matrix product), in fp32; F is written in fp32 or
// bf16.
//
// Replaces: epn_pointcloud_tpu/ops/pallas/ones_conv.py, ones_weight_sum
// (_ones_fwd -> _kernel). The TPU kernel selects neighbor coordinates with a
// one-hot MXU product from a hi/lo bf16 coordinate table and pads the lanes
// to 128 with sentinel kernel points; none of that comes over: here the
// neighbors' fp32 coordinates are read directly. Its VJP is zero (F depends
// on the coordinates only), so there is no backward kernel.
//
// What bounds it on the H100: instruction issue on the CUDA cores. The
// coordinates in are 2.4 MB and F out 94 MB (fp32) / 47 MB (bf16) at the
// b=32 flagship layer 0 (~28 / 14 us at 3.35 TB/s), against 32 * 512 * 32
// * 1440 = 755M weights.
//
// Design: the weight is folded so that it costs three FFMA and the sum's
// FADD. With a = 2 R_a kappa_k / sigma and c = 1 - |kappa_k|^2 / sigma a
// lane (l = a * K + k), and h = |gx|^2 / sigma a neighbor,
//
//   1 - |gx - R_a kappa_k|^2 / sigma = (c - h) + gx . a  <= 1,
//
// so its relu is the saturation of the last FFMA (fma.rn.sat clamps to
// [0, 1]). A block of T threads, T a multiple of K, owns kLanes lanes a
// thread, l = l0 + t + j * T: neighboring threads store neighboring lanes,
// and all the lanes of a thread share kernel point k = t % K, so c - h is
// one FADD a neighbor for all of them. The thread keeps its lanes' a and c
// in registers; each neighbor's (x, y, z, h), staged in shared memory for
// the block's kPoints points (every thread reads the same element: a
// broadcast), serves its kLanes lanes from one shared load. At 60 anchors
// x 24 kernel points, T = 288 (9 warps) covers the 1440 lanes with no idle
// pass. That is 4.4 instructions a weight, 0.099 ms at the card's issue
// rate (132 SMs x 128 lanes x 1.98 GHz) for the 755M weights above.
//
// Each lane sums its neighbors in kParts interleaved partial sums (the
// staged neighbors padded to a multiple of kParts with points whose weight
// is 0): on the reg_so3net layer 0 (clustered airplane clouds, 64
// neighbors) one chain of 64 adds put F's float64 error at 1.85-1.96x the
// plain version's; the rounding of the weight itself is within 0.85x of
// it.

#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>

#include "elem.cuh"

namespace {

constexpr int kLanes = 5;          // output lanes a thread
constexpr int kPoints = 4;         // points a block (staged together)
constexpr int kParts = 4;          // partial sums a lane (neighbors mod 4)
constexpr int kMaxThreads = 512;   // threads a block: K * (T / K)
constexpr size_t kSmemMax = 227 * 1024;

// a * b + c rounded once, clamped to [0, 1] (NaN to 0)
__device__ __forceinline__ float fma_sat(float a, float b, float c) {
  float d;
  asm("fma.rn.sat.f32 %0, %1, %2, %3;" : "=f"(d) : "f"(a), "f"(b), "f"(c));
  return d;
}

// one inner loop for both output types (F's type only changes its store):
// as a template the two instantiations were scheduled apart, and the bf16
// one's serial chains ran 22% slower
__global__ void __launch_bounds__(kMaxThreads)
ones_conv_kernel(const float* __restrict__ gx, const float* __restrict__ rk,
                 const float* __restrict__ k2, void* __restrict__ out,
                 int n_pts, int nn, int L, int K, int pts, float inv_sigma,
                 int bf16) {
  // [pts][nnp] (x, y, z, |gx|^2 / sigma), each point's neighbors padded to
  // nnp (a multiple of kParts) with (0, 0, 0, FLT_MAX), whose weight is 0
  extern __shared__ float4 s_g[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int pt0 = blockIdx.x * pts;
  const int np = min(pts, n_pts - pt0);
  const int nnp = (nn + kParts - 1) / kParts * kParts;
  for (int e = tid; e < np * nnp; e += nt) {
    const int i = e / nnp, r = e - i * nnp;
    float4 v = make_float4(0.f, 0.f, 0.f, FLT_MAX);
    if (r < nn) {
      const size_t src = (size_t)(pt0 + i) * nn + r;
      const float x = gx[3 * src], y = gx[3 * src + 1], z = gx[3 * src + 2];
      v = make_float4(x, y, z, fmaf(z, z, fmaf(y, y, x * x)) * inv_sigma);
    }
    s_g[e] = v;
  }
  __syncthreads();
  const float two_inv = 2.f * inv_sigma;
  const float c = fmaf(-k2[tid % K], inv_sigma, 1.f);
  for (int l0 = 0; l0 < L; l0 += kLanes * nt) {
    float ax[kLanes], ay[kLanes], az[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int l = l0 + tid + j * nt;
      const bool live = l < L;  // a lane past L sums zeros, never stored
      ax[j] = live ? rk[3 * l] * two_inv : 0.f;
      ay[j] = live ? rk[3 * l + 1] * two_inv : 0.f;
      az[j] = live ? rk[3 * l + 2] * two_inv : 0.f;
    }
    for (int i = 0; i < np; ++i) {
      const float4* g = s_g + i * nnp;
      // kParts partial sums a lane, of the neighbors n = q (mod kParts),
      // then added in order of q: the sum's rounding error grows with the
      // adds in one chain
      float part[kParts][kLanes];
#pragma unroll
      for (int q = 0; q < kParts; ++q)
#pragma unroll
        for (int j = 0; j < kLanes; ++j) part[q][j] = 0.f;
#pragma unroll 2
      for (int n = 0; n < nnp; n += kParts) {
#pragma unroll
        for (int q = 0; q < kParts; ++q) {
          const float4 v = g[n + q];
          const float t = c - v.w;
#pragma unroll
          for (int j = 0; j < kLanes; ++j) {
            part[q][j] += fma_sat(v.z, az[j], fmaf(v.y, ay[j], fmaf(v.x, ax[j], t)));
          }
        }
      }
      float acc[kLanes];
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        acc[j] = part[0][j];
#pragma unroll
        for (int q = 1; q < kParts; ++q) acc[j] += part[q][j];
      }
      const size_t o = (size_t)(pt0 + i) * L + l0 + tid;
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        if (l0 + tid + j * nt < L) {
          if (bf16) {
            epn::store1((epn::bf16*)out + o + j * nt, acc[j]);
          } else {
            epn::store1((float*)out + o + j * nt, acc[j]);
          }
        }
      }
    }
  }
}

}  // namespace

// gx [b, p2, nn, 3] fp32 neighbor coordinates relative to their centers,
// rk [na, K, 3], k2 [K], out [b, p2, na, K] (fp32, or bf16 when bf16 != 0);
// 1 <= nn <= 14528 (one point's neighbors, padded to a multiple of kParts,
// in shared memory), 1 <= K <= 512.
extern "C" int epn_ones_conv(const void* gx, const void* rk, const void* k2,
                             void* out, int b, int p2, int nn, int na, int K,
                             float sigma, int bf16, void* stream) {
  const int nnp = (nn + kParts - 1) / kParts * kParts;
  if (nn < 1 || (size_t)nnp * sizeof(float4) > kSmemMax || K < 1 ||
      K > kMaxThreads || na < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_pts = b * p2, L = na * K;
  // the fewest multiples of K that cover L in kLanes passes, at most
  // kMaxThreads threads (beyond, the lanes take more passes)
  const int per = (L + kLanes - 1) / kLanes;
  const int threads = K * std::min((per + K - 1) / K, kMaxThreads / K);
  const int pts = (int)std::min<size_t>(
      kPoints, kSmemMax / ((size_t)nnp * sizeof(float4)));
  const size_t smem = (size_t)pts * nnp * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ones_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ones_conv_kernel<<<(n_pts + pts - 1) / pts, threads, smem,
                     (cudaStream_t)stream>>>(
      (const float*)gx, (const float*)rk, (const float*)k2, out, n_pts, nn, L,
      K, pts, 1.f / sigma, bf16);
  return (int)cudaGetLastError();
}
