// Pieces shared by the inter conv forward (inter_conv.cu) and its backward
// (inter_conv_bwd.cu): the anchor weight, the F build's step for one
// neighbor (add_neighbor: every fp32 F build runs it, so each F element is
// summed in one order, bitwise the same in every kernel) and the function
// that builds one item of the SGEMM template's F slab,
//
//   F[row, k, cc] = sum_n w[pt, n, a, k] * T[b, idx[pt, n], a, c0 + cc]
//   w = relu(1 - ((|gx|^2 + |kappa_k|^2) - 2 gx . R_a kappa_k) / sigma)
//
// for one flattened (point, anchor) row and one group of KG kernel points,
// over a chunk of CC channels. The neighbor coordinates (x, y, z, |gx|^2)
// and indices of the block's points are staged in shared memory by the
// caller; the shadow index (== q) reads a zero row. The table is fp32 or
// bf16 (elem.cuh); the weights and the sums are fp32, and with kRound each
// weight is rounded to T before its products and F to T after its sum (the
// rounding points of the TPU forward kernels in bf16).

#pragma once

#include <cuda_runtime.h>

#include "elem.cuh"

namespace epn_inter {

constexpr int CC = 8;  // channels a chunk
constexpr int KG = 6;  // kernel points an F item

__device__ __forceinline__ float anchor_weight(const float4& g, const float4& r,
                                               float inv_sigma) {
  const float cross = (g.x * r.x + g.y * r.y) + g.z * r.z;
  const float d2 = (g.w + r.w) - 2.f * cross;
  return fmaxf(1.f - d2 * inv_sigma, 0.f);
}

// One neighbor's step of the F build: acc[j][c] += w_j * t[c] for the KT
// kernel points r[j] (x, y, z, |kappa|^2 of R_a kappa_k) and the N channel
// values t of the neighbor's table row, load4(h) giving t[4h .. 4h + 4];
// w_j = anchor_weight(g, r[j]) (rounded to T with kRound), each sum by
// fmaf. Called for the neighbors in order, it sums each F element as every
// F build of this repository does.
template <int KT, int N, bool kRound = false, typename T = float,
          typename Load4>
__device__ __forceinline__ void add_neighbor(float (&acc)[KT][N],
                                             const float4& g,
                                             const float4 (&r)[KT],
                                             float inv_sigma, Load4 load4) {
  static_assert(N % 4 == 0, "channels in float4s");
  float w[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    w[j] = anchor_weight(g, r[j], inv_sigma);
    if (kRound) w[j] = epn::round_to<T>(w[j]);
  }
#pragma unroll
  for (int h = 0; h < N / 4; ++h) {
    const float4 t = load4(h);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      acc[j][4 * h] = fmaf(w[j], t.x, acc[j][4 * h]);
      acc[j][4 * h + 1] = fmaf(w[j], t.y, acc[j][4 * h + 1]);
      acc[j][4 * h + 2] = fmaf(w[j], t.z, acc[j][4 * h + 2]);
      acc[j][4 * h + 3] = fmaf(w[j], t.w, acc[j][4 * h + 3]);
    }
  }
}

// Writes F[row, kg * KG + kq, cc] (kq < KG, cc < CC) to fr[kq * CC + cc];
// zeros for a row past M. gm = the flat row, pt0 = the first point whose
// neighbors sit in s_gx / s_idx, p2 = points a cloud.
template <typename T, bool kRound = false>
__device__ __forceinline__ void build_f_item(
    float* __restrict__ fr, const T* __restrict__ table,
    const float* __restrict__ rk, const float* __restrict__ k2,
    const float4* __restrict__ s_gx, const int* __restrict__ s_idx, int gm,
    int M, int pt0, int p2, int nn, int q, int na, int K, int C, int c0,
    int kg, float inv_sigma) {
  float f[KG][CC];
#pragma unroll
  for (int kq = 0; kq < KG; ++kq) {
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) f[kq][cc] = 0.f;
  }
  if (gm < M) {
    const int pt = gm / na, a = gm - pt * na;
    const T* tb = table + ((size_t)(pt / p2) * q * na + a) * C + c0;
    const float4* g4 = s_gx + (pt - pt0) * nn;
    const int* ix = s_idx + (pt - pt0) * nn;
    float4 r[KG];
#pragma unroll
    for (int kq = 0; kq < KG; ++kq) {
      const float* rp = rk + ((size_t)a * K + kg * KG + kq) * 3;
      r[kq] = make_float4(rp[0], rp[1], rp[2], k2[kg * KG + kq]);
    }
#pragma unroll 4
    for (int n = 0; n < nn; ++n) {
      const int j = ix[n];
      float t[CC] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j < q) epn::load8(tb + (size_t)j * na * C, t);
      add_neighbor<KG, CC, kRound, T>(f, g4[n], r, inv_sigma, [&](int h) {
        return make_float4(t[4 * h], t[4 * h + 1], t[4 * h + 2], t[4 * h + 3]);
      });
    }
  }
#pragma unroll
  for (int kq = 0; kq < KG; ++kq) {
    if (kRound) {
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) f[kq][cc] = epn::round_to<T>(f[kq][cc]);
    }
    reinterpret_cast<float4*>(fr + kq * CC)[0] =
        make_float4(f[kq][0], f[kq][1], f[kq][2], f[kq][3]);
    reinterpret_cast<float4*>(fr + kq * CC)[1] =
        make_float4(f[kq][4], f[kq][5], f[kq][6], f[kq][7]);
  }
}

// Stages the neighbor coordinates (x, y, z, |gx|^2) and indices of np
// points from point pt0 on into shared memory.
__device__ __forceinline__ void stage_neighbors(
    float4* __restrict__ s_gx, int* __restrict__ s_idx,
    const float* __restrict__ gx, const int* __restrict__ idx, int pt0,
    int np, int nn, int tid, int n_threads) {
  for (int e = tid; e < np * nn; e += n_threads) {
    const size_t src = (size_t)pt0 * nn + e;
    const float x = gx[3 * src], y = gx[3 * src + 1], z = gx[3 * src + 2];
    s_gx[e] = make_float4(x, y, z, (x * x + y * y) + z * z);
    s_idx[e] = idx[src];
  }
}

}  // namespace epn_inter
