// Pieces shared by the inter conv forward (inter_conv.cu) and its backward
// (inter_conv_bwd.cu): the anchor weight and the builder of one item of the
// F slab,
//
//   F[row, k, cc] = sum_n w[pt, n, a, k] * T[b, idx[pt, n], a, c0 + cc]
//   w = relu(1 - ((|gx|^2 + |kappa_k|^2) - 2 gx . R_a kappa_k) / sigma)
//
// for one flattened (point, anchor) row and one group of KG kernel points,
// over a chunk of CC channels. The neighbor coordinates (x, y, z, |gx|^2)
// and indices of the block's points are staged in shared memory by the
// caller; the shadow index (== q) reads a zero row.

#pragma once

#include <cuda_runtime.h>

namespace epn_inter {

constexpr int CC = 8;  // channels a chunk
constexpr int KG = 6;  // kernel points an F item

__device__ __forceinline__ float anchor_weight(const float4& g, const float4& r,
                                               float inv_sigma) {
  const float cross = (g.x * r.x + g.y * r.y) + g.z * r.z;
  const float d2 = (g.w + r.w) - 2.f * cross;
  return fmaxf(1.f - d2 * inv_sigma, 0.f);
}

// Writes F[row, kg * KG + kq, cc] (kq < KG, cc < CC) to fr[kq * CC + cc];
// zeros for a row past M. gm = the flat row, pt0 = the first point whose
// neighbors sit in s_gx / s_idx, p2 = points a cloud.
__device__ __forceinline__ void build_f_item(
    float* __restrict__ fr, const float* __restrict__ table,
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
    const float* tb = table + ((size_t)(pt / p2) * q * na + a) * C + c0;
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
      float4 t0 = make_float4(0.f, 0.f, 0.f, 0.f), t1 = t0;
      if (j < q) {
        const float4* tp = reinterpret_cast<const float4*>(tb + (size_t)j * na * C);
        t0 = tp[0];
        t1 = tp[1];
      }
      const float4 g = g4[n];
      const float t[CC] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
      for (int kq = 0; kq < KG; ++kq) {
        const float w = anchor_weight(g, r[kq], inv_sigma);
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) f[kq][cc] = fmaf(w, t[cc], f[kq][cc]);
      }
    }
  }
#pragma unroll
  for (int kq = 0; kq < KG; ++kq) {
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
