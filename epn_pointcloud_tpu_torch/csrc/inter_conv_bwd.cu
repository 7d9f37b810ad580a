// Inter (spatial) SO(3) convolution with the learned weight fused in,
// backward: the gradients of the table and of the weight,
//
//   dT[b, idx[b, p, n], a, c] += sum_k w[b, p, n, a, k] * dF[b, p, a, k, c]
//   dF[b, p, a, k, c] = sum_d dout[b, p, a, d] * W[k, c, d]
//   dW[k, c, d] = sum_{b, p, a} F[b, p, a, k, c] * dout[b, p, a, d]
//
// with F and w as in the forward (inter_conv.cu); a neighbor slot holding
// the shadow index (== q) contributes nothing.
//
// Replaces: epn_pointcloud_tpu/ops/pallas/inter_conv.py, the VJP _fgcw_bwd
// of fused_gather_conv_w: _call_gather_w_bwd -> _bwd_gather_w_kernel (the
// one-kernel form, nn=16 layers) and _call_gather_w_bwd_split ->
// _bwd_kernel_dtab / _bwd_kernel_dtab_packed and _bwd_kernel_dw2 /
// _bwd_kernel_dw2_packed (the split form, nn=32 layers). One design covers
// the fused, split and lane-packed TPU forms; the TPU's one-hot transpose
// select, block-diagonal folds and anchor pairing do not come over.
//
// What bounds it on the H100: arithmetic, as in the forward. dF and dW are
// each a GEMM the size of the forward's W product ([rows x 24C] x [24C x D]
// and its transpose over rows = b*p*60); the neighbor contraction and the
// anchor-weight recompute cost about 1.75 * nn / D of that. fp32 on the
// CUDA cores (no TF32, no wgmma): the FMA rate bounds it. dF would be 2.2 GB
// at L1 for b=12 and F more, so neither ever exists in device memory.
//
// dTable (inter_dtable_kernel): a block owns 64 flattened (point, anchor)
// rows. Per chunk of 8 channels it forms the dF slab [64 x 24 x 8] in
// shared memory by an SGEMM of its dout rows against W (both staged 16 d
// at a time; 8 x 6 outputs a thread), then gives each (row, neighbor) item
// to a thread, which recomputes the 24 anchor weights in registers exactly
// as the forward does, forms sum_k w * dF for the 8 channels and adds them
// into dT with atomics (red.global.add.f32). Threads of a warp share a row,
// so their dF reads are broadcasts. Determinism: the atomics add in an
// order that changes from run to run, so dT's ulp-level rounding does too.
//
// dW (inter_dw_kernel): a block owns one chunk of 8 channels (192 (k, cc)
// rows of dW), BN = 64 or 128 columns of d, and one range of rows. Per
// 64-row sub-tile it rebuilds the F slab with the forward's builder
// (inter_conv_common.cuh) and stages the dout slab, then accumulates
// F^T dout with 12 x (BN / 16) outputs a thread. Each row range writes its
// own partial dW to a workspace; a second launch (split_sum.cuh) adds the
// partials in a fixed order, so dW is deterministic.

#include <cuda_runtime.h>

#include "inter_conv_common.cuh"
#include "split_sum.cuh"

namespace {

using epn_inter::anchor_weight;
using epn_inter::build_f_item;
using epn_inter::CC;
using epn_inter::KG;
using epn_inter::stage_neighbors;

constexpr int NK = 24;          // kernel points (the model's kernel_size 1)
constexpr int NCOL = NK * CC;   // (k, cc) columns of a channel chunk
constexpr int FS = NCOL + 4;    // F / dF slab row stride (rows 4 banks apart)
constexpr size_t kMaxSmem = 227 * 1024;

// ---------------------------------------------------------------- dTable

constexpr int T_BM = 64;        // (point, anchor) rows a block
constexpr int T_BK = 16;        // d slice of the dF GEMM
constexpr int T_THREADS = 256;  // 8 row groups x 32 column lanes
constexpr int T_BS = NCOL + 1;  // W^T slice row stride (transposed stores)

// dynamic shared memory, in floats: dout^T slice [T_BK][T_BM], W^T slice
// [T_BK][T_BS], dF slab [T_BM][FS], neighbor coordinates [np][nn] float4,
// indices [np][nn]
struct TSmem {
  size_t b_off, f_off, gx_off, idx_off, total;
};

__host__ __device__ inline TSmem t_layout(int na, int nn) {
  TSmem s;
  const int np = T_BM / na + 2;
  s.b_off = (size_t)T_BK * T_BM;
  s.f_off = (s.b_off + (size_t)T_BK * T_BS + 3) / 4 * 4;
  s.gx_off = s.f_off + (size_t)T_BM * FS;
  s.idx_off = s.gx_off + (size_t)np * nn * 4;
  s.total = (s.idx_off + (size_t)np * nn) * sizeof(float);
  return s;
}

__global__ void __launch_bounds__(T_THREADS)
inter_dtable_kernel(const float* __restrict__ gx, const int* __restrict__ idx,
                    const float* __restrict__ rk, const float* __restrict__ k2,
                    const float* __restrict__ W,
                    const float* __restrict__ dout, float* __restrict__ dT,
                    int M, int p2, int nn, int q, int na, int C, int D,
                    float inv_sigma) {
  extern __shared__ __align__(16) float smem[];
  const TSmem L = t_layout(na, nn);
  float* s_A = smem;
  float* s_B = smem + L.b_off;
  float* s_F = smem + L.f_off;
  float4* s_gx = reinterpret_cast<float4*>(smem + L.gx_off);
  int* s_idx = reinterpret_cast<int*>(smem + L.idx_off);

  const int tid = threadIdx.x;
  const int tx = tid % 32, ty = tid / 32;
  const int m0 = blockIdx.x * T_BM;
  const int pt0 = m0 / na;
  const int np = (min(m0 + T_BM, M) - 1) / na - pt0 + 1;
  stage_neighbors(s_gx, s_idx, gx, idx, pt0, np, nn, tid, T_THREADS);

  for (int c0 = 0; c0 < C; c0 += CC) {
    // dF[row, k, cc] = sum_d dout[row, d] W[k, c0 + cc, d]: rows ty * 8 + i,
    // columns tx + 32 * j
    float acc[8][6];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) acc[i][j] = 0.f;
    }
    for (int d0 = 0; d0 < D; d0 += T_BK) {
      __syncthreads();
      for (int e = tid; e < T_BM * T_BK / 4; e += T_THREADS) {
        const int r = e % T_BM, q4 = e / T_BM;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m0 + r < M) {
          v = *reinterpret_cast<const float4*>(dout + (size_t)(m0 + r) * D +
                                               d0 + 4 * q4);
        }
        s_A[(4 * q4) * T_BM + r] = v.x;
        s_A[(4 * q4 + 1) * T_BM + r] = v.y;
        s_A[(4 * q4 + 2) * T_BM + r] = v.z;
        s_A[(4 * q4 + 3) * T_BM + r] = v.w;
      }
      for (int e = tid; e < NCOL * T_BK / 4; e += T_THREADS) {
        const int col = e / (T_BK / 4), q4 = e % (T_BK / 4);
        const int k = col / CC, cc = col - k * CC;
        const float4 v = *reinterpret_cast<const float4*>(
            W + ((size_t)k * C + c0 + cc) * D + d0 + 4 * q4);
        s_B[(4 * q4) * T_BS + col] = v.x;
        s_B[(4 * q4 + 1) * T_BS + col] = v.y;
        s_B[(4 * q4 + 2) * T_BS + col] = v.z;
        s_B[(4 * q4 + 3) * T_BS + col] = v.w;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < T_BK; ++dd) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(s_A + dd * T_BM + ty * 8);
        const float4 a1 =
            *reinterpret_cast<const float4*>(s_A + dd * T_BM + ty * 8 + 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float b[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) b[j] = s_B[dd * T_BS + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 6; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) s_F[(ty * 8 + i) * FS + tx + 32 * j] = acc[i][j];
    }
    __syncthreads();

    // scatter: one (row, neighbor) item a thread, neighbors fastest
    for (int e = tid; e < T_BM * nn; e += T_THREADS) {
      const int row = e / nn, n = e - row * nn;
      const int gm = m0 + row;
      if (gm >= M) continue;
      const int pt = gm / na, a = gm - pt * na;
      const int j = s_idx[(pt - pt0) * nn + n];
      if (j >= q) continue;
      const float4 g = s_gx[(pt - pt0) * nn + n];
      const float* fr = s_F + row * FS;
      const float* rp = rk + (size_t)a * NK * 3;
      float v[CC];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) v[cc] = 0.f;
#pragma unroll 4
      for (int k = 0; k < NK; ++k) {
        const float4 r = make_float4(__ldg(rp + 3 * k), __ldg(rp + 3 * k + 1),
                                     __ldg(rp + 3 * k + 2), __ldg(k2 + k));
        const float w = anchor_weight(g, r, inv_sigma);
        const float4 f0 = reinterpret_cast<const float4*>(fr + k * CC)[0];
        const float4 f1 = reinterpret_cast<const float4*>(fr + k * CC)[1];
        v[0] = fmaf(w, f0.x, v[0]);
        v[1] = fmaf(w, f0.y, v[1]);
        v[2] = fmaf(w, f0.z, v[2]);
        v[3] = fmaf(w, f0.w, v[3]);
        v[4] = fmaf(w, f1.x, v[4]);
        v[5] = fmaf(w, f1.y, v[5]);
        v[6] = fmaf(w, f1.z, v[6]);
        v[7] = fmaf(w, f1.w, v[7]);
      }
      float* dst = dT + (((size_t)(pt / p2) * q + j) * na + a) * C + c0;
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) atomicAdd(dst + cc, v[cc]);
    }
  }
}

// -------------------------------------------------------------------- dW

constexpr int W_BM = 64;         // rows a sub-tile
constexpr int W_THREADS = 256;   // 16 (k, cc) groups of 12 x 16 d lanes

// dynamic shared memory, in floats: F slab [W_BM][FS], dout slab
// [W_BM][BN], neighbor coordinates [np][nn] float4, indices [np][nn]
struct WSmem {
  size_t d_off, gx_off, idx_off, total;
};

__host__ __device__ inline WSmem w_layout(int bn, int na, int nn) {
  WSmem s;
  const int np = W_BM / na + 2;
  s.d_off = (size_t)W_BM * FS;
  s.gx_off = s.d_off + (size_t)W_BM * bn;
  s.idx_off = s.gx_off + (size_t)np * nn * 4;
  s.total = (s.idx_off + (size_t)np * nn) * sizeof(float);
  return s;
}

// d columns of a thread: h * (BN / NH) + tx * 4 + j, h < NH, j < 4
template <int BN>
__global__ void __launch_bounds__(W_THREADS)
inter_dw_kernel(const float* __restrict__ gx, const int* __restrict__ idx,
                const float* __restrict__ table, const float* __restrict__ rk,
                const float* __restrict__ k2, const float* __restrict__ dout,
                float* __restrict__ part, int M, int p2, int nn, int q,
                int na, int C, int D, int rows_per_split, float inv_sigma) {
  constexpr int NH = BN / 64;
  constexpr int TN = 4 * NH;
  extern __shared__ __align__(16) float smem[];
  const WSmem L = w_layout(BN, na, nn);
  float* s_F = smem;
  float* s_D = smem + L.d_off;
  float4* s_gx = reinterpret_cast<float4*>(smem + L.gx_off);
  int* s_idx = reinterpret_cast<int*>(smem + L.idx_off);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * CC, split = blockIdx.z;
  const int r_begin = split * rows_per_split;
  const int r_end = min(M, r_begin + rows_per_split);

  float acc[12][TN];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  for (int m0 = r_begin; m0 < r_end; m0 += W_BM) {
    const int m_end = min(m0 + W_BM, r_end);
    const int pt0 = m0 / na;
    const int np = (m_end - 1) / na - pt0 + 1;
    __syncthreads();
    stage_neighbors(s_gx, s_idx, gx, idx, pt0, np, nn, tid, W_THREADS);
    __syncthreads();
    for (int e = tid; e < W_BM * (NK / KG); e += W_THREADS) {
      const int row = e % W_BM, kg = e / W_BM;
      build_f_item(s_F + (size_t)row * FS + kg * KG * CC, table, rk, k2, s_gx,
                   s_idx, m0 + row, m_end, pt0, p2, nn, q, na, NK, C, c0, kg,
                   inv_sigma);
    }
    for (int e = tid; e < W_BM * BN / 4; e += W_THREADS) {
      const int r = e / (BN / 4), c4 = e % (BN / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < m_end) {
        v = *reinterpret_cast<const float4*>(dout + (size_t)(m0 + r) * D + n0 +
                                             4 * c4);
      }
      reinterpret_cast<float4*>(s_D + r * BN)[c4] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < W_BM; ++r) {
      const float4* fp = reinterpret_cast<const float4*>(s_F + r * FS + ty * 12);
      const float4 f0 = fp[0], f1 = fp[1], f2 = fp[2];
      const float a[12] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y,
                           f1.z, f1.w, f2.x, f2.y, f2.z, f2.w};
      float b[TN];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const float4 d4 = *reinterpret_cast<const float4*>(
            s_D + r * BN + h * (BN / NH) + tx * 4);
        b[4 * h] = d4.x;
        b[4 * h + 1] = d4.y;
        b[4 * h + 2] = d4.z;
        b[4 * h + 3] = d4.w;
      }
#pragma unroll
      for (int i = 0; i < 12; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  float* dst = part + (size_t)split * NK * C * D;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const int col = ty * 12 + i;
    const int k = col / CC, cc = col - k * CC;
    float* rowp = dst + ((size_t)k * C + c0 + cc) * D + n0 + tx * 4;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      reinterpret_cast<float4*>(rowp + h * (BN / NH))[0] = make_float4(
          acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

template <int BN>
int launch_dw(const float* gx, const int* idx, const float* table,
              const float* rk, const float* k2, const float* dout, float* ws,
              float* dW, int M, int p2, int nn, int q, int na, int C, int D,
              float sigma, int splits, cudaStream_t stream) {
  const WSmem L = w_layout(BN, na, nn);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      inter_dw_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M + W_BM - 1) / W_BM;
  const int rows_per_split = (tiles + splits - 1) / splits * W_BM;
  dim3 grid(D / BN, C / CC, splits);
  inter_dw_kernel<BN><<<grid, W_THREADS, L.total, stream>>>(
      gx, idx, table, rk, k2, dout, ws, M, p2, nn, q, na, C, D, rows_per_split,
      1.f / sigma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_splits(ws, dW, splits, (size_t)NK * C * D, stream);
}

}  // namespace

// gx [b, p2, nn, 3], idx [b, p2, nn] int32 in [0, q] (q = shadow), rk
// [na, K, 3], k2 [K], W [K, C, D], dout [b, p2, na, D]; dT [b, q, na, C]
// must hold zeros (the kernel adds into it). K must be 24, C a multiple of
// 8, D of 16.
extern "C" int epn_inter_conv_bwd_table(const void* gx, const void* idx,
                                        const void* rk, const void* k2,
                                        const void* W, const void* dout,
                                        void* dT, int b, int p2, int nn, int q,
                                        int na, int K, int C, int D,
                                        float sigma, void* stream) {
  if (K != NK || C % CC != 0 || D % T_BK != 0 || nn < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const TSmem L = t_layout(na, nn);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      inter_dtable_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int M = b * p2 * na;
  inter_dtable_kernel<<<(M + T_BM - 1) / T_BM, T_THREADS, L.total,
                        (cudaStream_t)stream>>>(
      (const float*)gx, (const int*)idx, (const float*)rk, (const float*)k2,
      (const float*)W, (const float*)dout, (float*)dT, M, p2, nn, q, na, C, D,
      1.f / sigma);
  return (int)cudaGetLastError();
}

// gx, idx, rk, k2 as above, table [b, q, na, C], dout [b, p2, na, D];
// ws [splits, K, C, D] scratch, dW [K, C, D] out. K must be 24, C a
// multiple of 8, D of 64.
extern "C" int epn_inter_conv_bwd_w(const void* gx, const void* idx,
                                    const void* table, const void* rk,
                                    const void* k2, const void* dout, void* ws,
                                    void* dW, int b, int p2, int nn, int q,
                                    int na, int K, int C, int D, float sigma,
                                    int splits, void* stream) {
  if (K != NK || C % CC != 0 || D % 64 != 0 || nn < 1 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gx;
  const int* ix = (const int*)idx;
  const float* t = (const float*)table;
  const float* r = (const float*)rk;
  const float* kk = (const float*)k2;
  const float* dy = (const float*)dout;
  const int M = b * p2 * na;
  if (D % 128 == 0) {
    return launch_dw<128>(g, ix, t, r, kk, dy, (float*)ws, (float*)dW, M, p2,
                          nn, q, na, C, D, sigma, splits, s);
  }
  return launch_dw<64>(g, ix, t, r, kk, dy, (float*)ws, (float*)dW, M, p2, nn,
                       q, na, C, D, sigma, splits, s);
}
