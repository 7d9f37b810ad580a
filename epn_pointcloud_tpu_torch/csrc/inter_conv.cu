// Inter (spatial) SO(3) convolution with the learned weight fused in,
// forward:
//
//   out[b, p, a, d] = sum_k sum_c F[b, p, a, k, c] * W[k, c, d]
//   F[b, p, a, k, c] = sum_n w[b, p, n, a, k] * T[b, idx[b, p, n], a, c]
//   w[b, p, n, a, k] = relu(1 - |gx[b, p, n] - R_a kappa_k|^2 / sigma)
//
// gx are the neighbors' coordinates relative to the sample center, T the
// support feature table; idx == q (the shadow index) reads a zero row.
// |gx - rk|^2 is expanded as (|gx|^2 + |kappa|^2) - 2 gx . rk, like the fp32
// XLA path of epn_pointcloud_tpu/ops/so3conv.py (inter_so3conv_fused).
//
// Replaces: epn_pointcloud_tpu/ops/pallas/inter_conv.py, fused_gather_conv_w
// (_fgcw_fwd -> _call_gather_w -> _fwd_gather_w_kernel, and the lane-packed
// variant _call_gather_w_packed -> _fwd_gather_w_packed_kernel for c <= 64).
// The TPU kernel selects neighbor rows with a one-hot MXU product and builds
// the weights through block-diagonal folded operands; none of that comes
// over: here the gather is an indexed load and the weights are computed
// directly.
//
// What bounds it on the H100: the learned contraction. Seen as one GEMM it
// is [b*p*60 x K*C] x [K*C x D] (K = 24) whose left operand F is produced on
// the fly; the neighbor contraction that produces F costs nn / D of the GEMM
// (6-25% at the flagship layers), so ~90% of the ~2.6 TFLOP of a b=32
// forward is the W product. This version runs in fp32 on the CUDA cores (no
// TF32, no wgmma): the FMA rate bounds it, and the design keeps the
// shared-memory traffic per FMA low enough not to bound it first.
//
// Design: a register-blocked SGEMM whose rows are the flattened (point,
// anchor) pairs. A block owns a BM x BN output tile (128 x 32/64/128, or
// 64 x 256 when D allows) with 8 x 8 outputs a thread, and walks the channels
// in chunks of CC = 8. For each chunk it first builds its A slab F[row, k, cc]
// (BM x 24 x 8) in shared memory: each item (row, group of 6 kernel points)
// loads its neighbors' 8 table values with two 16-byte loads and computes the
// anchor weights in registers (recomputed per chunk: no [rows x nn x 24]
// table fits shared memory; the rotated kernel points are read through L1,
// which keeps the 128 x 64 tile small enough for two blocks an SM). Then
// the slab is multiplied with the matching 192 rows of W, staged 16 at a
// time into two shared buffers through registers (the next rows are in
// flight while the current ones are used).
// Per step of the reduction a thread reads 2 + 2 float4 from shared memory
// for 64 FMAs. The [b, p, a, k, c] tensor never exists in device memory.

#include <cuda_runtime.h>

#include "inter_conv_common.cuh"

namespace {

using epn_inter::CC;
using epn_inter::KG;
using epn_inter::build_f_item;
using epn_inter::stage_neighbors;

constexpr int BK = 16;  // W rows a staged slab
constexpr int TM = 8;   // rows a thread: ty + i * (BM / 8)
constexpr int TN = 8;   // columns a thread: tx * 4 + j and BN / 2 + tx * 4 + j
constexpr size_t kMaxSmem = 227 * 1024;

template <int BM, int BN>
struct Cfg {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kBLoads = BK * BN / 4 / kThreads;  // float4 a thread
  static_assert(kBLoads * kThreads * 4 == BK * BN, "W slab split");
};

// dynamic shared memory, in floats: F slab [BM][K*CC + 4], W slabs
// [2][BK][BN], neighbor coordinates [np][nn] float4 (x, y, z, |gx|^2),
// indices [np][nn]
struct Smem {
  int fs, np;
  size_t b_off, gx_off, idx_off, total;
};

__host__ __device__ inline Smem layout(int bm, int bn, int K, int na, int nn) {
  Smem s;
  s.fs = K * CC + 4;  // rows 4 banks apart
  s.np = bm / na + 2;  // points a block's rows can touch
  s.b_off = (size_t)bm * s.fs;
  s.gx_off = s.b_off + 2 * BK * bn;
  s.idx_off = s.gx_off + (size_t)s.np * nn * 4;
  s.total = (s.idx_off + (size_t)s.np * nn) * sizeof(float);
  return s;
}

// W rows of slab s of channel chunk c0 into registers: slab row r is chunk
// row k * CC + cc, i.e. W row k * C + c0 + cc.
template <int BM, int BN>
__device__ __forceinline__ void load_w(const float* __restrict__ W, int s,
                                       int c0, int C, int D, int n0, int tid,
                                       float4 (&rb)[Cfg<BM, BN>::kBLoads]) {
#pragma unroll
  for (int i = 0; i < Cfg<BM, BN>::kBLoads; ++i) {
    const int e = tid + i * Cfg<BM, BN>::kThreads;
    const int r = s * BK + e / (BN / 4), c4 = e % (BN / 4);
    const int k = r / CC, cc = r - k * CC;
    rb[i] = *reinterpret_cast<const float4*>(
        W + ((size_t)k * C + c0 + cc) * D + n0 + 4 * c4);
  }
}

template <int BM, int BN>
__device__ __forceinline__ void store_w(float* __restrict__ Bs, int tid,
                                        const float4 (&rb)[Cfg<BM, BN>::kBLoads]) {
#pragma unroll
  for (int i = 0; i < Cfg<BM, BN>::kBLoads; ++i) {
    reinterpret_cast<float4*>(Bs)[tid + i * Cfg<BM, BN>::kThreads] = rb[i];
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(Cfg<BM, BN>::kThreads)
inter_conv_kernel(const float* __restrict__ gx, const int* __restrict__ idx,
                  const float* __restrict__ table,
                  const float* __restrict__ rk, const float* __restrict__ k2,
                  const float* __restrict__ W, float* __restrict__ out, int M,
                  int p2, int nn, int q, int na, int K, int C, int D,
                  float inv_sigma) {
  using G = Cfg<BM, BN>;
  extern __shared__ __align__(16) float smem[];
  const Smem L = layout(BM, BN, K, na, nn);
  float* s_F = smem;
  float* s_B = smem + L.b_off;
  float4* s_gx = reinterpret_cast<float4*>(smem + L.gx_off);
  int* s_idx = reinterpret_cast<int*>(smem + L.idx_off);

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int pt0 = m0 / na;                    // first (flat) point of the rows
  const int np = (min(m0 + BM, M) - 1) / na - pt0 + 1;

  stage_neighbors(s_gx, s_idx, gx, idx, pt0, np, nn, tid, G::kThreads);
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  const int n_items = BM * (K / KG);
  const int n_slabs = K * CC / BK;
  float4 rb[G::kBLoads];
  for (int c0 = 0; c0 < C; c0 += CC) {
    load_w<BM, BN>(W, 0, c0, C, D, n0, tid, rb);
    // A slab: F[row, k, cc] for this chunk, one (row, 6 kernel points) item
    // at a time
    for (int e = tid; e < n_items; e += G::kThreads) {
      const int row = e % BM, kg = e / BM;
      build_f_item(s_F + (size_t)row * L.fs + kg * KG * CC, table, rk, k2,
                   s_gx, s_idx, m0 + row, M, pt0, p2, nn, q, na, K, C,
                   c0, kg, inv_sigma);
    }
    store_w<BM, BN>(s_B, tid, rb);
    __syncthreads();

    // the learned contraction over the chunk's K * CC rows
    for (int s = 0; s < n_slabs; ++s) {
      const float* Bs = s_B + (s & 1) * BK * BN;
      if (s + 1 < n_slabs) load_w<BM, BN>(W, s + 1, c0, C, D, n0, tid, rb);
#pragma unroll
      for (int j = 0; j < BK; j += 4) {
        float4 a4[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          a4[i] = *reinterpret_cast<const float4*>(
              s_F + (size_t)(ty + i * (BM / TM)) * L.fs + s * BK + j);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 b0 =
              *reinterpret_cast<const float4*>(Bs + (j + jj) * BN + tx * 4);
          const float4 b1 = *reinterpret_cast<const float4*>(
              Bs + (j + jj) * BN + BN / 2 + tx * 4);
          const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float a = jj == 0 ? a4[i].x
                          : jj == 1 ? a4[i].y
                          : jj == 2 ? a4[i].z
                                    : a4[i].w;
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(a, b[c], acc[i][c]);
          }
        }
      }
      if (s + 1 < n_slabs) store_w<BM, BN>(s_B + ((s + 1) & 1) * BK * BN, tid, rb);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * (BM / TM);
    if (gm < M) {
      float* op = out + (size_t)gm * D + n0;
      *reinterpret_cast<float4*>(op + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(op + BN / 2 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

template <int BM, int BN>
int launch(const float* gx, const int* idx, const float* table,
           const float* rk, const float* k2, const float* W, float* out, int M,
           int p2, int nn, int q, int na, int K, int C, int D, float sigma,
           cudaStream_t stream) {
  const Smem L = layout(BM, BN, K, na, nn);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      inter_conv_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, D / BN);
  inter_conv_kernel<BM, BN><<<grid, Cfg<BM, BN>::kThreads, L.total, stream>>>(
      gx, idx, table, rk, k2, W, out, M, p2, nn, q, na, K, C, D, 1.f / sigma);
  return (int)cudaGetLastError();
}

}  // namespace

// gx [b, p2, nn, 3], idx [b, p2, nn] int32 in [0, q] (q = shadow, zero row),
// table [b, q, na, C], rk [na, K, 3], k2 [K], W [K, C, D],
// out [b, p2, na, D]. C must be a multiple of 8, K of 6, D of 32.
extern "C" int epn_inter_conv(const void* gx, const void* idx, const void* table,
                              const void* rk, const void* k2, const void* W,
                              void* out, int b, int p2, int nn, int q, int na,
                              int K, int C, int D, float sigma, void* stream) {
  if (C % CC != 0 || K % KG != 0 || D % 32 != 0 || nn < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gx;
  const int* ix = (const int*)idx;
  const float* t = (const float*)table;
  const float* r = (const float*)rk;
  const float* kk = (const float*)k2;
  const float* w = (const float*)W;
  float* o = (float*)out;
  const int M = b * p2 * na;
  if (D % 256 == 0) {
    return launch<64, 256>(g, ix, t, r, kk, w, o, M, p2, nn, q, na, K, C, D, sigma, s);
  }
  if (D % 128 == 0) {
    return launch<128, 128>(g, ix, t, r, kk, w, o, M, p2, nn, q, na, K, C, D, sigma, s);
  }
  if (D % 64 == 0) {
    return launch<128, 64>(g, ix, t, r, kk, w, o, M, p2, nn, q, na, K, C, D, sigma, s);
  }
  return launch<128, 32>(g, ix, t, r, kk, w, o, M, p2, nn, q, na, K, C, D, sigma, s);
}
