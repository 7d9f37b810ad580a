// Grouped (per-anchor) 1x1 conv on [b, p, na, C] activations, one shared
// [C, D] weight for every anchor, with two epilogues:
//
//   plain:  out[m, a, :] = x[m, a, :] @ W + bias
//   tail:   out = act(y * ssm0 + ssm1) + act((x @ W + bias) * ssk0 + ssk1)
//
// m = (b, p). The tail is the whole eval tail of a separable block: the
// skip conv, its BatchNorm folded to per-lane scale/shift (ssk, [1, 2, L],
// broadcast over the batch), the main branch's InstanceNorm folded the same
// way (ssm, [b, 2, L], per cloud) applied to the raw intra output y, both
// activations, and the residual add, rounded once at the end. L = na * D,
// lane = a * D + d. Sums are fp32; x, W, y and out are fp32 or bf16.
//
// Replaces: epn_pointcloud_tpu/ops/pallas/grouped_conv.py, grouped_conv1x1
// (_fwd -> _fwd_kernel) and grouped_conv1x1_skip_epilogue
// (_fwd_skip_kernel). The TPU kernels group g anchors into a block-diagonal
// weight so every lane slice is 128-aligned; none of that comes over: a
// contiguous [b, p, na, C] tensor is a [b * p * na, C] matrix, so here the
// conv is one GEMM over all (point, anchor) rows and takes every C and D
// the model has.
//
// Backward (B9: _gc_bwd -> _bwd_kernel, which computes dx and dW in one
// body): dx = dout @ W^T, dW = x^T dout and dbias = the column sums of dout,
// dW and dbias reduced over the rows as per-row-range partials added in a
// fixed order (split_sum.cuh), so they are deterministic.
//
// What bounds it on the H100. The arithmetic intensity of the conv is
// C * D / (C + D) operations a byte (32 at 64 x 64, 128 at 256 x 256),
// below the ~295 at which bf16 tensor cores and not device memory are the
// limit, so in bf16 every layer is bound by the bytes it moves: x, y and out
// once (the skip output and the branches never reach device memory). At
// 256 x 256, though, reaching that bound takes ~430 TFLOP/s, more than
// mma.sync sustains on the H100: those layers are bound by the issue
// rate of mma.sync (wgmma is the lever left).
//
// Design of the bf16 build (the production mode; every model path):
// - Forward (grouped_conv_mma_kernel): bf16 operands go straight to
//   mma.sync.m16n8k16 (tc.cuh) with fp32 accumulators. A block covers all
//   N <= 256 output columns of its row tile, so x is read from device
//   memory once. W (<= 128 KB) is staged in shared memory once a block, and
//   blocks are persistent over row tiles; x streams through a ring of
//   cp.async stages of 64-column slices that runs ahead across tile
//   boundaries. Where W does not fit beside the ring even at 32 columns a
//   block (K > 2432, no model layer), W streams by K slice with x through
//   the same ring instead, from L2. The ragged C tail and the ragged rows are zero-filled in
//   shared memory; C % 8 != 0 takes 8-byte copies. The epilogue (bias; for
//   the tail the folds, y, both activations and the residual) runs on the
//   accumulator fragments and rounds once into a bf16 tile in shared
//   memory, which the block stores by whole rows in 16-byte vectors: stored
//   straight from the fragments (16 rows an instruction) the epilogue took
//   most of the kernel's time. For the tail, y streams through the same
//   ring as x (a tile's y comes with its last slice, into the tile that the
//   output then overwrites), and a row tile is one anchor of consecutive
//   points, so the folds it reads (per anchor and column) are one column
//   pair's worth and stay in L1. The same kernel with W read in the other
//   layout (WT: ldmatrix without .trans on the untransposed W) is dx where
//   the backward runs apart (D > 256, or dx alone).
// - Backward (grouped_bwd_mma_kernel), the TPU body's fusion: a block owns
//   a 32-, 64- or 128-wide slice of C and a range of rows; it stages each
//   row tile of x (its C slice) and of dout (all D) once, and from those
//   tiles computes the dx tile, dout . W^T (W's slice resident,
//   untransposed; rounded into shared memory and stored by whole rows), its
//   partial of dW, x^T dout (ldmatrix.trans on both row-major tiles), over
//   the actual C x D, and its share of dbias's column sums (the C slices
//   split the columns). The partials go to [splits, C + 1, D] (row C:
//   dbias). One launch reads dout once; dx and dW apart (two launches) were
//   slower at every main-path shape, so they run apart only where the
//   fused block cannot hold all of D (D > 256).
// The fp32 build is the parity mode, which no model path runs: the
// register-blocked SGEMM of intra_conv.cu without the gather (a 128-row x
// BN-column tile, BN = 128, 64 or 32, 8 x 8 outputs a thread, C in slices of
// 16 through two shared buffers), dx by the same SGEMM reading W transposed,
// and dW by a 128 (c) x BN (d) tile of that SGEMM over a row range, with
// dbias's column sums beside it.

#include <cuda_runtime.h>

#include <algorithm>

#include "elem.cuh"
#include "split_sum.cuh"
#include "tc.cuh"

namespace {

struct Tail {
  const void* y;       // [rows, D], the raw intra output
  const float* ssk;    // skip fold [., 2, L] at batch stride ssk_stride
  const float* ssm;    // main fold [., 2, L] at batch stride ssm_stride
  int ssk_stride, ssm_stride, P, na;
  float slope;         // the activation's slope (epn::leaky)
};

// four outputs of row gm at columns n .. n + 3 from the accumulators v;
// D is out's row length
template <typename T, bool TAIL>
__device__ __forceinline__ void epilogue(T* __restrict__ out,
                                         const float* __restrict__ bias,
                                         const Tail& tl, int gm, int n, int D,
                                         float4 v) {
  if (bias != nullptr) {
    const float4 b = epn::load4(bias + n);
    v.x += b.x;
    v.y += b.y;
    v.z += b.z;
    v.w += b.w;
  }
  if (TAIL) {
    const int a = gm % tl.na, bi = gm / (tl.na * tl.P);
    const int L = tl.na * D, lane = a * D + n;
    const float* sk = tl.ssk + (size_t)bi * tl.ssk_stride + lane;
    const float* sm = tl.ssm + (size_t)bi * tl.ssm_stride + lane;
    const float4 y = epn::load4((const T*)tl.y + (size_t)gm * D + n);
    const float4 k0 = epn::load4(sk), k1 = epn::load4(sk + L);
    const float4 m0 = epn::load4(sm), m1 = epn::load4(sm + L);
    const float sl = tl.slope;
    v.x = epn::leaky(fmaf(y.x, m0.x, m1.x), sl) +
          epn::leaky(fmaf(v.x, k0.x, k1.x), sl);
    v.y = epn::leaky(fmaf(y.y, m0.y, m1.y), sl) +
          epn::leaky(fmaf(v.y, k0.y, k1.y), sl);
    v.z = epn::leaky(fmaf(y.z, m0.z, m1.z), sl) +
          epn::leaky(fmaf(v.z, k0.z, k1.z), sl);
    v.w = epn::leaky(fmaf(y.w, m0.w, m1.w), sl) +
          epn::leaky(fmaf(v.w, k0.w, k1.w), sl);
  }
  epn::store4(out + (size_t)gm * D + n, v);
}

// ------------------------------------------------------------------ fp32

constexpr int BM = 128;  // rows a block
constexpr int BK = 16;   // reduction slice
constexpr int TM = 8;    // rows a thread: ty * 4 + i and BM / 2 + ty * 4 + i
constexpr int TN = 8;    // columns a thread: tx * 4 + j and BN / 2 + tx * 4 + j

template <int BN>
struct Tile {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kALoads = BM * BK / 4 / kThreads;  // quads a thread
  static constexpr int kBLoads = BK * BN / 4 / kThreads;
  static_assert(kALoads * kThreads * 4 == BM * BK, "A tile split");
  static_assert(kBLoads * kThreads * 4 == BK * BN, "B tile split");
};

// x [M, K]; W [K, N], or for WT [N, K] read transposed
template <bool WT, int BN>
__device__ __forceinline__ void load_slice(
    const float* __restrict__ x, const float* __restrict__ W, int m0,
    int kk0, int tid, int M, int K, int N, int n0,
    float4 (&ra)[Tile<BN>::kALoads], float4 (&rb)[Tile<BN>::kBLoads]) {
  using G = Tile<BN>;
#pragma unroll
  for (int i = 0; i < G::kALoads; ++i) {
    const int e = tid + i * G::kThreads;
    const int gm = m0 + e / 4, kk = kk0 + 4 * (e % 4);
    ra[i] = gm < M && kk < K ? epn::load4(x + (size_t)gm * K + kk)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < G::kBLoads; ++i) {
    const int e = tid + i * G::kThreads;
    const int kk = kk0 + e / (BN / 4), n = n0 + 4 * (e % (BN / 4));
    if (kk >= K) {
      rb[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (WT) {
      const float* p = W + (size_t)n * K + kk;
      rb[i] = make_float4(p[0], p[K], p[2 * (size_t)K], p[3 * (size_t)K]);
    } else {
      rb[i] = epn::load4(W + (size_t)kk * N + n);
    }
  }
}

template <int BN>
__device__ __forceinline__ void store_slice(
    float (&As)[BK][BM], float (&Bs)[BK][BN], int tid,
    const float4 (&ra)[Tile<BN>::kALoads],
    const float4 (&rb)[Tile<BN>::kBLoads]) {
  using G = Tile<BN>;
#pragma unroll
  for (int i = 0; i < G::kALoads; ++i) {
    const int e = tid + i * G::kThreads;
    const int row = e / 4, q = 4 * (e % 4);
    As[q][row] = ra[i].x;
    As[q + 1][row] = ra[i].y;
    As[q + 2][row] = ra[i].z;
    As[q + 3][row] = ra[i].w;
  }
#pragma unroll
  for (int i = 0; i < G::kBLoads; ++i) {
    const int e = tid + i * G::kThreads;
    reinterpret_cast<float4*>(&Bs[e / (BN / 4)][0])[e % (BN / 4)] = rb[i];
  }
}

template <bool TAIL, bool WT, int BN>
__global__ void __launch_bounds__(Tile<BN>::kThreads)
grouped_conv_kernel(const float* __restrict__ x, const float* __restrict__ W,
                    const float* __restrict__ bias, float* __restrict__ out,
                    Tail tl, int M, int K, int N) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  float4 ra[Tile<BN>::kALoads], rb[Tile<BN>::kBLoads];
  load_slice<WT, BN>(x, W, m0, 0, tid, M, K, N, n0, ra, rb);
  store_slice<BN>(As[0], Bs[0], tid, ra, rb);
  __syncthreads();
  const int n_slices = (K + BK - 1) / BK;
  for (int s = 0; s < n_slices; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_slices) {
      load_slice<WT, BN>(x, W, m0, (s + 1) * BK, tid, M, K, N, n0, ra, rb);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][k][BN / 2 + tx * 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (s + 1 < n_slices) store_slice<BN>(As[buf ^ 1], Bs[buf ^ 1], tid, ra, rb);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (gm < M) {
      epilogue<float, TAIL>(out, bias, tl, gm, n0 + tx * 4, N,
                            make_float4(acc[i][0], acc[i][1], acc[i][2],
                                        acc[i][3]));
      epilogue<float, TAIL>(out, bias, tl, gm, n0 + BN / 2 + tx * 4, N,
                            make_float4(acc[i][4], acc[i][5], acc[i][6],
                                        acc[i][7]));
    }
  }
}

// x [M, K] @ W (+ bias, + the tail) -> out [M, N]; N % 32 == 0, K % 4 == 0
template <bool TAIL, bool WT>
int launch_f32(const void* x, const void* W, const float* bias, void* out,
               const Tail& tl, int M, int K, int N, cudaStream_t s) {
  const float* xp = (const float*)x;
  const float* wp = (const float*)W;
  float* op = (float*)out;
  const unsigned gx = (M + BM - 1) / BM;
  if (N % 128 == 0) {
    grouped_conv_kernel<TAIL, WT, 128><<<dim3(gx, N / 128),
                                         Tile<128>::kThreads, 0, s>>>(
        xp, wp, bias, op, tl, M, K, N);
  } else if (N % 64 == 0) {
    grouped_conv_kernel<TAIL, WT, 64><<<dim3(gx, N / 64), Tile<64>::kThreads,
                                        0, s>>>(xp, wp, bias, op, tl, M, K, N);
  } else {
    grouped_conv_kernel<TAIL, WT, 32><<<dim3(gx, N / 32), Tile<32>::kThreads,
                                        0, s>>>(xp, wp, bias, op, tl, M, K, N);
  }
  return (int)cudaGetLastError();
}

constexpr int WBK = 16;  // rows a reduction slice of dW

// dW[c, d] = sum_m x[m, c] dout[m, d] over one range of rows m: the block's
// 128 (c) x BN (d) tile of the partial dW of its range, rows staged 16 at a
// time, 8 x 8 outputs a thread (the intra conv's dW without the gather);
// partials at split stride (C + 1) * D
template <int BN>
__global__ void __launch_bounds__(Tile<BN>::kThreads)
grouped_dw_kernel(const float* __restrict__ x,
                  const float* __restrict__ dout, float* __restrict__ part,
                  int M, int C, int D, int rows_per_split) {
  using G = Tile<BN>;
  __shared__ __align__(16) float As[WBK][BM];
  __shared__ __align__(16) float Bs[WBK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int c0 = blockIdx.x * BM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int r_begin = split * rows_per_split;
  const int r_end = min(M, r_begin + rows_per_split);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  for (int m0 = r_begin; m0 < r_end; m0 += WBK) {
    __syncthreads();
    for (int e = tid; e < WBK * BM / 4; e += G::kThreads) {
      const int rr = e / (BM / 4), j4 = e % (BM / 4);
      const int m = m0 + rr, c = c0 + 4 * j4;
      reinterpret_cast<float4*>(&As[rr][0])[j4] =
          m < r_end && c < C ? epn::load4(x + (size_t)m * C + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int e = tid; e < WBK * BN / 4; e += G::kThreads) {
      const int rr = e / (BN / 4), c4 = e % (BN / 4);
      const int m = m0 + rr;
      reinterpret_cast<float4*>(&Bs[rr][0])[c4] =
          m < r_end ? epn::load4(dout + (size_t)m * D + n0 + 4 * c4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < WBK; ++rr) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[rr][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[rr][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[rr][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[rr][BN / 2 + tx * 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  float* dst = part + (size_t)split * (C + 1) * D;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (c < C) {
      float* op = dst + (size_t)c * D + n0;
      *reinterpret_cast<float4*>(op + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(op + BN / 2 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

// dbias partials of the fp32 build: row C of each split's [C + 1, D]
__global__ void colsum_kernel(const float* __restrict__ dout,
                              float* __restrict__ part, int M, int C, int D,
                              int rows_per_split) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x, split = blockIdx.y;
  if (d >= D) return;
  const int r_begin = split * rows_per_split;
  const int r_end = min(M, r_begin + rows_per_split);
  float s = 0.f;
  for (int r = r_begin; r < r_end; ++r) s += dout[(size_t)r * D + d];
  part[((size_t)split * (C + 1) + C) * D + d] = s;
}

template <int BN>
int launch_dw_f32(const float* x, const float* dout, float* ws, int M, int C,
                  int D, int splits, int rows_per_split, cudaStream_t s) {
  dim3 grid((C + BM - 1) / BM, D / BN, splits);
  grouped_dw_kernel<BN><<<grid, Tile<BN>::kThreads, 0, s>>>(
      x, dout, ws, M, C, D, rows_per_split);
  return (int)cudaGetLastError();
}

int bwd_f32(const void* x, const void* W, const void* dout, void* dx,
            float* ws, float* dwb, int M, int C, int D, int splits, int parts,
            cudaStream_t s) {
  const Tail none = {nullptr, nullptr, nullptr, 0, 0, 1, 1};
  if (parts & 1) {
    const int err = launch_f32<false, true>(dout, W, nullptr, dx, none, M, D,
                                            C, s);
    if (err != 0) return err;
  }
  if (!(parts & 2)) return 0;
  const int slices = (M + WBK - 1) / WBK;
  const int rows_per_split = (slices + splits - 1) / splits * WBK;
  const float* xp = (const float*)x;
  const float* dp = (const float*)dout;
  int err = D % 128 == 0 ? launch_dw_f32<128>(xp, dp, ws, M, C, D, splits,
                                               rows_per_split, s)
            : D % 64 == 0 ? launch_dw_f32<64>(xp, dp, ws, M, C, D, splits,
                                               rows_per_split, s)
                          : launch_dw_f32<32>(xp, dp, ws, M, C, D, splits,
                                              rows_per_split, s);
  if (err != 0) return err;
  colsum_kernel<<<dim3((D + 255) / 256, splits), 256, 0, s>>>(
      dp, ws, M, C, D, rows_per_split);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_sum_splits(ws, dwb, splits, (size_t)(C + 1) * D, s);
}

// ------------------------------------------------------------------ bf16

using epn::bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 64;        // reduction slice of the forward ring

// The forward's block for NT output columns: BM rows over 8 warps,
// WARPS_M x WARPS_N, MI m16 tiles x NI n8 tiles a warp (32 x 64 a warp at
// NT = 256 and 128); a ring of STAGES slices; the rounded output tile staged
// at row stride OS (padded: the fragments' 4-byte writes hit distinct
// banks). At NT = 256, W (128 KB) leaves room for 64 rows only.
template <int NT_>
struct FwdCfg {
  static constexpr int NT = NT_, BM = NT == 256 ? 64 : 128, STAGES = 4;
  static constexpr int OS = NT + 8;
  static constexpr int WARPS_M = BM / 32;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int MI = 2;
  static constexpr int WN = NT / WARPS_N;
  static constexpr int NI = WN / 8;
  static_assert(NI % 2 == 0, "warp tile");
};

// Tiles of the bf16 output staged in shared memory: one for the plain
// epilogue; with the tail, y is staged there too, a tile ahead of use
// through the x ring (loaded with a tile's last slice, STAGES - 1 steps
// early), so it needs ceil(STAGES / KT) of them.
template <typename G>
__host__ __device__ inline int out_tiles(bool tail, int KT) {
  return tail ? (G::STAGES + KT - 1) / KT : 1;
}

// elements of one stage of the forward's ring: x [BM, kBK] and, where W
// streams (WS), W's slice [kBK, NT]
template <typename G>
__host__ __device__ constexpr int stage_elems(bool ws) {
  return G::BM * kBK + (ws ? kBK * G::NT : 0);
}

// shared memory of the forward: W (resident unless it streams), the ring,
// the output tiles
template <typename G>
size_t fwd_smem(int K, bool tail, bool ws) {
  const int KT = (K + kBK - 1) / kBK;
  return (size_t)((ws ? 0 : KT * kBK * G::NT) +
                  G::STAGES * stage_elems<G>(ws) +
                  out_tiles<G>(tail, KT) * G::BM * G::OS) *
         sizeof(bf16);
}

// The bf16 tile Ob [rows][ostride] in shared memory to columns c0 .. c0 +
// CW of out (row length N): tile row r to out row row_of(r), skipped when
// that is -1, and columns past N skipped. A warp stores whole rows: 16-byte
// vectors when N % 8 == 0, else 8-byte ones (N % 4 == 0).
template <int CW, typename RowOf>
__device__ __forceinline__ void store_tile(bf16* __restrict__ out,
                                           const bf16* Ob, int ostride,
                                           int rows, int c0, int N,
                                           RowOf row_of) {
  if ((N & 7) == 0) {
    for (int e = threadIdx.x; e < rows * CW / 8; e += blockDim.x) {
      const int r = e / (CW / 8), c = e % (CW / 8) * 8, row = row_of(r);
      if (row >= 0 && c0 + c < N) {
        *reinterpret_cast<uint4*>(out + (size_t)row * N + c0 + c) =
            *reinterpret_cast<const uint4*>(Ob + r * ostride + c);
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * CW / 4; e += blockDim.x) {
      const int r = e / (CW / 4), c = e % (CW / 4) * 4, row = row_of(r);
      if (row >= 0 && c0 + c < N) {
        *reinterpret_cast<uint2*>(out + (size_t)row * N + c0 + c) =
            *reinterpret_cast<const uint2*>(Ob + r * ostride + c);
      }
    }
  }
}

// x [M, K] (row stride K) @ W (+ bias, + the tail) -> out [M, N]: W is
// [K, N], or for WT [N, K] (dx = dout W^T on the untransposed W). Block
// (bx, by) covers columns by * NT .. + NT and row tiles bx, bx + gridDim.x,
// ...; shared memory: W [KP, NT] (WT: [NT, KP]), then STAGES x [BM, kBK],
// then the output tiles [BM, OS]. With WS, W is not resident: each stage
// holds W's slice [kBK, NT] (WT: [NT, kBK]) after x's. A row tile is BM consecutive rows; with
// the tail it is one anchor a of BM consecutive points (rows q * na + a),
// so that the folds a tile reads are one anchor's lanes, which stay in L1,
// and not all na anchors'. The epilogue runs on the fragments: bias, and
// for the tail the folds and y (read from its staged tile), rounded once
// into the output tile, which the block then stores by whole rows (from
// the fragments one store instruction would touch 16 rows, and such
// stores took most of the kernel's time).
template <bool TAIL, bool WT, bool WS, int NT_>
__global__ void __launch_bounds__(kThreads, 1)
grouped_conv_mma_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ W,
                        const float* __restrict__ bias,
                        bf16* __restrict__ out, Tail tl, int M, int K, int N,
                        int KT) {
  using G = FwdCfg<NT_>;
  constexpr int NT = G::NT, BM = G::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int SE = stage_elems<G>(WS);
  const int KP = KT * kBK;
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  bf16* Xs = Ws + (WS ? 0 : KP * NT);
  bf16* Ob = Xs + G::STAGES * SE;
  const int nob = out_tiles<G>(TAIL, KT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / G::WARPS_N, wn = warp % G::WARPS_N;
  const int n0 = blockIdx.y * NT;
  const bool vec16 = (K & 7) == 0;
  // 16-byte chunks a row of W's tile: resident [KP, NT] / [NT, KP], or a
  // streamed slice [kBK, NT] / [NT, kBK]
  const int w_cpr = WT ? (WS ? kBK : KP) / 8 : NT / 8;

  // W's rows k0 .. k0 + kr (WT: its columns) into the tile at wd, zero
  // outside K x N
  auto load_w = [&](bf16* wd, int k0, int kr) {
    for (int e = tid; e < kr * NT / 8; e += kThreads) {
      const int r = e / w_cpr, c8 = (e % w_cpr) * 8;
      const int k = k0 + (WT ? c8 : r), n = n0 + (WT ? r : c8);
      const bool ok = k < K && n < N;
      const bf16* src = WT ? W + (size_t)n * K + k : W + (size_t)k * N + n;
      tc::cp16(tc::smem_addr(wd + tc::swz(r, c8, w_cpr)), ok ? src : W, ok);
    }
  };
  // resident W, committed with the first x stage
  if (!WS) load_w(Ws, 0, KP);

  const int na = TAIL ? tl.na : 1;
  const int Q = M / na;  // points (tail), else rows
  const int tiles = (Q + BM - 1) / BM * na;
  const int mine = (int)blockIdx.x < tiles
                       ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int total = mine * KT;  // (tile, slice) steps of this block
  // the row of row r of this block's i-th tile, or -1 past the end
  auto row_of = [&](int i, int r) {
    const int t = (int)blockIdx.x + i * (int)gridDim.x;
    const int q = t / na * BM + r;
    return q < Q ? q * na + t % na : -1;
  };
  // the rows and columns of this thread's accumulators: rows rb + mi * 16
  // (+ 8), columns cb + ni * 8 (+ 1)
  const int rb = wm * (BM / G::WARPS_M) + (lane >> 2);
  const int cb = wn * G::WN + 2 * (lane & 3);

  auto load_x = [&](int step) {
    const int i = step / KT, k0 = step % KT * kBK;
    bf16* dst = Xs + step % G::STAGES * SE;
    if (WS) load_w(dst + BM * kBK, k0, kBK);
#pragma unroll
    for (int j = 0; j < BM * 8 / kThreads; ++j) {
      const int e = tid + j * kThreads;
      const int r = e >> 3, c8 = (e & 7) * 8, m = row_of(i, r), k = k0 + c8;
      const uint32_t d = tc::smem_addr(dst + tc::swz(r, c8, 8));
      const bf16* src = x + (size_t)max(m, 0) * K + k;
      if (vec16) {
        const bool ok = m >= 0 && k < K;
        tc::cp16(d, ok ? src : x, ok);
      } else {
        const bool ok0 = m >= 0 && k < K, ok1 = m >= 0 && k + 4 < K;
        tc::cp8(d, ok0 ? src : x, ok0);
        tc::cp8(d + 8, ok1 ? src + 4 : x, ok1);
      }
    }
    if constexpr (TAIL) {
      // the tile's y with its last slice (N % 8 == 0: 16-byte copies)
      if (step % KT == KT - 1) {
        const bf16* y = (const bf16*)tl.y;
        bf16* yt = Ob + i % nob * BM * G::OS;
        for (int e = tid; e < BM * NT / 8; e += kThreads) {
          const int r = e / (NT / 8), c = e % (NT / 8) * 8;
          const int m = row_of(i, r);
          const bool ok = m >= 0 && n0 + c < N;
          tc::cp16(tc::smem_addr(yt + r * G::OS + c),
                   ok ? y + (size_t)m * N + n0 + c : y, ok);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < total) load_x(s);
    tc::cp_commit();
  }

  float acc[G::MI][G::NI][4];
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  for (int s = 0; s < total; ++s) {
    tc::cp_wait<G::STAGES - 2>();
    __syncthreads();
    if (s + G::STAGES - 1 < total) load_x(s + G::STAGES - 1);
    tc::cp_commit();

    const bf16* xs = Xs + s % G::STAGES * SE;
    // W's tile and the row (WT: column) of this slice in it
    const bf16* wt = WS ? xs + BM * kBK : Ws;
    const int kb = WS ? 0 : s % KT * kBK;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[G::MI][4];
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) {
        tc::ldsm4(a[mi], tc::smem_addr(
                             xs + tc::swz(wm * (BM / G::WARPS_M) + mi * 16 +
                                              (lane & 15),
                                          kk + (lane >> 4) * 8, 8)));
      }
      uint32_t b[G::NI][2];
#pragma unroll
      for (int nj = 0; nj < G::NI / 2; ++nj) {
        uint32_t r[4];
        const int nb = wn * G::WN + nj * 16;
        if (WT) {
          tc::ldsm4(r, tc::smem_addr(
                           wt + tc::swz(nb + (lane & 7) + (lane >> 4) * 8,
                                        kb + kk + ((lane >> 3) & 1) * 8,
                                        w_cpr)));
        } else {
          tc::ldsm4t(r, tc::smem_addr(
                            wt + tc::swz(kb + kk + (lane & 7) +
                                             ((lane >> 3) & 1) * 8,
                                         nb + (lane >> 4) * 8, w_cpr)));
        }
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < G::NI; ++ni)
          tc::mma(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }

    if (s % KT == KT - 1) {
      // bias and the tail on the fragments, rounded once into the tile. A
      // tile is one anchor; its folds are loaded once a column pair for
      // the cloud of the tile's first point, again for a row of another
      const int i = s / KT, t = (int)blockIdx.x + i * (int)gridDim.x;
      bf16* ot = Ob + i % nob * BM * G::OS;
      const int q0 = t / na * BM, a = t % na, L = na * N;
      const int b0 = TAIL ? min(q0, Q - 1) / tl.P : 0;
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
        const int c = cb + ni * 8, col = n0 + c;
        float2 bb = make_float2(0.f, 0.f), k0, k1, m0, m1;
        if (col < N) {
          if (bias != nullptr) bb = *reinterpret_cast<const float2*>(bias + col);
          if constexpr (TAIL) {
            const float* sk = tl.ssk + (size_t)b0 * tl.ssk_stride + a * N + col;
            const float* sm = tl.ssm + (size_t)b0 * tl.ssm_stride + a * N + col;
            k0 = *reinterpret_cast<const float2*>(sk);
            k1 = *reinterpret_cast<const float2*>(sk + L);
            m0 = *reinterpret_cast<const float2*>(sm);
            m1 = *reinterpret_cast<const float2*>(sm + L);
          }
        }
#pragma unroll
        for (int mi = 0; mi < G::MI; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = rb + mi * 16 + 8 * h;
            uint32_t* o = reinterpret_cast<uint32_t*>(ot + r * G::OS + c);
            float v0 = acc[mi][ni][2 * h] + bb.x;
            float v1 = acc[mi][ni][2 * h + 1] + bb.y;
            if constexpr (TAIL) {
              if (col < N) {
                float2 rk0 = k0, rk1 = k1, rm0 = m0, rm1 = m1;
                const int bi = min(q0 + r, Q - 1) / tl.P;
                if (bi != b0) {  // a row of the next cloud
                  const float* sk =
                      tl.ssk + (size_t)bi * tl.ssk_stride + a * N + col;
                  const float* sm =
                      tl.ssm + (size_t)bi * tl.ssm_stride + a * N + col;
                  rk0 = *reinterpret_cast<const float2*>(sk);
                  rk1 = *reinterpret_cast<const float2*>(sk + L);
                  rm0 = *reinterpret_cast<const float2*>(sm);
                  rm1 = *reinterpret_cast<const float2*>(sm + L);
                }
                const uint32_t y = *o;
                const float sl = tl.slope;
                v0 = epn::leaky(fmaf(__uint_as_float(y << 16), rm0.x, rm1.x),
                                sl) +
                     epn::leaky(fmaf(v0, rk0.x, rk1.x), sl);
                v1 = epn::leaky(fmaf(__uint_as_float(y & 0xffff0000u), rm0.y,
                                     rm1.y),
                                sl) +
                     epn::leaky(fmaf(v1, rk0.y, rk1.y), sl);
              }
            }
            *o = epn::pack2(v0, v1);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
      __syncthreads();
      store_tile<NT>(out, ot, G::OS, BM, n0, N,
                     [&](int r) { return row_of(i, r); });
    }
  }
  tc::cp_wait<0>();
}

constexpr size_t kSmemMax = 227 * 1024;  // shared memory a block can have

template <bool TAIL, bool WT, bool WS, int NT>
int launch_mma(const void* x, const void* W, const float* bias, void* out,
               const Tail& tl, int M, int K, int N, cudaStream_t s) {
  using G = FwdCfg<NT>;
  const int KT = (K + kBK - 1) / kBK;
  const size_t smem = fwd_smem<G>(K, TAIL, WS);
  auto kern = grouped_conv_mma_kernel<TAIL, WT, WS, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  const int ny = (N + NT - 1) / NT;
  const int na = TAIL ? tl.na : 1;
  const int tiles = (M / na + G::BM - 1) / G::BM * na;
  const int gx = std::max(1, std::min(tiles, occ * tc::num_sms() / ny));
  kern<<<dim3(gx, ny), kThreads, smem, s>>>(
      (const bf16*)x, (const bf16*)W, bias, (bf16*)out, tl, M, K, N, KT);
  return (int)cudaGetLastError();
}

// NT: the fewest columns a block that covers N, halved while the block's
// shared memory (W above all) would not fit; where W does not fit even at
// 32 columns, W streams with x at 128 columns a block
template <bool TAIL, bool WT>
int dispatch_mma(const void* x, const void* W, const float* bias, void* out,
                 const Tail& tl, int M, int K, int N, cudaStream_t s) {
  int nt = N <= 32 ? 32 : N <= 64 ? 64 : N <= 128 ? 128 : 256;
  auto smem = [K](int n) {
    return n == 256 ? fwd_smem<FwdCfg<256>>(K, TAIL, false)
           : n == 128 ? fwd_smem<FwdCfg<128>>(K, TAIL, false)
           : n == 64  ? fwd_smem<FwdCfg<64>>(K, TAIL, false)
                      : fwd_smem<FwdCfg<32>>(K, TAIL, false);
  };
  while (nt > 32 && smem(nt) > kSmemMax) nt /= 2;
  if (smem(nt) > kSmemMax) {
    return launch_mma<TAIL, WT, true, 128>(x, W, bias, out, tl, M, K, N, s);
  }
  switch (nt) {
    case 256:
      return launch_mma<TAIL, WT, false, 256>(x, W, bias, out, tl, M, K, N, s);
    case 128:
      return launch_mma<TAIL, WT, false, 128>(x, W, bias, out, tl, M, K, N, s);
    case 64:
      return launch_mma<TAIL, WT, false, 64>(x, W, bias, out, tl, M, K, N, s);
    default:
      return launch_mma<TAIL, WT, false, 32>(x, W, bias, out, tl, M, K, N, s);
  }
}

// The backward's block: CI (32, 64 or 128) columns of C and DN (32 .. 256)
// columns of D over BM-row tiles of its row range.
template <int CI, int DN>
struct BwdCfg {
  static constexpr int BM = 64;
  static constexpr int STAGES = 3;
  // dW [CI, DN]: warps 2 (c) x 4 (d), WMI m16 x WNI n8 tiles a warp
  static constexpr int WMI = CI / 32;
  static constexpr int WNI = DN / 32;
  // dx [BM, CI]: warps 4 (rows) x 2 (c), one m16 x XNI n8 tiles a warp
  static constexpr int XNI = CI / 16;
  // the rounded dx tile staged for its stores, at row stride XS
  static constexpr int XS = CI + 8;
};

template <bool DX, int CI, int DN>
constexpr size_t bwd_smem() {
  using G = BwdCfg<CI, DN>;
  return ((DX ? CI * DN + G::BM * G::XS : 0) + G::STAGES * G::BM * (CI + DN)) *
         sizeof(bf16);
}

// dW (and dbias) partials of the row range blockIdx.z over the block's C
// slice blockIdx.x and D slice blockIdx.y, into part [splits, C + 1, D];
// with DX (gridDim.y == 1, D <= DN) also dx = dout W^T for those rows and
// the C slice. Shared memory: W [CI, DN] (DX), then STAGES x (x [BM, CI],
// dout [BM, DN]), then (DX) the rounded dx tile [BM, XS], staged so that
// a warp's stores cover whole rows; reused for the dbias reduction at the
// end.
template <bool DX, int CI, int DN>
__global__ void __launch_bounds__(kThreads, 1)
grouped_bwd_mma_kernel(const bf16* __restrict__ x,
                       const bf16* __restrict__ W,
                       const bf16* __restrict__ dout, bf16* __restrict__ dx,
                       float* __restrict__ part, int M, int C, int D,
                       int rows_per_split) {
  using G = BwdCfg<CI, DN>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  bf16* Xs = Ws + (DX ? CI * DN : 0);
  bf16* Ds = Xs + G::STAGES * G::BM * CI;
  bf16* Pb = Ds + G::STAGES * G::BM * DN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * CI, d0 = blockIdx.y * DN, split = blockIdx.z;
  const int r_begin = split * rows_per_split;
  const int r_end = min(M, r_begin + rows_per_split);
  const int ntile = r_end > r_begin ? (r_end - r_begin + G::BM - 1) / G::BM
                                    : 0;
  const bool vec16 = (C & 7) == 0;
  // dbias: the C slices share the D slice's columns, bw (even) a block;
  // a thread sums one column pair over every brg-th row of each tile
  const int bw = ((DN + gridDim.x - 1) / gridDim.x + 1) & ~1;
  const int bc0 = blockIdx.x * bw, bn = min(bw, DN - bc0);
  const int brg = kThreads / (bw / 2);
  const int bcol = bc0 + 2 * (tid % (bw / 2)), brow = tid / (bw / 2);
  const bool do_bias = bn > 0 && brow < brg && bcol < bc0 + bn;

  if (DX) {
    for (int e = tid; e < CI * DN / 8; e += kThreads) {
      const int r = e / (DN / 8), c8 = (e % (DN / 8)) * 8;
      const int c = c0 + r, d = d0 + c8;
      const bool ok = c < C && d < D;
      tc::cp16(tc::smem_addr(Ws + tc::swz(r, c8, DN / 8)),
               ok ? W + (size_t)c * D + d : W, ok);
    }
  }

  auto load = [&](int t) {
    const int m0 = r_begin + t * G::BM;
    bf16* xs = Xs + t % G::STAGES * G::BM * CI;
    bf16* ds = Ds + t % G::STAGES * G::BM * DN;
    for (int e = tid; e < G::BM * CI / 8; e += kThreads) {
      const int r = e / (CI / 8), c8 = (e % (CI / 8)) * 8;
      const int m = m0 + r, c = c0 + c8;
      const uint32_t d = tc::smem_addr(xs + tc::swz(r, c8, CI / 8));
      const bf16* src = x + (size_t)m * C + c;
      if (vec16) {
        const bool ok = m < r_end && c < C;
        tc::cp16(d, ok ? src : x, ok);
      } else {
        const bool ok0 = m < r_end && c < C, ok1 = m < r_end && c + 4 < C;
        tc::cp8(d, ok0 ? src : x, ok0);
        tc::cp8(d + 8, ok1 ? src + 4 : x, ok1);
      }
    }
    for (int e = tid; e < G::BM * DN / 8; e += kThreads) {
      const int r = e / (DN / 8), c8 = (e % (DN / 8)) * 8;
      const int m = m0 + r, d = d0 + c8;
      const bool ok = m < r_end && d < D;
      tc::cp16(tc::smem_addr(ds + tc::swz(r, c8, DN / 8)),
               ok ? dout + (size_t)m * D + d : dout, ok);
    }
  };

#pragma unroll
  for (int t = 0; t < G::STAGES - 1; ++t) {
    if (t < ntile) load(t);
    tc::cp_commit();
  }

  const int wc = warp / 4, wd = warp % 4;  // dW warp tile
  const int xr = warp / 2, xc = warp % 2;  // dx warp tile
  float accw[G::WMI][G::WNI][4];
#pragma unroll
  for (int mi = 0; mi < G::WMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::WNI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) accw[mi][ni][q] = 0.f;
  float bsum0 = 0.f, bsum1 = 0.f;

  for (int t = 0; t < ntile; ++t) {
    tc::cp_wait<G::STAGES - 2>();
    __syncthreads();
    if (t + G::STAGES - 1 < ntile) load(t + G::STAGES - 1);
    tc::cp_commit();
    const bf16* xs = Xs + t % G::STAGES * G::BM * CI;
    const bf16* ds = Ds + t % G::STAGES * G::BM * DN;

    // dW += x^T dout: A = x^T from x [rows][c] (.trans), B = dout [rows][d]
    // (.trans); K runs over the tile's rows
#pragma unroll
    for (int kk = 0; kk < G::BM; kk += 16) {
      uint32_t a[G::WMI][4];
#pragma unroll
      for (int mi = 0; mi < G::WMI; ++mi) {
        tc::ldsm4t(a[mi], tc::smem_addr(
                              xs + tc::swz(kk + (lane & 7) + (lane >> 4) * 8,
                                           wc * (CI / 2) + mi * 16 +
                                               ((lane >> 3) & 1) * 8,
                                           CI / 8)));
      }
      uint32_t b[G::WNI][2];
      if (G::WNI == 1) {
        tc::ldsm2t(b[0], tc::smem_addr(
                             ds + tc::swz(kk + (lane & 7) +
                                              ((lane >> 3) & 1) * 8,
                                          wd * 8, DN / 8)));
      } else {
#pragma unroll
        for (int nj = 0; nj < G::WNI / 2; ++nj) {
          uint32_t r[4];
          tc::ldsm4t(r, tc::smem_addr(
                            ds + tc::swz(kk + (lane & 7) +
                                             ((lane >> 3) & 1) * 8,
                                         wd * (DN / 4) + nj * 16 +
                                             (lane >> 4) * 8,
                                         DN / 8)));
          b[2 * nj][0] = r[0];
          b[2 * nj][1] = r[1];
          b[2 * nj + 1][0] = r[2];
          b[2 * nj + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < G::WMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < G::WNI; ++ni)
          tc::mma(accw[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }

    if (DX) {
      // dx = dout W^T: A = dout [rows][d], B = W [c][d] (no .trans); K
      // runs over d
      float accx[G::XNI][4];
#pragma unroll
      for (int ni = 0; ni < G::XNI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) accx[ni][q] = 0.f;
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[4];
        tc::ldsm4(a, tc::smem_addr(ds + tc::swz(xr * 16 + (lane & 15),
                                                kk + (lane >> 4) * 8,
                                                DN / 8)));
#pragma unroll
        for (int nj = 0; nj < G::XNI / 2; ++nj) {
          uint32_t r[4];
          tc::ldsm4(r, tc::smem_addr(
                           Ws + tc::swz(xc * (CI / 2) + nj * 16 +
                                            (lane & 7) + (lane >> 4) * 8,
                                        kk + ((lane >> 3) & 1) * 8, DN / 8)));
          tc::mma(accx[2 * nj], a, r[0], r[1]);
          tc::mma(accx[2 * nj + 1], a, r[2], r[3]);
        }
      }
#pragma unroll
      for (int ni = 0; ni < G::XNI; ++ni) {
        bf16* o = Pb + (xr * 16 + (lane >> 2)) * G::XS + xc * (CI / 2) +
                  ni * 8 + 2 * (lane & 3);
        *reinterpret_cast<uint32_t*>(o) = epn::pack2(accx[ni][0], accx[ni][1]);
        *reinterpret_cast<uint32_t*>(o + 8 * G::XS) =
            epn::pack2(accx[ni][2], accx[ni][3]);
      }
      __syncthreads();
      const int m0 = r_begin + t * G::BM;
      store_tile<CI>(dx, Pb, G::XS, G::BM, c0, C, [&](int r) {
        return m0 + r < r_end ? m0 + r : -1;
      });
    }

    if (do_bias) {
      // column sums of the staged dout (rows past the range are zeros)
      for (int r = brow; r < G::BM; r += brg) {
        const float2 v = epn::load2(ds + tc::swz(r, bcol, DN / 8));
        bsum0 += v.x;
        bsum1 += v.y;
      }
    }
  }
  tc::cp_wait<0>();

  float* dst = part + (size_t)split * (C + 1) * D;
#pragma unroll
  for (int mi = 0; mi < G::WMI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < G::WNI; ++ni) {
      const int c = c0 + wc * (CI / 2) + mi * 16 + (lane >> 2);
      const int d = d0 + wd * (DN / 4) + ni * 8 + 2 * (lane & 3);
      if (d < D) {
        if (c < C) {
          *reinterpret_cast<float2*>(dst + (size_t)c * D + d) =
              make_float2(accw[mi][ni][0], accw[mi][ni][1]);
        }
        if (c + 8 < C) {
          *reinterpret_cast<float2*>(dst + (size_t)(c + 8) * D + d) =
              make_float2(accw[mi][ni][2], accw[mi][ni][3]);
        }
      }
    }
  }
  if (bn > 0) {
    // the row groups' sums, added in order
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);  // [brg][bw]
    if (do_bias) {
      red[brow * bw + bcol - bc0] = bsum0;
      red[brow * bw + bcol - bc0 + 1] = bsum1;
    }
    __syncthreads();
    if (tid < bn && d0 + bc0 + tid < D) {
      float sum = 0.f;
      for (int g = 0; g < brg; ++g) sum += red[g * bw + tid];
      dst[(size_t)C * D + d0 + bc0 + tid] = sum;
    }
  }
}

template <bool DX, int CI, int DN>
int launch_bwd_mma(const void* x, const void* W, const void* dout, void* dx,
                   float* ws, int M, int C, int D, int splits,
                   cudaStream_t s) {
  using G = BwdCfg<CI, DN>;
  const size_t smem = bwd_smem<DX, CI, DN>();
  auto kern = grouped_bwd_mma_kernel<DX, CI, DN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M + G::BM - 1) / G::BM;
  const int rows_per_split = (tiles + splits - 1) / splits * G::BM;
  dim3 grid((C + CI - 1) / CI, (D + DN - 1) / DN, splits);
  kern<<<grid, kThreads, smem, s>>>((const bf16*)x, (const bf16*)W,
                                    (const bf16*)dout, (bf16*)dx, ws, M, C, D,
                                    rows_per_split);
  return (int)cudaGetLastError();
}

template <bool DX, int CI>
int bwd_cols(const void* x, const void* W, const void* dout, void* dx,
             float* ws, int M, int C, int D, int splits, cudaStream_t s) {
  if (D <= 32) return launch_bwd_mma<DX, CI, 32>(x, W, dout, dx, ws, M, C, D, splits, s);
  if (D <= 64) return launch_bwd_mma<DX, CI, 64>(x, W, dout, dx, ws, M, C, D, splits, s);
  if (D <= 128) return launch_bwd_mma<DX, CI, 128>(x, W, dout, dx, ws, M, C, D, splits, s);
  return launch_bwd_mma<DX, CI, 256>(x, W, dout, dx, ws, M, C, D, splits, s);
}

// parts: bit 0 dx, bit 1 dW and dbias; both in one launch where the block
// holds all of D, else dx apart (the forward kernel on W read transposed)
int bwd_bf16(const void* x, const void* W, const void* dout, void* dx,
             float* ws, float* dwb, int M, int C, int D, int splits,
             int parts, cudaStream_t s) {
  const bool fused = parts == 3 && D <= 256;
  if ((parts & 1) && !fused) {
    const Tail none = {nullptr, nullptr, nullptr, 0, 0, 1, 1};
    const int err = dispatch_mma<false, true>(dout, W, nullptr, dx, none, M,
                                              D, C, s);
    if (err != 0) return err;
  }
  if (!(parts & 2)) return 0;
  // the C slice: 128 wide from C = 128 on (fewer re-reads of dout)
  const int ci = C <= 32 ? 32 : C < 128 ? 64 : 128;
  int err;
  if (fused) {
    err = ci == 32   ? bwd_cols<true, 32>(x, W, dout, dx, ws, M, C, D, splits, s)
          : ci == 64 ? bwd_cols<true, 64>(x, W, dout, dx, ws, M, C, D, splits, s)
                     : bwd_cols<true, 128>(x, W, dout, dx, ws, M, C, D, splits,
                                           s);
  } else {
    err = ci == 32   ? bwd_cols<false, 32>(x, W, dout, dx, ws, M, C, D, splits, s)
          : ci == 64 ? bwd_cols<false, 64>(x, W, dout, dx, ws, M, C, D, splits, s)
                     : bwd_cols<false, 128>(x, W, dout, dx, ws, M, C, D, splits,
                                            s);
  }
  if (err != 0) return err;
  return launch_sum_splits(ws, dwb, splits, (size_t)(C + 1) * D, s);
}

template <bool TAIL>
int dispatch(const void* x, const void* W, const void* bias, void* out,
             const Tail& tl, int rows, int C, int D, int bf16, void* stream) {
  if (C % 4 != 0 || D % 32 != 0 || rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* bp = (const float*)bias;
  if (bf16) return dispatch_mma<TAIL, false>(x, W, bp, out, tl, rows, C, D, s);
  return launch_f32<TAIL, false>(x, W, bp, out, tl, rows, C, D, s);
}

}  // namespace

// x [rows, C], W [C, D], out [rows, D] (fp32, or bf16 when bf16 != 0),
// bias [D] fp32; rows = b * p * na. C must be a multiple of 4, D of 32.
extern "C" int epn_grouped_conv(const void* x, const void* W,
                                const void* bias, void* out, int rows, int C,
                                int D, int bf16, void* stream) {
  const Tail tl = {nullptr, nullptr, nullptr, 0, 0, 1, 1, 0.f};
  return dispatch<false>(x, W, bias, out, tl, rows, C, D, bf16, stream);
}

// The fused separable-block tail. x [b, P, na, C], W [C, D], y and out
// [b, P, na, D] (fp32, or bf16 when bf16 != 0), bias [D], ssk and ssm
// fp32 [., 2, na * D] at batch strides ssk_stride / ssm_stride (elements;
// 0 broadcasts one row pair over the batch); slope the activation's (0.01
// the leaky ReLU, 0 the ReLU).
extern "C" int epn_grouped_conv_tail(const void* x, const void* W,
                                     const void* bias, const void* ssk,
                                     const void* y, const void* ssm,
                                     void* out, int b, int P, int na, int C,
                                     int D, int ssk_stride, int ssm_stride,
                                     float slope, int bf16, void* stream) {
  const Tail tl = {y, (const float*)ssk, (const float*)ssm, ssk_stride,
                   ssm_stride, P, na, slope};
  return dispatch<true>(x, W, bias, out, tl, b * P * na, C, D, bf16, stream);
}

// B9 over x [rows, C], W [C, D], dout [rows, D] (fp32, or bf16 when
// bf16 != 0): dx [rows, C] = dout W^T (parts bit 0) and, in dwb
// [C + 1, D] fp32, dW = x^T dout with dbias = the column sums of dout as
// its last row (bit 1), from per-row-range partials in ws [splits, C + 1, D]
// fp32 added in a fixed order. C must be a multiple of 4 (32 for fp32 dx),
// D of 32.
extern "C" int epn_grouped_conv_bwd(const void* x, const void* W,
                                    const void* dout, void* dx, void* ws,
                                    void* dwb, int rows, int C, int D,
                                    int splits, int parts, int bf16,
                                    void* stream) {
  if (C % 4 != 0 || D % 32 != 0 || rows < 1 || splits < 1 ||
      (!bf16 && (parts & 1) && C % 32 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return bwd_bf16(x, W, dout, dx, (float*)ws, (float*)dwb, rows, C, D,
                    splits, parts, s);
  }
  return bwd_f32(x, W, dout, dx, (float*)ws, (float*)dwb, rows, C, D, splits,
                 parts, s);
}
