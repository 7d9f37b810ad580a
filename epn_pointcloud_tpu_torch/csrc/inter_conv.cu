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
// forward is the W product. The fp32 build (and bf16 shapes off the
// tensor-core route) runs on the CUDA cores (no TF32): the FMA rate bounds
// it. The bf16 build runs on tensor cores (inter_conv_mma_kernel, below):
// bound by its 2.6 TFLOP a b=32 cls forward at the bf16 peak, it reaches
// ~12% of that; the W slices it streams from L2 and the fragment traffic
// in shared memory hold it back, not the products.
//
// Design of the SGEMM template (fp32 and bf16 shapes off the CUDA-core and
// tensor-core kernels' envelopes): a register-blocked SGEMM whose rows are the
// flattened (point, anchor) pairs. A block owns a BM x BN output tile
// (128 x 32/64/128, or 64 x 256 when D allows; 64 rows where the
// neighbors of 128 do not fit, at few anchors) with 8 x 8 outputs a
// thread, and walks the channels
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
//
// fp32 on the CUDA cores (inter_fwd_f32_kernel, epn_inter_conv_fwd_f32;
// every layer of both models: K = 24, na = 60, C % 16 == 0, D % 32 == 0,
// nn <= 64), FFMA only (no TF32: the TPU kernel runs its fp32 dots at full
// precision). Bound: the W product, 2 * M * 24 * C * D operations (2.32
// TFLOP a b=32 cls forward), beside the F build's 2 * M * nn * 24 * C
// (0.29 TFLOP), at 67 TFLOP/s. What held the template back, and what this
// kernel does about it: (1) each anchor weight recomputed for every
// 8-channel chunk -> at 256 columns (two thirds of the cls forward's
// work) F is built 16 channels a chunk (a weight once a 16-channel
// chunk); narrower layers keep 8, so that two or three blocks an SM fit
// beside the slab; (2) the four items of a row loading the same neighbor
// rows synchronously -> a lane builds one row's 3 kernel points over the
// chunk (add_neighbor, as the W-off F kernel), so each table row is
// gathered once a chunk, by cp.async into a ring a warp that runs ahead
// (the next chunk's first stages go out during the last W slice); (3) W
// staged through registers -> W slices of 16 rows by cp.async into a ring
// of three that runs ahead across chunks; (4) F built once for each 128
// columns and several barriers an 8-channel chunk -> a block owns 64 rows
// and all of D up to 256 columns, one barrier a W slice and one a chunk;
// (5) the product: 8 x 8 sums a thread at D = 256 (8 x 4 at 128 and 64,
// 4 x 4 at 32), the slab stored k-major so that a thread's rows of one
// (k, c) are one or two float4 loads, a quarter-warp's one address, and
// the next row's fragments loaded while this one's FFMA run. What holds
// it back (inter_conv_variants.py on the H100): the product's shared-
// memory loads, a byte a FFMA at 8 x 8 against the card's 128 bytes and
// 128 FFMA a cycle an SM: the product alone runs at ~60% of the rate
// (16 x 8 sums a thread, 0.75 bytes a FFMA, gained nothing once the slab
// went k-major); the F build adds 10-40% (more at small D). F is summed
// as the template sums it (bitwise); the product in the order (chunk,
// kernel point, channel) by fmaf; no atomics.
//
// Element type: the table, W and out are fp32 (parity mode) or bf16 (the
// production mode of the _call_gather_w forms in bf16); gx, rk and k2 stay
// fp32, and every product and sum is fp32. In bf16 the anchor weights are
// rounded to bf16 before the neighbor contraction and F after it, where
// the TPU kernels round them (_fwd_gather_w_kernel:974, 980, _conv_body:
// 516, 523), and out is rounded once on store.
//
// Design of the bf16 build (inter_conv_mma_kernel, epn_inter_conv_mma; every
// layer of both models): both contractions on mma.sync.m16n8k16 bf16 ->
// fp32 (tc.cuh). A block owns 64 (point, anchor) rows and all of D up to
// 256 and walks C in chunks of 32 channels. Per chunk, phase 1 builds the
// bf16 F slab [64 x 24*32] in swizzled shared memory, one row at a time a
// warp (two interleaved): the row's table rows G [nn x 32] arrive by
// cp.async as an indexed load (16-byte pieces; the shadow index and nn
// padded to 16 zero-filled), and F^T [32 x 24] = G^T w runs on tensor cores
// with the channels as M and the 24 kernel points as three n8 tiles, so
// nothing is padded: A = G^T by ldmatrix.trans, B = the anchor weights,
// computed in fp32 in the fragment registers and rounded to bf16 there
// (once a chunk: C / 32 times a weight, against C / 8 in the SGEMM), F
// rounded to bf16 into the slab, three 16-byte stores a lane (the slab's
// column order is the fragments', slab_column). Phase 2 multiplies the slab
// by the chunk's 768 W rows, 16 or 32 KB at a time through a cp.async ring
// that runs ahead across chunks; the fp32 accumulators stay in registers
// over all chunks and the output is rounded once into a tile staged in
// shared memory and stored by whole rows. Each pair of k16 steps (kGroup)
// of the W product sums in a fresh mma accumulator, added to the running
// sum by a rounding fp32 add, as in intra_conv.cu (inter_conv_variants.py
// measures the in-place form's lean toward zero). The anchor weights and F are
// rounded to bf16 where the TPU kernel rounds them (_fwd_gather_w_kernel:
// 974, 980), as in the SGEMM template and the plain version. No atomics:
// the output is the same on every call.
//
// W-off F: F [b, p2, na, K, C] without the learned product, in the table's
// type, so a bf16 F is the neighbor contraction of bf16 anchor weights,
// summed in fp32 and rounded once (the TPU kernel's weights and F are in
// the table's dtype too: _conv_body:516, 523).
// Replaces: epn_pointcloud_tpu/ops/pallas/inter_conv.py, _call_gather ->
// _fwd_gather_kernel (via fused_gather_neighbor_conv) and _call ->
// _fwd_kernel (via fused_neighbor_conv), both through _conv_body: F from
// the table and the indices or from rows gathered beforehand. On the card a
// gather is an indexed load, so both TPU forms are one kernel (rows gathered
// beforehand are a table indexed by their own positions). The JAX package
// reaches it where _fgcw_bwd takes its composed backward (c <= 32 or
// nn > 32), to recompute F for dW = F^T dout: the inv model's B0L1, B1L0,
// B2L0 and B3L0, twice a triplet step.
// What bounds it on the H100, in bf16: storing F, K * C elements a row:
// 3.77 GB over the inv step (0.75 GB at B0L1, 0.38 GB at each other layer,
// a leg of b = 16), 1.13 ms at 3.35 TB/s; beside that the gathers, nn
// table rows of 64 bytes a row and 32-channel chunk (~1 GB a layer and
// leg), which mostly hit in L2 (the table is ~31 MB a layer). The
// neighbor contraction, 2 * nn * K * C operations a row, is ~1% of the
// bf16 peak's time. In fp32 (no TF32: the TPU kernel runs its fp32 dots at
// full precision) both terms count: the contraction is ~24 GFLOP of FFMA
// at every layer and leg, 3.28 ms over the step's 8 calls at 67 TFLOP/s,
// and F is 7.5 GB, 2.25 ms at 3.35 TB/s; the gathers, nn * C * 4 bytes a
// row (~2 GB a layer and leg), come from L2 (the table is 63 MB a layer
// but ~4 MB a cloud, and the blocks in flight cover a few clouds).
// fp32 shapes off the CUDA-core kernel's envelope (and bf16 shapes off
// the tensor-core one's) run the SGEMM template with the learned product
// cut out (template flag kWOff, epn_inter_conv_f): each 8-channel chunk's
// fp32 slab is written from shared memory to F. What holds it back: each
// (row, neighbor, kernel point) anchor weight is recomputed for every
// 8-channel chunk (C / 8 times; ~6 instructions for 8 FMAs); one item
// covers 6 of the 24 kernel points, so the four items of a row each load
// the same neighbor rows, synchronously, with nothing in flight during
// the FMAs; the 100 KB slab a block allows two blocks an SM, and each
// chunk crosses two block barriers to write it out, 32 bytes of each
// (row, k) run a pass.
// fp32 (inter_f_f32_kernel, epn_inter_conv_f_f32; every composed layer of
// the inv model: K = 24, na = 60, C % 16 == 0, nn <= 64) on the CUDA
// cores, FFMA only, F summed as the template sums it (each element's sum
// over n in order by fmaf, the weights by anchor_weight: F bitwise the
// template's). A warp owns 4 rows at a time, a lane one row's 3 kernel
// points (g, g + 8, g + 16) over a 32-channel chunk (16 where C % 32 !=
// 0): 96 sums, so each shared-memory load of G feeds 12 FFMA and each
// anchor weight 32 channels (C / 32 times a weight). The block owns all 24
// kernel points of its rows, so each table row is gathered once a chunk,
// by cp.async into a ring of three 8-neighbor stages a warp that runs two
// stages ahead across chunks and row groups. A chunk's F goes out from
// the registers through a 4 KB tile a warp (one kernel point of the
// three at a time, a __syncwarp each way) as whole 128-byte runs, 8 lanes
// a run, evict-first, so that F does not push the table out of L2. No
// slab, no block barrier after the neighbors are staged: a warp's stores
// overlap the other warps' gathers and FFMA. Three blocks of 4 warps an
// SM (70 KB of shared memory and at most 168 registers each); no
// atomics.
// bf16 (inter_f_mma_kernel, epn_inter_conv_f_mma; every composed layer of
// the inv model) runs phase 1 of the tensor-core forward as it is
// (stage_block, gather_pair, contract_pair: the same gathers, products and
// rounding points), with a store epilogue in place of the W product. For
// the stores: stmatrix.trans writes F^T's fragments as F [k][c] into a
// warp's staged tile, and each (row, k) run of 32 channels goes out whole,
// 16 bytes a lane (a row's 1536 bytes one run at C = 32), as evict-first
// stores so that F does not push the table out of L2; each warp runs on
// without a block barrier, so one warp's stores overlap the others' gathers
// and products. For the gathers: cp.async into a ring of row buffers a
// warp, the next pair's rows in flight where four blocks an SM still fit
// (nn <= 32), and four blocks of 128 threads an SM (no slab, no W ring), so
// 16 warps an SM keep gathers in flight. The anchor weights are computed
// once a 32-channel chunk, C / 32 times (C / 8 in the template).

#include <cuda_runtime.h>

#include <type_traits>

#include "inter_conv_common.cuh"
#include "tc.cuh"

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
template <int BM, int BN, typename T>
__device__ __forceinline__ void load_w(const T* __restrict__ W, int s,
                                       int c0, int C, int D, int n0, int tid,
                                       float4 (&rb)[Cfg<BM, BN>::kBLoads]) {
#pragma unroll
  for (int i = 0; i < Cfg<BM, BN>::kBLoads; ++i) {
    const int e = tid + i * Cfg<BM, BN>::kThreads;
    const int r = s * BK + e / (BN / 4), c4 = e % (BN / 4);
    const int k = r / CC, cc = r - k * CC;
    rb[i] = epn::load4(W + ((size_t)k * C + c0 + cc) * D + n0 + 4 * c4);
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

// kWOff: out is F [M, K, C]; W and D are unused
template <int BM, int BN, typename T, bool kWOff>
__global__ void __launch_bounds__(Cfg<BM, BN>::kThreads)
inter_conv_kernel(const float* __restrict__ gx, const int* __restrict__ idx,
                  const T* __restrict__ table,
                  const float* __restrict__ rk, const float* __restrict__ k2,
                  const T* __restrict__ W, T* __restrict__ out, int M,
                  int p2, int nn, int q, int na, int K, int C, int D,
                  float inv_sigma) {
  using G = Cfg<BM, BN>;
  extern __shared__ __align__(16) float smem[];
  const Smem L = layout(BM, kWOff ? 0 : BN, K, na, nn);
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
    if constexpr (!kWOff) load_w<BM, BN>(W, 0, c0, C, D, n0, tid, rb);
    // A slab: F[row, k, cc] for this chunk, one (row, 6 kernel points) item
    // at a time
    for (int e = tid; e < n_items; e += G::kThreads) {
      const int row = e % BM, kg = e / BM;
      build_f_item<T, std::is_same<T, epn::bf16>::value>(
          s_F + (size_t)row * L.fs + kg * KG * CC, table, rk, k2, s_gx,
          s_idx, m0 + row, M, pt0, p2, nn, q, na, K, C, c0, kg, inv_sigma);
    }
    if constexpr (kWOff) {
      // the slab to F[row, k, c0 + cc], a float4 (half a (row, k) chunk
      // row) a thread
      __syncthreads();
      constexpr int kRow4 = CC / 4;
      for (int e = tid; e < BM * K * kRow4; e += G::kThreads) {
        const int row = e / (K * kRow4), j = e - row * (K * kRow4);
        if (m0 + row < M) {
          const int k = j / kRow4, h = j - k * kRow4;
          epn::store4(out + ((size_t)(m0 + row) * K + k) * C + c0 + 4 * h,
                      *reinterpret_cast<const float4*>(s_F + (size_t)row * L.fs
                                                       + 4 * j));
        }
      }
      __syncthreads();
      continue;
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

  if constexpr (kWOff) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * (BM / TM);
    if (gm < M) {
      T* op = out + (size_t)gm * D + n0;
      epn::store4(op + tx * 4,
                  make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      epn::store4(op + BN / 2 + tx * 4,
                  make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
    }
  }
}

template <int BM, int BN, typename T, bool kWOff = false>
int launch(const float* gx, const int* idx, const T* table,
           const float* rk, const float* k2, const T* W, T* out, int M,
           int p2, int nn, int q, int na, int K, int C, int D, float sigma,
           cudaStream_t stream) {
  const Smem L = layout(BM, kWOff ? 0 : BN, K, na, nn);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      inter_conv_kernel<BM, BN, T, kWOff>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, kWOff ? 1 : D / BN);
  inter_conv_kernel<BM, BN, T, kWOff>
      <<<grid, Cfg<BM, BN>::kThreads, L.total, stream>>>(
          gx, idx, table, rk, k2, W, out, M, p2, nn, q, na, K, C, D,
          1.f / sigma);
  return (int)cudaGetLastError();
}

// 128 rows a block where their neighbors fit in shared memory, else 64: a
// block's rows touch BM / na + 2 points, so at few anchors the staged
// neighbors outgrow it (one anchor, nn = 64: 130 points, 166 KB beside the
// 100 KB F slab)
template <int BN, typename T, bool kWOff = false>
int launch_rows(const float* gx, const int* idx, const T* table,
                const float* rk, const float* k2, const T* W, T* out, int M,
                int p2, int nn, int q, int na, int K, int C, int D,
                float sigma, cudaStream_t stream) {
  if (layout(128, kWOff ? 0 : BN, K, na, nn).total <= kMaxSmem) {
    return launch<128, BN, T, kWOff>(gx, idx, table, rk, k2, W, out, M, p2,
                                     nn, q, na, K, C, D, sigma, stream);
  }
  return launch<64, BN, T, kWOff>(gx, idx, table, rk, k2, W, out, M, p2, nn,
                                  q, na, K, C, D, sigma, stream);
}

template <typename T>
int dispatch(const void* gx, const void* idx, const void* table,
             const void* rk, const void* k2, const void* W, void* out,
             int b, int p2, int nn, int q, int na, int K, int C, int D,
             float sigma, cudaStream_t s) {
  const float* g = (const float*)gx;
  const int* ix = (const int*)idx;
  const T* t = (const T*)table;
  const float* r = (const float*)rk;
  const float* kk = (const float*)k2;
  const T* w = (const T*)W;
  T* o = (T*)out;
  const int M = b * p2 * na;
  if (D % 256 == 0) {
    return launch<64, 256>(g, ix, t, r, kk, w, o, M, p2, nn, q, na, K, C, D, sigma, s);
  }
  if (D % 128 == 0) {
    return launch_rows<128>(g, ix, t, r, kk, w, o, M, p2, nn, q, na, K, C, D, sigma, s);
  }
  if (D % 64 == 0) {
    return launch_rows<64>(g, ix, t, r, kk, w, o, M, p2, nn, q, na, K, C, D, sigma, s);
  }
  return launch_rows<32>(g, ix, t, r, kk, w, o, M, p2, nn, q, na, K, C, D, sigma, s);
}

// ------------------------------------------------- bf16 on tensor cores

using epn::bf16;

namespace mma {

constexpr int kBM = 64;          // rows a block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kBM / kWarps;
constexpr int kCC = 32;          // channels a chunk
constexpr int kK = 24;           // kernel points: three n8 tiles
constexpr int kKC = kK * kCC;    // F slab columns a row
constexpr int kStages = 3;       // W slices in the ring
constexpr int kGroup = 2;        // k16 steps summed in one fresh accumulator
constexpr int kMaxNN = 64;
constexpr int kMinNA = 4;

// A block's warps for BN output columns: WM x WN warps, MI m16 x NI n8
// tiles a warp (32 x 64 at BN = 256); W slices SK rows deep (16 KB, or 32
// KB where the gathered rows still fit beside them: half the block
// barriers); the bf16 output tile staged at row stride OS (padded: the
// fragments' 4-byte writes hit distinct banks)
template <int BN_, bool kDeep>
struct MmaCfg {
  static constexpr int BN = BN_;
  static constexpr int WM = BN >= 128 ? 2 : 4, WN = kWarps / WM;
  static constexpr int MI = kBM / WM / 16, NI = BN / WN / 8;
  static constexpr int SK = (kDeep ? 16384 : 8192) / BN;
  static constexpr int SLICES = kKC / SK;
  static constexpr int OS = BN + 8;
  static_assert(NI % 2 == 0 && kKC % SK == 0 && SK % (16 * kGroup) == 0,
                "warp tile");
};

// The slab's column order. Lane (g, t) of the warp that builds a row holds
// F[cc][k] for cc = 16 mi + 8 h + g and k = 8 j + 2 t + e (mi, h, e < 2,
// j < 3) and stores them as three 16-byte chunks, 3 * lane + w: w = 0, 1
// the (h, j < 2, e) of mi = w, w = 2 the (mi, h, e) of j = 2. The channel
// and kernel point of slab column col, for W's rows:
__device__ __forceinline__ void slab_column(int col, int& cc, int& k) {
  const int chunk = col >> 3, pos = col & 7, lane = chunk / 3;
  const int w = chunk - 3 * lane, g = lane >> 2, t = lane & 3;
  if (w < 2) {
    cc = 16 * w + 8 * (pos >> 2) + g;
    k = 8 * ((pos >> 1) & 1) + 2 * t + (pos & 1);
  } else {
    cc = 8 * (pos >> 1) + g;
    k = 16 + 2 * t + (pos & 1);
  }
}

// dynamic shared memory, in bytes from the base: the F slab [kBM, kKC]
// (offset 0), the W ring [kStages][SK, BN], the neighbor coordinates
// [np][nnp] float4 (x, y, z, 1 - |gx|^2 / sigma) and indices [np][nnp], the
// rows' table offsets [kBM] and (point, anchor) [kBM], then each warp's
// ring of R gathered-row buffers [nnp, kCC]: as many as fit, even, at most
// a warp's rows
struct MmaSmem {
  int nnp, np, R;
  size_t ring, gx, idx, rtb, ri, rows, total;
};

__host__ __device__ inline MmaSmem mma_layout(int bn, int sk, int na,
                                              int nn) {
  MmaSmem s;
  s.nnp = (nn + 15) / 16 * 16;
  s.np = (kBM - 1) / na + 2;
  s.ring = (size_t)kBM * kKC * sizeof(bf16);
  s.gx = s.ring + (size_t)kStages * sk * bn * sizeof(bf16);
  s.idx = s.gx + (size_t)s.np * s.nnp * sizeof(float4);
  s.rtb = s.idx + (size_t)s.np * s.nnp * sizeof(int);
  s.ri = s.rtb + (size_t)kBM * sizeof(long long);
  s.rows = s.ri + (size_t)kBM * sizeof(int2);
  const size_t row_bytes = (size_t)kWarps * s.nnp * kCC * sizeof(bf16);
  const size_t fit = kMaxSmem > s.rows ? (kMaxSmem - s.rows) / row_bytes : 0;
  s.R = (int)(fit < (size_t)kRowsPerWarp ? fit : kRowsPerWarp) & ~1;
  s.total = s.rows + (size_t)s.R * row_bytes;
  return s;
}

// wait until at most n (< 4) committed groups are still in flight
__device__ __forceinline__ void cp_wait_upto(int n) {
  switch (n) {
    case 0: tc::cp_wait<0>(); break;
    case 1: tc::cp_wait<1>(); break;
    case 2: tc::cp_wait<2>(); break;
    default: tc::cp_wait<3>(); break;
  }
}

// Phase 1, shared by the W-fused forward and the W-off F
// (inter_f_mma_kernel).
//
// The block's points' neighbors (padded slots hold the shadow index) and
// each of its kBM rows' table offset, local point (-1 past M) and anchor
__device__ __forceinline__ void stage_block(
    float4* __restrict__ s_gx, int* __restrict__ s_idx,
    long long* __restrict__ s_rtb, int2* __restrict__ s_ri,
    const float* __restrict__ gx, const int* __restrict__ idx, int m0, int M,
    int pt0, int np, int nnp, int nn, int q, int na, int p2, int C,
    float inv_sigma, int tid, int n_threads) {
  for (int e = tid; e < np * nnp; e += n_threads) {
    const int p = e / nnp, n = e - p * nnp;
    float4 v = make_float4(0.f, 0.f, 0.f, 1.f);
    int j = q;
    if (n < nn) {
      const size_t src = (size_t)(pt0 + p) * nn + n;
      const float x = gx[3 * src], y = gx[3 * src + 1], z = gx[3 * src + 2];
      v = make_float4(x, y, z, 1.f - ((x * x + y * y) + z * z) * inv_sigma);
      j = idx[src];
    }
    s_gx[e] = v;
    s_idx[e] = j;
  }
  if (tid < kBM) {
    const int gm = m0 + tid, pt = gm / na, a = gm - pt * na;
    s_rtb[tid] = ((long long)(pt / p2) * q * na + a) * C;
    s_ri[tid] = make_int2(gm < M ? pt - pt0 : -1, a);
  }
}

// the table rows of block rows r, r + 1, channels c0 .. c0 + kCC, into the
// [nnp, kCC] buffers dst and dst + nnp * kCC (zeros for the shadow index
// and padded slots; nothing past M); one commit group
__device__ __forceinline__ void gather_pair(
    bf16* __restrict__ dst, const bf16* __restrict__ table,
    const int* __restrict__ s_idx, const long long* __restrict__ s_rtb,
    const int2* __restrict__ s_ri, int r, int c0, int nnp, int q, int na,
    int C, int lane) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int lp = s_ri[r + u].x;
    if (lp < 0) continue;
    const int* ix = s_idx + lp * nnp;
    const bf16* tb = table + s_rtb[r + u] + c0;
    bf16* d = dst + (size_t)u * nnp * kCC;
    for (int e = lane; e < nnp * (kCC / 8); e += 32) {
      const int n = e / (kCC / 8), c8 = e % (kCC / 8) * 8;
      const int j = ix[n];
      const bool ok = j < q;
      tc::cp16(tc::smem_addr(d + tc::swz(n, c8, kCC / 8)),
               ok ? tb + (size_t)j * na * C + c8 : table, ok);
    }
  }
  tc::cp_commit();
}

// block rows r, r + 1 (gathered rows in gb and gb + nnp * kCC): F^T [kCC,
// 24] = G^T [kCC, nnp] w [nnp, 24] into f[u]; A = G^T by ldmatrix.trans
// from the [n][c] buffer; B = the anchor weights of neighbors 2t, 2t + 1
// (b0) and 2t + 8, 2t + 9 (b1) for kernel point 8j + g, computed in fp32
// as relu((1 - |gx|^2 / sigma) - |kappa|^2 / sigma + gx . (2 R kappa /
// sigma)) and rounded to bf16 in the fragment. f[u][mi][j] is the m16n8
// accumulator of channels 16 mi .. 16 mi + 16 and kernel points 8j .. 8j +
// 8, summed in place over the nnp / 16 <= 4 k16 steps.
__device__ __forceinline__ void contract_pair(
    float (&f)[2][2][3][4], const bf16* __restrict__ gb,
    const float4* __restrict__ s_gx, const int2* __restrict__ s_ri,
    const float* __restrict__ rk, const float* __restrict__ k2, int r,
    int nnp, float inv_sigma, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float4* g4[2];
  const bf16* gbu[2];
  float4 rj[2][3];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int2 ri = s_ri[r + u];
    g4[u] = s_gx + max(ri.x, 0) * nnp;
    gbu[u] = gb + (size_t)u * nnp * kCC;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int kp = 8 * j + g;
      const float* rp = rk + ((size_t)ri.y * kK + kp) * 3;
      const float s2 = 2.f * inv_sigma;
      rj[u][j] = make_float4(s2 * __ldg(rp), s2 * __ldg(rp + 1),
                             s2 * __ldg(rp + 2),
                             -__ldg(k2 + kp) * inv_sigma);
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) f[u][mi][j][h] = 0.f;
  for (int nb = 0; nb < nnp; nb += 16) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float4 gq[4] = {g4[u][nb + 2 * t], g4[u][nb + 2 * t + 1],
                            g4[u][nb + 2 * t + 8], g4[u][nb + 2 * t + 9]};
      uint32_t b[3][2];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float w[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float4& p = gq[n];
          const float4& k = rj[u][j];
          w[n] = fmaxf(fmaf(p.x, k.x, fmaf(p.y, k.y, fmaf(p.z, k.z,
                                                          p.w + k.w))),
                       0.f);
        }
        b[j][0] = epn::pack2(w[0], w[1]);
        b[j][1] = epn::pack2(w[2], w[3]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t af[4];
        tc::ldsm4t(af, tc::smem_addr(
                           gbu[u] + tc::swz(nb + (lane & 7) + (lane >> 4) * 8,
                                            (2 * mi + ((lane >> 3) & 1)) * 8,
                                            kCC / 8)));
#pragma unroll
        for (int j = 0; j < 3; ++j)
          tc::mma(f[u][mi][j], af, b[j][0], b[j][1]);
      }
    }
  }
}

// out [M, D] (bf16) for rows m0 .. m0 + kBM and columns n0 .. n0 + BN:
// per 32-channel chunk, phase 1 builds the bf16 F slab (each warp two rows
// at a time: the rows' gathered table rows G [nnp, kCC] in a cp.async ring,
// F^T [kCC, 24] = G^T w by mma with the anchor weights computed in the B
// fragments, rounded into the slab), phase 2 multiplies the slab by the
// chunk's W rows (slab_column's order), streamed SK at a time through a
// cp.async ring that runs ahead across chunks; the accumulators stay in
// registers, and the output is rounded once into a tile staged in the
// slab's memory and stored by rows.
template <int BN, bool kDeep>
__global__ void __launch_bounds__(kThreads, 1)
inter_conv_mma_kernel(const float* __restrict__ gx,
                      const int* __restrict__ idx,
                      const bf16* __restrict__ table,
                      const float* __restrict__ rk,
                      const float* __restrict__ k2,
                      const bf16* __restrict__ W, bf16* __restrict__ out,
                      int M, int p2, int nn, int q, int na, int C, int D,
                      float inv_sigma) {
  using G = MmaCfg<BN, kDeep>;
  extern __shared__ __align__(128) unsigned char mma_smem[];
  unsigned char* smem = mma_smem;
  const MmaSmem L = mma_layout(BN, G::SK, na, nn);
  const int nnp = L.nnp, R = L.R, R2 = R / 2;
  bf16* slab = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  float4* s_gx = reinterpret_cast<float4*>(smem + L.gx);
  int* s_idx = reinterpret_cast<int*>(smem + L.idx);
  long long* s_rtb = reinterpret_cast<long long*>(smem + L.rtb);
  int2* s_ri = reinterpret_cast<int2*>(smem + L.ri);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  bf16* rows = reinterpret_cast<bf16*>(smem + L.rows) +
               (size_t)warp * R * nnp * kCC;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int pt0 = m0 / na;
  const int np = (min(m0 + kBM, M) - 1) / na - pt0 + 1;
  const int steps = C / kCC * G::SLICES;  // W slices over all chunks

  // W slice `step`: slab columns kk0 .. kk0 + SK of chunk step / SLICES
  auto load_w = [&](int step) {
    const int c0 = step / G::SLICES * kCC, kk0 = step % G::SLICES * G::SK;
    bf16* dst = ring + (size_t)(step % kStages) * G::SK * BN;
    for (int e = tid; e < G::SK * BN / 8; e += kThreads) {
      const int r = e / (BN / 8), c8 = e % (BN / 8) * 8;
      int cc, k;
      slab_column(kk0 + r, cc, k);
      tc::cp16(tc::smem_addr(dst + tc::swz(r, c8, BN / 8)),
               W + ((size_t)k * C + c0 + cc) * D + n0 + c8, true);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_w(s);
    tc::cp_commit();
  }

  stage_block(s_gx, s_idx, s_rtb, s_ri, gx, idx, m0, M, pt0, np, nnp, nn, q,
              na, p2, C, inv_sigma, tid, kThreads);
  __syncthreads();

  // the table rows of this warp's rows i, i + 1 (i even), channels c0 ..
  // c0 + kCC, into buffers i % R, i % R + 1; one commit group a pair
  auto gather = [&](int i, int c0) {
    gather_pair(rows + (size_t)(i % R) * nnp * kCC, table, s_idx, s_rtb,
                s_ri, warp * kRowsPerWarp + i, c0, nnp, q, na, C, lane);
  };

  // rows i, i + 1: F^T by contract_pair, rounded to bf16 into the slab,
  // three 16-byte chunks a lane
  auto contract = [&](int i) {
    const int r0 = warp * kRowsPerWarp + i;
    float f[2][2][3][4];
    contract_pair(f, rows + (size_t)(i % R) * nnp * kCC, s_gx, s_ri, rk, k2,
                  r0, nnp, inv_sigma, lane);
    const int r[2] = {r0, r0 + 1};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (s_ri[r[u]].x < 0) continue;
      const float(&h)[2][3][4] = f[u];
      const uint4 v[3] = {
          make_uint4(epn::pack2(h[0][0][0], h[0][0][1]),
                     epn::pack2(h[0][1][0], h[0][1][1]),
                     epn::pack2(h[0][0][2], h[0][0][3]),
                     epn::pack2(h[0][1][2], h[0][1][3])),
          make_uint4(epn::pack2(h[1][0][0], h[1][0][1]),
                     epn::pack2(h[1][1][0], h[1][1][1]),
                     epn::pack2(h[1][0][2], h[1][0][3]),
                     epn::pack2(h[1][1][2], h[1][1][3])),
          make_uint4(epn::pack2(h[0][2][0], h[0][2][1]),
                     epn::pack2(h[0][2][2], h[0][2][3]),
                     epn::pack2(h[1][2][0], h[1][2][1]),
                     epn::pack2(h[1][2][2], h[1][2][3]))};
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        *reinterpret_cast<uint4*>(
            slab + tc::swz(r[u], (3 * lane + w) * 8, kKC / 8)) = v[w];
      }
    }
  };

  float acc[G::MI][G::NI][4];
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[mi][ni][h] = 0.f;
  const int wm = warp / G::WN, wn = warp % G::WN;
  constexpr int kPairs = kRowsPerWarp / 2;

  for (int c0 = 0, step = 0; c0 < C; c0 += kCC) {
    // phase 1: the slab, R2 pairs of the warp's rows in flight
    for (int i = 0; i < R2 - 1; ++i) gather(2 * i, c0);
    for (int i = 0; i < kPairs; ++i) {
      if (i + R2 - 1 < kPairs) {
        gather(2 * (i + R2 - 1), c0);
      } else {
        tc::cp_commit();
      }
      cp_wait_upto(R2 - 1);
      __syncwarp();
      contract(2 * i);
      __syncwarp();
    }
    __syncthreads();

    // phase 2: out += slab . W[chunk rows]
    for (int s = 0; s < G::SLICES; ++s, ++step) {
      tc::cp_wait<kStages - 2>();
      __syncthreads();
      if (step + kStages - 1 < steps) load_w(step + kStages - 1);
      tc::cp_commit();
      const bf16* ws = ring + (size_t)(step % kStages) * G::SK * BN;
      const int kk0 = s * G::SK;
#pragma unroll
      for (int kg = 0; kg < G::SK; kg += 16 * kGroup) {
        // the group's products into a fresh accumulator, added to the
        // running sum by an fp32 add that rounds to nearest: the mma's own
        // accumulation truncates, and over the 48-384 k16 steps of a row
        // it can lean the rounded outputs toward zero
        float t[G::MI][G::NI][4];
#pragma unroll
        for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
            for (int h = 0; h < 4; ++h) t[mi][ni][h] = 0.f;
#pragma unroll
        for (int kk = kg; kk < kg + 16 * kGroup; kk += 16) {
          uint32_t af[G::MI][4];
#pragma unroll
          for (int mi = 0; mi < G::MI; ++mi) {
            tc::ldsm4(af[mi], tc::smem_addr(
                                  slab + tc::swz(wm * (kBM / G::WM) +
                                                     mi * 16 + (lane & 15),
                                                 kk0 + kk + (lane >> 4) * 8,
                                                 kKC / 8)));
          }
          uint32_t bf[G::NI][2];
#pragma unroll
          for (int nj = 0; nj < G::NI / 2; ++nj) {
            uint32_t r4[4];
            tc::ldsm4t(r4, tc::smem_addr(
                               ws + tc::swz(kk + (lane & 7) +
                                                ((lane >> 3) & 1) * 8,
                                            wn * (BN / G::WN) + nj * 16 +
                                                (lane >> 4) * 8,
                                            BN / 8)));
            bf[2 * nj][0] = r4[0];
            bf[2 * nj][1] = r4[1];
            bf[2 * nj + 1][0] = r4[2];
            bf[2 * nj + 1][1] = r4[3];
          }
#pragma unroll
          for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < G::NI; ++ni)
              tc::mma(t[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
            for (int h = 0; h < 4; ++h) acc[mi][ni][h] += t[mi][ni][h];
      }
    }
    __syncthreads();  // the slab is rebuilt next
  }

  // the output rounded once into a tile in the slab's memory, stored by
  // whole rows in 16-byte vectors
  bf16* ot = slab;
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * (kBM / G::WM) + mi * 16 + g + 8 * h;
        const int c = wn * (BN / G::WN) + ni * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(ot + r * G::OS + c) =
            epn::pack2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
  __syncthreads();
  for (int e = tid; e < kBM * BN / 8; e += kThreads) {
    const int r = e / (BN / 8), c = e % (BN / 8) * 8;
    if (m0 + r < M) {
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * D + n0 + c) =
          *reinterpret_cast<const uint4*>(ot + r * G::OS + c);
    }
  }
  tc::cp_wait<0>();
}

template <int BN, bool kDeep>
int launch(const void* gx, const void* idx, const void* table,
           const void* rk, const void* k2, const void* W, void* out, int M,
           int p2, int nn, int q, int na, int C, int D, float sigma,
           cudaStream_t stream) {
  using G = MmaCfg<BN, kDeep>;
  const MmaSmem L = mma_layout(BN, G::SK, na, nn);
  if (L.R < 2) return (int)cudaErrorInvalidValue;
  auto kern = inter_conv_mma_kernel<BN, kDeep>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + kBM - 1) / kBM, D / BN);
  kern<<<grid, kThreads, L.total, stream>>>(
      (const float*)gx, (const int*)idx, (const bf16*)table,
      (const float*)rk, (const float*)k2, (const bf16*)W, (bf16*)out, M, p2,
      nn, q, na, C, D, 1.f / sigma);
  return (int)cudaGetLastError();
}

// the deep W slices where a pair of gathered rows a warp fits beside them
// (not at BN = 32: a chunk's 768 columns are not a whole number of them)
template <int BN>
int launch_any(const void* gx, const void* idx, const void* table,
               const void* rk, const void* k2, const void* W, void* out,
               int M, int p2, int nn, int q, int na, int C, int D,
               float sigma, cudaStream_t stream) {
  if constexpr (BN > 32) {
    if (mma_layout(BN, MmaCfg<BN, true>::SK, na, nn).R >= 2) {
      return launch<BN, true>(gx, idx, table, rk, k2, W, out, M, p2, nn, q,
                              na, C, D, sigma, stream);
    }
  }
  return launch<BN, false>(gx, idx, table, rk, k2, W, out, M, p2, nn, q, na,
                           C, D, sigma, stream);
}

// ------------------------------------------------- W-off F on tensor cores

constexpr int kFWarps = 4;
constexpr int kFThreads = 32 * kFWarps;
constexpr int kFRowsPerWarp = kBM / kFWarps;  // eight pairs
constexpr int kFStage = 2 * kKC;              // a pair's F chunk (elements)
constexpr int kFBlocks = 4;                   // blocks an SM the ring fits
constexpr int kFRing = 4;                     // rows a warp's ring, at most
constexpr size_t kSmemPerSM = 228 * 1024;

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~(size_t)127;
}

// dynamic shared memory, in bytes from the base: the neighbor coordinates
// [np][nnp] float4 (offset 0) and indices [np][nnp], the rows' table
// offsets [kBM] and (point, anchor) [kBM], each warp's staged F tile
// [2 rows][24][kCC], then each warp's ring of R gathered-row buffers
// [nnp, kCC]: kFRing where kFBlocks blocks still fit an SM, else 2
struct FSmem {
  int nnp, np, R;
  size_t idx, rtb, ri, stage, rows, total;
};

__host__ __device__ inline FSmem f_layout(int na, int nn) {
  FSmem s;
  s.nnp = (nn + 15) / 16 * 16;
  s.np = (kBM - 1) / na + 2;
  s.idx = (size_t)s.np * s.nnp * sizeof(float4);
  s.rtb = align128(s.idx + (size_t)s.np * s.nnp * sizeof(int));
  s.ri = s.rtb + (size_t)kBM * sizeof(long long);
  s.stage = align128(s.ri + (size_t)kBM * sizeof(int2));
  s.rows = s.stage + (size_t)kFWarps * kFStage * sizeof(bf16);
  const size_t row_bytes = (size_t)kFWarps * s.nnp * kCC * sizeof(bf16);
  // each block's share of the SM, less the 1 KB the system keeps a block
  const size_t budget = kSmemPerSM / kFBlocks - 1024;
  s.R = s.rows + kFRing * row_bytes <= budget ? kFRing : 2;
  s.total = s.rows + (size_t)s.R * row_bytes;
  return s;
}

// F [M, 24, C] (bf16) for rows m0 .. m0 + kBM. Each warp walks its eight
// row pairs and each pair's C / 32 channel chunks in turn (items), with
// the gathers of the next R / 2 - 1 items in flight in its ring; phase 1
// (gather_pair, contract_pair) builds F^T, whose fragments stmatrix.trans
// writes into the warp's staged tile as F [u][k][cc] (swizzled: the eight
// k rows of one 8 x 8 store fall in distinct banks); each row's 24 runs of
// 32 channels (64 bytes) then go to F in 16-byte vectors, four lanes a
// run, as evict-first stores. No block barrier after the staging; no
// atomics.
__global__ void __launch_bounds__(kFThreads, kFBlocks)
inter_f_mma_kernel(const float* __restrict__ gx, const int* __restrict__ idx,
                   const bf16* __restrict__ table,
                   const float* __restrict__ rk,
                   const float* __restrict__ k2, bf16* __restrict__ F,
                   int M, int p2, int nn, int q, int na, int C,
                   float inv_sigma) {
  extern __shared__ __align__(128) unsigned char f_smem[];
  const FSmem L = f_layout(na, nn);
  const int nnp = L.nnp, R2 = L.R / 2;
  float4* s_gx = reinterpret_cast<float4*>(f_smem);
  int* s_idx = reinterpret_cast<int*>(f_smem + L.idx);
  long long* s_rtb = reinterpret_cast<long long*>(f_smem + L.rtb);
  int2* s_ri = reinterpret_cast<int2*>(f_smem + L.ri);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bf16* stage = reinterpret_cast<bf16*>(f_smem + L.stage) +
                (size_t)warp * kFStage;
  bf16* rows = reinterpret_cast<bf16*>(f_smem + L.rows) +
               (size_t)warp * L.R * nnp * kCC;
  const int m0 = blockIdx.x * kBM, pt0 = m0 / na;
  const int np = (min(m0 + kBM, M) - 1) / na - pt0 + 1;
  stage_block(s_gx, s_idx, s_rtb, s_ri, gx, idx, m0, M, pt0, np, nnp, nn, q,
              na, p2, C, inv_sigma, tid, kFThreads);
  __syncthreads();

  // item it: the warp's pair it / nch (block rows r, r + 1), channels
  // c0 .. c0 + kCC of chunk it % nch; its rows in ring slot it % R2
  const int nch = C / kCC, items = kFRowsPerWarp / 2 * nch;
  const int rw = warp * kFRowsPerWarp;
  auto gather = [&](int it) {
    gather_pair(rows + (size_t)(it % R2) * 2 * nnp * kCC, table, s_idx,
                s_rtb, s_ri, rw + it / nch * 2, it % nch * kCC, nnp, q, na,
                C, lane);
  };
  for (int it = 0; it < R2 - 1; ++it) gather(it);
  for (int it = 0; it < items; ++it) {
    if (it + R2 - 1 < items) {
      gather(it + R2 - 1);
    } else {
      tc::cp_commit();
    }
    cp_wait_upto(R2 - 1);
    __syncwarp();
    const int r = rw + it / nch * 2, c0 = it % nch * kCC;
    float f[2][2][3][4];
    contract_pair(f, rows + (size_t)(it % R2) * 2 * nnp * kCC, s_gx, s_ri,
                  rk, k2, r, nnp, inv_sigma, lane);
    // store j of row u: matrix 2 mi + h holds channels 16 mi + 8 h + g by
    // kernel points 8j + 2t, 8j + 2t + 1; lane l gives the staged row of
    // kernel point 8j + l % 8, channels 8 (l / 8) .. + 8
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float(&h)[2][3][4] = f[u];
        tc::stsm4t(tc::smem_addr(stage + tc::swz(u * kK + 8 * j + (lane & 7),
                                                 (lane >> 3) * 8, kCC / 8)),
                   epn::pack2(h[0][j][0], h[0][j][1]),
                   epn::pack2(h[0][j][2], h[0][j][3]),
                   epn::pack2(h[1][j][0], h[1][j][1]),
                   epn::pack2(h[1][j][2], h[1][j][3]));
      }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (s_ri[r + u].x < 0) continue;
      bf16* out = F + (size_t)(m0 + r + u) * kK * C + c0;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int e = 32 * s + lane, k = e >> 2, ch = e & 3;
        tc::st_stream16(out + (size_t)k * C + ch * 8,
                        *reinterpret_cast<const uint4*>(
                            stage + tc::swz(u * kK + k, ch * 8, kCC / 8)));
      }
    }
    __syncwarp();  // the staged tile is written again next item
  }
  tc::cp_wait<0>();
}

int launch_f(const void* gx, const void* idx, const void* table,
             const void* rk, const void* k2, void* F, int M, int p2, int nn,
             int q, int na, int C, float sigma, cudaStream_t stream) {
  const FSmem L = f_layout(na, nn);
  cudaError_t err = cudaFuncSetAttribute(
      inter_f_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  inter_f_mma_kernel<<<(M + kBM - 1) / kBM, kFThreads, L.total, stream>>>(
      (const float*)gx, (const int*)idx, (const bf16*)table,
      (const float*)rk, (const float*)k2, (bf16*)F, M, p2, nn, q, na, C,
      1.f / sigma);
  return (int)cudaGetLastError();
}

}  // namespace mma

// ------------------------------------------- fp32 W-off F on the CUDA cores

namespace ff32 {

using epn_inter::add_neighbor;

constexpr int kNA = 60;            // anchors: the rows of a point
constexpr int kK = 24;             // kernel points
constexpr int kKT = 3;             // kernel points a lane
constexpr int kCH = 32;            // channels a chunk (16 where C % 32 != 0)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 64;            // rows a block
constexpr int kNS = 8;             // neighbors a ring stage
constexpr int kStages = 3;         // ring stages a warp
constexpr int kBlocks = 3;         // blocks an SM
constexpr int kMaxNN = 64;
constexpr int kMaxNP = (kBM - 1) / kNA + 2;  // points a block touches

// A lane owns KT of a row's 24 kernel points over a chunk of CH channels:
// LR lanes a row, R rows a warp item, P float4 a (row, neighbor); G items
// a warp. TS: the float4 of a row in the warp's store tile (LR runs of P,
// 4 of padding: the two rows a quarter-warp writes fall in different bank
// groups).
template <int KT, int CH>
struct Shape {
  static constexpr int LR = kK / KT, R = 32 / LR, P = CH / 4;
  static constexpr int G = kBM / (kWarps * R);
  static constexpr int TS = LR * P + 4;
  static_assert(kK % KT == 0 && 32 % LR == 0 && G * kWarps * R == kBM &&
                    32 % P == 0,
                "shape");
};

// dynamic shared memory, in bytes from the base: the block's points'
// neighbor coordinates [kMaxNP][nn] float4 (x, y, z, |gx|^2) and indices
// [kMaxNP][nn], each row's table offset [kBM] and local point [kBM] (-1
// past M), then each warp's ring of kStages stages [R][RS] (a stage's kNS
// neighbors of CH channels a row; RS = kNS * CH + 4: the rows a warp reads
// at once fall in different bank groups) and its store tile [R][TS]
// float4
template <int KT, int CH>
struct Smem {
  using S = Shape<KT, CH>;
  static constexpr int RS = kNS * CH + 4;
  static constexpr size_t idx = (size_t)kMaxNP * kMaxNN * sizeof(float4);
  static constexpr size_t rtb = idx + (size_t)kMaxNP * kMaxNN * sizeof(int);
  static constexpr size_t lp = rtb + (size_t)kBM * sizeof(long long);
  static constexpr size_t ring = lp + (size_t)kBM * sizeof(int);
  static constexpr size_t ring_warp = (size_t)kStages * S::R * RS;  // floats
  static constexpr size_t tile = ring + kWarps * ring_warp * sizeof(float);
  static constexpr size_t tile_warp = (size_t)S::R * S::TS;  // float4
  static constexpr size_t total = tile + kWarps * tile_warp * sizeof(float4);
  static_assert(ring % 16 == 0 && tile % 16 == 0 && RS % 4 == 0, "align");
};

// F [M, 24, C] (fp32) for rows m0 .. m0 + kBM. Warp w walks its items w,
// w + kWarps, ... (R rows each), each in C / CH channel chunks, each chunk
// in stages of kNS neighbors. Lane l owns row l / LR of the item and
// kernel points g, g + LR, ... (g = l % LR) over the chunk's CH channels:
// KT x CH fp32 sums. A stage's table rows come by cp.async into the
// warp's ring, kStages - 1 stages ahead across chunks and items. Per
// neighbor a lane computes its KT anchor weights (anchor_weight, as the
// template: each weight once a chunk) and adds w * G over the chunk's
// channels by fmaf, the neighbors in order (a loop not unrolled: more
// registers for the sums), so F is bitwise the template's. After a
// chunk's last stage the lanes write their runs into the warp's store
// tile (one of their kernel points at a time) and read them back by runs
// of F, stored whole (LR lanes a run of CH channels), evict-first. No
// block barrier after the staging; no atomics.
template <int KT, int CH>
__global__ void __launch_bounds__(kThreads, kBlocks)
inter_f_f32_kernel(const float* __restrict__ gx, const int* __restrict__ idx,
                   const float* __restrict__ table,
                   const float* __restrict__ rk, const float* __restrict__ k2,
                   float* __restrict__ F, int M, int p2, int nn, int q, int C,
                   float inv_sigma) {
  using S = Shape<KT, CH>;
  using L = Smem<KT, CH>;
  constexpr int LR = S::LR, R = S::R, P = S::P;
  constexpr int NL = 32 / P;       // neighbors a gather pass
  extern __shared__ __align__(16) unsigned char ff_smem[];
  float4* s_gx = reinterpret_cast<float4*>(ff_smem);
  int* s_idx = reinterpret_cast<int*>(ff_smem + L::idx);
  long long* s_rtb = reinterpret_cast<long long*>(ff_smem + L::rtb);
  int* s_lp = reinterpret_cast<int*>(ff_smem + L::lp);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* ring = reinterpret_cast<float*>(ff_smem + L::ring) +
                warp * L::ring_warp;
  float4* tile = reinterpret_cast<float4*>(ff_smem + L::tile) +
                 warp * L::tile_warp;
  const int m0 = blockIdx.x * kBM, pt0 = m0 / kNA;
  const int np = (min(m0 + kBM, M) - 1) / kNA - pt0 + 1;
  epn_inter::stage_neighbors(s_gx, s_idx, gx, idx, pt0, np, nn, tid,
                             kThreads);
  if (tid < kBM) {
    const int gm = m0 + tid, pt = gm / kNA, a = gm - pt * kNA;
    s_rtb[tid] = ((long long)(pt / p2) * q * kNA + a) * C;
    s_lp[tid] = gm < M ? pt - pt0 : -1;
  }
  __syncthreads();

  // the warp's items: w + kWarps * i whose first row is below M, C / CH
  // chunks each, ns_all stages of kNS neighbors a chunk
  int items = 0;
  while (items < S::G && m0 + R * (warp + kWarps * items) < M) ++items;
  const int ns_all = (nn + kNS - 1) / kNS, nch = C / CH;
  const int steps = items * nch * ns_all;

  // the next step to gather (gt; its item gi, chunk gc, stage gs) into
  // ring stage gslot: lane (c4, nl) copies float4 c4 of neighbors nl,
  // nl + NL, ... of each of the item's rows (zeros for the shadow index and
  // past nn, nothing for a row past M); one commit group, empty past the
  // last step
  const int c4 = lane % P, nl = lane / P;
  int gt = 0, gi = 0, gc = 0, gs = 0, gslot = 0;
  auto gather_next = [&]() {
    if (gt < steps) {
      const int r0 = R * (warp + kWarps * gi), n0 = gs * kNS;
      float* dst = ring + gslot * R * L::RS + 4 * c4;
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int lp = s_lp[r0 + u];
        const float* tb = table + s_rtb[r0 + u] + gc * CH + 4 * c4;
        const int* ix = s_idx + max(lp, 0) * nn + n0;
#pragma unroll
        for (int n = nl; n < kNS; n += NL) {
          const int j = lp >= 0 && n0 + n < nn ? ix[n] : q;
          const bool live = j < q;
          tc::cp16(tc::smem_addr(dst + u * L::RS + n * CH),
                   live ? tb + (size_t)j * kNA * C : table, live);
        }
      }
      if (++gs == ns_all) {
        gs = 0;
        if (++gc == nch) {
          gc = 0;
          ++gi;
        }
      }
    }
    tc::cp_commit();
    ++gt;
    gslot = gslot + 1 == kStages ? 0 : gslot + 1;
  };
  for (int i = 0; i < kStages - 1; ++i) gather_next();

  // the lane's row u of the item and kernel points g + LR j
  const int u = lane / LR, g = lane % LR;
  float acc[KT][CH];
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[j][c] = 0.f;
  int slot = 0;
  for (int it = 0; it < items; ++it) {
    const int row = R * (warp + kWarps * it) + u;
    const int a = (m0 + row) % kNA, lp = s_lp[row];
    float4 r[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int k = g + LR * j;
      const float* rp = rk + ((size_t)a * kK + k) * 3;
      r[j] = make_float4(__ldg(rp), __ldg(rp + 1), __ldg(rp + 2),
                         __ldg(k2 + k));
    }
    const float4* g4 = s_gx + max(lp, 0) * nn;
    for (int ch = 0; ch < nch; ++ch) {
      for (int s = 0; s < ns_all; ++s) {
        gather_next();
        tc::cp_wait<kStages - 1>();
        __syncwarp();
        const float* Gr = ring + slot * R * L::RS + u * L::RS;
        const int n0 = s * kNS, ns = min(kNS, nn - n0);
#pragma unroll 1
        for (int n = 0; n < ns; ++n) {
          add_neighbor(acc, g4[n0 + n], r, inv_sigma, [&](int h) {
            return *reinterpret_cast<const float4*>(Gr + n * CH + 4 * h);
          });
        }
        __syncwarp();  // this ring stage is refilled by the next gather
        slot = slot + 1 == kStages ? 0 : slot + 1;
      }
      // the chunk's F, one of the lane's kernel points at a time: each
      // lane's run (kernel point g + LR j of row u) into the tile at
      // [u][g][h ^ g % P], then read back by runs, float4 hh = e % P of
      // run e / P (e = i * LR + g), and stored evict-first: LR lanes a
      // whole run of CH channels
      float* out = F + (size_t)(m0 + row) * kK * C + ch * CH;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int h = 0; h < P; ++h) {
          tile[u * S::TS + g * P + (h ^ (g % P))] =
              make_float4(acc[j][4 * h], acc[j][4 * h + 1],
                          acc[j][4 * h + 2], acc[j][4 * h + 3]);
          acc[j][4 * h] = acc[j][4 * h + 1] = 0.f;
          acc[j][4 * h + 2] = acc[j][4 * h + 3] = 0.f;
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const int e = i * LR + g, run = e / P, hh = e % P;
          const float4 v = tile[u * S::TS + run * P + (hh ^ (run % P))];
          if (lp >= 0) {
            tc::st_stream16(out + (size_t)(run + LR * j) * C + 4 * hh,
                            make_uint4(__float_as_uint(v.x),
                                       __float_as_uint(v.y),
                                       __float_as_uint(v.z),
                                       __float_as_uint(v.w)));
          }
        }
        __syncwarp();  // the tile is written again next
      }
    }
  }
  tc::cp_wait<0>();
}

template <int CH>
int launch(const void* gx, const void* idx, const void* table,
           const void* rk, const void* k2, void* F, int M, int p2, int nn,
           int q, int C, float sigma, cudaStream_t stream) {
  using L = Smem<kKT, CH>;
  auto kern = inter_f_f32_kernel<kKT, CH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::total);
  if (err != cudaSuccess) return (int)err;
  kern<<<(M + kBM - 1) / kBM, kThreads, L::total, stream>>>(
      (const float*)gx, (const int*)idx, (const float*)table,
      (const float*)rk, (const float*)k2, (float*)F, M, p2, nn, q, C,
      1.f / sigma);
  return (int)cudaGetLastError();
}

}  // namespace ff32

// ----------------------------- fp32 W-fused forward on the CUDA cores

namespace fwf32 {

using epn_inter::add_neighbor;

constexpr int kNA = 60;             // anchors: the rows of a point
constexpr int kK = 24;              // kernel points
constexpr int kBM = 64;             // rows a block
constexpr int kKT = kK / 8;         // kernel points a build lane
constexpr int kLR = kK / kKT;       // build lanes a row
constexpr int kR = 32 / kLR;        // rows a build item
constexpr int kNS = 8;              // neighbors a gather stage
constexpr int kSK = 16;             // W rows a slice
constexpr int kWStages = 3;         // W ring slices
constexpr int kPF = 1;              // product fragments loaded ahead
constexpr int kMaxNN = 64;
constexpr int kMaxNP = (kBM - 1) / kNA + 2;  // points a block touches
constexpr int kSR = kBM;            // F slab stride: a (k, c) row's kBM rows

// The slab column of block row `row` in the rows of kernel point k: the
// row's float4 group XOR k % 8, so that the eight kernel points a build
// warp stores at once fall in different banks (a group stays whole; no
// padding, so that three blocks an SM fit at 64 columns)
__device__ __forceinline__ int slab_col(int row, int k) {
  return row ^ (4 * (k & 7));
}
using mma::kSmemPerSM;
static_assert(kK % kKT == 0 && 32 % kLR == 0, "build lanes");

// The block shape by the columns a block owns (BN = D up to 256): its
// threads NT, the channels a chunk CH (the F slab is [24 CH][kBM]) and its
// warps' gather ring stages GS. At 256 columns one block an SM of 8 x 8
// sums a thread, F built 16 channels a chunk; below, 8 channels a chunk,
// so that two or three blocks an SM fit and overlap one another's F build
// and barriers (inter_conv_variants.py times each choice)
template <int BN>
struct Shape {
  static constexpr int NT = BN == 256 || BN == 128 ? 256 : 128;
  static constexpr int CH = BN == 256 ? 16 : 8, GS = BN == 256 ? 3 : 2;
};

// A block owns kBM rows and BN columns, NT threads, CH channels a chunk.
// The F build: warp w builds rows w RW .. + RW, kItems items of kR rows; a
// gather stage is kNS neighbors of an item's rows, kP float4 a (row,
// neighbor). The product: thread (ty, tx) owns rows ty TM .. + TM and
// columns q * BN / NQ + 4 tx .. + 4 (q < NQ): TM x TN sums; a warp's lanes
// are 4 ty by 8 tx (a quarter-warp's A loads one address, its B loads 128
// contiguous bytes).
// A W slice is kSK rows of W: KPS kernel points' CH channels; SPC slices a
// chunk.
template <int BN>
struct Cfg {
  static constexpr int NT = Shape<BN>::NT, CH = Shape<BN>::CH;
  static constexpr int kStages = Shape<BN>::GS;  // gather ring stages
  static constexpr int kWarps = NT / 32, RW = kBM / kWarps, kItems = RW / kR;
  static constexpr int kP = CH / 4, RS = kNS * CH + 4;
  static constexpr int kOut = kBM * BN / NT;  // sums a thread
  static constexpr int TN = kOut >= 64 ? 8 : 4, NQ = TN / 4, TM = kOut / TN;
  static constexpr int TX = BN / TN, TY = NT / TX, WX = TX / 8;
  static constexpr int KPS = kSK / CH, SPC = kK / KPS;
  // dynamic shared memory, in bytes from the base: the F slab [24 CH][kSR]
  // (k-major: a row a (k, c), c fastest, holding the block's kBM rows at
  // slab_col); the W ring [kWStages][kSK][BN]; each warp's gather ring
  // [kStages][kR][RS]; the block's points' neighbor coordinates
  // [kMaxNP][nn] float4 (x, y, z, |gx|^2) and indices; each row's table
  // offset and local point (-1 past M)
  static constexpr size_t wring = (size_t)kK * CH * kSR * sizeof(float);
  static constexpr size_t gring = wring + (size_t)kWStages * kSK * BN * 4;
  static constexpr size_t gring_warp = (size_t)kStages * kR * RS;  // float
  static constexpr size_t gx = gring + kWarps * gring_warp * sizeof(float);
  static constexpr size_t idx = gx + (size_t)kMaxNP * kMaxNN * sizeof(float4);
  static constexpr size_t rtb = idx + (size_t)kMaxNP * kMaxNN * sizeof(int);
  static constexpr size_t lp = rtb + (size_t)kBM * sizeof(long long);
  static constexpr size_t total = lp + (size_t)kBM * sizeof(int);
  // blocks an SM the shared memory holds (each keeps 1 KB for the system)
  static constexpr int kBlocks = (int)(kSmemPerSM / (total + 1024));
  static_assert(RW % kR == 0 && TX * TY == NT && TM * TY == kBM &&
                    TX % 8 == 0 && TY % 4 == 0 && CH % 4 == 0 && TM % 4 == 0 &&
                    kSK % CH == 0 && kK % KPS == 0 && kBlocks >= 1 &&
                    total <= kMaxSmem,
                "block shape");
};

// four consecutive floats of shared memory into x[0 .. 4] (one 16-byte load)
__device__ __forceinline__ void lds4(float* x, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

// out [M, D] (fp32) for rows m0 .. m0 + kBM and columns n0 .. n0 + BN. Per
// chunk of CH channels, phase 1 builds the F slab: warp w builds its rows
// w RW .. + RW as items of kR rows, lane (u, g) row u of the item and
// kernel points g, g + 8, g + 16 over the chunk's channels (3 CH sums,
// each anchor weight once a chunk), by add_neighbor over the neighbors in
// order (F bitwise the template's); each stage of kNS neighbors' table
// rows comes by cp.async into the warp's gather ring, kStages - 1 stages
// ahead (the next chunk's first stages go out during the last W slice),
// so each table row is gathered once a chunk. Phase 2 multiplies the slab
// by the chunk's 24 CH W rows, a slice of kSK rows at a time through a
// cp.async ring that runs ahead across chunks: TM x TN sums a thread, the
// fragments of (k, c) row kc (the thread's TM slab rows, its TN W
// columns: float4 loads) loaded while row kc - 1's FFMA run; the sums stay
// in registers over all chunks. One barrier a W slice and one a chunk;
// below 256 columns two or three blocks an SM, so that one block's F build
// and barriers overlap another's product; no atomics.
template <int BN>
__global__ void __launch_bounds__(Cfg<BN>::NT, Cfg<BN>::kBlocks)
inter_fwd_f32_kernel(const float* __restrict__ gx,
                     const int* __restrict__ idx,
                     const float* __restrict__ table,
                     const float* __restrict__ rk,
                     const float* __restrict__ k2,
                     const float* __restrict__ W, float* __restrict__ out,
                     int M, int p2, int nn, int q, int C, int D,
                     float inv_sigma) {
  using G = Cfg<BN>;
  constexpr int CH = G::CH, RS = G::RS, kP = G::kP;
  constexpr int kStages = G::kStages;
  extern __shared__ __align__(16) unsigned char fw_smem[];
  float* slab = reinterpret_cast<float*>(fw_smem);
  float* wring = reinterpret_cast<float*>(fw_smem + G::wring);
  float4* s_gx = reinterpret_cast<float4*>(fw_smem + G::gx);
  int* s_idx = reinterpret_cast<int*>(fw_smem + G::idx);
  long long* s_rtb = reinterpret_cast<long long*>(fw_smem + G::rtb);
  int* s_lp = reinterpret_cast<int*>(fw_smem + G::lp);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* gring = reinterpret_cast<float*>(fw_smem + G::gring) +
                 warp * G::gring_warp;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int pt0 = m0 / kNA;
  const int np = (min(m0 + kBM, M) - 1) / kNA - pt0 + 1;
  const int nch = C / CH, w_steps = nch * G::SPC;

  // W slice st (chunk st / SPC, kernel points KPS (st % SPC) ..) into ring
  // stage st % kWStages: slice row r is W row (k0 + r / CH) * C + c0 +
  // r % CH; one commit group, empty past the last slice
  auto load_w = [&](int st) {
    if (st < w_steps) {
      const int c0 = st / G::SPC * CH, k0 = st % G::SPC * G::KPS;
      float* dst = wring + (st % kWStages) * kSK * BN;
#pragma unroll
      for (int e = tid; e < kSK * BN / 4; e += G::NT) {
        const int r = e / (BN / 4), c4 = e % (BN / 4) * 4;
        tc::cp16(tc::smem_addr(dst + r * BN + c4),
                 W + ((size_t)(k0 + r / CH) * C + c0 + r % CH) * D + n0 + c4,
                 true);
      }
    }
    tc::cp_commit();
  };
#pragma unroll
  for (int s = 0; s < kWStages - 1; ++s) load_w(s);

  epn_inter::stage_neighbors(s_gx, s_idx, gx, idx, pt0, np, nn, tid, G::NT);
  if (tid < kBM) {
    const int gm = m0 + tid, pt = gm / kNA, a = gm - pt * kNA;
    s_rtb[tid] = ((long long)(pt / p2) * q * kNA + a) * C;
    s_lp[tid] = gm < M ? pt - pt0 : -1;
  }
  __syncthreads();

  // the warp's items (rows RW warp + kR i ..) whose first row is below M;
  // a chunk's gather steps: its items' stages of kNS neighbors
  int items = 0;
  while (items < G::kItems && m0 + G::RW * warp + kR * items < M) ++items;
  const int ns_all = (nn + kNS - 1) / kNS, spc = items * ns_all;

  // gather step t (chunk t / spc, item, stage) into ring slot t %
  // kStages: the stage's float4 (u, n, c4) of the item's rows, lane by
  // lane (zeros for the shadow index, past nn and past M); no commit
  auto gather = [&](int t) {
    const int ch = t / spc, rest = t - ch * spc;
    const int it = rest / ns_all, nb = (rest - it * ns_all) * kNS;
    const int r0 = G::RW * warp + kR * it;
    float* dst = gring + (t % kStages) * kR * RS;
#pragma unroll
    for (int e = lane; e < kR * kNS * kP; e += 32) {
      const int u = e / (kNS * kP), n = e / kP % kNS, c4 = e % kP;
      const int lp = s_lp[r0 + u];
      const int j = lp >= 0 && nb + n < nn ? s_idx[lp * nn + nb + n] : q;
      const bool ok = j < q;
      tc::cp16(tc::smem_addr(dst + u * RS + n * CH + 4 * c4),
               ok ? table + s_rtb[r0 + u] + ch * CH + 4 * c4 +
                        (size_t)j * kNA * C
                  : table,
               ok);
    }
  };
  // the first kStages - 1 steps of chunk ch, kStages - 1 commit groups
  auto prefetch = [&](int ch) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (ch < nch && s < spc) gather(ch * spc + s);
      tc::cp_commit();
    }
  };
  prefetch(0);

  const int u = lane / kLR, g = lane % kLR;
  const int tx = warp % G::WX * 8 + lane % 8;
  const int ty = warp / G::WX * 4 + lane / 8;
  float acc[G::TM][G::TN];
#pragma unroll
  for (int i = 0; i < G::TM; ++i)
#pragma unroll
    for (int j = 0; j < G::TN; ++j) acc[i][j] = 0.f;

  for (int ch = 0, st = 0; ch < nch; ++ch) {
    // phase 1: the chunk's F slab, item by item
#pragma unroll 1
    for (int it = 0, t = ch * spc; it < G::kItems; ++it) {
      const int row = G::RW * warp + kR * it + u;
      float f[kKT][CH];
#pragma unroll
      for (int j = 0; j < kKT; ++j)
#pragma unroll
        for (int c = 0; c < CH; ++c) f[j][c] = 0.f;
      if (it < items) {
        const int a = (m0 + row) % kNA;
        float4 r[kKT];
#pragma unroll
        for (int j = 0; j < kKT; ++j) {
          const int k = g + kLR * j;
          const float* rp = rk + ((size_t)a * kK + k) * 3;
          r[j] = make_float4(__ldg(rp), __ldg(rp + 1), __ldg(rp + 2),
                             __ldg(k2 + k));
        }
        const float4* g4 = s_gx + max(s_lp[row], 0) * nn;
        for (int s = 0; s < ns_all; ++s, ++t) {
          if (t + kStages - 1 < (ch + 1) * spc) gather(t + kStages - 1);
          tc::cp_commit();
          tc::cp_wait<kStages - 1>();
          __syncwarp();
          const float* Gr = gring + (t % kStages) * kR * RS + u * RS;
          const int nb = s * kNS, ns = min(kNS, nn - nb);
#pragma unroll 1
          for (int n = 0; n < ns; ++n) {
            add_neighbor(f, g4[nb + n], r, inv_sigma, [&](int h) {
              return *reinterpret_cast<const float4*>(Gr + n * CH + 4 * h);
            });
          }
          __syncwarp();  // this ring slot is refilled by a later gather
        }
      }
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
        const int k = g + kLR * j;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          slab[(k * CH + c) * kSR + slab_col(row, k)] = f[j][c];
        }
      }
    }

    // phase 2: out += slab . W[the chunk's rows], a slice at a time
#pragma unroll 1
    for (int sl = 0; sl < G::SPC; ++sl, ++st) {
      tc::cp_wait<kWStages - 2>();
      __syncthreads();  // slice st and the slab visible; slice st - 1 done
      load_w(st + kWStages - 1);
      if (sl == G::SPC - 1) prefetch(ch + 1);
      const float* ws = wring + (st % kWStages) * kSK * BN + 4 * tx;
      const float* fa = slab + (size_t)sl * kSK * kSR;
      // the fragments of slab row kc (the thread's TM rows) and W row kc
      // (its TN columns), kPF rows ahead of their FFMA
      float a[kPF + 1][G::TM], b[kPF + 1][G::TN];
      auto frag = [&](int buf, int kc) {
        const int k = sl * G::KPS + kc / CH;
#pragma unroll
        for (int i = 0; i < G::TM; i += 4) {
          lds4(a[buf] + i, fa + kc * kSR + slab_col(ty * G::TM + i, k));
        }
#pragma unroll
        for (int qq = 0; qq < G::NQ; ++qq) {
          lds4(b[buf] + 4 * qq, ws + kc * BN + qq * (BN / G::NQ));
        }
      };
#pragma unroll
      for (int kc = 0; kc < kPF; ++kc) frag(kc, kc);
#pragma unroll
      for (int kc = 0; kc < kSK; ++kc) {
        if (kc + kPF < kSK) frag((kc + kPF) % (kPF + 1), kc + kPF);
        const int f = kc % (kPF + 1);
#pragma unroll
        for (int i = 0; i < G::TM; ++i)
#pragma unroll
          for (int j = 0; j < G::TN; ++j) {
            acc[i][j] = fmaf(a[f][i], b[f][j], acc[i][j]);
          }
      }
    }
    __syncthreads();  // every warp done with the slab before it is rebuilt
  }
  tc::cp_wait<0>();

#pragma unroll
  for (int i = 0; i < G::TM; ++i) {
    const int gm = m0 + ty * G::TM + i;
    if (gm < M) {
      float* op = out + (size_t)gm * D + n0 + 4 * tx;
#pragma unroll
      for (int qq = 0; qq < G::NQ; ++qq) {
        *reinterpret_cast<float4*>(op + qq * (BN / G::NQ)) =
            make_float4(acc[i][4 * qq], acc[i][4 * qq + 1],
                        acc[i][4 * qq + 2], acc[i][4 * qq + 3]);
      }
    }
  }
}

template <int BN>
int launch(const void* gx, const void* idx, const void* table,
           const void* rk, const void* k2, const void* W, void* out, int M,
           int p2, int nn, int q, int C, int D, float sigma,
           cudaStream_t stream) {
  using G = Cfg<BN>;
  auto kern = inter_fwd_f32_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::total);
  if (err == cudaSuccess) {
    // the shared memory of G::kBlocks blocks an SM, the rest L1
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((M + kBM - 1) / kBM, D / BN), G::NT, G::total, stream>>>(
      (const float*)gx, (const int*)idx, (const float*)table,
      (const float*)rk, (const float*)k2, (const float*)W, (float*)out, M,
      p2, nn, q, C, D, 1.f / sigma);
  return (int)cudaGetLastError();
}

}  // namespace fwf32

}  // namespace

// gx [b, p2, nn, 3], idx [b, p2, nn] int32 in [0, q] (q = shadow, zero row),
// table [b, q, na, C], rk [na, K, 3], k2 [K], W [K, C, D],
// out [b, p2, na, D]; table, W and out fp32, or bf16 when bf16 != 0. C must
// be a multiple of 8, K of 6, D of 32.
extern "C" int epn_inter_conv(const void* gx, const void* idx, const void* table,
                              const void* rk, const void* k2, const void* W,
                              void* out, int b, int p2, int nn, int q, int na,
                              int K, int C, int D, float sigma, int bf16,
                              void* stream) {
  if (C % CC != 0 || K % KG != 0 || D % 32 != 0 || nn < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return dispatch<epn::bf16>(gx, idx, table, rk, k2, W, out, b, p2, nn, q,
                               na, K, C, D, sigma, s);
  }
  return dispatch<float>(gx, idx, table, rk, k2, W, out, b, p2, nn, q, na, K,
                         C, D, sigma, s);
}

// W-off mode (the SGEMM template): gx, idx, rk, k2 as above, table
// [b, q, na, C] and F [b, p2, na, K, C]: fp32, or bf16 when bf16 != 0 (the
// anchor weights rounded to bf16, F summed in fp32 and rounded once). C
// must be a multiple of 8, K of 6.
extern "C" int epn_inter_conv_f(const void* gx, const void* idx,
                                const void* table, const void* rk,
                                const void* k2, void* F, int b, int p2, int nn,
                                int q, int na, int K, int C, float sigma,
                                int bf16, void* stream) {
  if (C % CC != 0 || K % KG != 0 || nn < 1) return (int)cudaErrorInvalidValue;
  const float* g = (const float*)gx;
  const int* ix = (const int*)idx;
  const float* r = (const float*)rk;
  const float* kk = (const float*)k2;
  cudaStream_t s = (cudaStream_t)stream;
  // 256 threads a block, 128 rows (64 rows, 128 threads, where their
  // neighbors do not fit); no W slabs in shared memory
  if (bf16) {
    return launch_rows<128, epn::bf16, true>(
        g, ix, (const epn::bf16*)table, r, kk, nullptr, (epn::bf16*)F,
        b * p2 * na, p2, nn, q, na, K, C, 0, sigma, s);
  }
  return launch_rows<128, float, true>(g, ix, (const float*)table, r, kk,
                                       nullptr, (float*)F, b * p2 * na, p2,
                                       nn, q, na, K, C, 0, sigma, s);
}

// bf16 W-off F on tensor cores (inter_f_mma_kernel): gx, idx, table, rk, k2
// and F as epn_inter_conv_f with a bf16 table and F. K must be 24, C a
// positive multiple of 32, 1 <= nn <= 64 and na >= 4.
extern "C" int epn_inter_conv_f_mma(const void* gx, const void* idx,
                                    const void* table, const void* rk,
                                    const void* k2, void* F, int b, int p2,
                                    int nn, int q, int na, int K, int C,
                                    float sigma, void* stream) {
  if (K != mma::kK || C < mma::kCC || C % mma::kCC != 0 || nn < 1 ||
      nn > mma::kMaxNN || na < mma::kMinNA) {
    return (int)cudaErrorInvalidValue;
  }
  return mma::launch_f(gx, idx, table, rk, k2, F, b * p2 * na, p2, nn, q, na,
                       C, sigma, (cudaStream_t)stream);
}

// fp32 W-off F on the CUDA cores (inter_f_f32_kernel): gx, idx, table, rk,
// k2 and F as epn_inter_conv_f with an fp32 table and F. K must be 24, na
// 60, C a positive multiple of 16 and 1 <= nn <= 64.
extern "C" int epn_inter_conv_f_f32(const void* gx, const void* idx,
                                    const void* table, const void* rk,
                                    const void* k2, void* F, int b, int p2,
                                    int nn, int q, int na, int K, int C,
                                    float sigma, void* stream) {
  if (K != ff32::kK || na != ff32::kNA || C < 16 || C % 16 != 0 || nn < 1 ||
      nn > ff32::kMaxNN) {
    return (int)cudaErrorInvalidValue;
  }
  const int M = b * p2 * na;
  cudaStream_t s = (cudaStream_t)stream;
  if (C % ff32::kCH == 0) {
    return ff32::launch<ff32::kCH>(gx, idx, table, rk, k2, F, M, p2, nn, q, C,
                                   sigma, s);
  }
  return ff32::launch<16>(gx, idx, table, rk, k2, F, M, p2, nn, q, C, sigma,
                          s);
}

// bf16 on tensor cores (the production mode's W-fused forward): gx, idx,
// table, rk, k2, W and out as epn_inter_conv with a bf16 table, W and out.
// K must be 24, C a multiple of 32, D of 32, 1 <= nn <= 64 and na >= 4.
extern "C" int epn_inter_conv_mma(const void* gx, const void* idx,
                                  const void* table, const void* rk,
                                  const void* k2, const void* W, void* out,
                                  int b, int p2, int nn, int q, int na, int K,
                                  int C, int D, float sigma, void* stream) {
  if (K != mma::kK || C % mma::kCC != 0 || D % 32 != 0 || nn < 1 ||
      nn > mma::kMaxNN || na < mma::kMinNA) {
    return (int)cudaErrorInvalidValue;
  }
  const int M = b * p2 * na;
  cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto bn) {
    return mma::launch_any<decltype(bn)::value>(gx, idx, table, rk, k2, W,
                                                out, M, p2, nn, q, na, C, D,
                                                sigma, s);
  };
  if (D % 256 == 0) return go(std::integral_constant<int, 256>());
  if (D % 128 == 0) return go(std::integral_constant<int, 128>());
  if (D % 64 == 0) return go(std::integral_constant<int, 64>());
  return go(std::integral_constant<int, 32>());
}

// fp32 W-fused forward on the CUDA cores (inter_fwd_f32_kernel): gx, idx,
// table, rk, k2, W and out as epn_inter_conv with an fp32 table, W and
// out. K must be 24, na 60, C a positive multiple of 16, D of 32 and
// 1 <= nn <= 64.
extern "C" int epn_inter_conv_fwd_f32(const void* gx, const void* idx,
                                      const void* table, const void* rk,
                                      const void* k2, const void* W,
                                      void* out, int b, int p2, int nn, int q,
                                      int na, int K, int C, int D, float sigma,
                                      void* stream) {
  if (K != fwf32::kK || na != fwf32::kNA || C < 16 || C % 16 != 0 ||
      D < 32 || D % 32 != 0 || nn < 1 ||
      nn > fwf32::kMaxNN || b < 0 || p2 < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int M = b * p2 * na;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto bn) {
    return fwf32::launch<decltype(bn)::value>(gx, idx, table, rk, k2, W, out,
                                              M, p2, nn, q, C, D, sigma, s);
  };
  if (D % 256 == 0) return go(std::integral_constant<int, 256>());
  if (D % 128 == 0) return go(std::integral_constant<int, 128>());
  if (D % 64 == 0) return go(std::integral_constant<int, 64>());
  return go(std::integral_constant<int, 32>());
}
