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
// at L1 for b=12 and F more, so in this fused form neither exists in device
// memory (the W-off mode below reads a dF its caller formed).
// Element type: the table, W and dout are fp32, or bf16 in the production
// mode, widened on load (elem.cuh); products, sums, dT's atomics and dW
// stay fp32 (the caller rounds dT to the table's type, as _fgcw_bwd rounds
// its fp32 dTable).
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
// W-off mode of dTable (template flag kWOff, epn_inter_conv_dg): dF
// [b, p2, na, K, C] (fp32, or bf16 widened on load) comes from device
// memory (the caller formed it as dout W^T) and each chunk's slab is loaded
// instead of formed; the scatter is the same. In bf16 both modes round at
// the TPU kernels' points, as the plain versions do: dF (fused mode), the
// anchor weights and each slot's sum (the TPU's dG is stored in bf16)
// rounded to bf16 before the fp32 atomics. It replaces _call ->
// _bwd_kernel (the VJP of
// fused_gather_neighbor_conv / fused_neighbor_conv, and the composed
// backward of _fgcw_bwd:1685-1703) together with the one-hot fold of dG
// onto the table rows that follows it there (_fgcw_bwd:1692-1696,
// _fgnc_bwd:802-805): the scatter is that fold, so dG [b, p2, nn, na, C]
// never exists. What bounds it: reading dF (K * C elements a row) against
// the scatter's 2 * nn * K * C flops a row and the weights recomputed per
// chunk (~9 * nn * K a row and chunk): near the card's balance point.
//
// dW (inter_dw_kernel; fp32 shapes off the CUDA-core kernel's envelope
// and bf16 shapes off the tensor-core one's): a block owns one chunk of 8
// channels (192 (k, cc)
// rows of dW), BN = 64 or 128 columns of d, and one range of rows. Per
// 64-row sub-tile it rebuilds the F slab with the forward's builder
// (inter_conv_common.cuh) and stages the dout slab, then accumulates
// F^T dout with 12 x (BN / 16) outputs a thread. Each row range writes its
// own partial dW to a workspace; a second launch (split_sum.cuh) adds the
// partials in a fixed order, so dW is deterministic. In bf16 (shapes off
// the tensor-core kernel's envelope) the anchor weights and F are rounded
// to bf16 where the TPU kernels round them (build_f_item<bf16, true>).
//
// bf16 on tensor cores (inter_bwd_mma_kernel; epn_inter_conv_bwd_table_mma,
// epn_inter_conv_dg_mma): the fused dTable and the W-off dG of every model
// layer (60 anchors, 24 kernel points, C % 16 == 0, nn <= 64), at the TPU
// kernels' rounding points: dF rounded to bf16 (_bwd_gather_w_kernel:1120;
// the W-off dF is bf16 already), the anchor weights rounded to bf16
// (:1133; _bwd_kernel:573), each slot's sum over k rounded to bf16 (:1158;
// _bwd_kernel:580-581), the fold onto the table rows in fp32 (:1166), dT
// rounded once by the caller (_fgcw_bwd:1683). A block owns 2 whole points
// (all 60 anchors: 120 rows) and 16 channels. The fused entry forms the bf16
// dF slab [120 x 24 x 16] by mma.sync.m16n8k16 (dout rows against W's
// (k, c) rows, 3 pieces of 8 kernel points, 32-deep d slices through a
// 3-stage cp.async ring, a fresh accumulator a slice); the W-off entry loads
// it by cp.async. Then a warp (16 a block) takes one (point, anchor) row at
// a time: the slot contraction G [16 slots, 16 c] = w [16, 24] dF [24, 16]
// runs on mma.sync with the anchor weights computed once a block into the
// A fragments, and each slot's 16 rounded sums of one anchor (64 contiguous
// bytes of dT) go out as vector reductions (atomicAdd on float4, compute
// capability 9.x): one operation per 16 bytes, a warp instruction covering
// 16 whole 32-byte sectors on 8 table rows, where the template issues 8
// scalar atomics into each sector from 32 rows. Work a call: M * nn * C
// fp32 reductions (~377 M at every cls layer at b=12), the dF product's
// 2 * M * 24 * C * D operations, ~12 operations a slot, anchor and kernel
// point for the weights (once for each of the C / 16 channel blocks). What
// holds it back (inter_bwd_variants.py on the H100): in the W-off dG the
// reductions (without them 36% less time; scalar ones 3.3x the time); in
// the fused dTable its phases in turn, one block an SM (without the
// product's mma 4% less time, without the reductions 6%, without the
// weights 12%; 8 warps a block 11% more).
//
// bf16 dW on tensor cores (inter_dw_mma_kernel; epn_inter_conv_bwd_w_mma):
// the fused dW of every fused-route model layer (60 anchors, 24 kernel
// points, C % 16 == 0, D % 64 == 0, nn <= 64), at the TPU kernels' rounding
// points: the anchor weights rounded to bf16 (_bwd_gather_w_kernel:1133,
// _bwd_kernel_dw2:1309), F summed in fp32 and rounded to bf16 (:1140,
// :1315), dW = F^T dout summed in fp32 (fp32 out; the caller's cast to W's
// bf16 rounds it once, as _fgcw_bwd rounds dw32). The tile: a block owns
// 16 channels (the 384 (k, cc) rows of its dW) and 64 columns of d over a
// range of rows (a split), 8 warps of 96 x 32 outputs: 96 fp32
// accumulators a thread (255 registers, no spills; 32 channels would need
// 192). Per 64-row tile it builds the bf16 F slab [64, 384] as the
// forward's phase 1 does (gathered table rows by cp.async, F^T = G^T w on
// mma.sync with the anchor weights computed and rounded in the B
// fragments) and adds slab^T . dout on mma.sync (both operands by
// ldmatrix.trans, a fresh accumulator every two k16 steps added by a
// rounding fp32 add: the mma's truncating accumulation would lean dW
// toward zero over a split's thousands of k16 steps). Two sets of tile
// buffers pipeline it: the next tile's gathers and dout rows (cp.async)
// and its successor's neighbors (loads into registers) are in flight while
// the product runs. Each split writes its partial; split_sum.cuh adds them
// in a fixed order (no atomics: bitwise the same on every call). Work a
// call: the product's 2 * M * 24 * C * D operations and the F build's
// 2 * M * nn * 24 * C, the F build repeated for each of the D / 64 column
// blocks. What holds it back (inter_bwd_variants.py on the H100, the cls
// b=12 step's six calls): the F build, 62% of the time (the contraction
// with its anchor weights 43%, the gathers 23%), rebuilt D / 64 times;
// without the product's mma no time is saved (the fragment loads, the
// barriers and one block an SM are the rest). Sharing the slab across the
// column blocks of a thread-block cluster was slower at every layer.
//
// fp32 dW on the CUDA cores (inter_dw_f32_kernel; epn_inter_conv_bwd_w_f32):
// the fused dW of every fused-route model layer in fp32 (60 anchors, 24
// kernel points, C % 16 == 0, D % 64 == 0, nn <= 64), FFMA only (no TF32):
// F summed in fp32 in the template's order (F bitwise the template's), dW
// = F^T dout summed in fp32. A block owns 8 of the 24 kernel points, 16
// channels and all of D up to 256 columns, so no layer builds F twice (the
// template: 8 channels and at most 128 columns, F built twice at d = 256)
// and each neighbor's anchor weight serves 16 channels (the template's 8);
// the 3 kernel-point blocks of a row range gather the same table rows.
// Per 32-row tile: the table rows were gathered by cp.async into shared
// memory while the previous tile's product ran; each of 256 threads builds
// one (row, kernel point) item of the F slab; the product runs 8 x (D / 16)
// FFMA a thread from float4 loads of both operands; two barriers a tile.
// Two blocks an SM at D <= 128, one at 256 (its 128 accumulators a
// thread). Split partials summed in a fixed order (split_sum.cuh). Work a
// call: the product's 2 * M * 24 * C * D operations and the F build's
// 2 * M * nn * 24 * C, each once; the anchor weights once a 16-channel
// block. What holds it (inter_bwd_variants.py on the H100, the cls b=12
// step's six calls): the product alone runs at 63% of the fp32 rate (one
// torch.mm of F^T dout at 77%), and the F build, its gathers and the
// barriers, which no other block overlaps at D = 256, add half again.
//
// fp32 backward scatter on the CUDA cores (inter_bwd_f32_kernel;
// epn_inter_conv_bwd_table_f32, epn_inter_conv_dg_f32): the fused dTable
// and the W-off dG of every model layer in fp32 (60 anchors, 24 kernel
// points, C % 16 == 0, nn <= 64; the fused entry D % 16 == 0), FFMA only
// (no TF32), fp32 sums with no rounding points. A persistent block (one an
// SM, 16 warps) walks tiles of one whole point (its 60 anchor rows, so the
// neighbor list is shared) and 16 channels. The fused entry first writes
// W^T and dout^T into its workspace in the order its slices are read (two
// small launches), so that each 16-deep slice of either is contiguous;
// then 12 warps form each tile's dF slab [60, 24 x 16] by a
// register-blocked product, 8 x 8 outputs a thread from float4 loads of
// both operands, the slices arriving through a 3-stage cp.async ring that
// runs on from one tile to the next, while 4 warps scatter the last tile's
// slab: named barriers hand the slab over, so the scatter of a tile runs
// beside the next tile's product. Each dout row is loaded once a tile
// (the template: once for 8 channels), W's slice once a tile, nothing
// staged through registers. The W-off entry loads the slab from dF by
// cp.async into one of two slabs, the next tile's while all 16 warps
// scatter this one. The scatter gives each (anchor row, neighbor slot)
// item to a thread: the slot's 24 anchor weights once for 16 channels
// (the template: for 8), the 16 sums over k in registers (k in order),
// and four float4 vector reductions into dT (the template: 8 scalar
// atomics for 8 channels). Work a call: the product's 2 * M * 24 * C * D
// operations, the scatter's 2 * M * nn * 24 * C, the weights ~5 * M * nn
// * 24 * C / 16; M * nn * C / 4 vector reductions. What holds it back
// (inter_bwd_variants.py on the H100, the cls b=12 step's six calls): the
// product, 87% of the fused entry's time (without the scatter's writes),
// at 53% of the fp32 rate (48% at d = 64, 54% at d = 256); the scatter
// beside it adds 13% (after it, in a block of 12 warps, 21%); tiles of
// two points (half of W's 29 GB of L2 reads a cls step) gained 2.5%, two
// slots an item lost 3%. In the W-off dG the scatter is 81% of the time,
// its reductions 7%.

#include <cuda_runtime.h>

#include <type_traits>

#include "inter_conv_common.cuh"
#include "split_sum.cuh"
#include "tc.cuh"

namespace {

using epn_inter::add_neighbor;
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

// The dF slab [T_BM][FS] of channel chunk c0, formed by the GEMM of the
// block's dout rows against W (both staged T_BK d at a time): rows ty * 8 + i,
// columns tx + 32 * j; summed in fp32 and rounded to E (bf16 where the TPU
// kernel rounds dF, _bwd_gather_w_kernel:1120).
template <typename E>
__device__ __forceinline__ void df_slab_gemm(
    float* __restrict__ s_A, float* __restrict__ s_B, float* __restrict__ s_F,
    const E* __restrict__ W, const E* __restrict__ dout, int m0, int M, int C,
    int D, int c0, int tid) {
  const int tx = tid % 32, ty = tid / 32;
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
        v = epn::load4(dout + (size_t)(m0 + r) * D + d0 + 4 * q4);
      }
      s_A[(4 * q4) * T_BM + r] = v.x;
      s_A[(4 * q4 + 1) * T_BM + r] = v.y;
      s_A[(4 * q4 + 2) * T_BM + r] = v.z;
      s_A[(4 * q4 + 3) * T_BM + r] = v.w;
    }
    for (int e = tid; e < NCOL * T_BK / 4; e += T_THREADS) {
      const int col = e / (T_BK / 4), q4 = e % (T_BK / 4);
      const int k = col / CC, cc = col - k * CC;
      const float4 v =
          epn::load4(W + ((size_t)k * C + c0 + cc) * D + d0 + 4 * q4);
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
    for (int j = 0; j < 6; ++j) {
      s_F[(ty * 8 + i) * FS + tx + 32 * j] = epn::round_to<E>(acc[i][j]);
    }
  }
}

// The dF slab of channel chunk c0 read from dF [M, NK, C] in device memory
// (W-off mode; bf16 widened on load), a float4 (half a (row, k) chunk row)
// a thread; zeros for rows past M.
template <typename E>
__device__ __forceinline__ void df_slab_load(float* __restrict__ s_F,
                                             const E* __restrict__ dF,
                                             int m0, int M, int C, int c0,
                                             int tid) {
  constexpr int kRow4 = CC / 4;
  for (int e = tid; e < T_BM * NK * kRow4; e += T_THREADS) {
    const int row = e / (NK * kRow4), j = e - row * (NK * kRow4);
    const int k = j / kRow4, h = j - k * kRow4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + row < M) {
      v = epn::load4(dF + ((size_t)(m0 + row) * NK + k) * C + c0 + 4 * h);
    }
    *reinterpret_cast<float4*>(s_F + row * FS + 4 * j) = v;
  }
}

// In bf16 (E) the anchor weights and each slot's sum sum_k w dF are rounded
// to E (the TPU kernels' rounding points: _bwd_gather_w_kernel:1133, 1158;
// _bwd_kernel:573, 580-581), as the tensor-core scatter and the plain
// versions round them; the fold onto the table rows stays fp32.
// kWOff: dout is dF [M, NK, C]; W and D are unused, and each slot's sum
// sum_k w dF is rounded to E before it is added (the TPU kernel writes dG in
// dF's dtype before its fp32 fold onto the table rows)
template <typename E, bool kWOff>
__global__ void __launch_bounds__(T_THREADS)
inter_dtable_kernel(const float* __restrict__ gx, const int* __restrict__ idx,
                    const float* __restrict__ rk, const float* __restrict__ k2,
                    const E* __restrict__ W, const E* __restrict__ dout,
                    float* __restrict__ dT,
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
  const int m0 = blockIdx.x * T_BM;
  const int pt0 = m0 / na;
  const int np = (min(m0 + T_BM, M) - 1) / na - pt0 + 1;
  stage_neighbors(s_gx, s_idx, gx, idx, pt0, np, nn, tid, T_THREADS);

  for (int c0 = 0; c0 < C; c0 += CC) {
    if constexpr (kWOff) {
      __syncthreads();
      df_slab_load(s_F, dout, m0, M, C, c0, tid);
    } else {
      df_slab_gemm(s_A, s_B, s_F, W, dout, m0, M, C, D, c0, tid);
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
        const float w = epn::round_to<E>(anchor_weight(g, r, inv_sigma));
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
      for (int cc = 0; cc < CC; ++cc) {
        atomicAdd(dst + cc, epn::round_to<E>(v[cc]));
      }
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
template <typename E, int BN>
__global__ void __launch_bounds__(W_THREADS)
inter_dw_kernel(const float* __restrict__ gx, const int* __restrict__ idx,
                const E* __restrict__ table, const float* __restrict__ rk,
                const float* __restrict__ k2, const E* __restrict__ dout,
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
      build_f_item<E, std::is_same<E, epn::bf16>::value>(
          s_F + (size_t)row * FS + kg * KG * CC, table, rk, k2, s_gx, s_idx,
          m0 + row, m_end, pt0, p2, nn, q, na, NK, C, c0, kg, inv_sigma);
    }
    for (int e = tid; e < W_BM * BN / 4; e += W_THREADS) {
      const int r = e / (BN / 4), c4 = e % (BN / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < m_end) {
        v = epn::load4(dout + (size_t)(m0 + r) * D + n0 + 4 * c4);
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

template <typename E, int BN>
int launch_dw(const float* gx, const int* idx, const void* table,
              const float* rk, const float* k2, const void* dout, float* ws,
              float* dW, int M, int p2, int nn, int q, int na, int C, int D,
              float sigma, int splits, cudaStream_t stream) {
  const WSmem L = w_layout(BN, na, nn);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      inter_dw_kernel<E, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M + W_BM - 1) / W_BM;
  const int rows_per_split = (tiles + splits - 1) / splits * W_BM;
  dim3 grid(D / BN, C / CC, splits);
  inter_dw_kernel<E, BN><<<grid, W_THREADS, L.total, stream>>>(
      gx, idx, (const E*)table, rk, k2, (const E*)dout, ws, M, p2, nn, q, na, C,
      D, rows_per_split, 1.f / sigma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_splits(ws, dW, splits, (size_t)NK * C * D, stream);
}

template <typename E, bool kWOff = false>
int launch_dtable(const float* gx, const int* idx, const float* rk,
                  const float* k2, const void* W, const void* dout, float* dT,
                  int M, int p2, int nn, int q, int na, int C, int D,
                  float sigma, cudaStream_t stream) {
  const TSmem L = t_layout(na, nn);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      inter_dtable_kernel<E, kWOff>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  inter_dtable_kernel<E, kWOff><<<(M + T_BM - 1) / T_BM, T_THREADS, L.total,
                                  stream>>>(gx, idx, rk, k2, (const E*)W,
                                            (const E*)dout, dT, M, p2, nn, q,
                                            na, C, D, 1.f / sigma);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_dw_cols(const float* gx, const int* idx, const void* table,
                   const float* rk, const float* k2, const void* dout,
                   float* ws, float* dW, int M, int p2, int nn, int q, int na,
                   int C, int D, float sigma, int splits, cudaStream_t s) {
  if (D % 128 == 0) {
    return launch_dw<E, 128>(gx, idx, table, rk, k2, dout, ws, dW, M, p2, nn,
                             q, na, C, D, sigma, splits, s);
  }
  return launch_dw<E, 64>(gx, idx, table, rk, k2, dout, ws, dW, M, p2, nn, q,
                          na, C, D, sigma, splits, s);
}

// ------------------------------------------------- bf16 on tensor cores

namespace mma {

using epn::bf16;

constexpr int kNA = 60;             // anchors: the rows of a point
constexpr int kNP = 2;              // whole points a block
constexpr int kRows = kNP * kNA;    // (point, anchor) rows a block
constexpr int kBM = 128;            // the dF product's rows (kRows, padded)
constexpr int kCC = 16;             // channels a block
constexpr int kKP = 8;              // kernel points a piece of the product
constexpr int kPieces = NK / kKP;
constexpr int kBN = kKP * kCC;      // the product's columns a piece
constexpr int kSD = 32;             // d a slice: two k16 steps
constexpr int kStages = 3;          // slices in the ring
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kWN = 4;              // warps over a piece: 4 x 4 of 32 x 32
constexpr int kMI = kBM / (kWarps / kWN) / 16, kNI = kBN / kWN / 8;
constexpr int kMaxNN = 64;
static_assert(kRows <= kBM && kNI % 2 == 0, "block shape");

// dynamic shared memory, in bytes: the dF slab [kRows * NK][kCC] bf16 (row
// (point, anchor) * NK + k), the fused entry's ring of dout and W slices
// [kStages][kBM + kBN][kSD] bf16, the points' neighbor coordinates
// [kNP][nnp] float4 (x, y, z, 1 - |gx|^2 / sigma) and indices [kNP][nnp]
struct Smem {
  size_t ring, gx, idx, total;
};

__host__ __device__ inline Smem layout(bool woff, int nnp) {
  Smem s;
  s.ring = (size_t)kRows * NK * kCC * sizeof(bf16);
  s.gx = s.ring + (woff ? 0 : (size_t)kStages * (kBM + kBN) * kSD *
                                  sizeof(bf16));
  s.idx = s.gx + (size_t)kNP * nnp * sizeof(float4);
  s.total = s.idx + (size_t)kNP * nnp * sizeof(int);
  return s;
}

// Element offset of (r, col < kCC) in the slab, whose rows are two 16-byte
// chunks: the chunk is flipped every four rows, so that the eight rows an
// ldmatrix phase reads (eight kernel points of one row) fall in eight
// different bank groups.
__device__ __forceinline__ int slab_off(int r, int col) {
  return r * kCC + ((((col >> 3) ^ (r >> 2)) & 1) << 3) + (col & 7);
}

// dT[dst .. dst + 4] += v: one vector reduction (compute capability 9.x)
__device__ __forceinline__ void red4(float* dst, const float4& v) {
  atomicAdd(reinterpret_cast<float4*>(dst), v);
}

// the anchor weight of a neighbor v (x, y, z, 1 - |gx|^2 / sigma) and a
// rotated kernel point k (2 R kappa / sigma, -|kappa|^2 / sigma), in fp32
// as the forward kernel computes it
__device__ __forceinline__ float weight(const float4& v, const float4& k) {
  return fmaxf(fmaf(v.x, k.x, fmaf(v.y, k.y, fmaf(v.z, k.z, v.w + k.w))),
               0.f);
}

// The fused entry (kWOff false): dF = dout W^T rounded to bf16 into the
// slab by mma.sync, then the slot contraction and the scatter. The W-off
// entry: the bf16 slab loaded from dF [M, NK, C] by cp.async. Block
// (blockIdx.x, blockIdx.y) owns points kNP * blockIdx.x .. + kNP and
// channels kCC * blockIdx.y .. + kCC. dT [b, q, kNA, C] fp32 receives, for
// each live neighbor slot n of each point p and anchor a,
//   round_bf16(sum_k round_bf16(w[p, n, a, k]) dF[p, a, k, c])
// with the anchor weights computed once a block, in fp32 as the forward
// kernel computes them, and rounded in the mma fragment.
template <bool kWOff>
__global__ void __launch_bounds__(kThreads, 1)
inter_bwd_mma_kernel(const float* __restrict__ gx, const int* __restrict__ idx,
                     const float* __restrict__ rk,
                     const float* __restrict__ k2,
                     const bf16* __restrict__ W, const bf16* __restrict__ src,
                     float* __restrict__ dT, int P, int p2, int nn, int q,
                     int C, int D, float inv_sigma) {
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  const int nnp = (nn + 15) / 16 * 16;
  const Smem L = layout(kWOff, nnp);
  bf16* slab = reinterpret_cast<bf16*>(bwd_smem);
  bf16* ring = reinterpret_cast<bf16*>(bwd_smem + L.ring);
  float4* s_gx = reinterpret_cast<float4*>(bwd_smem + L.gx);
  int* s_idx = reinterpret_cast<int*>(bwd_smem + L.idx);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pt0 = blockIdx.x * kNP, c0 = blockIdx.y * kCC;
  const int np = min(kNP, P - pt0), rows = np * kNA;
  const size_t m0 = (size_t)pt0 * kNA;

  if constexpr (kWOff) {
    // the slab: 32 bytes a (row, k)
    for (int e = tid; e < rows * NK * 2; e += kThreads) {
      const int r = e >> 1, ch = e & 1;
      tc::cp16(tc::smem_addr(slab + slab_off(r, 8 * ch)),
               src + (m0 * NK + r) * C + c0 + 8 * ch, true);
    }
    tc::cp_commit();
  }

  // the points' neighbors; padded slots hold the shadow index
  for (int e = tid; e < kNP * nnp; e += kThreads) {
    const int p = e / nnp, n = e - p * nnp;
    float4 v = make_float4(0.f, 0.f, 0.f, 1.f);
    int j = q;
    if (p < np && n < nn) {
      const size_t s = (size_t)(pt0 + p) * nn + n;
      const float x = gx[3 * s], y = gx[3 * s + 1], z = gx[3 * s + 2];
      v = make_float4(x, y, z, 1.f - ((x * x + y * y) + z * z) * inv_sigma);
      j = idx[s];
    }
    s_gx[e] = v;
    s_idx[e] = j;
  }

  if constexpr (!kWOff) {
    // dF [rows, (k, cc)] = dout [rows, D] . W[k, c0 + cc, D]^T, a piece of
    // kKP kernel points (kBN columns) at a time over kSD-deep slices of d
    const int slices = D / kSD, steps = kPieces * slices;
    const bf16* dout = src;
    auto load = [&](int s) {
      const int piece = s / slices, d0 = (s - piece * slices) * kSD;
      bf16* sa = ring + (size_t)(s % kStages) * (kBM + kBN) * kSD;
      bf16* sb = sa + kBM * kSD;
      for (int e = tid; e < (kBM + kBN) * kSD / 8; e += kThreads) {
        const int r = e >> 2, c8 = (e & 3) * 8;
        if (r < kBM) {
          const bool ok = r < rows;
          tc::cp16(tc::smem_addr(sa + tc::swz(r, c8, kSD / 8)),
                   ok ? dout + (m0 + r) * D + d0 + c8 : dout, ok);
        } else {
          const int n = r - kBM, k = piece * kKP + n / kCC, cc = n % kCC;
          tc::cp16(tc::smem_addr(sb + tc::swz(n, c8, kSD / 8)),
                   W + ((size_t)k * C + c0 + cc) * D + d0 + c8, true);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < steps) load(s);
      tc::cp_commit();
    }
    const int wm = warp / kWN, wn = warp % kWN;
    float acc[kMI][kNI][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[mi][ni][h] = 0.f;
    for (int s = 0; s < steps; ++s) {
      tc::cp_wait<kStages - 2>();
      __syncthreads();
      if (s + kStages - 1 < steps) load(s + kStages - 1);
      tc::cp_commit();
      const bf16* sa = ring + (size_t)(s % kStages) * (kBM + kBN) * kSD;
      const bf16* sb = sa + kBM * kSD;
      // a slice's two k16 steps into a fresh accumulator, added to the
      // running sum by a rounding fp32 add (the mma's own accumulation
      // truncates)
      float f[kMI][kNI][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
          for (int h = 0; h < 4; ++h) f[mi][ni][h] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSD; kk += 16) {
        uint32_t af[kMI][4], bf[kNI][2];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          tc::ldsm4(af[mi], tc::smem_addr(sa + tc::swz(
                                wm * (kMI * 16) + mi * 16 + (lane & 15),
                                kk + (lane >> 4) * 8, kSD / 8)));
        }
#pragma unroll
        for (int nj = 0; nj < kNI / 2; ++nj) {
          uint32_t r4[4];
          tc::ldsm4(r4, tc::smem_addr(sb + tc::swz(
                            wn * (kNI * 8) + nj * 16 + (lane & 7) +
                                ((lane >> 4) << 3),
                            kk + ((lane >> 3) & 1) * 8, kSD / 8)));
          bf[2 * nj][0] = r4[0];
          bf[2 * nj][1] = r4[1];
          bf[2 * nj + 1][0] = r4[2];
          bf[2 * nj + 1][1] = r4[3];
        }
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNI; ++ni)
            tc::mma(f[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
          for (int h = 0; h < 4; ++h) acc[mi][ni][h] += f[mi][ni][h];
      if ((s + 1) % slices == 0) {
        // the piece rounded to bf16 into the slab (the TPU kernel's dF
        // slabs, _bwd_gather_w_kernel:1120)
        const int piece = s / slices;
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = wm * (kMI * 16) + mi * 16 + g + 8 * h;
              const int n = wn * (kNI * 8) + ni * 8 + 2 * t;
              if (r < rows) {
                *reinterpret_cast<uint32_t*>(
                    slab + slab_off(r * NK + piece * kKP + n / kCC,
                                    n % kCC)) =
                    epn::pack2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
              }
              acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0.f;
            }
      }
    }
    tc::cp_wait<0>();
  } else {
    tc::cp_wait<0>();
  }
  __syncthreads();

  // the slot contraction, a (point, anchor) row at a time a warp: for each
  // m16 tile of neighbor slots, G [16 slots, kCC] = w [16, 24 (k, padded
  // to 32)] . dF [24, kCC] on mma.sync, the anchor weights computed into the
  // A fragments (lane (g, t): slots g, g + 8; kernel points 2t, 2t + 1,
  // 2t + 8, 2t + 9, 2t + 16, 2t + 17) and rounded there; each slot's sum
  // rounded to bf16; lanes t, t ^ 1 trade halves so that each lane holds
  // four consecutive channels of a slot, added into dT by one vector
  // reduction (a slot's kCC channels of one anchor: 64 contiguous bytes)
  const float s2 = 2.f * inv_sigma;
  for (int it = warp; it < rows; it += kWarps) {
    const int p = it / kNA, a = it - p * kNA, r0 = it * NK;
    uint32_t b0[4], b1[2];
    tc::ldsm4t(b0, tc::smem_addr(slab + slab_off(
                       r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                       (lane >> 4) * 8)));
    tc::ldsm2t(b1, tc::smem_addr(slab + slab_off(r0 + 16 + (lane & 7),
                                                 ((lane >> 3) & 1) * 8)));
    float4 kr[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int kp = 2 * t + (j & 1) + 8 * (j >> 1);
      const float* rp = rk + ((size_t)a * NK + kp) * 3;
      kr[j] = make_float4(s2 * __ldg(rp), s2 * __ldg(rp + 1),
                          s2 * __ldg(rp + 2), -__ldg(k2 + kp) * inv_sigma);
    }
    const int pt = pt0 + p;
    float* dst = dT + ((size_t)(pt / p2) * q * kNA + a) * C + c0 +
                 ((t & 1) ? 2 * t + 6 : 2 * t);
    const float4* gp = s_gx + p * nnp;
    const int* ip = s_idx + p * nnp;
    for (int n0 = 0; n0 < nnp; n0 += 16) {
      const float4 gq[2] = {gp[n0 + g], gp[n0 + g + 8]};
      float w[2][6];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 6; ++j) w[u][j] = weight(gq[u], kr[j]);
      const uint32_t a0[4] = {epn::pack2(w[0][0], w[0][1]),
                              epn::pack2(w[1][0], w[1][1]),
                              epn::pack2(w[0][2], w[0][3]),
                              epn::pack2(w[1][2], w[1][3])};
      const uint32_t a1[4] = {epn::pack2(w[0][4], w[0][5]),
                              epn::pack2(w[1][4], w[1][5]), 0u, 0u};
      float c[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int h = 0; h < 4; ++h) c[nt][h] = 0.f;
        tc::mma(c[nt], a0, b0[2 * nt], b0[2 * nt + 1]);
        tc::mma(c[nt], a1, b1[nt], 0u);
#pragma unroll
        for (int h = 0; h < 4; ++h) c[nt][h] = epn::round_to<bf16>(c[nt][h]);
      }
      // even t keeps n-tile 0 (channels 2t .. 2t + 3), odd t n-tile 1
      // (channels 2t + 6 .. 2t + 9); each sends the other half
      const bool odd = t & 1;
      float x[4];
#pragma unroll
      for (int h = 0; h < 4; ++h)
        x[h] = __shfl_xor_sync(0xffffffffu, odd ? c[0][h] : c[1][h], 1);
      const float4 v[2] = {
          odd ? make_float4(x[0], x[1], c[1][0], c[1][1])
              : make_float4(c[0][0], c[0][1], x[0], x[1]),
          odd ? make_float4(x[2], x[3], c[1][2], c[1][3])
              : make_float4(c[0][2], c[0][3], x[2], x[3])};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = ip[n0 + g + 8 * u];
        if (j < q) red4(dst + (size_t)j * kNA * C, v[u]);
      }
    }
  }
}

template <bool kWOff>
int launch(const void* gx, const void* idx, const void* rk, const void* k2,
           const void* W, const void* src, void* dT, int b, int p2, int nn,
           int q, int C, int D, float sigma, cudaStream_t stream) {
  const int nnp = (nn + 15) / 16 * 16;
  const Smem L = layout(kWOff, nnp);
  auto kern = inter_bwd_mma_kernel<kWOff>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int P = b * p2;
  dim3 grid((P + kNP - 1) / kNP, C / kCC);
  kern<<<grid, kThreads, L.total, stream>>>(
      (const float*)gx, (const int*)idx, (const float*)rk, (const float*)k2,
      (const bf16*)W, (const bf16*)src, (float*)dT, P, p2, nn, q, C, D,
      1.f / sigma);
  return (int)cudaGetLastError();
}

}  // namespace mma

// ------------------------------------------- bf16 dW on tensor cores

namespace dwmma {

using epn::bf16;
using mma::slab_off;
using mma::weight;

constexpr int kNA = 60;                  // anchors: the rows of a point
constexpr int kBM = 64;                  // rows a tile: 4 k16 steps of dW
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kBM / kWarps;
constexpr int kCC = 16;                  // channels a block
constexpr int kKC = NK * kCC;            // slab columns: the block's dW rows
constexpr int kBN = 64;                  // d a block
constexpr int kWM = 4, kWN = 2;          // warps over [kKC, kBN]: 96 x 32
constexpr int kMI = kKC / kWM / 16, kNI = kBN / kWN / 8;
constexpr int kGroup = 2;                // k16 steps a fresh accumulator
constexpr int kMaxNN = 64;
constexpr int kMaxNP = (kBM - 1) / kNA + 2;  // points a tile's rows touch
static_assert(kMI * kWM * 16 == kKC && kNI * kWN * 8 == kBN && kNI % 2 == 0 &&
                  kBM % (16 * kGroup) == 0 && kCC == mma::kCC &&
                  kMaxNP * kMaxNN <= kThreads,
              "block shape");

// The slab's column order: lane (g, t) of the warp that builds a row holds
// F[cc][k] for cc = g + 8 h and k = 8 j + 2 t + e (h, e < 2, j < 3) and
// stores them as three 8-byte pieces, one a j, at columns 12 lane + 4 j +
// 2 h + e. The channel and kernel point of slab column col, for dW's rows:
__device__ __forceinline__ void slab_column(int col, int& cc, int& k) {
  const int lane = col / 12, r = col - 12 * lane, pos = r & 3;
  cc = (lane >> 2) + 8 * (pos >> 1);
  k = 8 * (r >> 2) + 2 * (lane & 3) + (pos & 1);
}

// dynamic shared memory, in bytes from the base: the F slab [kBM, kKC]
// (offset 0); two of each of the tile buffers, the current tile's and the
// next one's: the dout tile [kBM, kBN], the tile's points' neighbor
// coordinates [nbr] float4 (x, y, z, 1 - |gx|^2 / sigma) and indices
// [nbr] (nbr = kMaxNP * nnp), the rows' table offsets [kBM] and (point,
// anchor) [kBM]; then each warp's gathered table rows [kRowsPerWarp][nnp,
// kCC]
struct Smem {
  int nnp, nbr;
  size_t dout, gx, idx, rtb, ri, rows, total;
};

__host__ __device__ inline Smem layout(int nn) {
  Smem s;
  s.nnp = (nn + 15) / 16 * 16;
  s.nbr = kMaxNP * s.nnp;
  s.dout = (size_t)kBM * kKC * sizeof(bf16);
  s.gx = s.dout + 2 * (size_t)kBM * kBN * sizeof(bf16);
  s.idx = s.gx + 2 * (size_t)s.nbr * sizeof(float4);
  s.rtb = s.idx + 2 * (size_t)s.nbr * sizeof(int);
  s.ri = s.rtb + 2 * (size_t)kBM * sizeof(long long);
  s.rows = s.ri + 2 * (size_t)kBM * sizeof(int2);
  s.total = s.rows + (size_t)kWarps * kRowsPerWarp * s.nnp * kCC *
                         sizeof(bf16);
  return s;
}

// The partial dW [NK, C, D] of split blockIdx.z (rows r_begin .. r_end)
// for channels c0 .. c0 + kCC and columns n0 .. n0 + kBN, a 64-row tile at
// a time, software-pipelined over two sets of tile buffers: phase 1 builds
// the tile's bf16 F slab (each warp kRowsPerWarp rows, two at a time: F^T
// [kCC, 24] = G^T w by mma on the rows' gathered table rows G [nnp, kCC],
// the anchor weights computed in the B fragments and rounded to bf16 there,
// F rounded to bf16 into the slab);
// then the next tile's gathers and dout rows go out by cp.async and its
// successor's neighbors are loaded into registers, all in flight while
// phase 2 adds F^T dout over the tile's rows (A = the slab, B = the dout
// tile, both by ldmatrix.trans), each kGroup k16 steps in a fresh
// accumulator added to the registers' running sum by a rounding fp32 add.
__global__ void __launch_bounds__(kThreads, 1)
inter_dw_mma_kernel(const float* __restrict__ gx, const int* __restrict__ idx,
                    const bf16* __restrict__ table,
                    const float* __restrict__ rk,
                    const float* __restrict__ k2,
                    const bf16* __restrict__ dout, float* __restrict__ part,
                    int M, int p2, int nn, int q, int C, int D,
                    int rows_per_split, float inv_sigma) {
  extern __shared__ __align__(128) unsigned char dw_smem[];
  const int row0 = (threadIdx.x >> 5) * kRowsPerWarp;  // the warp's slab rows
  const Smem L = layout(nn);
  const int nnp = L.nnp, nbr = L.nbr;
  bf16* slab = reinterpret_cast<bf16*>(dw_smem);
  bf16* s_dout = reinterpret_cast<bf16*>(dw_smem + L.dout);
  float4* s_gx = reinterpret_cast<float4*>(dw_smem + L.gx);
  int* s_idx = reinterpret_cast<int*>(dw_smem + L.idx);
  long long* s_rtb = reinterpret_cast<long long*>(dw_smem + L.rtb);
  int2* s_ri = reinterpret_cast<int2*>(dw_smem + L.ri);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  bf16* rows = reinterpret_cast<bf16*>(dw_smem + L.rows) +
               (size_t)warp * kRowsPerWarp * nnp * kCC;
  const int n0 = blockIdx.x * kBN, c0 = blockIdx.y * kCC, split = blockIdx.z;
  const int r_begin = split * rows_per_split;
  const int r_end = min(M, r_begin + rows_per_split);
  const int wm = warp / kWN, wn = warp % kWN;
  const float s2 = 2.f * inv_sigma;

  // the neighbor of tile m0's points that this thread stages (at most one:
  // kMaxNP * nnp <= kThreads), from device memory into registers; the
  // padded slots and a thread past the points hold the shadow index
  auto stage_load = [&](int m0, float4& v, int& j) {
    v = make_float4(0.f, 0.f, 0.f, 1.f);
    j = q;
    if (m0 >= r_end) return;
    const int pt0 = m0 / kNA;
    const int np = (min(m0 + kBM, r_end) - 1) / kNA - pt0 + 1;
    const int p = tid / nnp, n = tid - p * nnp;
    if (p < np && n < nn) {
      const size_t src = (size_t)(pt0 + p) * nn + n;
      const float x = gx[3 * src], y = gx[3 * src + 1], z = gx[3 * src + 2];
      v = make_float4(x, y, z, 1.f - ((x * x + y * y) + z * z) * inv_sigma);
      j = idx[src];
    }
  };
  // ... and into buffer s, with each row's table offset, local point (-1
  // past r_end) and anchor
  auto stage_store = [&](int m0, int s, const float4& v, int j) {
    if (m0 >= r_end) return;
    if (tid < nbr) {
      s_gx[s * nbr + tid] = v;
      s_idx[s * nbr + tid] = j;
    }
    if (tid < kBM) {
      const int pt0 = m0 / kNA;
      const int gm = m0 + tid, pt = gm / kNA, a = gm - pt * kNA;
      s_rtb[s * kBM + tid] = ((long long)(pt / p2) * q * kNA + a) * C + c0;
      s_ri[s * kBM + tid] = make_int2(gm < r_end ? pt - pt0 : -1, a);
    }
  };
  // tile m0's dout rows (zeros past r_end) into dout buffer s, and the
  // table rows of the slab rows this warp builds (channels c0 .. c0 + kCC;
  // zeros for the shadow index and padded slots, nothing for a row past
  // r_end) into its buffers, from staging buffer s: cp.async, one commit
  // group
  auto prefetch = [&](int m0, int s) {
    if (m0 < r_end) {
      bf16* dd = s_dout + (size_t)s * kBM * kBN;
      for (int e = tid; e < kBM * kBN / 8; e += kThreads) {
        const int r = e / (kBN / 8), c8 = e % (kBN / 8) * 8;
        const bool ok = m0 + r < r_end;
        tc::cp16(tc::smem_addr(dd + tc::swz(r, c8, kBN / 8)),
                 ok ? dout + (size_t)(m0 + r) * D + n0 + c8 : dout, ok);
      }
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = row0 + i, lp = s_ri[s * kBM + r].x;
        if (lp < 0) continue;
        const int* ix = s_idx + s * nbr + lp * nnp;
        const bf16* tb = table + s_rtb[s * kBM + r];
        bf16* dst = rows + (size_t)i * nnp * kCC;
        for (int e = lane; e < nnp * 2; e += 32) {
          const int n = e >> 1, c8 = (e & 1) * 8;
          const int j = ix[n];
          const bool ok = j < q;
          tc::cp16(tc::smem_addr(dst + slab_off(n, c8)),
                   ok ? tb + (size_t)j * kNA * C + c8 : table, ok);
        }
      }
    }
    tc::cp_commit();
  };

  // the warp's slab rows i, i + 1 from staging buffer s: F^T [kCC, 24] =
  // G^T [kCC, nnp] w [nnp, 24] for each (A = G^T by ldmatrix.trans; B =
  // the anchor weights of neighbors 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1)
  // for kernel point 8j + g, in fp32 as the forward kernel computes them,
  // rounded to bf16 in the fragment); F rounded to bf16 into the slab,
  // zeros for a row past r_end
  auto contract = [&](int i, int s) {
    const float4* g4[2];
    const bf16* gb[2];
    float4 rj[2][3];
    int r[2];
    bool live[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      r[u] = row0 + i + u;
      const int2 ri = s_ri[s * kBM + r[u]];
      live[u] = ri.x >= 0;
      g4[u] = s_gx + s * nbr + max(ri.x, 0) * nnp;
      gb[u] = rows + (size_t)(i + u) * nnp * kCC;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int kp = 8 * j + g;
        const float* rp = rk + ((size_t)ri.y * NK + kp) * 3;
        rj[u][j] = make_float4(s2 * __ldg(rp), s2 * __ldg(rp + 1),
                               s2 * __ldg(rp + 2),
                               -__ldg(k2 + kp) * inv_sigma);
      }
    }
    float f[2][3][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) f[u][j][h] = 0.f;
#pragma unroll 1
    for (int nb = 0; nb < nnp; nb += 16) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float4 gq[4] = {g4[u][nb + 2 * t], g4[u][nb + 2 * t + 1],
                              g4[u][nb + 2 * t + 8], g4[u][nb + 2 * t + 9]};
        uint32_t af[4];
        tc::ldsm4t(af, tc::smem_addr(gb[u] + slab_off(
                                         nb + (lane & 7) + (lane >> 4) * 8,
                                         ((lane >> 3) & 1) * 8)));
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          tc::mma(f[u][j], af,
                  epn::pack2(weight(gq[0], rj[u][j]),
                             weight(gq[1], rj[u][j])),
                  epn::pack2(weight(gq[2], rj[u][j]),
                             weight(gq[3], rj[u][j])));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const uint2 v =
            live[u] ? make_uint2(epn::pack2(f[u][j][0], f[u][j][1]),
                                 epn::pack2(f[u][j][2], f[u][j][3]))
                    : make_uint2(0u, 0u);
        *reinterpret_cast<uint2*>(
            slab + tc::swz(r[u], 12 * lane + 4 * j, kKC / 8)) = v;
      }
    }
  };

  float acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[mi][ni][h] = 0.f;
  // the product's ldmatrix addresses: the rows a lane addresses are 8 apart
  // from one k16 step to the next, so the swizzle's XOR term is the lane's
  // own and each address is a per-lane base (a_off: one an m16 tile, b_off:
  // one a pair of n8 tiles) plus the step's rows
  int a_off[kMI], b_off[kNI / 2];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
    a_off[mi] = tc::swz((lane & 7) + (lane >> 4) * 8,
                        wm * (kKC / kWM) + mi * 16 + ((lane >> 3) & 1) * 8,
                        kKC / 8);
#pragma unroll
  for (int nj = 0; nj < kNI / 2; ++nj)
    b_off[nj] = tc::swz((lane & 7) + ((lane >> 3) & 1) * 8,
                        wn * (kBN / kWN) + nj * 16 + (lane >> 4) * 8,
                        kBN / 8);

  // prologue: the first two tiles staged, the first one's operands in
  // flight
  {
    float4 v;
    int j;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      stage_load(r_begin + s * kBM, v, j);
      stage_store(r_begin + s * kBM, s, v, j);
    }
  }
  __syncthreads();
  prefetch(r_begin, 0);

  for (int m0 = r_begin, s = 0; m0 < r_end; m0 += kBM, s ^= 1) {
    // phase 1: the slab from the gathered rows
    tc::cp_wait<0>();
    __syncwarp();
#pragma unroll 1
    for (int i = 0; i < kRowsPerWarp; i += 2) contract(i, s);
    __syncthreads();  // every slab whole; this tile's dout and the next tile's
                 // staging visible; the gathered rows free

    prefetch(m0 + kBM, s ^ 1);
    float4 v;
    int j;
    stage_load(m0 + 2 * kBM, v, j);

    // phase 2: acc += slab^T . dout over the tile's rows, a group of kGroup
    // k16 steps at a time: its B fragments held, then for each m16 tile the
    // group's products into a fresh accumulator, added to the running sum
    // by an fp32 add that rounds to nearest (the mma's own accumulation
    // truncates, and over the thousands of k16 steps of a split it would
    // lean dW toward zero)
    const bf16* dd = s_dout + (size_t)s * kBM * kBN;
#pragma unroll
    for (int kg = 0; kg < kBM; kg += 16 * kGroup) {
      uint32_t bf[kGroup][kNI][2];
#pragma unroll
      for (int ks = 0; ks < kGroup; ++ks)
#pragma unroll
        for (int nj = 0; nj < kNI / 2; ++nj) {
          uint32_t r4[4];
          tc::ldsm4t(r4, tc::smem_addr(dd + (kg + 16 * ks) * kBN +
                                       b_off[nj]));
          bf[ks][2 * nj][0] = r4[0];
          bf[ks][2 * nj][1] = r4[1];
          bf[ks][2 * nj + 1][0] = r4[2];
          bf[ks][2 * nj + 1][1] = r4[3];
        }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        uint32_t af[kGroup][4];
#pragma unroll
        for (int ks = 0; ks < kGroup; ++ks) {
          tc::ldsm4t(af[ks], tc::smem_addr(slab + (kg + 16 * ks) * kKC +
                                           a_off[mi]));
        }
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < kGroup; ++ks)
            tc::mma(f, af[ks], bf[ks][ni][0], bf[ks][ni][1]);
#pragma unroll
          for (int h = 0; h < 4; ++h) acc[mi][ni][h] += f[h];
        }
      }
    }

    // the tile after next staged in this tile's buffer (its reads are done)
    stage_store(m0 + 2 * kBM, s, v, j);
    __syncthreads();  // every product is done with the slab and dout
  }
  tc::cp_wait<0>();

  // the split's partial: dW row k * C + c0 + cc of each slab column
  float* dst = part + (size_t)split * NK * C * D + n0 + wn * (kBN / kWN) +
               2 * t;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int cc, k;
      slab_column(wm * (kKC / kWM) + mi * 16 + g + 8 * h, cc, k);
      float* rowp = dst + ((size_t)k * C + c0 + cc) * D;
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        *reinterpret_cast<float2*>(rowp + ni * 8) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

int launch(const void* gx, const void* idx, const void* table,
           const void* rk, const void* k2, const void* dout, void* ws,
           void* dW, int M, int p2, int nn, int q, int C, int D, float sigma,
           int splits, cudaStream_t stream) {
  const Smem L = layout(nn);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      inter_dw_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M + kBM - 1) / kBM;
  const int rows_per_split = (tiles + splits - 1) / splits * kBM;
  inter_dw_mma_kernel<<<dim3(D / kBN, C / kCC, splits), kThreads, L.total,
                        stream>>>((const float*)gx, (const int*)idx,
                                  (const bf16*)table, (const float*)rk,
                                  (const float*)k2, (const bf16*)dout,
                                  (float*)ws, M, p2, nn, q, C, D,
                                  rows_per_split, 1.f / sigma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_splits((const float*)ws, (float*)dW, splits,
                           (size_t)NK * C * D, stream);
}

}  // namespace dwmma

// ------------------------------------------- fp32 dW on the CUDA cores

namespace dwf32 {

constexpr int kNA = 60;                // anchors: the rows of a point
constexpr int kKP = 8;                 // kernel points a block
constexpr int kGroups = NK / kKP;      // kernel-point groups of dW
constexpr int kCC = 16;                // channels a block
constexpr int kBM = 32;                // rows a tile
constexpr int kThreads = 256;          // one (row, kernel point) F item each
constexpr int kWarps = kThreads / 32;
constexpr int kFK = kCC + 4;           // F slab stride of a kernel point
constexpr int kFS = kKP * kFK;         // F slab row stride
constexpr int kMaxNP = 2;              // points a tile's rows touch
constexpr int kMaxNN = 64;
static_assert(kBM * kKP == kThreads && (kBM - 1) / kNA + 2 == kMaxNP &&
                  NK % kKP == 0 && kThreads == 16 * 16 &&
                  kMaxNP * kMaxNN <= kThreads,
              "block shape");

// dynamic shared memory, in bytes from the base: the gathered table rows
// [kBM][gs] fp32 (gs = nn * kCC + 4: a row's nn neighbors, kCC channels
// each, padded so that the four rows a warp's F items read fall in four
// different bank groups; offset 0), the F slab [kBM][kKP][kFK], the dout
// tile [kBM][bn]; then two of each staging buffer, the current tile's and
// the next one's: the tile's points' neighbor coordinates [nbr] float4
// (x, y, z, |gx|^2) and indices [nbr] (nbr = kMaxNP * nn), the rows'
// table offsets [kBM] and (point, anchor) [kBM]
struct Smem {
  int gs, nbr;
  size_t f, d, gx, idx, rtb, ri, total;
};

__host__ __device__ inline Smem layout(int bn, int nn) {
  Smem s;
  s.gs = nn * kCC + 4;
  s.nbr = kMaxNP * nn;
  s.f = (size_t)kBM * s.gs * sizeof(float);
  s.d = s.f + (size_t)kBM * kFS * sizeof(float);
  s.gx = s.d + (size_t)kBM * bn * sizeof(float);
  s.idx = s.gx + 2 * (size_t)s.nbr * sizeof(float4);
  s.rtb = s.idx + 2 * (size_t)s.nbr * sizeof(int);
  s.ri = s.rtb + 2 * (size_t)kBM * sizeof(long long);
  s.total = s.ri + 2 * (size_t)kBM * sizeof(int2);
  return s;
}

// The partial dW [NK, C, D] of split blockIdx.z (rows r_begin .. r_end)
// for kernel points kg * kKP .. + kKP, channels c0 .. c0 + kCC and columns
// n0 .. n0 + BN, a 32-row tile at a time: the tile's table rows were
// gathered (cp.async) while the previous tile's product ran; its dout rows
// go out by cp.async while each thread builds one (row, kernel point) item
// of the F slab (the anchor weight of each neighbor once, then its kCC
// channels, in fp32 as inter_dw_kernel<float> sums them: F bitwise the
// template's); then the next tile's gathers go out and the product adds
// slab^T dout over the tile's rows, 8 x (BN / 16) outputs a thread from
// float4 loads of both operands. Two barriers a tile.
template <int BN>
__global__ void __launch_bounds__(kThreads, BN > 128 ? 1 : 2)
inter_dw_f32_kernel(const float* __restrict__ gx, const int* __restrict__ idx,
                    const float* __restrict__ table,
                    const float* __restrict__ rk,
                    const float* __restrict__ k2,
                    const float* __restrict__ dout, float* __restrict__ part,
                    int M, int p2, int nn, int q, int C, int D,
                    int rows_per_split, float inv_sigma) {
  constexpr int TN = BN / 16;  // d columns a thread: h * 64 + tx * 4 + j
  constexpr int NH = TN / 4;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  const Smem L = layout(BN, nn);
  const int gs = L.gs, nbr = L.nbr;
  float* s_G = reinterpret_cast<float*>(f32_smem);
  float* s_F = reinterpret_cast<float*>(f32_smem + L.f);
  float* s_D = reinterpret_cast<float*>(f32_smem + L.d);
  float4* s_gx = reinterpret_cast<float4*>(f32_smem + L.gx);
  int* s_idx = reinterpret_cast<int*>(f32_smem + L.idx);
  long long* s_rtb = reinterpret_cast<long long*>(f32_smem + L.rtb);
  int2* s_ri = reinterpret_cast<int2*>(f32_smem + L.ri);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = blockIdx.x % kGroups, n0 = blockIdx.x / kGroups * BN;
  const int c0 = blockIdx.y * kCC, split = blockIdx.z;
  const int r_begin = split * rows_per_split;
  const int r_end = min(M, r_begin + rows_per_split);

  // the neighbor of tile m0's points that this thread stages (at most one:
  // nbr <= kThreads), from device memory into registers; a thread past the
  // points holds the shadow index
  auto stage_load = [&](int m0, float4& v, int& j) {
    v = make_float4(0.f, 0.f, 0.f, 0.f);
    j = q;
    if (m0 >= r_end || tid >= nbr) return;
    const int pt0 = m0 / kNA;
    const int np = (min(m0 + kBM, r_end) - 1) / kNA - pt0 + 1;
    const int p = tid / nn, n = tid - p * nn;
    if (p < np) {
      const size_t src = (size_t)(pt0 + p) * nn + n;
      const float x = gx[3 * src], y = gx[3 * src + 1], z = gx[3 * src + 2];
      v = make_float4(x, y, z, (x * x + y * y) + z * z);
      j = idx[src];
    }
  };
  // ... and into staging buffer s, with each row's table offset (channel
  // c0) and local point (-1 past r_end) and anchor
  auto stage_store = [&](int m0, int s, const float4& v, int j) {
    if (m0 >= r_end) return;
    if (tid < nbr) {
      s_gx[s * nbr + tid] = v;
      s_idx[s * nbr + tid] = j;
    }
    if (tid < kBM) {
      const int pt0 = m0 / kNA;
      const int gm = m0 + tid, pt = gm / kNA, a = gm - pt * kNA;
      s_rtb[s * kBM + tid] = ((long long)(pt / p2) * q * kNA + a) * C + c0;
      s_ri[s * kBM + tid] = make_int2(gm < r_end ? pt - pt0 : -1, a);
    }
  };
  // tile m0's table rows (kCC channels of each neighbor of each row; zeros
  // for the shadow index, nothing for a row past r_end) from staging
  // buffer s into s_G: cp.async, a warp a row at a time, one commit group
  auto gather = [&](int m0, int s) {
    if (m0 < r_end) {
      for (int r = warp; r < kBM; r += kWarps) {
        const int lp = s_ri[s * kBM + r].x;
        const int* ix = s_idx + s * nbr + max(lp, 0) * nn;
        const float* tb = table + s_rtb[s * kBM + r];
        float* dst = s_G + (size_t)r * gs;
        for (int e = lane; lp >= 0 && e < nn * (kCC / 4); e += 32) {
          const int n = e >> 2, c4 = (e & 3) * 4;
          const int j = ix[n];
          const bool ok = j < q;
          tc::cp16(tc::smem_addr(dst + n * kCC + c4),
                   ok ? tb + (size_t)j * kNA * C + c4 : table, ok);
        }
      }
    }
    tc::cp_commit();
  };
  // tile m0's dout rows (zeros past r_end) into s_D: one commit group
  auto dout_tile = [&](int m0) {
    for (int e = tid; e < kBM * BN / 4; e += kThreads) {
      const int r = e / (BN / 4), c4 = e % (BN / 4) * 4;
      const bool ok = m0 + r < r_end;
      tc::cp16(tc::smem_addr(s_D + r * BN + c4),
               ok ? dout + (size_t)(m0 + r) * D + n0 + c4 : dout, ok);
    }
    tc::cp_commit();
  };
  // the F slab's item (row tid / 8, kernel point kg * kKP + tid % 8) of
  // the tile in staging buffer s: F[cc] = sum_n w_n G[n, cc], n in order;
  // zeros for a row past r_end
  auto build_f = [&](int s) {
    const int r = tid >> 3, kq = tid & 7;
    const int2 ri = s_ri[s * kBM + r];
    float f[1][kCC];
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) f[0][cc] = 0.f;
    if (ri.x >= 0) {
      const int k = kg * kKP + kq;
      const float* rp = rk + ((size_t)ri.y * NK + k) * 3;
      const float4 rv[1] = {make_float4(__ldg(rp), __ldg(rp + 1),
                                        __ldg(rp + 2), __ldg(k2 + k))};
      const float4* g4 = s_gx + s * nbr + ri.x * nn;
      const float4* gr = reinterpret_cast<const float4*>(s_G + (size_t)r * gs);
#pragma unroll 2
      for (int n = 0; n < nn; ++n) {
        add_neighbor(f, g4[n], rv, inv_sigma,
                     [&](int h) { return gr[n * (kCC / 4) + h]; });
      }
    }
    float4* dst = reinterpret_cast<float4*>(s_F + r * kFS + kq * kFK);
#pragma unroll
    for (int h = 0; h < kCC / 4; ++h) {
      dst[h] = make_float4(f[0][4 * h], f[0][4 * h + 1], f[0][4 * h + 2],
                           f[0][4 * h + 3]);
    }
  };

  // the product's operands: the thread's 8 slab columns (kernel point
  // ty / 2, channels (ty & 1) * 8 .. + 8) and d columns
  const int ty = tid >> 4, tx = tid & 15;
  const float* fa = s_F + (ty >> 1) * kFK + (ty & 1) * 8;
  const float* db = s_D + tx * 4;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // prologue: the first two tiles staged, the first one's gathers in flight
  {
    float4 v;
    int j;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      stage_load(r_begin + s * kBM, v, j);
      stage_store(r_begin + s * kBM, s, v, j);
    }
  }
  __syncthreads();
  gather(r_begin, 0);

  for (int m0 = r_begin, s = 0; m0 < r_end; m0 += kBM, s ^= 1) {
    tc::cp_wait<0>();
    __syncthreads();  // the tile's gathered rows visible; the last product
                      // done with the slab and the dout tile
    dout_tile(m0);
    build_f(s);
    tc::cp_wait<0>();
    __syncthreads();  // the slab whole, the dout tile visible, s_G free

    gather(m0 + kBM, s ^ 1);
    float4 v;
    int j;
    stage_load(m0 + 2 * kBM, v, j);

#pragma unroll 4
    for (int r = 0; r < kBM; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(fa + r * kFS);
      const float4 a1 = *reinterpret_cast<const float4*>(fa + r * kFS + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TN];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const float4 d4 =
            *reinterpret_cast<const float4*>(db + r * BN + h * 64);
        b[4 * h] = d4.x;
        b[4 * h + 1] = d4.y;
        b[4 * h + 2] = d4.z;
        b[4 * h + 3] = d4.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj)
          acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
    }

    // the tile after next staged in this tile's buffer (its reads are done)
    stage_store(m0 + 2 * kBM, s, v, j);
  }
  tc::cp_wait<0>();

  // the split's partial: dW rows (k, c0 + (ty & 1) * 8 + i)
  const int k = kg * kKP + (ty >> 1);
  float* dst = part + (size_t)split * NK * C * D +
               ((size_t)k * C + c0 + (ty & 1) * 8) * D + n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      *reinterpret_cast<float4*>(dst + (size_t)i * D + h * 64) = make_float4(
          acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
          acc[i][4 * h + 3]);
    }
}

template <int BN>
int launch_bn(const void* gx, const void* idx, const void* table,
              const void* rk, const void* k2, const void* dout, void* ws,
              void* dW, int M, int p2, int nn, int q, int C, int D,
              float sigma, int splits, cudaStream_t stream) {
  const Smem L = layout(BN, nn);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      inter_dw_f32_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M + kBM - 1) / kBM;
  const int rows_per_split = (tiles + splits - 1) / splits * kBM;
  inter_dw_f32_kernel<BN><<<dim3(kGroups * (D / BN), C / kCC, splits),
                            kThreads, L.total, stream>>>(
      (const float*)gx, (const int*)idx, (const float*)table,
      (const float*)rk, (const float*)k2, (const float*)dout, (float*)ws, M,
      p2, nn, q, C, D, rows_per_split, 1.f / sigma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_splits((const float*)ws, (float*)dW, splits,
                           (size_t)NK * C * D, stream);
}

int launch(const void* gx, const void* idx, const void* table,
           const void* rk, const void* k2, const void* dout, void* ws,
           void* dW, int M, int p2, int nn, int q, int C, int D, float sigma,
           int splits, int BN, cudaStream_t stream) {
  switch (BN) {
    case 256:
      return launch_bn<256>(gx, idx, table, rk, k2, dout, ws, dW, M, p2, nn,
                            q, C, D, sigma, splits, stream);
    case 128:
      return launch_bn<128>(gx, idx, table, rk, k2, dout, ws, dW, M, p2, nn,
                            q, C, D, sigma, splits, stream);
    case 64:
      return launch_bn<64>(gx, idx, table, rk, k2, dout, ws, dW, M, p2, nn,
                           q, C, D, sigma, splits, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dwf32

// ---------------------- fp32 backward scatter on the CUDA cores

namespace scf32 {

using mma::red4;
using mma::weight;

constexpr int kNA = 60;                 // anchors: the rows of a point (a tile)
constexpr int kCC = 16;                 // channels a tile
constexpr int kCols = NK * kCC;         // slab columns (k, cc)
constexpr int kFS = kCols + 4;          // slab row stride
constexpr int kBM = 64;                 // the dF product's rows (kNA, padded)
constexpr int kSD = 16;                 // d a slice of the product
constexpr int kDepth = 3;               // slices in the ring
constexpr int kStage = kSD * (kBM + kCols);  // floats a ring stage
// the fused mode's warps: kPWarps form the dF product (a warp 64 rows x 32
// columns, a thread 8 x 8 of them) while kSWarps scatter the last tile's
constexpr int kPWarps = 12;
constexpr int kSWarps = 4;
constexpr int kPThreads = 32 * kPWarps;
constexpr int kThreads = 32 * (kPWarps + kSWarps);
constexpr int kMaxNN = 64;
static_assert(kPWarps * 32 == kCols && kBM == 64 && kMaxNN <= kPThreads,
              "block shape");

// named barriers of the fused mode (0 is __syncthreads): the product
// warps' slices, the slab empty (the scatter warps done with it), the slab
// full (the product warps done writing it)
constexpr int kBarSlice = 1, kBarEmpty = 2, kBarFull = 3;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// dynamic shared memory, in floats from the base: the rotated kernel points
// of every anchor [kNA * NK] float4 (2 R kappa / sigma, -|kappa|^2 /
// sigma), the dF slab [kNA][kFS] (two in the W-off mode: the tile's and
// the next one's), the fused mode's ring of dout^T and W^T slices
// [kDepth][kStage] (dout^T [kSD][kBM], then W^T [kSD][kCols]), and two
// neighbor buffers (the tile's and the next one's): coordinates [nn]
// float4 (x, y, z, 1 - |gx|^2 / sigma) and indices [nn]
struct Smem {
  size_t slab, ring, gx, idx, total;
};

__host__ __device__ inline Smem layout(bool woff, int nn) {
  Smem s;
  s.slab = (size_t)kNA * NK * 4;
  s.ring = s.slab + (size_t)(woff ? 2 : 1) * kNA * kFS;
  s.gx = s.ring + (woff ? 0 : (size_t)kDepth * kStage);
  s.idx = s.gx + 2 * (size_t)nn * 4;
  s.total = (s.idx + 2 * (size_t)nn) * sizeof(float);
  return s;
}

// the fused mode's operands in the layouts its slices are read in: W [K,
// C, D] -> W^T [C / kCC][D][K][kCC] and dout [M, D] -> dout^T [M / kNA][D]
// [kBM] (rows kNA .. kBM zero), so that a slice of each is contiguous. One
// thread an element of W^T (read along d); 32 x 32 tiles of dout through
// shared memory.
__global__ void inter_bwd_wt_kernel(const float* __restrict__ W,
                                    float* __restrict__ wt, int C, int D) {
  const size_t n = (size_t)NK * C * D;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int d = (int)(e % D);
    const size_t kc = e / D;
    const int k = (int)(kc / C), c = (int)(kc % C);
    wt[((((size_t)(c / kCC) * D + d) * NK + k) * kCC) + c % kCC] = W[e];
  }
}

__global__ void inter_bwd_dt_kernel(const float* __restrict__ dout,
                                    float* __restrict__ dt, int D) {
  __shared__ float tile[32][33];
  const int pt = blockIdx.x, d0 = blockIdx.y * 32, r0 = blockIdx.z * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i;
    tile[i][threadIdx.x] =
        (r < kNA && d0 + threadIdx.x < D)
            ? dout[((size_t)pt * kNA + r) * D + d0 + threadIdx.x]
            : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32 && d0 + i < D; i += 8) {
    dt[((size_t)pt * D + d0 + i) * kBM + r0 + threadIdx.x] =
        tile[threadIdx.x][i];
  }
}

// A persistent block walks tiles blockIdx.x, + gridDim.x, ...; tile t owns
// point t / (C / kCC) (its kNA rows, so that the neighbor list is shared)
// and channels kCC * (t % (C / kCC)) .. + kCC. The fused entry (kWOff
// false) splits its warps: kPWarps form each tile's dF slab [kNA][NK *
// kCC] = dout [kNA, D] . W^T [D, (k, cc)] in fp32 FFMA, 8 x 8 outputs a
// thread from float4 loads of both operands (dout^T and W^T slices, kSD
// deep, through a kDepth ring of cp.async groups that runs on from one
// tile to the next), and write it to the slab once the kSWarps scatter
// warps are done with the last one; the scatter of a tile so runs beside
// the next tile's product. The W-off entry loads the slab from dF [M, NK,
// C] by cp.async into one of two slabs, the next tile's while every warp
// scatters this one. The scatter: one (row, neighbor slot) item a thread:
// the slot's 24 anchor weights (once for kCC channels), sum_k w dF for the
// kCC channels in fp32 (k in order), then four vector reductions into dT
// (64 contiguous bytes).
template <bool kWOff>
__global__ void __launch_bounds__(kThreads, 1)
inter_bwd_f32_kernel(const float* __restrict__ gx, const int* __restrict__ idx,
                     const float* __restrict__ rk,
                     const float* __restrict__ k2,
                     const float* __restrict__ wt,
                     const float* __restrict__ src, float* __restrict__ dT,
                     int P, int p2, int nn, int q, int C, int D,
                     float inv_sigma) {
  extern __shared__ __align__(16) float scf_smem[];
  const Smem L = layout(kWOff, nn);
  float4* s_kr = reinterpret_cast<float4*>(scf_smem);
  float* slabs = scf_smem + L.slab;
  float* ring = scf_smem + L.ring;
  float4* s_gx = reinterpret_cast<float4*>(scf_smem + L.gx);
  int* s_idx = reinterpret_cast<int*>(scf_smem + L.idx);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_cb = C / kCC, tiles = P * n_cb;
  const float s2 = 2.f * inv_sigma;

  for (int e = tid; e < kNA * NK; e += kThreads) {
    const float* rp = rk + 3 * e;
    s_kr[e] = make_float4(s2 * rp[0], s2 * rp[1], s2 * rp[2],
                          -k2[e % NK] * inv_sigma);
  }
  __syncthreads();

  // point pt's neighbors into buffer u (thread tid < nn)
  auto stage = [&](int pt, int u) {
    if (tid < nn) {
      const size_t s = (size_t)pt * nn + tid;
      const float x = gx[3 * s], y = gx[3 * s + 1], z = gx[3 * s + 2];
      s_gx[u * nn + tid] =
          make_float4(x, y, z, 1.f - ((x * x + y * y) + z * z) * inv_sigma);
      s_idx[u * nn + tid] = idx[s];
    }
  };

  // the scatter of the slab fs (point pt, channels c0 .. c0 + kCC) with
  // the neighbors of buffer u, items first, + stride, ...; a shadow slot
  // adds nothing
  auto scatter = [&](const float* fs, int pt, int c0, int u, int first,
                     int stride) {
    const float4* gq = s_gx + u * nn;
    const int* iq = s_idx + u * nn;
    float* base = dT + (size_t)(pt / p2) * q * kNA * C + c0;
    for (int e = first; e < kNA * nn; e += stride) {
      const int a = e / nn, n = e - a * nn;
      const int j = iq[n];
      if (j >= q) continue;
      const float4 g = gq[n];
      const float4* fr = reinterpret_cast<const float4*>(fs + a * kFS);
      const float4* kp = s_kr + a * NK;
      float4 v[kCC / 4];
#pragma unroll
      for (int h = 0; h < kCC / 4; ++h) v[h] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const float w = weight(g, kp[k]);
#pragma unroll
        for (int h = 0; h < kCC / 4; ++h) {
          const float4 f = fr[k * (kCC / 4) + h];
          v[h].x = fmaf(w, f.x, v[h].x);
          v[h].y = fmaf(w, f.y, v[h].y);
          v[h].z = fmaf(w, f.z, v[h].z);
          v[h].w = fmaf(w, f.w, v[h].w);
        }
      }
      float* dst = base + ((size_t)j * kNA + a) * C;
#pragma unroll
      for (int h = 0; h < kCC / 4; ++h) red4(dst + 4 * h, v[h]);
    }
  };

  if constexpr (!kWOff) {
    const int nsl = D / kSD;
    if (warp < kPWarps) {
      // slice g of the block's sequence (tile blockIdx.x + (g / nsl) *
      // gridDim.x, d slice g % nsl) into ring stage g % kDepth: one commit
      // group, empty past the last tile
      auto load = [&](int g) {
        const int t = blockIdx.x + (g / nsl) * gridDim.x;
        if (t < tiles) {
          const int pt = t / n_cb, cb = t - pt * n_cb;
          const int d0 = (g % nsl) * kSD;
          float* st = ring + (g % kDepth) * kStage;
          const float* da = src + ((size_t)pt * D + d0) * kBM;
          const float* wb = wt + ((size_t)cb * D + d0) * kCols;
          for (int e = tid; e < kStage / 4; e += kPThreads) {
            const float* from = e < kSD * kBM / 4 ? da + 4 * e
                                                  : wb + 4 * e - kSD * kBM;
            tc::cp16(tc::smem_addr(st + 4 * e), from, true);
          }
        }
        tc::cp_commit();
      };
      int next = 0;
#pragma unroll
      for (int s = 0; s < kDepth - 1; ++s) load(next++);
      // the thread's rows lr * 4 + 32 i + e, columns 32 warp + 4 lc + 16 j
      // + e (i, j < 2, e < 4)
      const int row0 = (lane >> 2) * 4, col0 = 32 * warp + 4 * (lane & 3);
      for (int t = blockIdx.x, lt = 0; t < tiles; t += gridDim.x, ++lt) {
        const int pt = t / n_cb;
        stage(pt, lt & 1);
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[i][n] = 0.f;
        for (int s = 0; s < nsl; ++s) {
          const int g = lt * nsl + s;
          tc::cp_wait<kDepth - 2>();
          bar_sync(kBarSlice, kPThreads);  // slice g landed; stage (g - 1)
                                           // % kDepth free
          load(next++);
          const float* sa = ring + (g % kDepth) * kStage + row0;
          const float* sb = ring + (g % kDepth) * kStage + kSD * kBM + col0;
#pragma unroll
          for (int dd = 0; dd < kSD; ++dd) {
            const float4 a0 = *reinterpret_cast<const float4*>(sa + dd * kBM);
            const float4 a1 =
                *reinterpret_cast<const float4*>(sa + dd * kBM + 32);
            const float4 b0 =
                *reinterpret_cast<const float4*>(sb + dd * kCols);
            const float4 b1 =
                *reinterpret_cast<const float4*>(sb + dd * kCols + 16);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w,
                                a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                                b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int n = 0; n < 8; ++n)
                acc[i][n] = fmaf(a[i], b[n], acc[i][n]);
          }
        }
        bar_sync(kBarEmpty, kThreads);  // the scatter warps done with the
                                        // slab
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = row0 + (i & 3) + 32 * (i >> 2);
          if (r < kNA) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              *reinterpret_cast<float4*>(slabs + r * kFS + col0 + 16 * j) =
                  make_float4(acc[i][4 * j], acc[i][4 * j + 1],
                              acc[i][4 * j + 2], acc[i][4 * j + 3]);
            }
          }
        }
        bar_arrive(kBarFull, kThreads);  // the slab and neighbors ready
      }
      tc::cp_wait<0>();
    } else {
      bar_arrive(kBarEmpty, kThreads);
      for (int t = blockIdx.x, lt = 0; t < tiles; t += gridDim.x, ++lt) {
        const int pt = t / n_cb;
        bar_sync(kBarFull, kThreads);
        scatter(slabs, pt, (t - pt * n_cb) * kCC, lt & 1, tid - kPThreads,
                kThreads - kPThreads);
        if (t + gridDim.x < tiles) bar_arrive(kBarEmpty, kThreads);
      }
    }
  } else {
    // tile lt's slab (buffer lt & 1) from dF: one commit group, empty past
    // the last tile
    auto load_slab = [&](int lt) {
      const int t = blockIdx.x + lt * gridDim.x;
      if (t < tiles) {
        const int pt = t / n_cb, c0 = (t - pt * n_cb) * kCC;
        float* fs = slabs + (lt & 1) * kNA * kFS;
        const float* sp = src + (size_t)pt * kNA * NK * C + c0;
        constexpr int kRow4 = NK * (kCC / 4);
        for (int e = tid; e < kNA * kRow4; e += kThreads) {
          const int r = e / kRow4, f = e - r * kRow4;
          tc::cp16(tc::smem_addr(fs + r * kFS + 4 * f),
                   sp + ((size_t)r * NK + (f >> 2)) * C + 4 * (f & 3), true);
        }
      }
      tc::cp_commit();
    };
    load_slab(0);
    for (int t = blockIdx.x, lt = 0; t < tiles; t += gridDim.x, ++lt) {
      const int pt = t / n_cb, c0 = (t - pt * n_cb) * kCC, u = lt & 1;
      __syncthreads();  // the last scatter done: its slab free
      load_slab(lt + 1);
      stage(pt, u);
      tc::cp_wait<1>();
      __syncthreads();  // this tile's slab and neighbors visible
      scatter(slabs + u * kNA * kFS, pt, c0, u, tid, kThreads);
    }
    tc::cp_wait<0>();
  }
}

template <bool kWOff>
int launch(const void* gx, const void* idx, const void* rk, const void* k2,
           const void* W, void* ws, const void* src, void* dT, int b, int p2,
           int nn, int q, int C, int D, float sigma, cudaStream_t stream) {
  const Smem L = layout(kWOff, nn);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = inter_bwd_f32_kernel<kWOff>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int P = b * p2;
  const float* operand = (const float*)src;
  if (!kWOff) {
    float* wt = (float*)ws;
    float* dt = wt + (size_t)NK * C * D;
    inter_bwd_wt_kernel<<<256, 256, 0, stream>>>((const float*)W, wt, C, D);
    inter_bwd_dt_kernel<<<dim3(P, (D + 31) / 32, kBM / 32), dim3(32, 8), 0,
                          stream>>>((const float*)src, dt, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    operand = dt;
  }
  const int tiles = P * (C / kCC);
  const int sms = tc::num_sms();
  kern<<<tiles < sms ? tiles : sms, kThreads, L.total, stream>>>(
      (const float*)gx, (const int*)idx, (const float*)rk, (const float*)k2,
      (const float*)ws, operand, (float*)dT, P, p2, nn, q, C, D,
      1.f / sigma);
  return (int)cudaGetLastError();
}

}  // namespace scf32

}  // namespace

// gx [b, p2, nn, 3], idx [b, p2, nn] int32 in [0, q] (q = shadow), rk
// [na, K, 3], k2 [K] fp32; W [K, C, D] and dout [b, p2, na, D] fp32, or
// bf16 when bf16 != 0; dT [b, q, na, C] fp32 must hold zeros (the kernel
// adds into it). K must be 24, C a multiple of 8, D of 16.
extern "C" int epn_inter_conv_bwd_table(const void* gx, const void* idx,
                                        const void* rk, const void* k2,
                                        const void* W, const void* dout,
                                        void* dT, int b, int p2, int nn, int q,
                                        int na, int K, int C, int D,
                                        float sigma, int bf16, void* stream) {
  if (K != NK || C % CC != 0 || D % T_BK != 0 || nn < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int M = b * p2 * na;
  const float* g = (const float*)gx;
  const int* ix = (const int*)idx;
  const float* r = (const float*)rk;
  const float* kk = (const float*)k2;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return launch_dtable<epn::bf16>(g, ix, r, kk, W, dout, (float*)dT, M, p2,
                                    nn, q, na, C, D, sigma, s);
  }
  return launch_dtable<float>(g, ix, r, kk, W, dout, (float*)dT, M, p2, nn, q,
                              na, C, D, sigma, s);
}

// W-off mode of dTable: gx, idx, rk, k2 as above, dF [b, p2, na, K, C]
// fp32, or bf16 when bf16 != 0 (each slot's sum then rounded to bf16 before
// the fp32 atomics); dT [b, q, na, C] fp32 must hold zeros. K must be 24, C
// a multiple of 8.
extern "C" int epn_inter_conv_dg(const void* gx, const void* idx,
                                 const void* rk, const void* k2,
                                 const void* dF, void* dT, int b, int p2,
                                 int nn, int q, int na, int K, int C,
                                 float sigma, int bf16, void* stream) {
  if (K != NK || C % CC != 0 || nn < 1) return (int)cudaErrorInvalidValue;
  const float* g = (const float*)gx;
  const int* ix = (const int*)idx;
  const float* r = (const float*)rk;
  const float* kk = (const float*)k2;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return launch_dtable<epn::bf16, true>(g, ix, r, kk, nullptr, dF,
                                          (float*)dT, b * p2 * na, p2, nn, q,
                                          na, C, 0, sigma, s);
  }
  return launch_dtable<float, true>(g, ix, r, kk, nullptr, dF, (float*)dT,
                                    b * p2 * na, p2, nn, q, na, C, 0, sigma,
                                    s);
}

// gx, idx, rk, k2 as above, table [b, q, na, C] and dout [b, p2, na, D]
// fp32, or bf16 when bf16 != 0; ws [splits, K, C, D] fp32 scratch, dW [K, C,
// D] fp32 out. K must be 24, C a multiple of 8, D of 64.
extern "C" int epn_inter_conv_bwd_w(const void* gx, const void* idx,
                                    const void* table, const void* rk,
                                    const void* k2, const void* dout, void* ws,
                                    void* dW, int b, int p2, int nn, int q,
                                    int na, int K, int C, int D, float sigma,
                                    int splits, int bf16, void* stream) {
  if (K != NK || C % CC != 0 || D % 64 != 0 || nn < 1 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gx;
  const int* ix = (const int*)idx;
  const float* r = (const float*)rk;
  const float* kk = (const float*)k2;
  const int M = b * p2 * na;
  if (bf16) {
    return launch_dw_cols<epn::bf16>(g, ix, table, r, kk, dout, (float*)ws,
                                     (float*)dW, M, p2, nn, q, na, C, D,
                                     sigma, splits, s);
  }
  return launch_dw_cols<float>(g, ix, table, r, kk, dout, (float*)ws,
                               (float*)dW, M, p2, nn, q, na, C, D, sigma,
                               splits, s);
}

// bf16 on tensor cores (inter_bwd_mma_kernel): the fused dTable, with
// epn_inter_conv_bwd_table's arguments (bf16 W and dout), and the W-off dG,
// with epn_inter_conv_dg's (a bf16 dF). dT [b, q, na, C] fp32 must hold
// zeros. na must be 60, K 24, C a multiple of 16, 1 <= nn <= 64, and D (the
// fused entry) a multiple of 32.
extern "C" int epn_inter_conv_bwd_table_mma(const void* gx, const void* idx,
                                            const void* rk, const void* k2,
                                            const void* W, const void* dout,
                                            void* dT, int b, int p2, int nn,
                                            int q, int na, int K, int C,
                                            int D, float sigma,
                                            void* stream) {
  if (na != mma::kNA || K != NK || C % mma::kCC != 0 || D % mma::kSD != 0 ||
      D < mma::kSD || nn < 1 || nn > mma::kMaxNN) {
    return (int)cudaErrorInvalidValue;
  }
  return mma::launch<false>(gx, idx, rk, k2, W, dout, dT, b, p2, nn, q, C, D,
                            sigma, (cudaStream_t)stream);
}

extern "C" int epn_inter_conv_dg_mma(const void* gx, const void* idx,
                                     const void* rk, const void* k2,
                                     const void* dF, void* dT, int b, int p2,
                                     int nn, int q, int na, int K, int C,
                                     float sigma, void* stream) {
  if (na != mma::kNA || K != NK || C % mma::kCC != 0 || nn < 1 ||
      nn > mma::kMaxNN) {
    return (int)cudaErrorInvalidValue;
  }
  return mma::launch<true>(gx, idx, rk, k2, nullptr, dF, dT, b, p2, nn, q, C,
                           0, sigma, (cudaStream_t)stream);
}

// bf16 on tensor cores (inter_dw_mma_kernel): the fused dW, with
// epn_inter_conv_bwd_w's arguments (a bf16 table and dout; ws [splits, K,
// C, D] fp32 scratch, dW [K, C, D] fp32 out). na must be 60, K 24, C a
// multiple of 16, D of 64, and 1 <= nn <= 64.
extern "C" int epn_inter_conv_bwd_w_mma(const void* gx, const void* idx,
                                        const void* table, const void* rk,
                                        const void* k2, const void* dout,
                                        void* ws, void* dW, int b, int p2,
                                        int nn, int q, int na, int K, int C,
                                        int D, float sigma, int splits,
                                        void* stream) {
  if (na != dwmma::kNA || K != NK || C % dwmma::kCC != 0 ||
      D % dwmma::kBN != 0 || nn < 1 || nn > dwmma::kMaxNN || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return dwmma::launch(gx, idx, table, rk, k2, dout, ws, dW, b * p2 * na, p2,
                       nn, q, C, D, sigma, splits, (cudaStream_t)stream);
}

// fp32 on the CUDA cores (inter_dw_f32_kernel): the fused dW, with
// epn_inter_conv_bwd_w's arguments (an fp32 table and dout; ws [splits, K,
// C, D] fp32 scratch, dW [K, C, D] fp32 out) and bn, the d columns a block
// (64, 128 or 256, a divisor of D: the caller picks it and sizes the splits
// for its grid). na must be 60, K 24, C a multiple of 16, and 1 <= nn <= 64.
extern "C" int epn_inter_conv_bwd_w_f32(const void* gx, const void* idx,
                                        const void* table, const void* rk,
                                        const void* k2, const void* dout,
                                        void* ws, void* dW, int b, int p2,
                                        int nn, int q, int na, int K, int C,
                                        int D, float sigma, int splits,
                                        int bn, void* stream) {
  if (na != dwf32::kNA || K != NK || C % dwf32::kCC != 0 || bn < 1 ||
      D % bn != 0 || nn < 1 || nn > dwf32::kMaxNN || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return dwf32::launch(gx, idx, table, rk, k2, dout, ws, dW, b * p2 * na, p2,
                       nn, q, C, D, sigma, splits, bn, (cudaStream_t)stream);
}

// fp32 on the CUDA cores (inter_bwd_f32_kernel): the fused dTable, with
// epn_inter_conv_bwd_table's arguments (fp32 W and dout) and ws, an fp32
// workspace of K * C * D + b * p2 * D * 64 floats (W^T and dout^T in the
// layouts the kernel reads, written here), and the W-off dG,
// with epn_inter_conv_dg's (an fp32 dF). dT [b, q, na, C] fp32 must hold
// zeros. na must be 60, K 24, C a multiple of 16, 1 <= nn <= 64, and D
// (the fused entry) a multiple of 16.
extern "C" int epn_inter_conv_bwd_table_f32(const void* gx, const void* idx,
                                            const void* rk, const void* k2,
                                            const void* W, const void* dout,
                                            void* dT, int b, int p2, int nn,
                                            int q, int na, int K, int C,
                                            int D, float sigma, void* ws,
                                            void* stream) {
  if (na != scf32::kNA || K != NK || C % scf32::kCC != 0 ||
      D % scf32::kSD != 0 || D < scf32::kSD || nn < 1 ||
      nn > scf32::kMaxNN) {
    return (int)cudaErrorInvalidValue;
  }
  return scf32::launch<false>(gx, idx, rk, k2, W, ws, dout, dT, b, p2, nn, q,
                              C, D, sigma, (cudaStream_t)stream);
}

extern "C" int epn_inter_conv_dg_f32(const void* gx, const void* idx,
                                     const void* rk, const void* k2,
                                     const void* dF, void* dT, int b, int p2,
                                     int nn, int q, int na, int K, int C,
                                     float sigma, void* stream) {
  if (na != scf32::kNA || K != NK || C % scf32::kCC != 0 || nn < 1 ||
      nn > scf32::kMaxNN) {
    return (int)cudaErrorInvalidValue;
  }
  return scf32::launch<true>(gx, idx, rk, k2, nullptr, nullptr, dF, dT, b, p2,
                             nn, q, C, 0, sigma, (cudaStream_t)stream);
}
