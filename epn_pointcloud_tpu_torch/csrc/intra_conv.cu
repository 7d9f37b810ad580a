// Intra (rotation-group) SO(3) convolution, forward:
//
//   out[b, p, a, d] = sum_k sum_c f[b, p, trace_idx[a, k], c] * W[k, c, d]
//
// over the static 60 x 12 icosahedral group adjacency trace_idx.
//
// Replaces: epn_pointcloud_tpu/ops/pallas/intra_conv.py, intra_conv
// (_fwd_pallas -> _kernel), which runs 60 per-input-anchor MXU GEMMs per
// point tile and scatters each k-block into its target anchor's lanes.
//
// What bounds it on the H100: arithmetic. Seen as one GEMM it is
// [b*p*60 x 12C] x [12C x D] with a gathered left operand: 2 * 60 * 12 * C * D
// FLOPs per point against 60 * C * 4 bytes of input, i.e. ~1.5 TFLOP per b=32
// flagship forward (all seven layers). The SGEMM below (the fp32 prenorm
// form, and fp32 and bf16 off the models' shapes) runs on the CUDA cores
// (no TF32, no wgmma), so the fp32 FMA rate bounds it, and the design keeps
// the shared-memory traffic per FMA low enough not to bound it first. The
// fp32 plain form of every model layer runs intra_fwd_f32_kernel (below),
// also on the CUDA cores. The bf16 forward, B6 df and dW of every model
// layer run on tensor cores (intra_conv_mma_kernel and intra_dw_mma_kernel,
// at the end of this file), bound by the bf16 rate.
//
// Design of the SGEMM: a classic register-blocked SGEMM whose A rows are
// the flattened (point, anchor) pairs. A block computes a 128-row x
// BN-column tile (BN = 128, 64 or 32, whichever divides D) with 8 x 8
// outputs a thread, walking the reduction in slices of 16. Each slice
// stages the gathered A rows A[(p, a), (k, c)] = f[p, trace_idx[a, k], c]
// (16-byte loads: C % 4 == 0 keeps four consecutive c inside one k)
// transposed into shared memory, and
// the matching 16 rows of W (viewed as [12C, D]). The next slice's global
// loads are issued into registers before the current slice is computed, and
// land in the other of two shared-memory buffers (one barrier a slice).
// Per step of the reduction a thread reads 2 + 2 float4 for 64 FMAs.
// trace_idx is staged in shared memory once a block.
//
// fp32, the plain form (the parity mode: every model layer, 60 anchors, 12
// kernel points, C and D multiples of 32; the df too), runs on the CUDA
// cores in a kernel of its own (intra_fwd_f32_kernel; epn_intra_conv_f32),
// FFMA only: no TF32, as the TPU kernel's fp32 dot runs at HIGHEST
// precision. Its bound is the fp32 FMA rate: 1.54 TFLOP over the cls b=32
// forward's 7 calls (23.08 ms at 67 TFLOP/s), 0.58 over the cls b=12 step's
// 7 df calls (8.65 ms); reading f and W once costs 20-40x less. What held
// the SGEMM above (52% of that bound) back, taken by parts on the card
// (intra_conv_variants.py): without its FFMA it still takes 60% of its
// time, and that is neither its gather (the rows read in order: 2.5%
// faster) nor a wait on its global loads (waiting for each slice was 3.7%
// faster): it is its shared-memory loop, 4 16-byte loads a thread per 64
// FFMA, behind stores that transpose the slice with 4-way bank conflicts,
// in 128-row tiles that straddle points (so no point's rows are staged
// once), with 64-thread blocks at D = 32. The design: a block owns NP whole
// points (NP x 60 rows) by BN = 64 columns (NP = 4; at D % 64 != 0, 8
// points by 32 columns) and walks the reduction in chunks of 8 channels
// through a two-stage cp.async ring (the next chunk in flight behind this
// one's FFMA, one barrier a chunk); a chunk stages its points' f rows
// [NP, 60, 8] once and W's rows [12, 8, BN]. For kernel point k, output
// row (p, a) reads slab row trace[a, k]: the gather is the shared-load
// address (the adjacency staged once as slab offsets), so each f element
// leaves L2 D / BN times. The reduction runs chunk, kernel point, channel:
// a thread's offsets for k are read once and held over the chunk's
// channels. What bounds the product is the shared bytes loaded into
// registers per FFMA, which only the thread's tile sets: a thread owns 15
// anchors x 8 columns (120 fp32 sums; per 4 channels fifteen 16-byte loads
// of f, the 8 lanes of an anchor group reading one address, and eight of
// W, contiguous across the lanes: 0.77 bytes a FFMA, against 0.9 for 10 x
// 8 and 1.0 for the SGEMM's 8 x 8). 128 threads a block, two blocks an SM
// (8 warps at <= 255 registers, no spills): 10 x 8 sums in 192 threads
// (12 warps at 168) was 8% slower, 12 x 8 at 168 registers spilled and
// lost 27%, three blocks an SM at 96 registers lost 5x.
//
// Element type and prenorm: f, W and out are fp32 (parity mode) or bf16
// (production mode); products and sums are fp32, and out is rounded once on
// store. The PRENORM form (production mode; replaces _fwd_pallas ->
// _kernel_prenorm of intra_conv_prenorm) applies the preceding inter
// conv's deferred norm and activation on load,
//   z[b, p, x, c] = act(f[b, p, x, c] * scale[b, x*C + c] + shift[b, x*C + c])
// rounded to the element type (where _apply_prenorm rounds), then runs the
// same product on z. scale and shift are fp32 lanes [b or 1, 2, na*C] (row
// 0 scale, row 1 shift; batch stride 0 broadcasts one fold); act is the
// leaky ReLU of the launch's slope (0.01; 0 is the ReLU) with mask u > 0.
// The TPU's [b, 8, L] sublane padding does not come over. A prenorm load costs two more 16-byte reads of the (cached)
// fold and four FMAs per four elements.
//
// Backward. df needs no kernel of its own: every column k of trace_idx is a
// permutation of the anchors, so with inv[x, k] the one a with
// trace_idx[a, k] == x,
//   df[b, p, x, c] = sum_k sum_d dout[b, p, inv[x, k], d] * W[k, c, d],
// which is this forward kernel on (dout, inv, W transposed to [K, D, C]):
// a gather, deterministic, no atomics. It replaces the df half of
// _bwd_pallas -> _bwd_kernel (epn_pointcloud_tpu/ops/pallas/intra_conv.py).
//
// dW (the dW half of _bwd_kernel and _bwd_kernel_prenorm):
//   dW[k, c, d] = sum_{b, p, a} z[b, p, trace_idx[a, k], c] * dout[b, p, a, d]
// (z = f, or in the PRENORM form z = act(f * scale + shift) rounded to the
// element type as the forward rounds it) is a GEMM [K*C x rows] x [rows x D]
// reducing over rows = b*p*60 (368,640 at b=12 on the first layers): 2 *
// rows * 12 * C * D operations against rows * (C + D) elements read, bound
// by arithmetic. Each row range writes a partial dW to a workspace, and a
// second launch (split_sum.cuh) adds the partials in a fixed order:
// deterministic, no atomics; dW is fp32 (the caller's cast to a bf16 weight
// rounds it once, where _bwd_pallas rounds dw2.astype(w2.dtype)).
// bf16 at every model layer (60 anchors, 12 kernel points, C = D in 32, 64,
// 128, 256) runs on tensor cores (intra_dw_mma_kernel, at the end of this
// file; epn_intra_conv_bwd_w_mma): a block owns one range of rows in whole
// groups of 8 points (480 rows, 30 k16 steps), 32 channels for all 12
// kernel points (the 384 (k, c) rows of its dW) and 64 columns of D (32 at
// D = 32): 8 warps of 48 x 64 outputs, 96 fp32 accumulators a thread
// (250-252 registers, no spills), each gathered A fragment feeding 8 mma. Per group it stages the f rows of its channels and
// the dout rows of its columns once, in bf16 (cp.async into XOR-swizzled
// slabs, two sets of buffers: the group after next loads during this
// one's product), folds f into z in place in the prenorm form (once an
// element, where the SGEMM folds once for each kernel point and column
// block that reads it), and adds z^T dout on mma.sync.m16n8k16: for kernel
// point k the A fragment (z^T, ldmatrix.trans) takes reduction row (p, a)
// from slab row (p, trace[a, k]), so the adjacency gather is the row
// address each lane hands ldmatrix; B is the dout slab in order. Each pair
// of k16 steps sums into a fresh accumulator, added to the running sum by a
// rounding fp32 add (in place, the mma's truncating accumulation would lean
// dW toward zero over a split's thousands of steps). Rows past a split's
// end stage as zeros in both slabs. Each z element is read D / 64 times
// from device memory, each dout element C / 32 times; the blocks that
// share rows are neighbors in the grid (columns fastest), so the re-reads
// meet L2. The splits aim at two waves of one block an SM (DW_MMA_BLOCKS
// in ops/kernels/intra_conv.py), never a third wave's few blocks.
// fp32, the plain form (the parity mode: every model layer, 60 anchors, 12
// kernel points, C and D multiples of 32), runs on the CUDA cores in a
// kernel of its own (intra_dw_f32_kernel; epn_intra_conv_bwd_w_f32), FFMA
// only: no TF32, as the TPU kernel's fp32 dW dot runs at HIGHEST precision.
// It replaces the dW half of _bwd_pallas -> _bwd_kernel. Its bound is the
// fp32 FMA rate: 580 GFLOP over the cls b=12 step's 7 calls (8.65 ms at 67
// TFLOP/s) and 435 GFLOP over the inv step's 16 (6.49 ms); reading f and
// dout once costs 10-20x less. What held the SGEMM below (46% of that bound
// on the cls step) back: nothing was in flight while it computed (each
// 16-row slice crossed a barrier, staged by synchronous 16-byte loads,
// crossed another, then ran 1,024 FFMA a thread: L2 latency was hidden only
// by the other blocks on the SM); each f element was gathered from L2 12 x
// (D / BN) times (a block owns 128 (k, c) rows of dW, so each kernel point
// fetched it again) and dout re-read 12C / 128 times; and the narrow layers
// got tiny blocks (64 threads at C = D = 32). The design does this about
// them: a block owns 32 channels of all 12 kernel points and 32 columns of
// D (4 warps, three kernel points each) and walks its split's points one at
// a time; each point's f rows [60, 32] and dout rows [60, 32] stage once,
// by cp.async, into a three-stage ring (the next two points in flight
// behind this one's FFMA, one barrier a point). For kernel point k,
// reduction row (p, a) reads slab row trace[a, k]: the gather is the
// shared-load address (the adjacency staged once as each warp's slab
// offsets), so each f element leaves L2 D / 32 times and each dout element
// C / 32 times. A thread owns 3 kernel points x 4 channels x 8 columns (96
// fp32 sums, each adding its rows in order): per row one 16-byte load of
// offsets, three of f (a whole 128-byte slab row across each
// quarter-warp's 8 lanes, so no bank conflicts; the other quarters
// broadcast) and two of dout, for 96 FFMA; the row loop unrolled by 12
// keeps more rows' loads in flight beside the FFMA (by 2, 4 or 6 slower;
// intra_conv_variants.py). Three blocks an SM (12 warps at <= 168
// registers). Splits of whole points fill one or two waves of 396
// blocks (DW_F32_WAVE in ops/kernels/intra_conv.py): the 32-wide inv
// layers, a single (c, d) tile, split 391 ways, the 256-wide cls layers 12.
// The fp32 prenorm form and the other bf16 shapes run intra_dw_kernel, the
// register-blocked SGEMM on the CUDA cores: a block
// owns a 128 x BN tile of dW and one range of rows; it walks its rows 16 at
// a time, staging the gathered A^T slice (the adjacency gather, and the
// fold, done in the 16-byte staging loads, as in the forward) and the dout
// slice, with 8 x 8 outputs a thread.
//
// Prenorm backward (B6: _bwd_pallas -> _bwd_kernel_prenorm, the VJP of
// intra_conv_prenorm), with u = f * scale + shift and z = act(u):
//   dz = the df above (fp32, never rounded),  du = dz * (u > 0 ? 1 : slope)
//   df = du * scale (rounded to f's type),  dscale = sum_p du * f,
//   dshift = sum_p du  (per lane; over the clouds too when one fold serves
//   the batch),  dW = the dW above on z.
// intra_df_prenorm_kernel is the forward's product tile on the inverse
// adjacency with that epilogue. Its blocks own whole points of one cloud (2
// points at 60 anchors: 120 of the 128 rows work), so it sums du * f and du
// over its points in shared memory, point after point, and writes one
// partial a block and lane; split_sum.cuh adds them in a fixed order. No
// atomics anywhere: df, dscale, dshift and dW are deterministic. Bound, as
// the forward: the fp32 FMA rate; the epilogue reads f and the fold again.
//
// bf16 on tensor cores (intra_conv_mma_kernel; epn_intra_conv_mma,
// epn_intra_conv_prenorm_df_mma): the forward (plain and prenorm) and B6
// df of every model layer (60 anchors, 12 kernel points, C = D in 32, 64,
// 128, 256), on mma.sync.m16n8k16 bf16 -> fp32 (tc.cuh). A block owns NP
// whole points of one cloud (ROWS = NP * 60 rows, a whole number of m16
// tiles: no padding) and BN columns, with BN * ROWS = 30720 fp32
// accumulators (128 a thread): (NP, BN) = (4, 128), (8, 64) or (16, 32),
// the widest BN that divides D. It stages its points' z once, in bf16, in
// an XOR-swizzled slab [ROWS, C] (rows padded to 64 channels): in B5 the
// fold and the activation are applied there, once an element (the SGEMM
// applies them once for each of the 12 kernel points that read it). For
// kernel point k the A fragment's row for (point, anchor a) is slab row
// (point, trace[a, k]): the adjacency gather is the row address each lane
// hands ldmatrix, with no traffic of its own (the gathered rows' low bits
// are a permutation's, so some ldmatrix phases meet bank conflicts). W,
// [12C, D] (1.5 MB at C = D = 256), streams through a 3-stage cp.async ring
// 64 reduction rows a slice; at D = 256 two blocks (BN = 128) stage the
// same slab: the fold runs twice an element, against 240 KB of
// accumulators a block for BN = 256. Each pair of k16 steps (kGroup) sums
// its products in a fresh mma accumulator, added to the running fp32 sum
// with a round-to-nearest add: accumulated in place, the mma's truncating
// fp32 sums leaned the bf16 outputs toward zero (1.5e-4 .. 5.9e-4 more
// elements rounded toward zero than away from it, against the plain
// versions; ~1e-5 with the fresh accumulators) and moved a bf16 inv step's
// gradients past the smoke's gate (intra_conv_variants.py times and
// measures the forms: a fresh accumulator every four steps is ~7% faster
// and leans 2e-5, every step ~20% slower). The output is rounded once
// into a staged tile and stored by rows, as the grouped conv's. B6 df is
// the same mainloop on (dout, inv_idx, W^T), with no fold on load; its
// fp32 dz feeds intra_df_prenorm_kernel's epilogue: du and df = du * scale
// (rounded once), then du * x and du staged in fp32 and summed over the
// block's points for each (anchor, column), point after point, and over
// the blocks by split_sum.cuh. No atomics: bitwise repeatable. Rounding
// points are the SGEMM's and the plain versions': z rounded to bf16, sums
// fp32, the output rounded once; the fold is computed as the plain
// versions compute it (a product, then a sum: no FMA contraction), so z
// and the mask u > 0 are their bits.

#include <cuda_runtime.h>

#include "elem.cuh"
#include "split_sum.cuh"
#include "tc.cuh"

namespace {

constexpr int kMaxTrace = 1024;
constexpr int BM = 128;  // rows (point, anchor) a block
constexpr int BK = 16;   // reduction slice
constexpr int TM = 8;    // rows a thread: ty * 4 + i and BM / 2 + ty * 4 + i
constexpr int TN = 8;    // columns a thread: tx * 4 + j and BN / 2 + tx * 4 + j

template <int BN>
struct Tile {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kALoads = BM * BK / 4 / kThreads;  // float4 a thread
  static constexpr int kBLoads = BK * BN / 4 / kThreads;
  static_assert(kALoads * kThreads * 4 == BM * BK, "A tile split");
  static_assert(kBLoads * kThreads * 4 == BK * BN, "B tile split");
};

// z = act(v * scale + shift) per lane, rounded to the element type E
template <typename E>
__device__ __forceinline__ float4 prenorm4(float4 v, const float* ss, int L,
                                           float slope) {
  const float4 sc = *reinterpret_cast<const float4*>(ss);
  const float4 sh = *reinterpret_cast<const float4*>(ss + L);
  return make_float4(
      epn::round_to<E>(epn::leaky(fmaf(v.x, sc.x, sh.x), slope)),
      epn::round_to<E>(epn::leaky(fmaf(v.y, sc.y, sh.y), slope)),
      epn::round_to<E>(epn::leaky(fmaf(v.z, sc.z, sh.z), slope)),
      epn::round_to<E>(epn::leaky(fmaf(v.w, sc.w, sh.w), slope)));
}

// The global loads of reduction slice kk0 into registers: ra for the
// gathered A rows (through the prenorm when PRE), rb for the W rows.
template <typename E, bool PRE, int BN>
__device__ __forceinline__ void load_slice(
    const E* __restrict__ W, const int* __restrict__ s_trace,
    const E* (&a_pt)[Tile<BN>::kALoads],
    const float* (&a_ss)[Tile<BN>::kALoads],
    const int (&a_anchor)[Tile<BN>::kALoads], int kk0, int tid, int K, int C,
    int D, int n0, int L, float slope, float4 (&ra)[Tile<BN>::kALoads],
    float4 (&rb)[Tile<BN>::kBLoads]) {
  using T = Tile<BN>;
  const int KC = K * C;
#pragma unroll
  for (int i = 0; i < T::kALoads; ++i) {
    const int kk = kk0 + 4 * ((tid + i * T::kThreads) % 4);
    ra[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a_anchor[i] >= 0 && kk < KC) {
      const int k = kk / C, c = kk - k * C;
      const int lane = s_trace[a_anchor[i] * K + k] * C + c;
      ra[i] = epn::load4(a_pt[i] + lane);
      if (PRE) ra[i] = prenorm4<E>(ra[i], a_ss[i] + lane, L, slope);
    }
  }
#pragma unroll
  for (int i = 0; i < T::kBLoads; ++i) {
    const int e = tid + i * T::kThreads;
    const int kk = kk0 + e / (BN / 4), c4 = e % (BN / 4);
    rb[i] = kk < KC ? epn::load4(W + (size_t)kk * D + n0 + 4 * c4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Registers -> shared buffer: A transposed to [k][row], W as [k][col].
template <int BN>
__device__ __forceinline__ void store_slice(
    float (&As)[BK][BM], float (&Bs)[BK][BN], int tid,
    const float4 (&ra)[Tile<BN>::kALoads],
    const float4 (&rb)[Tile<BN>::kBLoads]) {
  using T = Tile<BN>;
#pragma unroll
  for (int i = 0; i < T::kALoads; ++i) {
    const int e = tid + i * T::kThreads;
    const int row = e / 4, q = 4 * (e % 4);
    As[q][row] = ra[i].x;
    As[q + 1][row] = ra[i].y;
    As[q + 2][row] = ra[i].z;
    As[q + 3][row] = ra[i].w;
  }
#pragma unroll
  for (int i = 0; i < T::kBLoads; ++i) {
    const int e = tid + i * T::kThreads;
    reinterpret_cast<float4*>(&Bs[e / (BN / 4)][0])[e % (BN / 4)] = rb[i];
  }
}

// The block's product tile acc = A[block rows] @ W[:, n0 : n0 + BN] over
// the reduction K * C, A's rows gathered through s_trace (and through the
// prenorm when PRE) as a_pt / a_ss / a_anchor give them.
template <typename E, bool PRE, int BN>
__device__ __forceinline__ void product_tile(
    const E* __restrict__ W, const int* __restrict__ s_trace,
    const E* (&a_pt)[Tile<BN>::kALoads],
    const float* (&a_ss)[Tile<BN>::kALoads],
    const int (&a_anchor)[Tile<BN>::kALoads], float (&As)[2][BK][BM],
    float (&Bs)[2][BK][BN], int tid, int K, int C, int D, int n0, int L,
    float slope, float (&acc)[TM][TN]) {
  using T = Tile<BN>;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  float4 ra[T::kALoads], rb[T::kBLoads];
  load_slice<E, PRE, BN>(W, s_trace, a_pt, a_ss, a_anchor, 0, tid, K, C, D, n0,
                         L, slope, ra, rb);
  store_slice<BN>(As[0], Bs[0], tid, ra, rb);
  __syncthreads();
  const int n_slices = (K * C + BK - 1) / BK;
  for (int s = 0; s < n_slices; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_slices) {
      load_slice<E, PRE, BN>(W, s_trace, a_pt, a_ss, a_anchor, (s + 1) * BK,
                             tid, K, C, D, n0, L, slope, ra, rb);
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
}

// row of the block tile that output row i (< TM) of thread row group ty is
__device__ __forceinline__ int tile_row(int ty, int i) {
  return i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4;
}

// PRE: ss is the prenorm fold [., 2, na * C] at batch stride ss_stride,
// applied with the activation of slope `slope` (a template flag, so the
// plain form carries no prenorm registers)
template <typename E, bool PRE, int BN>
__global__ void __launch_bounds__(Tile<BN>::kThreads)
intra_conv_kernel(const E* __restrict__ f, const int* __restrict__ trace_idx,
                  const E* __restrict__ W, const float* __restrict__ ss,
                  E* __restrict__ out, int M, int P, int na, int K, int C,
                  int D, int ss_stride, float slope) {
  using T = Tile<BN>;
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  __shared__ int s_trace[kMaxTrace];

  const int tid = threadIdx.x;
  for (int i = tid; i < na * K; i += T::kThreads) s_trace[i] = trace_idx[i];
  __syncthreads();
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // this thread's A rows are fixed over the reduction: the point's feature
  // rows and the anchor, per staged float4 (row = e / 4, slice quad = e % 4:
  // four lanes read one row's 64 contiguous bytes)
  const E* a_pt[T::kALoads];
  const float* a_ss[T::kALoads];
  int a_anchor[T::kALoads];
#pragma unroll
  for (int i = 0; i < T::kALoads; ++i) {
    const int gm = m0 + (tid + i * T::kThreads) / 4;
    const int pt = gm / na;
    a_anchor[i] = gm < M ? gm - pt * na : -1;
    a_pt[i] = f + (size_t)pt * na * C;
    a_ss[i] = PRE ? ss + (size_t)(pt / P) * ss_stride : nullptr;
  }

  float acc[TM][TN];
  product_tile<E, PRE, BN>(W, s_trace, a_pt, a_ss, a_anchor, As, Bs, tid, K,
                           C, D, n0, na * C, slope, acc);

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + tile_row(ty, i);
    if (gm < M) {
      E* op = out + (size_t)gm * D + n0;
      epn::store4(op + tx * 4,
                  make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      epn::store4(op + BN / 2 + tx * 4,
                  make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
    }
  }
}

// du = dz * act'(u) for four lanes, u = x * scale + shift (mask u > 0, as
// the forward's prenorm4; s the activation's slope), with the scale of the
// lanes in *sc
__device__ __forceinline__ float4 act_grad4(const float4& dz, const float4& x,
                                            const float* ss, int L, float s,
                                            float4* sc) {
  *sc = *reinterpret_cast<const float4*>(ss);
  const float4 sh = *reinterpret_cast<const float4*>(ss + L);
  return make_float4(fmaf(x.x, sc->x, sh.x) > 0.f ? dz.x : s * dz.x,
                     fmaf(x.y, sc->y, sh.y) > 0.f ? dz.y : s * dz.y,
                     fmaf(x.z, sc->z, sh.z) > 0.f ? dz.z : s * dz.z,
                     fmaf(x.w, sc->w, sh.w) > 0.f ? dz.w : s * dz.w);
}

// B6 df (the df half of _bwd_kernel_prenorm): the product tile is the
// forward's on (g = dout, inv_idx, Wt = W transposed to [K, C, D]), i.e. the
// fp32 dz of z = act(x * scale + shift), never rounded. The epilogue writes
// df = du * scale rounded to E, and sums dscale = du * x and dshift = du over
// the block's points. A block's rows are whole points of one cloud bi (the
// first np * na of its BM rows), so those sums are per (cloud, block, lane)
// partials, written to ws [2][nJ][b][na * D] for a fixed-order sum.
template <typename E, int BN>
__global__ void __launch_bounds__(Tile<BN>::kThreads)
intra_df_prenorm_kernel(const E* __restrict__ g,
                        const int* __restrict__ inv_idx,
                        const E* __restrict__ Wt, const E* __restrict__ x,
                        const float* __restrict__ ss, E* __restrict__ df,
                        float* __restrict__ ws, int b, int P, int na, int K,
                        int C, int D, int ss_stride, int nJ, float slope) {
  using T = Tile<BN>;
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  __shared__ int s_trace[kMaxTrace];

  const int tid = threadIdx.x;
  for (int i = tid; i < na * K; i += T::kThreads) s_trace[i] = inv_idx[i];
  __syncthreads();
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int bi = blockIdx.x / nJ, j = blockIdx.x - bi * nJ;
  const int ppb = BM / na;
  const int pt0 = bi * P + j * ppb;       // the block's first point
  const int np = min(ppb, P - j * ppb);   // and its number of points
  const int rows = np * na;
  const int n0 = blockIdx.y * BN;

  const E* a_pt[T::kALoads];
  const float* a_ss[T::kALoads];
  int a_anchor[T::kALoads];
#pragma unroll
  for (int i = 0; i < T::kALoads; ++i) {
    const int r = (tid + i * T::kThreads) / 4;
    const int pl = r / na;
    a_anchor[i] = r < rows ? r - pl * na : -1;
    a_pt[i] = g + (size_t)(pt0 + pl) * na * C;
    a_ss[i] = nullptr;
  }

  float acc[TM][TN];
  product_tile<E, false, BN>(Wt, s_trace, a_pt, a_ss, a_anchor, As, Bs, tid,
                             K, C, D, n0, na * C, 0.f, acc);

  const int L = na * D;                    // lanes of x, ss and df
  const float* ssb = ss + (size_t)bi * ss_stride;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tile_row(ty, i);
    if (r >= rows) continue;
    const int pl = r / na, a = r - pl * na;
    const size_t gm = (size_t)(pt0 + pl) * na + a;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * (BN / 2) + tx * 4;
      const float4 dz = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                    acc[i][4 * h + 2], acc[i][4 * h + 3]);
      float4 sc;
      const float4 du =
          act_grad4(dz, epn::load4(x + gm * D + n), ssb + a * D + n, L,
                    slope, &sc);
      epn::store4(df + gm * D + n, make_float4(du.x * sc.x, du.y * sc.y,
                                               du.z * sc.z, du.w * sc.w));
    }
  }

  // dscale (q = 0: du * x) and dshift (q = 1: du) summed over the block's
  // points in shared memory, one point after the other: each (anchor,
  // column) sum takes its terms in point order, no atomics
  float* s_red = &As[0][0][0];             // [na][BN], na * BN <= 2 BK BM
  for (int q = 0; q < 2; ++q) {
    for (int e = tid; e < na * BN; e += T::kThreads) s_red[e] = 0.f;
    __syncthreads();
    for (int pl = 0; pl < np; ++pl) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = tile_row(ty, i);
        if (r >= rows || r / na != pl) continue;
        const int a = r - pl * na;
        const size_t gm = (size_t)(pt0 + pl) * na + a;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cl = h * (BN / 2) + tx * 4, n = n0 + cl;
          const float4 dz = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                        acc[i][4 * h + 2], acc[i][4 * h + 3]);
          const float4 xv = epn::load4(x + gm * D + n);
          float4 sc;
          const float4 du =
              act_grad4(dz, xv, ssb + a * D + n, L, slope, &sc);
          float* sp = s_red + a * BN + cl;
          if (q == 0) {
            sp[0] += du.x * xv.x;
            sp[1] += du.y * xv.y;
            sp[2] += du.z * xv.z;
            sp[3] += du.w * xv.w;
          } else {
            sp[0] += du.x;
            sp[1] += du.y;
            sp[2] += du.z;
            sp[3] += du.w;
          }
        }
      }
      __syncthreads();
    }
    float* dst = ws + ((size_t)q * nJ * b + (size_t)j * b + bi) * L;
    for (int e = tid; e < na * BN; e += T::kThreads) {
      const int a = e / BN, cl = e - a * BN;
      dst[a * D + n0 + cl] = s_red[e];
    }
    __syncthreads();
  }
}

template <typename E, bool PRE>
int launch_fwd(const void* f, const int* trace_idx, const void* W,
               const float* ss, void* out, int M, int P, int na, int K, int C,
               int D, int ss_stride, float slope, cudaStream_t s) {
  const E* fp = (const E*)f;
  const E* wp = (const E*)W;
  E* op = (E*)out;
  const unsigned gx = (M + BM - 1) / BM;
  if (D % 128 == 0) {
    intra_conv_kernel<E, PRE, 128><<<dim3(gx, D / 128), Tile<128>::kThreads, 0,
                                     s>>>(fp, trace_idx, wp, ss, op, M, P, na,
                                          K, C, D, ss_stride, slope);
  } else if (D % 64 == 0) {
    intra_conv_kernel<E, PRE, 64><<<dim3(gx, D / 64), Tile<64>::kThreads, 0,
                                    s>>>(fp, trace_idx, wp, ss, op, M, P, na,
                                         K, C, D, ss_stride, slope);
  } else {
    intra_conv_kernel<E, PRE, 32><<<dim3(gx, D / 32), Tile<32>::kThreads, 0,
                                    s>>>(fp, trace_idx, wp, ss, op, M, P, na,
                                         K, C, D, ss_stride, slope);
  }
  return (int)cudaGetLastError();
}

template <typename E>
int launch(const void* f, const int* trace_idx, const void* W,
           const float* ss, void* out, int M, int P, int na, int K, int C,
           int D, int ss_stride, float slope, cudaStream_t s) {
  if (ss != nullptr) {
    return launch_fwd<E, true>(f, trace_idx, W, ss, out, M, P, na, K, C,
                               D, ss_stride, slope, s);
  }
  return launch_fwd<E, false>(f, trace_idx, W, ss, out, M, P, na, K, C, D,
                              ss_stride, slope, s);
}

constexpr int WBK = 16;  // rows a reduction slice of dW

// dW tile: (k, c) rows kc0 + ty * 4 + i and kc0 + BM / 2 + ty * 4 + i, d
// columns n0 + tx * 4 + j and n0 + BN / 2 + tx * 4 + j. PRE: the staged f
// is z = act(f * scale + shift) rounded to E, as the prenorm forward's.
template <typename E, bool PRE, int BN>
__global__ void __launch_bounds__(Tile<BN>::kThreads)
intra_dw_kernel(const E* __restrict__ f, const int* __restrict__ trace_idx,
                const float* __restrict__ ss, const E* __restrict__ dout,
                float* __restrict__ part, int M, int P, int na, int K, int C,
                int D, int ss_stride, float slope, int rows_per_split) {
  using T = Tile<BN>;
  __shared__ __align__(16) float As[WBK][BM];
  __shared__ __align__(16) float Bs[WBK][BN];
  __shared__ int s_trace[kMaxTrace];

  const int tid = threadIdx.x;
  for (int i = tid; i < na * K; i += T::kThreads) s_trace[i] = trace_idx[i];
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int kc0 = blockIdx.x * BM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int r_begin = split * rows_per_split;
  const int r_end = min(M, r_begin + rows_per_split);
  const int KC = K * C;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  for (int m0 = r_begin; m0 < r_end; m0 += WBK) {
    __syncthreads();
    for (int e = tid; e < WBK * BM / 4; e += T::kThreads) {
      const int rr = e / (BM / 4), j4 = e % (BM / 4);
      const int m = m0 + rr, kc = kc0 + 4 * j4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < r_end && kc < KC) {
        const int pt = m / na, a = m - pt * na;
        const int k = kc / C, c = kc - k * C;
        const int lane = s_trace[a * K + k] * C + c;
        v = epn::load4(f + (size_t)pt * na * C + lane);
        if (PRE) {
          v = prenorm4<E>(v, ss + (size_t)(pt / P) * ss_stride + lane, na * C,
                          slope);
        }
      }
      reinterpret_cast<float4*>(&As[rr][0])[j4] = v;
    }
    for (int e = tid; e < WBK * BN / 4; e += T::kThreads) {
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

  float* dst = part + (size_t)split * KC * D;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int kc = kc0 + tile_row(ty, i);
    if (kc < KC) {
      float* op = dst + (size_t)kc * D + n0;
      *reinterpret_cast<float4*>(op + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(op + BN / 2 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

template <typename E, bool PRE, int BN>
int launch_dw(const void* f, const int* trace_idx, const float* ss,
              const void* dout, float* ws, float* dW, int M, int P, int na,
              int K, int C, int D, int ss_stride, float slope, int splits,
              cudaStream_t stream) {
  const int slices = (M + WBK - 1) / WBK;
  const int rows_per_split = (slices + splits - 1) / splits * WBK;
  dim3 grid((K * C + BM - 1) / BM, D / BN, splits);
  intra_dw_kernel<E, PRE, BN><<<grid, Tile<BN>::kThreads, 0, stream>>>(
      (const E*)f, trace_idx, ss, (const E*)dout, ws, M, P, na, K, C, D,
      ss_stride, slope, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_splits(ws, dW, splits, (size_t)K * C * D, stream);
}

template <typename E, bool PRE>
int launch_dw_cols(const void* f, const int* trace_idx, const float* ss,
                   const void* dout, float* ws, float* dW, int M, int P,
                   int na, int K, int C, int D, int ss_stride, float slope,
                   int splits, cudaStream_t s) {
  if (D % 128 == 0) {
    return launch_dw<E, PRE, 128>(f, trace_idx, ss, dout, ws, dW, M, P, na, K,
                                  C, D, ss_stride, slope, splits, s);
  }
  if (D % 64 == 0) {
    return launch_dw<E, PRE, 64>(f, trace_idx, ss, dout, ws, dW, M, P, na, K,
                                 C, D, ss_stride, slope, splits, s);
  }
  return launch_dw<E, PRE, 32>(f, trace_idx, ss, dout, ws, dW, M, P, na, K, C,
                               D, ss_stride, slope, splits, s);
}

template <typename E>
int launch_dw_any(const void* f, const int* trace_idx, const float* ss,
                  const void* dout, float* ws, float* dW, int M, int P, int na,
                  int K, int C, int D, int ss_stride, float slope, int splits,
                  cudaStream_t s) {
  if (ss != nullptr) {
    return launch_dw_cols<E, true>(f, trace_idx, ss, dout, ws, dW, M, P, na,
                                   K, C, D, ss_stride, slope, splits, s);
  }
  return launch_dw_cols<E, false>(f, trace_idx, ss, dout, ws, dW, M, P, na, K,
                                  C, D, ss_stride, slope, splits, s);
}

template <typename E, int BN>
int launch_df_prenorm(const void* g, const int* inv_idx, const void* Wt,
                      const void* x, const float* ss, void* df, float* ws,
                      float* dscale, float* dshift, int b, int P, int na,
                      int K, int C, int D, int ss_batch, float slope,
                      cudaStream_t s) {
  const int nJ = (P + BM / na - 1) / (BM / na);
  const size_t L = (size_t)na * D;
  intra_df_prenorm_kernel<E, BN><<<dim3(b * nJ, D / BN), Tile<BN>::kThreads,
                                   0, s>>>(
      (const E*)g, inv_idx, (const E*)Wt, (const E*)x, ss, (E*)df, ws, b, P,
      na, K, C, D, ss_batch > 1 ? (int)(2 * L) : 0, nJ, slope);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the partials [nJ][b][L] in order: over each cloud's blocks (a fold per
  // cloud) or over every block (one fold for the batch)
  const int splits = ss_batch > 1 ? nJ : nJ * b;
  const size_t n = ss_batch > 1 ? b * L : L;
  const int e = launch_sum_splits(ws, dscale, splits, n, s);
  if (e != 0) return e;
  return launch_sum_splits(ws + (size_t)nJ * b * L, dshift, splits, n, s);
}

template <typename E>
int launch_df_prenorm_cols(const void* g, const int* inv_idx, const void* Wt,
                           const void* x, const float* ss, void* df, float* ws,
                           float* dscale, float* dshift, int b, int P, int na,
                           int K, int C, int D, int ss_batch, float slope,
                           cudaStream_t s) {
  if (D % 64 == 0 && na * 64 <= 2 * BK * BM) {
    return launch_df_prenorm<E, 64>(g, inv_idx, Wt, x, ss, df, ws, dscale,
                                    dshift, b, P, na, K, C, D, ss_batch, slope,
                                    s);
  }
  return launch_df_prenorm<E, 32>(g, inv_idx, Wt, x, ss, df, ws, dscale,
                                  dshift, b, P, na, K, C, D, ss_batch, slope,
                                  s);
}


// ------------------------------------------------- bf16 on tensor cores

using epn::bf16;

namespace mma {

constexpr int kNA = 60;          // anchors: the rows of a point
constexpr int kK = 12;           // kernel points
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSK = 64;          // reduction rows a W slice
constexpr int kGroup = 2;        // k16 steps summed in one fresh accumulator
static_assert(kSK % (16 * kGroup) == 0, "a group within a W slice");
constexpr int kStages = 3;       // W slices in the ring
constexpr int kTraceBytes = 3072;  // the adjacency [kK][kNA] int, padded
constexpr size_t kMaxSmem = 227 * 1024;

// A block's shape for BN output columns: NP whole points of one cloud
// (ROWS = NP * 60 rows, TILES m16 tiles, no padding: 15, 30 or 60), WM x WN
// warps, MI m16 x NI n8 tiles a warp; BN x ROWS = 30720 accumulators, 128
// a thread. The bf16 output tile is staged at row stride OS (padded: the
// fragments' 4-byte writes hit distinct banks).
template <int BN_>
struct Cfg {
  static constexpr int BN = BN_;
  static constexpr int WN = BN >= 128 ? BN / 64 : 1, WM = kWarps / WN;
  static constexpr int NI = BN / WN / 8;
  static constexpr int NP = 512 / BN;
  static constexpr int ROWS = NP * kNA, TILES = ROWS / 16;
  static constexpr int MI = (TILES + WM - 1) / WM;
  static constexpr int OS = BN + 8;
  static constexpr int RS = BN + 4;  // df's staged sums, [ROWS][RS] fp32
  static_assert(NI % 2 == 0 && TILES * 16 == ROWS, "warp tile");
};

// the columns of D a block owns: 128 where D allows, else 64 or 32
__host__ __device__ inline int pick_bn(int D) {
  return D % 128 == 0 ? 128 : D % 64 == 0 ? 64 : 32;
}

// the slab's row stride in elements: C, at least 64 (a 128-byte line, so
// the XOR swizzle of tc::swz keys on the slab row's low three bits)
__host__ __device__ inline int slab_stride(int C) { return C < 64 ? 64 : C; }

// u = v * scale + shift rounded twice, as the plain versions compute it
// (no FMA contraction: z and the mask u > 0 are the plain versions' bits)
__device__ __forceinline__ float fold(float v, float scale, float shift) {
  return __fadd_rn(__fmul_rn(v, scale), shift);
}

// dynamic shared memory, in bytes: the adjacency, then the slab
// [ROWS, slab_stride(C)] and the W ring [kStages][kSK, BN]; after the
// product the same memory holds the staged output tile [ROWS, OS] and, for
// df, the terms of its per-(anchor, column) sums [ROWS][RS] fp32
template <int BN>
__host__ __device__ inline size_t smem_bytes(int C, bool df) {
  using G = Cfg<BN>;
  const size_t main = (size_t)G::ROWS * slab_stride(C) * sizeof(bf16) +
                      (size_t)kStages * kSK * BN * sizeof(bf16);
  const size_t epi = (size_t)G::ROWS * G::OS * sizeof(bf16) +
                     (df ? (size_t)G::ROWS * G::RS * sizeof(float) : 0);
  return kTraceBytes + (main > epi ? main : epi);
}

// out[p, a, n0 + n] = sum_k sum_c z[p, trace[a, k], c] W[k, c, n0 + n] for
// the block's NP points (pt0 on; np of them live) and BN columns, on
// tensor cores. The slab holds z (PRE: act(fold(g, scale, shift)) rounded
// to bf16, else g itself) of those points, staged once; for kernel point k
// the A fragment's row for (point, anchor a) is the slab row (point,
// trace[a, k]): the gather is the row address each lane gives ldmatrix.
// W streams as [12C, D] rows through a cp.async ring, kSK rows a slice.
// DF: the product is dz of B6 (g = dout, trace = inv_idx, W = W^T), and
// the epilogue forms du = dz * act'(x * scale + shift), df = du * scale
// (rounded to bf16) and the per-block sums of du * x and du.
template <int BN, bool PRE, bool DF>
__global__ void __launch_bounds__(kThreads, 1)
intra_conv_mma_kernel(const bf16* __restrict__ g,
                      const int* __restrict__ trace,
                      const bf16* __restrict__ W,
                      const float* __restrict__ ss,
                      const bf16* __restrict__ x, bf16* __restrict__ out,
                      float* __restrict__ ws, int b, int P, int C, int D,
                      int ss_stride, int nJ, float slope) {
  using G = Cfg<BN>;
  extern __shared__ __align__(128) unsigned char mma_smem[];
  int* s_trace = reinterpret_cast<int*>(mma_smem);
  bf16* slab = reinterpret_cast<bf16*>(mma_smem + kTraceBytes);
  const int S = slab_stride(C);
  bf16* ring = slab + (size_t)G::ROWS * S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int bi = blockIdx.x / nJ, j = blockIdx.x - bi * nJ;
  const int np = min(G::NP, P - j * G::NP);
  const int rows = np * kNA, live = (rows + 15) / 16;
  const size_t row0 = ((size_t)bi * P + (size_t)j * G::NP) * kNA;
  const int n0 = blockIdx.y * BN;
  const int steps = kK * C / kSK;

  // W slice `step`: rows step * kSK .. + kSK of W viewed as [12C, D]
  auto load_w = [&](int step) {
    bf16* dst = ring + (size_t)(step % kStages) * kSK * BN;
    for (int e = tid; e < kSK * BN / 8; e += kThreads) {
      const int r = e / (BN / 8), c8 = e % (BN / 8) * 8;
      tc::cp16(tc::smem_addr(dst + tc::swz(r, c8, BN / 8)),
               W + (size_t)(step * kSK + r) * D + n0 + c8, true);
    }
  };

  for (int i = tid; i < kNA * kK; i += kThreads) {
    const int a = i / kK, k = i - a * kK;
    s_trace[k * kNA + a] = trace[i];
  }
  // the slab: cp.async straight from g, or through the fold in registers
  const bf16* gb = g + row0 * C;
  const float* ssb = PRE ? ss + (size_t)bi * ss_stride : nullptr;
  const int cpr = C / 8;
  for (int e = tid; e < rows * cpr; e += kThreads) {
    const int r = e / cpr, c8 = (e - r * cpr) * 8;
    bf16* dst = slab + tc::swz(r, c8, S / 8);
    if constexpr (PRE) {
      float v[8], sc[8], sh[8];
      epn::load8(gb + (size_t)r * C + c8, v);
      epn::load8(ssb + (r % kNA) * C + c8, sc);
      epn::load8(ssb + (kNA + r % kNA) * C + c8, sh);
      uint32_t o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        o[q] = epn::pack2(
            epn::leaky(fold(v[2 * q], sc[2 * q], sh[2 * q]), slope),
            epn::leaky(fold(v[2 * q + 1], sc[2 * q + 1], sh[2 * q + 1]),
                       slope));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      tc::cp16(tc::smem_addr(dst), gb + (size_t)r * C + c8, true);
    }
  }
  if constexpr (!PRE) tc::cp_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_w(s);
    tc::cp_commit();
  }

  // this lane's A rows: tile row lane & 15 of each of the warp's m16
  // tiles, as (point * 60, anchor); a row past the live points reads point
  // 0's (its outputs are not stored)
  const int wm = warp / G::WN, wn = warp % G::WN;
  int pt60[G::MI], anc[G::MI];
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi) {
    const int r = (wm * G::MI + mi) * 16 + (lane & 15);
    const int pt = r < rows ? r / kNA : 0;
    pt60[mi] = pt * kNA;
    anc[mi] = r < rows ? r - pt * kNA : 0;
  }

  float acc[G::MI][G::NI][4];
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[mi][ni][h] = 0.f;

  for (int step = 0; step < steps; ++step) {
    tc::cp_wait<kStages - 2>();
    __syncthreads();
    if (step + kStages - 1 < steps) load_w(step + kStages - 1);
    tc::cp_commit();
    const bf16* wsl = ring + (size_t)(step % kStages) * kSK * BN;
#pragma unroll
    for (int kk = 0; kk < kSK; kk += 16 * kGroup) {
      // the group's B fragments (W rows kk .. kk + 16 kGroup of the slice)
      // and, per k16 step, its kernel point's adjacency column and channel
      uint32_t bf[kGroup][G::NI][2];
      const int* tk[kGroup];
      int cg[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int red = step * kSK + kk + 16 * u;  // reduction row k C + c
        const int k = red / C;
        tk[u] = s_trace + k * kNA;
        cg[u] = red - k * C;
#pragma unroll
        for (int nj = 0; nj < G::NI / 2; ++nj) {
          uint32_t r4[4];
          tc::ldsm4t(r4, tc::smem_addr(
                             wsl + tc::swz(kk + 16 * u + (lane & 7) +
                                               ((lane >> 3) & 1) * 8,
                                           wn * (BN / G::WN) + nj * 16 +
                                               (lane >> 4) * 8,
                                           BN / 8)));
          bf[u][2 * nj][0] = r4[0];
          bf[u][2 * nj][1] = r4[1];
          bf[u][2 * nj + 1][0] = r4[2];
          bf[u][2 * nj + 1][1] = r4[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) {
        if (wm * G::MI + mi < live) {  // warp-uniform
          // the group's products into a fresh accumulator, added to the
          // running sum by an fp32 add that rounds to nearest: the mma's
          // own accumulation truncates, and over the 48-192 k16 steps of a
          // row it biases the rounded outputs toward zero
          float t[G::NI][4];
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
            for (int h = 0; h < 4; ++h) t[ni][h] = 0.f;
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            uint32_t af[4];
            tc::ldsm4(af, tc::smem_addr(
                              slab + tc::swz(pt60[mi] + tk[u][anc[mi]],
                                             cg[u] + (lane >> 4) * 8,
                                             S / 8)));
#pragma unroll
            for (int ni = 0; ni < G::NI; ++ni)
              tc::mma(t[ni], af, bf[u][ni][0], bf[u][ni][1]);
          }
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
            for (int h = 0; h < 4; ++h) acc[mi][ni][h] += t[ni][h];
        }
      }
    }
  }
  tc::cp_wait<0>();
  __syncthreads();  // the slab and the ring are free

  bf16* ot = slab;
  if constexpr (!DF) {
    // the output rounded once into the staged tile
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (wm * G::MI + mi) * 16 + gq + 8 * h;
          const int cl = wn * (BN / G::WN) + ni * 8 + 2 * tq;
          if (r < rows) {
            *reinterpret_cast<uint32_t*>(ot + r * G::OS + cl) =
                epn::pack2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
          }
        }
  } else {
    // du = dz * act'(u) (kept in acc) and df = du * scale rounded into the
    // staged tile; then du * x (q = 0) and du (q = 1), each staged in fp32
    // [ROWS][RS] and summed over the block's points for every (anchor,
    // column), point after point: no atomics, no barrier a point
    float* red = reinterpret_cast<float*>(ot + G::ROWS * G::OS);
    const int L = kNA * D;                  // lanes of x, ss and df
    const float* ssd = ss + (size_t)bi * ss_stride;
    auto reduce = [&](int q) {
      __syncthreads();
      float* dst = ws + ((size_t)q * nJ * b + (size_t)j * b + bi) * L + n0;
      for (int e = tid; e < kNA * BN; e += kThreads) {
        const int a = e / BN, cl = e - a * BN;
        float sum = 0.f;
        for (int pl = 0; pl < np; ++pl) sum += red[(pl * kNA + a) * G::RS + cl];
        dst[a * D + cl] = sum;
      }
      __syncthreads();
    };
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * G::MI + mi) * 16 + gq + 8 * h;
        if (r >= rows) continue;
        const bf16* xr = x + (row0 + r) * D + n0;
        const float* sc = ssd + (r % kNA) * D + n0;
#pragma unroll
        for (int ni = 0; ni < G::NI; ++ni) {
          const int cl = wn * (BN / G::WN) + ni * 8 + 2 * tq;
          const float2 xv = epn::load2(xr + cl);
          const float2 s2 = *reinterpret_cast<const float2*>(sc + cl);
          const float2 h2 = *reinterpret_cast<const float2*>(sc + L + cl);
          float& du0 = acc[mi][ni][2 * h];
          float& du1 = acc[mi][ni][2 * h + 1];
          if (!(fold(xv.x, s2.x, h2.x) > 0.f)) du0 *= slope;
          if (!(fold(xv.y, s2.y, h2.y) > 0.f)) du1 *= slope;
          *reinterpret_cast<uint32_t*>(ot + r * G::OS + cl) =
              epn::pack2(du0 * s2.x, du1 * s2.y);
          *reinterpret_cast<float2*>(red + r * G::RS + cl) =
              make_float2(du0 * xv.x, du1 * xv.y);
        }
      }
    reduce(0);
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * G::MI + mi) * 16 + gq + 8 * h;
        if (r >= rows) continue;
#pragma unroll
        for (int ni = 0; ni < G::NI; ++ni) {
          const int cl = wn * (BN / G::WN) + ni * 8 + 2 * tq;
          *reinterpret_cast<float2*>(red + r * G::RS + cl) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        }
      }
    reduce(1);
  }
  __syncthreads();
  for (int e = tid; e < rows * (BN / 8); e += kThreads) {
    const int r = e / (BN / 8), c8 = e % (BN / 8) * 8;
    *reinterpret_cast<uint4*>(out + (row0 + r) * D + n0 + c8) =
        *reinterpret_cast<const uint4*>(ot + r * G::OS + c8);
  }
}

template <int BN, bool PRE, bool DF>
int launch(const void* g, const int* trace, const void* W, const float* ss,
           const void* x, void* out, float* ws, int b, int P, int C, int D,
           int ss_stride, float slope, cudaStream_t stream) {
  using G = Cfg<BN>;
  const size_t smem = smem_bytes<BN>(C, DF);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = intra_conv_mma_kernel<BN, PRE, DF>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nJ = (P + G::NP - 1) / G::NP;
  kern<<<dim3(b * nJ, D / BN), kThreads, smem, stream>>>(
      (const bf16*)g, trace, (const bf16*)W, ss, (const bf16*)x, (bf16*)out,
      ws, b, P, C, D, ss_stride, nJ, slope);
  return (int)cudaGetLastError();
}

template <bool PRE, bool DF>
int launch_bn(const void* g, const int* trace, const void* W,
              const float* ss, const void* x, void* out, float* ws, int b,
              int P, int C, int D, int ss_stride, float slope,
              cudaStream_t s) {
  switch (pick_bn(D)) {
    case 128:
      return launch<128, PRE, DF>(g, trace, W, ss, x, out, ws, b, P, C, D,
                                  ss_stride, slope, s);
    case 64:
      return launch<64, PRE, DF>(g, trace, W, ss, x, out, ws, b, P, C, D,
                                 ss_stride, slope, s);
    default:
      return launch<32, PRE, DF>(g, trace, W, ss, x, out, ws, b, P, C, D,
                                 ss_stride, slope, s);
  }
}

// the points a block of the tensor-core kernels owns at D output columns
inline int block_points(int D) { return 512 / pick_bn(D); }

}  // namespace mma

// ------------------------------------------- bf16 dW on tensor cores

namespace dwmma {

using mma::kK;
using mma::kNA;
constexpr int kNP = 8;                 // points a group
constexpr int kRows = kNP * kNA;       // 480 rows a group: 30 k16 steps
constexpr int kCB = 32;                // channels a block
constexpr int kKC = kK * kCB;          // the block's dW rows (k, c): 384
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 2;              // k16 steps a fresh accumulator
static_assert(kRows % (16 * kGroup) == 0, "whole groups of k16 steps");

// A block's warps over its [kKC, BN] tile of dW: each warp 48 rows (MI = 3
// m16 tiles) by all BN columns (NI n8 tiles; BN = 64: 96 accumulators a
// thread), so each gathered A fragment feeds NI mma (warps of 96 x 32
// would gather twice as many for the same products); shared memory:
// the adjacency, then two buffers of the z slab [kRows, kCB] and the dout
// slab [kRows, BN] (bf16)
template <int BN>
struct Cfg {
  static constexpr int MI = kKC / kWarps / 16, NI = BN / 8;
  static constexpr size_t kZ = (size_t)kRows * kCB * sizeof(bf16);
  static constexpr size_t kBuf = kZ + (size_t)kRows * BN * sizeof(bf16);
  static constexpr size_t kSmem = mma::kTraceBytes + 2 * kBuf;
  static_assert(MI * kWarps * 16 == kKC && NI % 2 == 0, "warp tile");
};

// the columns of D a block owns: 64 where D allows, else 32
__host__ __device__ inline int pick_bn(int D) { return D % 64 == 0 ? 64 : 32; }

// The partial dW [kK, C, D] of split blockIdx.z (points pt_begin .. pt_end)
// for channels c0 .. c0 + kCB (all 12 kernel points) and columns n0 .. n0 +
// BN, a group of kNP points at a time over two sets of buffers: the group
// after next's f and dout rows go out by cp.async (zeros past pt_end) while
// this one's product runs. PRE: the slab's f is folded in place into z =
// act(fold(f, scale, shift)) rounded to bf16, once an element, before the
// product. The product adds z^T dout: for kernel point k the A fragment
// (z^T, by ldmatrix.trans) takes its reduction row (p, a) from slab row
// (p, trace[a, k]), so the gather is the row address each lane hands
// ldmatrix; B is the dout slab in order. Each kGroup k16 steps go into a
// fresh accumulator, added to the running sum by a rounding fp32 add.
template <int BN, bool PRE>
__global__ void __launch_bounds__(kThreads, 1)
intra_dw_mma_kernel(const bf16* __restrict__ f, const int* __restrict__ trace,
                    const float* __restrict__ ss,
                    const bf16* __restrict__ dout, float* __restrict__ part,
                    int n_pts, int P, int C, int D, int ss_stride,
                    float slope, int pts_per_split) {
  using G = Cfg<BN>;
  extern __shared__ __align__(128) unsigned char dw_smem[];
  int* s_trace = reinterpret_cast<int*>(dw_smem);
  unsigned char* bufs = dw_smem + mma::kTraceBytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * kCB, split = blockIdx.z;
  const int pt_begin = split * pts_per_split;
  const int pt_end = min(n_pts, pt_begin + pts_per_split);

  for (int i = tid; i < kNA * kK; i += kThreads) {
    const int a = i / kK, k = i - a * kK;
    s_trace[k * kNA + a] = trace[i];
  }

  // the group of points pt0 .. into buffer s, one commit group
  auto load = [&](int pt0, int s) {
    if (pt0 < pt_end) {
      const int live = min(kNP, pt_end - pt0) * kNA;
      const size_t row0 = (size_t)pt0 * kNA;
      bf16* zs = reinterpret_cast<bf16*>(bufs + s * G::kBuf);
      bf16* ds = reinterpret_cast<bf16*>(bufs + s * G::kBuf + G::kZ);
      for (int e = tid; e < kRows * (kCB / 8); e += kThreads) {
        const int r = e / (kCB / 8), c8 = e % (kCB / 8) * 8;
        const bool ok = r < live;
        tc::cp16(tc::smem_addr(zs + tc::swz(r, c8, kCB / 8)),
                 ok ? f + (row0 + r) * C + c0 + c8 : f, ok);
      }
      for (int e = tid; e < kRows * (BN / 8); e += kThreads) {
        const int r = e / (BN / 8), c8 = e % (BN / 8) * 8;
        const bool ok = r < live;
        tc::cp16(tc::smem_addr(ds + tc::swz(r, c8, BN / 8)),
                 ok ? dout + (row0 + r) * D + n0 + c8 : dout, ok);
      }
    }
    tc::cp_commit();
  };

  // the lane's ldmatrix.trans rows and columns: A (z^T) reduction row a_row
  // of a k16 step at channel column a_col of its m16 tile; B (dout) at the
  // per-lane base b_off of each pair of n8 tiles (rows 16 apart keep the
  // swizzle's XOR term, so a step adds its rows)
  const int a_row = (lane & 7) + (lane >> 4) * 8;
  const int a_col = ((lane >> 3) & 1) * 8;
  int b_off[G::NI / 2];
#pragma unroll
  for (int nj = 0; nj < G::NI / 2; ++nj)
    b_off[nj] = tc::swz((lane & 7) + ((lane >> 3) & 1) * 8,
                        nj * 16 + (lane >> 4) * 8, BN / 8);

  float acc[G::MI][G::NI][4];
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[mi][ni][h] = 0.f;

  load(pt_begin, 0);
  load(pt_begin + kNP, 1);
  for (int pt0 = pt_begin, s = 0; pt0 < pt_end; pt0 += kNP, s ^= 1) {
    tc::cp_wait<1>();
    __syncthreads();  // this group's rows (and the adjacency) visible
    const int live = min(kNP, pt_end - pt0) * kNA;
    bf16* zs = reinterpret_cast<bf16*>(bufs + s * G::kBuf);
    const bf16* ds = reinterpret_cast<const bf16*>(bufs + s * G::kBuf + G::kZ);
    if constexpr (PRE) {
      // the fold in place, live rows only (a zero row stays zero)
      for (int e = tid; e < live * (kCB / 8); e += kThreads) {
        const int r = e / (kCB / 8), c8 = e % (kCB / 8) * 8;
        const int pl = r / kNA, x = r - pl * kNA;
        const float* sc =
            ss + (size_t)((pt0 + pl) / P) * ss_stride + x * C + c0 + c8;
        uint4* zp = reinterpret_cast<uint4*>(zs + tc::swz(r, c8, kCB / 8));
        float v[8], a[8], h[8];
        epn::load8(reinterpret_cast<const bf16*>(zp), v);
        epn::load8(sc, a);
        epn::load8(sc + kNA * C, h);
        uint32_t o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          o[q] = epn::pack2(
              epn::leaky(mma::fold(v[2 * q], a[2 * q], h[2 * q]), slope),
              epn::leaky(mma::fold(v[2 * q + 1], a[2 * q + 1], h[2 * q + 1]),
                         slope));
        }
        *zp = make_uint4(o[0], o[1], o[2], o[3]);
      }
      __syncthreads();
    }

#pragma unroll 1
    for (int kg = 0; kg < live; kg += 16 * kGroup) {
      // each step's lane row as (point * 60, anchor), then the A fragments
      // of the warp's m16 tiles (k, 16 channels), their rows gathered
      // through kernel point k's adjacency column
      int p60[kGroup], anc[kGroup];
#pragma unroll
      for (int ks = 0; ks < kGroup; ++ks) {
        const int r = kg + 16 * ks + a_row;
        p60[ks] = r / kNA * kNA;
        anc[ks] = r - p60[ks];
      }
      uint32_t af[G::MI][kGroup][4];
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) {
        constexpr int kTiles = kCB / 16;
        const int tile = warp * G::MI + mi;
        const int k = tile / kTiles;
        const int* tk = s_trace + k * kNA;
        const int col = tile % kTiles * 16 + a_col;
#pragma unroll
        for (int ks = 0; ks < kGroup; ++ks) {
          tc::ldsm4t(af[mi][ks], tc::smem_addr(
                                 zs + tc::swz(p60[ks] + tk[anc[ks]], col,
                                              kCB / 8)));
        }
      }
      // per pair of n8 tiles its B fragments (dout in order), then the
      // kGroup products of each tile into a fresh accumulator
#pragma unroll
      for (int nj = 0; nj < G::NI / 2; ++nj) {
        uint32_t bq[kGroup][4];
#pragma unroll
        for (int ks = 0; ks < kGroup; ++ks)
          tc::ldsm4t(bq[ks],
                     tc::smem_addr(ds + (kg + 16 * ks) * BN + b_off[nj]));
#pragma unroll
        for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float r4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int ks = 0; ks < kGroup; ++ks)
              tc::mma(r4, af[mi][ks], bq[ks][2 * h2], bq[ks][2 * h2 + 1]);
#pragma unroll
            for (int h = 0; h < 4; ++h) acc[mi][2 * nj + h2][h] += r4[h];
          }
      }
    }
    __syncthreads();  // every product is done with buffer s
    load(pt0 + 2 * kNP, s);
  }
  tc::cp_wait<0>();

  // the split's partial: dW row k * C + c0 + cc of each tile row (k, cc)
  float* dst = part + (size_t)split * kK * C * D + n0 + 2 * t;
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (warp * G::MI + mi) * 16 + g + 8 * h;
      const int k = m / kCB, cc = m - k * kCB;
      float* rowp = dst + ((size_t)k * C + c0 + cc) * D;
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
        *reinterpret_cast<float2*>(rowp + ni * 8) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

template <int BN, bool PRE>
int launch(const void* f, const int* trace, const float* ss, const void* dout,
           float* ws, float* dW, int n_pts, int P, int C, int D,
           int ss_stride, float slope, int splits, int pts_per_split,
           cudaStream_t stream) {
  using G = Cfg<BN>;
  if (G::kSmem > mma::kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = intra_dw_mma_kernel<BN, PRE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(D / BN, C / kCB, splits), kThreads, G::kSmem, stream>>>(
      (const bf16*)f, trace, ss, (const bf16*)dout, ws, n_pts, P, C, D,
      ss_stride, slope, pts_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_splits(ws, dW, splits, (size_t)kK * C * D, stream);
}

template <bool PRE>
int launch_bn(const void* f, const int* trace, const float* ss,
              const void* dout, float* ws, float* dW, int n_pts, int P, int C,
              int D, int ss_stride, float slope, int splits,
              int pts_per_split, cudaStream_t s) {
  if (pick_bn(D) == 64) {
    return launch<64, PRE>(f, trace, ss, dout, ws, dW, n_pts, P, C, D,
                           ss_stride, slope, splits, pts_per_split, s);
  }
  return launch<32, PRE>(f, trace, ss, dout, ws, dW, n_pts, P, C, D,
                         ss_stride, slope, splits, pts_per_split, s);
}

}  // namespace dwmma

// ------------------------------------------- fp32 dW on the CUDA cores

namespace dwf32 {

using mma::kK;
using mma::kNA;
constexpr int kCB = 32;                // channels a block (all 12 kernel points)
constexpr int kBN = 32;                // columns of D a block
constexpr int kKT = 3;                 // kernel points a warp (and a thread)
constexpr int kWarps = kK / kKT;       // 4
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSM = 3;        // 12 warps an SM at <= 168 registers
constexpr int kStages = 3;             // points in the cp.async ring
constexpr int kStage = kNA * (kCB + kBN);  // floats a stage: f rows, dout rows
// shared memory: the adjacency as slab offsets [kNA][kWarps] int4, then the
// ring of kStages stages, each a point's f rows [kNA][kCB] and its dout
// rows [kNA][kBN]
constexpr size_t kOffBytes = (size_t)kNA * kWarps * sizeof(int4);
constexpr size_t kSmem = kOffBytes + (size_t)kStages * kStage * sizeof(float);
static_assert(kK % kKT == 0 && kKT <= 4 && kCB == 32 && kBN == 32,
              "thread layout");

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The partial dW [kK, C, D] of split blockIdx.z (points pt_begin .. pt_end)
// for channels c0 .. c0 + kCB of all 12 kernel points and columns n0 .. n0
// + kBN, a point at a time through a ring of kStages stages: each point's
// f rows and dout rows go out by cp.async kStages - 1 points ahead, one
// barrier a point. Warp w owns kernel points 3w .. 3w + 2; lane cq + 8 co
// owns channels c0 + 4 cq .. + 4 and columns n0 + 8 co .. + 8: 96 fp32 sums
// (3 x 4 x 8), each adding its rows in order by fmaf. For reduction row
// (p, a) and kernel point k the f row is slab row trace[a, k] of the point
// (the gather is the shared-load address: s_off holds each anchor's three
// slab offsets of the warp's kernel points); a row costs one 16-byte load
// of offsets, three of f (each a whole 128-byte slab row across a
// quarter-warp's 8 lanes, broadcast to the other quarters), two of dout,
// and 96 FFMA.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
intra_dw_f32_kernel(const float* __restrict__ f, const int* __restrict__ trace,
                    const float* __restrict__ dout, float* __restrict__ part,
                    int n_pts, int C, int D, int pts_per_split) {
  extern __shared__ __align__(16) unsigned char f32_smem[];
  int4* s_off = reinterpret_cast<int4*>(f32_smem);
  float* ring = reinterpret_cast<float*>(f32_smem + kOffBytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the thread's kernel points kKT kg .. + kKT, channels c0 + 4 cq .. + 4
  // and columns n0 + 8 co .. + 8
  const int kg = warp, cq = lane & 7, co = lane >> 3;
  const int n0 = blockIdx.x * kBN, c0 = blockIdx.y * kCB, split = blockIdx.z;
  const int pt_begin = split * pts_per_split;
  const int n = max(0, min(n_pts, pt_begin + pts_per_split) - pt_begin);

  for (int i = tid; i < kNA * kWarps; i += kThreads) {
    const int a = i / kWarps, g = i - a * kWarps;
    const int* t = trace + a * kK + g * kKT;
    int o[4] = {0, 0, 0, 0};
    for (int j = 0; j < kKT; ++j) o[j] = t[j] * kCB;
    s_off[i] = make_int4(o[0], o[1], o[2], o[3]);
  }

  // point g of the split into its stage, one commit group (empty past n)
  auto load = [&](int g) {
    if (g < n) {
      const size_t row0 = (size_t)(pt_begin + g) * kNA;
      float* st = ring + (g % kStages) * kStage;
      for (int e = tid; e < kNA * kCB / 4; e += kThreads) {
        const int r = e / (kCB / 4), c4 = e % (kCB / 4) * 4;
        tc::cp16(tc::smem_addr(st + r * kCB + c4),
                 f + (row0 + r) * C + c0 + c4, true);
      }
      for (int e = tid; e < kNA * kBN / 4; e += kThreads) {
        const int r = e / (kBN / 4), c4 = e % (kBN / 4) * 4;
        tc::cp16(tc::smem_addr(st + kNA * kCB + r * kBN + c4),
                 dout + (row0 + r) * D + n0 + c4, true);
      }
    }
    tc::cp_commit();
  };

  float acc[kKT][4][8];
#pragma unroll
  for (int j = 0; j < kKT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[j][i][q] = 0.f;

#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) load(g);
#pragma unroll 1
  for (int g = 0; g < n; ++g) {
    tc::cp_wait<kStages - 2>();
    __syncthreads();  // point g visible; every warp done with point g - 1
    load(g + kStages - 1);
    const float* fs = ring + (g % kStages) * kStage + 4 * cq;
    const float* ds = ring + (g % kStages) * kStage + kNA * kCB + 8 * co;
#pragma unroll 12
    for (int a = 0; a < kNA; ++a) {
      const int4 o = s_off[a * kWarps + kg];
      const int oo[4] = {o.x, o.y, o.z, o.w};
      float4 x[kKT];
#pragma unroll
      for (int j = 0; j < kKT; ++j) x[j] = lds4(fs + oo[j]);
      const float4 d0 = lds4(ds + a * kBN), d1 = lds4(ds + a * kBN + 4);
      const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
        const float xv[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            acc[j][i][q] = fmaf(xv[i], dv[q], acc[j][i][q]);
      }
    }
  }
  tc::cp_wait<0>();

  // the split's partial: dW rows (kKT kg + j, c0 + 4 cq + i)
  float* dst = part + (size_t)split * kK * C * D + n0 + 8 * co;
#pragma unroll
  for (int j = 0; j < kKT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* rowp =
          dst + ((size_t)(kg * kKT + j) * C + c0 + 4 * cq + i) * D;
      *reinterpret_cast<float4*>(rowp) = make_float4(
          acc[j][i][0], acc[j][i][1], acc[j][i][2], acc[j][i][3]);
      *reinterpret_cast<float4*>(rowp + 4) = make_float4(
          acc[j][i][4], acc[j][i][5], acc[j][i][6], acc[j][i][7]);
    }
}

int launch(const float* f, const int* trace, const float* dout, float* ws,
           float* dW, int n_pts, int C, int D, int splits, int pts_per_split,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      intra_dw_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  intra_dw_f32_kernel<<<dim3(D / kBN, C / kCB, splits), kThreads, kSmem,
                        stream>>>(f, trace, dout, ws, n_pts, C, D,
                                  pts_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_splits(ws, dW, splits, (size_t)kK * C * D, stream);
}

}  // namespace dwf32

// -------------------------------------- fp32 forward on the CUDA cores

namespace fwdf32 {

using mma::kK;
using mma::kNA;
constexpr int kAT = 15;                  // anchors a thread
constexpr int kGroups = kNA / kAT;       // anchor groups a point
constexpr int kATP = (kAT + 3) / 4 * 4;  // a group's offsets, padded to int4s
constexpr int kCC = 8;                   // channels a stage
constexpr int kCS = 4;                   // channels a step of the product
constexpr int kStages = 2;               // channel chunks in the cp.async ring
constexpr int kTile = 256;               // points a block x columns a block
constexpr int kThreads = kGroups * kTile / 8;  // 8 columns a thread
constexpr int kBlocksPerSM = 2;
// C and D must be multiples of kMult (FWD_F32_MULT in ops/kernels/
// intra_conv.py): whole chunks of kCC channels, whole 32-column tiles
constexpr int kMult = 32;
// shared memory: the adjacency as slab offsets (trace[a, k] * kCC) by kernel
// point, anchor group and the group's anchors [kK][kGroups][kATP], then the
// ring of kStages stages, each a chunk of kCC channels: the block's f rows
// [NP][kNA][kCC] and W's rows [kK][kCC][BN]
constexpr size_t kOffBytes = (size_t)kK * kGroups * kATP * sizeof(int);
static_assert(kNA % kAT == 0 && kCC % 4 == 0 && kCC % kCS == 0 &&
                  kMult % kCC == 0 &&
                  (kCS == 1 || kCS == 2 || kCS == 4),
              "thread layout");

// n consecutive floats of shared memory into registers (n = 1, 2, 4: one
// load of 4, 8 or 16 bytes)
template <int N>
__device__ __forceinline__ void lds(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

template <int BN>
struct Cfg {
  static constexpr int NP = kTile / BN;          // points a block: 4 or 8
  static constexpr int LG = BN / 8;              // lanes an anchor group
  static constexpr int kF = NP * kNA * kCC;      // floats of f a stage
  static constexpr int kStage = kF + kK * kCC * BN;
  static constexpr size_t kSmem =
      kOffBytes + (size_t)kStages * kStage * sizeof(float);
  static_assert(kThreads == NP * kGroups * LG, "thread layout");
};

// the columns a block owns: 64, or 32 where D % 64 != 0
inline int pick_bn(int D) { return D % 64 == 0 ? 64 : 32; }

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// out[p, a, n0 + n] = sum_k sum_c f[p, trace[a, k], c] W[k, c, n0 + n] for
// the block's NP whole points (pt0 on; np of them live) and BN columns,
// kCC channels at a time through a ring of kStages stages: each chunk's f
// rows of the block's points and W rows [kK, kCC, BN] go out by cp.async
// kStages - 1 chunks ahead, one barrier a chunk. Thread (point pl, anchor
// group grp, lane co of the group) owns anchors kAT grp .. + kAT of point pl
// and columns n0 + 4 co .. + 4 and n0 + BN / 2 + 4 co .. + 4: kAT x 8 fp32
// sums, each adding its 12C terms in one order (chunk, kernel point,
// channel) by fmaf. For kernel point k, output row (pl, a) reads slab row
// trace[a, k] of point pl: the gather is the shared-load address, with the
// group's kAT offsets for k read once and held over the chunk's channels.
// A group's lanes read the same f address (a broadcast) and contiguous W.
template <int BN>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
intra_fwd_f32_kernel(const float* __restrict__ f,
                     const int* __restrict__ trace,
                     const float* __restrict__ W, float* __restrict__ out,
                     int n_pts, int C, int D) {
  using G = Cfg<BN>;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  int* s_off = reinterpret_cast<int*>(fwd_smem);
  float* ring = reinterpret_cast<float*>(fwd_smem + kOffBytes);
  const int tid = threadIdx.x;
  const int co = tid % G::LG, q = tid / G::LG;
  const int pl = q / kGroups, grp = q - pl * kGroups;
  const int n_cb = D / BN;
  const int n0 = (blockIdx.x % n_cb) * BN;
  const int pt0 = blockIdx.x / n_cb * G::NP;
  const int live = min(G::NP, n_pts - pt0) * kNA;  // the block's live rows
  const int chunks = C / kCC;

  for (int i = tid; i < kK * kGroups * kATP; i += kThreads) {
    const int k = i / (kGroups * kATP), r = i - k * (kGroups * kATP);
    const int g = r / kATP, t = r - g * kATP;
    s_off[i] = t < kAT ? trace[(g * kAT + t) * kK + k] * kCC : 0;
  }

  // chunk ch of the reduction into its stage, one commit group (empty past
  // the last chunk); rows past the live points stage as zeros
  auto load = [&](int ch) {
    if (ch < chunks) {
      float* st = ring + (ch % kStages) * G::kStage;
      const int c0 = ch * kCC;
      for (int e = tid; e < G::NP * kNA * (kCC / 4); e += kThreads) {
        const int r = e / (kCC / 4), c4 = (e - r * (kCC / 4)) * 4;
        const bool ok = r < live;
        tc::cp16(tc::smem_addr(st + r * kCC + c4),
                 ok ? f + ((size_t)pt0 * kNA + r) * C + c0 + c4 : f, ok);
      }
      float* ws = st + G::kF;
      for (int e = tid; e < kK * kCC * (BN / 4); e += kThreads) {
        const int r = e / (BN / 4), c4 = (e - r * (BN / 4)) * 4;
        const int k = r / kCC, i = r - k * kCC;
        tc::cp16(tc::smem_addr(ws + r * BN + c4),
                 W + ((size_t)k * C + c0 + i) * D + n0 + c4, true);
      }
    }
    tc::cp_commit();
  };

  float acc[kAT][8];
#pragma unroll
  for (int t = 0; t < kAT; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[t][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(s);
  const int* so = s_off + grp * kATP;
#pragma unroll 1
  for (int ch = 0; ch < chunks; ++ch) {
    tc::cp_wait<kStages - 2>();
    __syncthreads();  // chunk ch visible; every warp done with chunk ch - 1
    load(ch + kStages - 1);
    const float* fs = ring + (ch % kStages) * G::kStage + pl * kNA * kCC;
    const float* ws = ring + (ch % kStages) * G::kStage + G::kF + 4 * co;
#pragma unroll 2
    for (int k = 0; k < kK; ++k) {
      int o[kATP];
#pragma unroll
      for (int t4 = 0; t4 < kATP / 4; ++t4) {
        const int4 v =
            *reinterpret_cast<const int4*>(so + k * kGroups * kATP + 4 * t4);
        o[4 * t4] = v.x;
        o[4 * t4 + 1] = v.y;
        o[4 * t4 + 2] = v.z;
        o[4 * t4 + 3] = v.w;
      }
#pragma unroll
      for (int cs = 0; cs < kCC; cs += kCS) {
        // W rows (k, cs + i) at the thread's 8 columns
        float w[kCS][8];
#pragma unroll
        for (int i = 0; i < kCS; ++i) {
          const float* wr = ws + (k * kCC + cs + i) * BN;
          const float4 lo = lds4(wr), hi = lds4(wr + BN / 2);
          w[i][0] = lo.x;
          w[i][1] = lo.y;
          w[i][2] = lo.z;
          w[i][3] = lo.w;
          w[i][4] = hi.x;
          w[i][5] = hi.y;
          w[i][6] = hi.z;
          w[i][7] = hi.w;
        }
#pragma unroll
        for (int t = 0; t < kAT; ++t) {
          float xv[kCS];
          lds<kCS>(xv, fs + o[t] + cs);
#pragma unroll
          for (int i = 0; i < kCS; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[t][j] = fmaf(xv[i], w[i][j], acc[t][j]);
        }
      }
    }
  }
  tc::cp_wait<0>();

  if (pl * kNA < live) {
    float* op = out + ((size_t)(pt0 + pl) * kNA + grp * kAT) * D + n0 + 4 * co;
#pragma unroll
    for (int t = 0; t < kAT; ++t) {
      *reinterpret_cast<float4*>(op + (size_t)t * D) =
          make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
      *reinterpret_cast<float4*>(op + (size_t)t * D + BN / 2) =
          make_float4(acc[t][4], acc[t][5], acc[t][6], acc[t][7]);
    }
  }
}

template <int BN>
int launch(const float* f, const int* trace, const float* W, float* out,
           int n_pts, int C, int D, cudaStream_t stream) {
  using G = Cfg<BN>;
  auto kern = intra_fwd_f32_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)(n_pts + G::NP - 1) / G::NP * (D / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kThreads, G::kSmem, stream>>>(f, trace, W, out,
                                                         n_pts, C, D);
  return (int)cudaGetLastError();
}

}  // namespace fwdf32

}  // namespace

// f [b, P, na, C], trace_idx [na, K] int32 (device), W [K, C, D],
// out [b, P, na, D]: fp32, or bf16 when bf16 != 0. ss: null, or the
// prenorm fold fp32 [., 2, na * C] at batch stride ss_stride (elements; 0
// broadcasts one fold), applied with the activation of slope `slope` (the
// leaky ReLU's 0.01, or 0: the ReLU; unused without ss). C must be a
// multiple of 4 and D of 32.
extern "C" int epn_intra_conv(const void* f, const void* trace_idx,
                              const void* W, const void* ss, void* out, int b,
                              int P, int na, int K, int C, int D,
                              int ss_stride, float slope, int bf16,
                              void* stream) {
  if (na * K > kMaxTrace || C % 4 != 0 || D % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int* tp = (const int*)trace_idx;
  const float* sp = (const float*)ss;
  const int M = b * P * na;
  if (bf16) {
    return launch<epn::bf16>(f, tp, W, sp, out, M, P, na, K, C, D, ss_stride,
                             slope, s);
  }
  return launch<float>(f, tp, W, sp, out, M, P, na, K, C, D, ss_stride, slope,
                       s);
}

// f [b, P, na, C], trace_idx [na, K] int32, dout [b, P, na, D] (fp32, or
// bf16 when bf16 != 0); ss: null, or the prenorm fold fp32 [., 2, na * C]
// at batch stride ss_stride, applied to f on load with the activation of
// slope `slope`; ws [splits, K, C, D] fp32 scratch, dW [K, C, D] fp32 out.
// C must be a multiple of 4, D of 32.
extern "C" int epn_intra_conv_bwd_w(const void* f, const void* trace_idx,
                                    const void* ss, const void* dout, void* ws,
                                    void* dW, int b, int P, int na, int K,
                                    int C, int D, int ss_stride, float slope,
                                    int splits, int bf16, void* stream) {
  if (na * K > kMaxTrace || C % 4 != 0 || D % 32 != 0 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int* tp = (const int*)trace_idx;
  const float* sp = (const float*)ss;
  const int M = b * P * na;
  if (bf16) {
    return launch_dw_any<epn::bf16>(f, tp, sp, dout, (float*)ws, (float*)dW, M,
                                    P, na, K, C, D, ss_stride, slope, splits,
                                    s);
  }
  return launch_dw_any<float>(f, tp, sp, dout, (float*)ws, (float*)dW, M, P,
                              na, K, C, D, ss_stride, slope, splits, s);
}

// dW on tensor cores (intra_dw_mma_kernel): f, trace_idx, ss, dout, ws, dW,
// ss_stride and slope as epn_intra_conv_bwd_w, with f and dout bf16; rows a
// split, rows_per_split, a whole number of 8-point groups (480 rows), with
// splits * rows_per_split >= b * P * na. na must be 60, K 12, C a multiple
// of 32 and D of 32.
extern "C" int epn_intra_conv_bwd_w_mma(const void* f, const void* trace_idx,
                                        const void* ss, const void* dout,
                                        void* ws, void* dW, int b, int P,
                                        int na, int K, int C, int D,
                                        int ss_stride, float slope, int splits,
                                        int rows_per_split, void* stream) {
  const long long rows = (long long)b * P * na;
  if (na != mma::kNA || K != mma::kK || C % dwmma::kCB != 0 || D % 32 != 0 ||
      splits < 1 || rows_per_split <= 0 ||
      rows_per_split % dwmma::kRows != 0 ||
      (long long)splits * rows_per_split < rows) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int* tp = (const int*)trace_idx;
  const float* sp = (const float*)ss;
  const int pps = rows_per_split / na;
  if (sp != nullptr) {
    return dwmma::launch_bn<true>(f, tp, sp, dout, (float*)ws, (float*)dW,
                                  b * P, P, C, D, ss_stride, slope, splits,
                                  pps, s);
  }
  return dwmma::launch_bn<false>(f, tp, nullptr, dout, (float*)ws, (float*)dW,
                                 b * P, P, C, D, 0, slope, splits, pps, s);
}

// dW on the CUDA cores (intra_dw_f32_kernel), the plain form: the
// arguments of epn_intra_conv_bwd_w_mma with f and dout fp32 and ss null
// (ss_stride unused); rows a split, rows_per_split, whole points (a
// multiple of na), with splits * rows_per_split >= b * P * na. na must be
// 60, K 12, C and D multiples of 32.
extern "C" int epn_intra_conv_bwd_w_f32(const void* f, const void* trace_idx,
                                        const void* ss, const void* dout,
                                        void* ws, void* dW, int b, int P,
                                        int na, int K, int C, int D,
                                        int ss_stride, int splits,
                                        int rows_per_split, void* stream) {
  (void)ss_stride;
  const long long rows = (long long)b * P * na;
  if (ss != nullptr || na != mma::kNA || K != mma::kK ||
      C % dwf32::kCB != 0 || D % dwf32::kBN != 0 || splits < 1 ||
      rows_per_split <= 0 || rows_per_split % na != 0 ||
      (long long)splits * rows_per_split < rows) {
    return (int)cudaErrorInvalidValue;
  }
  return dwf32::launch((const float*)f, (const int*)trace_idx,
                       (const float*)dout, (float*)ws, (float*)dW, b * P, C,
                       D, splits, rows_per_split / na, (cudaStream_t)stream);
}

// The forward on the CUDA cores (intra_fwd_f32_kernel), the plain form:
// the arguments of epn_intra_conv_mma with f, W and out fp32 and ss null
// (ss_stride unused). The df runs it on (dout, inv_idx, W^T [K, D, C]).
// na must be 60, K 12, C and D multiples of 32.
extern "C" int epn_intra_conv_f32(const void* f, const void* trace_idx,
                                  const void* W, const void* ss, void* out,
                                  int b, int P, int na, int K, int C, int D,
                                  int ss_stride, void* stream) {
  (void)ss_stride;
  if (ss != nullptr || na != mma::kNA || K != mma::kK ||
      C % fwdf32::kMult != 0 || D % fwdf32::kMult != 0 || b < 0 || P < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_pts = b * P;
  if (n_pts == 0) return 0;
  const float* fp = (const float*)f;
  const int* tp = (const int*)trace_idx;
  const float* wp = (const float*)W;
  float* op = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (fwdf32::pick_bn(D) == 64) {
    return fwdf32::launch<64>(fp, tp, wp, op, n_pts, C, D, s);
  }
  return fwdf32::launch<32>(fp, tp, wp, op, n_pts, C, D, s);
}

// B6 df, dscale, dshift. dout [b, P, na, C], inv_idx [na, K] int32, Wt [K,
// C, D] (W transposed), x [b, P, na, D] the saved pre-norm input, df [b, P,
// na, D] out (fp32, or bf16 when bf16 != 0); ss fp32 [ss_batch, 2, na * D]
// (ss_batch 1 or b); ws fp32 scratch [2, nJ, b, na * D] with nJ =
// ceil(P / (128 / na)); dscale, dshift fp32 [ss_batch, na * D] out; slope
// the forward activation's (its mask u > 0). C must be a multiple of 4, D
// of 32, na at most 64.
extern "C" int epn_intra_conv_prenorm_df(const void* dout, const void* inv_idx,
                                         const void* Wt, const void* x,
                                         const void* ss, void* df, void* ws,
                                         void* dscale, void* dshift, int b,
                                         int P, int na, int K, int C, int D,
                                         int ss_batch, float slope, int bf16,
                                         void* stream) {
  if (na * K > kMaxTrace || na > 64 || C % 4 != 0 || D % 32 != 0 ||
      (ss_batch != 1 && ss_batch != b)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int* ip = (const int*)inv_idx;
  const float* sp = (const float*)ss;
  float* w = (float*)ws;
  float* dsc = (float*)dscale;
  float* dsh = (float*)dshift;
  if (bf16) {
    return launch_df_prenorm_cols<epn::bf16>(dout, ip, Wt, x, sp, df, w, dsc,
                                             dsh, b, P, na, K, C, D, ss_batch,
                                             slope, s);
  }
  return launch_df_prenorm_cols<float>(dout, ip, Wt, x, sp, df, w, dsc, dsh, b,
                                       P, na, K, C, D, ss_batch, slope, s);
}

// bf16 on tensor cores (intra_conv_mma_kernel): f, trace_idx, W, ss, out,
// ss_stride and slope as epn_intra_conv, with f, W and out bf16. na must be 60,
// K 12, C a multiple of 32 and D of 32 (and the slab and ring within the
// shared memory a block may use: C up to 256 at D % 128 == 0).
extern "C" int epn_intra_conv_mma(const void* f, const void* trace_idx,
                                  const void* W, const void* ss, void* out,
                                  int b, int P, int na, int K, int C, int D,
                                  int ss_stride, float slope, void* stream) {
  if (na != mma::kNA || K != mma::kK || C % 32 != 0 || D % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int* tp = (const int*)trace_idx;
  const float* sp = (const float*)ss;
  if (sp != nullptr) {
    return mma::launch_bn<true, false>(f, tp, W, sp, nullptr, out, nullptr,
                                       b, P, C, D, ss_stride, slope, s);
  }
  return mma::launch_bn<false, false>(f, tp, W, nullptr, nullptr, out,
                                      nullptr, b, P, C, D, 0, slope, s);
}

// B6 df, dscale, dshift on tensor cores: the arguments of
// epn_intra_conv_prenorm_df (slope among them) with bf16 dout, Wt, x and df,
// and ws fp32
// [2, nJ, b, na * D] with nJ = ceil(P / (512 / BN)), BN = 128 where D % 128
// == 0, else 64 where D % 64 == 0, else 32. na must be 60, K 12, C and D
// multiples of 32.
extern "C" int epn_intra_conv_prenorm_df_mma(
    const void* dout, const void* inv_idx, const void* Wt, const void* x,
    const void* ss, void* df, void* ws, void* dscale, void* dshift, int b,
    int P, int na, int K, int C, int D, int ss_batch, float slope,
    void* stream) {
  if (na != mma::kNA || K != mma::kK || C % 32 != 0 || D % 32 != 0 ||
      (ss_batch != 1 && ss_batch != b)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const size_t L = (size_t)na * D;
  float* w = (float*)ws;
  const int e = mma::launch_bn<false, true>(
      dout, (const int*)inv_idx, Wt, (const float*)ss, x, df, w, b, P, C, D,
      ss_batch > 1 ? (int)(2 * L) : 0, slope, s);
  if (e != 0) return e;
  // the partials [nJ][b][L] in order: over each cloud's blocks (a fold per
  // cloud) or over every block (one fold for the batch)
  const int nJ = (P + mma::block_points(D) - 1) / mma::block_points(D);
  const int splits = ss_batch > 1 ? nJ : nJ * b;
  const size_t n = ss_batch > 1 ? b * L : L;
  const int e2 = launch_sum_splits(w, (float*)dscale, splits, n, s);
  if (e2 != 0) return e2;
  return launch_sum_splits(w + (size_t)nJ * b * L, (float*)dshift, splits, n,
                           s);
}
