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
// flagship forward (all seven layers). This version runs in fp32 on the CUDA
// cores (no TF32, no wgmma), so the fp32 FMA rate bounds it, and the design
// keeps the shared-memory traffic per FMA low enough not to bound it first.
//
// Design: a classic register-blocked SGEMM whose A rows are the flattened
// (point, anchor) pairs. A block computes a 128-row x BN-column tile (BN =
// 128, 64 or 32, whichever divides D) with 8 x 8 outputs a thread, walking
// the reduction in slices of 16. Each slice stages the gathered A rows
// A[(p, a), (k, c)] = f[p, trace_idx[a, k], c] (16-byte loads: C % 4 == 0
// keeps four consecutive c inside one k) transposed into shared memory, and
// the matching 16 rows of W (viewed as [12C, D]). The next slice's global
// loads are issued into registers before the current slice is computed, and
// land in the other of two shared-memory buffers (one barrier a slice).
// Per step of the reduction a thread reads 2 + 2 float4 for 64 FMAs.
// trace_idx is staged in shared memory once a block.
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
// leaky ReLU with mask u > 0. The TPU's [b, 8, L] sublane padding does not
// come over. A prenorm load costs two more 16-byte reads of the (cached)
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
// dW (intra_dw_kernel, the dW half of _bwd_kernel):
//   dW[k, c, d] = sum_{b, p, a} f[b, p, trace_idx[a, k], c] * dout[b, p, a, d]
// is a GEMM [K*C x rows] x [rows x D] reducing over rows = b*p*60 (368,640 at
// b=12 on the first layers), bound by the FMA rate like the forward. A block
// owns a 128 x BN tile of dW and one range of rows; it walks its rows 16 at
// a time, staging the gathered A^T slice (the adjacency gather done in the
// 16-byte staging loads, as in the forward) and the dout slice, with 8 x 8
// outputs a thread. Each row range writes a partial dW to a workspace, and a
// second launch (split_sum.cuh) adds the partials in a fixed order:
// deterministic, no atomics. It runs in fp32 and bf16, and in the PRENORM
// form stages z = act(f * scale + shift), rounded as the forward rounds it.
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

#include <cuda_runtime.h>

#include "elem.cuh"
#include "split_sum.cuh"

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
__device__ __forceinline__ float4 prenorm4(float4 v, const float* ss, int L) {
  const float4 sc = *reinterpret_cast<const float4*>(ss);
  const float4 sh = *reinterpret_cast<const float4*>(ss + L);
  return make_float4(epn::round_to<E>(epn::leaky(fmaf(v.x, sc.x, sh.x))),
                     epn::round_to<E>(epn::leaky(fmaf(v.y, sc.y, sh.y))),
                     epn::round_to<E>(epn::leaky(fmaf(v.z, sc.z, sh.z))),
                     epn::round_to<E>(epn::leaky(fmaf(v.w, sc.w, sh.w))));
}

// The global loads of reduction slice kk0 into registers: ra for the
// gathered A rows (through the prenorm when PRE), rb for the W rows.
template <typename E, bool PRE, int BN>
__device__ __forceinline__ void load_slice(
    const E* __restrict__ W, const int* __restrict__ s_trace,
    const E* (&a_pt)[Tile<BN>::kALoads],
    const float* (&a_ss)[Tile<BN>::kALoads],
    const int (&a_anchor)[Tile<BN>::kALoads], int kk0, int tid, int K, int C,
    int D, int n0, int L, float4 (&ra)[Tile<BN>::kALoads],
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
      if (PRE) ra[i] = prenorm4<E>(ra[i], a_ss[i] + lane, L);
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
    float (&acc)[TM][TN]) {
  using T = Tile<BN>;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  float4 ra[T::kALoads], rb[T::kBLoads];
  load_slice<E, PRE, BN>(W, s_trace, a_pt, a_ss, a_anchor, 0, tid, K, C, D, n0,
                         L, ra, rb);
  store_slice<BN>(As[0], Bs[0], tid, ra, rb);
  __syncthreads();
  const int n_slices = (K * C + BK - 1) / BK;
  for (int s = 0; s < n_slices; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_slices) {
      load_slice<E, PRE, BN>(W, s_trace, a_pt, a_ss, a_anchor, (s + 1) * BK,
                             tid, K, C, D, n0, L, ra, rb);
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

// PRE: ss is the prenorm fold [., 2, na * C] at batch stride ss_stride
// (a template flag, so the plain form carries no prenorm registers)
template <typename E, bool PRE, int BN>
__global__ void __launch_bounds__(Tile<BN>::kThreads)
intra_conv_kernel(const E* __restrict__ f, const int* __restrict__ trace_idx,
                  const E* __restrict__ W, const float* __restrict__ ss,
                  E* __restrict__ out, int M, int P, int na, int K, int C,
                  int D, int ss_stride) {
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
                           C, D, n0, na * C, acc);

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
// the forward's prenorm4), with the scale of the lanes in *sc
__device__ __forceinline__ float4 act_grad4(const float4& dz, const float4& x,
                                            const float* ss, int L,
                                            float4* sc) {
  *sc = *reinterpret_cast<const float4*>(ss);
  const float4 sh = *reinterpret_cast<const float4*>(ss + L);
  const float s = epn::kLeakySlope;
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
                        int C, int D, int ss_stride, int nJ) {
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
                             K, C, D, n0, na * C, acc);

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
          act_grad4(dz, epn::load4(x + gm * D + n), ssb + a * D + n, L, &sc);
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
          const float4 du = act_grad4(dz, xv, ssb + a * D + n, L, &sc);
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
               int D, int ss_stride, cudaStream_t s) {
  const E* fp = (const E*)f;
  const E* wp = (const E*)W;
  E* op = (E*)out;
  const unsigned gx = (M + BM - 1) / BM;
  if (D % 128 == 0) {
    intra_conv_kernel<E, PRE, 128><<<dim3(gx, D / 128), Tile<128>::kThreads, 0,
                                     s>>>(fp, trace_idx, wp, ss, op, M, P, na,
                                          K, C, D, ss_stride);
  } else if (D % 64 == 0) {
    intra_conv_kernel<E, PRE, 64><<<dim3(gx, D / 64), Tile<64>::kThreads, 0,
                                    s>>>(fp, trace_idx, wp, ss, op, M, P, na,
                                         K, C, D, ss_stride);
  } else {
    intra_conv_kernel<E, PRE, 32><<<dim3(gx, D / 32), Tile<32>::kThreads, 0,
                                    s>>>(fp, trace_idx, wp, ss, op, M, P, na,
                                         K, C, D, ss_stride);
  }
  return (int)cudaGetLastError();
}

template <typename E>
int launch(const void* f, const int* trace_idx, const void* W,
           const float* ss, void* out, int M, int P, int na, int K, int C,
           int D, int ss_stride, cudaStream_t s) {
  if (ss != nullptr) {
    return launch_fwd<E, true>(f, trace_idx, W, ss, out, M, P, na, K, C,
                               D, ss_stride, s);
  }
  return launch_fwd<E, false>(f, trace_idx, W, ss, out, M, P, na, K, C, D,
                              ss_stride, s);
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
                int D, int ss_stride, int rows_per_split) {
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
          v = prenorm4<E>(v, ss + (size_t)(pt / P) * ss_stride + lane, na * C);
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
              int K, int C, int D, int ss_stride, int splits,
              cudaStream_t stream) {
  const int slices = (M + WBK - 1) / WBK;
  const int rows_per_split = (slices + splits - 1) / splits * WBK;
  dim3 grid((K * C + BM - 1) / BM, D / BN, splits);
  intra_dw_kernel<E, PRE, BN><<<grid, Tile<BN>::kThreads, 0, stream>>>(
      (const E*)f, trace_idx, ss, (const E*)dout, ws, M, P, na, K, C, D,
      ss_stride, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_splits(ws, dW, splits, (size_t)K * C * D, stream);
}

template <typename E, bool PRE>
int launch_dw_cols(const void* f, const int* trace_idx, const float* ss,
                   const void* dout, float* ws, float* dW, int M, int P,
                   int na, int K, int C, int D, int ss_stride, int splits,
                   cudaStream_t s) {
  if (D % 128 == 0) {
    return launch_dw<E, PRE, 128>(f, trace_idx, ss, dout, ws, dW, M, P, na, K,
                                  C, D, ss_stride, splits, s);
  }
  if (D % 64 == 0) {
    return launch_dw<E, PRE, 64>(f, trace_idx, ss, dout, ws, dW, M, P, na, K,
                                 C, D, ss_stride, splits, s);
  }
  return launch_dw<E, PRE, 32>(f, trace_idx, ss, dout, ws, dW, M, P, na, K, C,
                               D, ss_stride, splits, s);
}

template <typename E>
int launch_dw_any(const void* f, const int* trace_idx, const float* ss,
                  const void* dout, float* ws, float* dW, int M, int P, int na,
                  int K, int C, int D, int ss_stride, int splits,
                  cudaStream_t s) {
  if (ss != nullptr) {
    return launch_dw_cols<E, true>(f, trace_idx, ss, dout, ws, dW, M, P, na,
                                   K, C, D, ss_stride, splits, s);
  }
  return launch_dw_cols<E, false>(f, trace_idx, ss, dout, ws, dW, M, P, na, K,
                                  C, D, ss_stride, splits, s);
}

template <typename E, int BN>
int launch_df_prenorm(const void* g, const int* inv_idx, const void* Wt,
                      const void* x, const float* ss, void* df, float* ws,
                      float* dscale, float* dshift, int b, int P, int na,
                      int K, int C, int D, int ss_batch, cudaStream_t s) {
  const int nJ = (P + BM / na - 1) / (BM / na);
  const size_t L = (size_t)na * D;
  intra_df_prenorm_kernel<E, BN><<<dim3(b * nJ, D / BN), Tile<BN>::kThreads,
                                   0, s>>>(
      (const E*)g, inv_idx, (const E*)Wt, (const E*)x, ss, (E*)df, ws, b, P,
      na, K, C, D, ss_batch > 1 ? (int)(2 * L) : 0, nJ);
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
                           int K, int C, int D, int ss_batch, cudaStream_t s) {
  if (D % 64 == 0 && na * 64 <= 2 * BK * BM) {
    return launch_df_prenorm<E, 64>(g, inv_idx, Wt, x, ss, df, ws, dscale,
                                    dshift, b, P, na, K, C, D, ss_batch, s);
  }
  return launch_df_prenorm<E, 32>(g, inv_idx, Wt, x, ss, df, ws, dscale,
                                  dshift, b, P, na, K, C, D, ss_batch, s);
}

}  // namespace

// f [b, P, na, C], trace_idx [na, K] int32 (device), W [K, C, D],
// out [b, P, na, D]: fp32, or bf16 when bf16 != 0. ss: null, or the
// prenorm fold fp32 [., 2, na * C] at batch stride ss_stride (elements; 0
// broadcasts one fold), applied with the leaky ReLU. C must be a
// multiple of 4 and D of 32.
extern "C" int epn_intra_conv(const void* f, const void* trace_idx,
                              const void* W, const void* ss, void* out, int b,
                              int P, int na, int K, int C, int D,
                              int ss_stride, int bf16,
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
                             s);
  }
  return launch<float>(f, tp, W, sp, out, M, P, na, K, C, D, ss_stride, s);
}

// f [b, P, na, C], trace_idx [na, K] int32, dout [b, P, na, D] (fp32, or
// bf16 when bf16 != 0); ss: null, or the prenorm fold fp32 [., 2, na * C]
// at batch stride ss_stride, applied to f on load; ws [splits, K, C, D]
// fp32 scratch, dW [K, C, D] fp32 out. C must be a multiple of 4, D of 32.
extern "C" int epn_intra_conv_bwd_w(const void* f, const void* trace_idx,
                                    const void* ss, const void* dout, void* ws,
                                    void* dW, int b, int P, int na, int K,
                                    int C, int D, int ss_stride, int splits,
                                    int bf16, void* stream) {
  if (na * K > kMaxTrace || C % 4 != 0 || D % 32 != 0 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int* tp = (const int*)trace_idx;
  const float* sp = (const float*)ss;
  const int M = b * P * na;
  if (bf16) {
    return launch_dw_any<epn::bf16>(f, tp, sp, dout, (float*)ws, (float*)dW, M,
                                    P, na, K, C, D, ss_stride, splits, s);
  }
  return launch_dw_any<float>(f, tp, sp, dout, (float*)ws, (float*)dW, M, P,
                              na, K, C, D, ss_stride, splits, s);
}

// B6 df, dscale, dshift. dout [b, P, na, C], inv_idx [na, K] int32, Wt [K,
// C, D] (W transposed), x [b, P, na, D] the saved pre-norm input, df [b, P,
// na, D] out (fp32, or bf16 when bf16 != 0); ss fp32 [ss_batch, 2, na * D]
// (ss_batch 1 or b); ws fp32 scratch [2, nJ, b, na * D] with nJ =
// ceil(P / (128 / na)); dscale, dshift fp32 [ss_batch, na * D] out. C must
// be a multiple of 4, D of 32, na at most 64.
extern "C" int epn_intra_conv_prenorm_df(const void* dout, const void* inv_idx,
                                         const void* Wt, const void* x,
                                         const void* ss, void* df, void* ws,
                                         void* dscale, void* dshift, int b,
                                         int P, int na, int K, int C, int D,
                                         int ss_batch, int bf16,
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
                                             s);
  }
  return launch_df_prenorm_cols<float>(dout, ip, Wt, x, sp, df, w, dsc, dsh, b,
                                       P, na, K, C, D, ss_batch, s);
}
