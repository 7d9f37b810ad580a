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

#include <cuda_runtime.h>

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

// The global loads of reduction slice kk0 into registers: ra for the
// gathered A rows, rb for the W rows.
template <int BN>
__device__ __forceinline__ void load_slice(
    const float* __restrict__ W, const int* __restrict__ s_trace,
    const float* (&a_pt)[Tile<BN>::kALoads],
    const int (&a_anchor)[Tile<BN>::kALoads], int kk0, int tid, int K, int C,
    int D, int n0, float4 (&ra)[Tile<BN>::kALoads],
    float4 (&rb)[Tile<BN>::kBLoads]) {
  using T = Tile<BN>;
  const int KC = K * C;
#pragma unroll
  for (int i = 0; i < T::kALoads; ++i) {
    const int kk = kk0 + 4 * ((tid + i * T::kThreads) % 4);
    ra[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a_anchor[i] >= 0 && kk < KC) {
      const int k = kk / C, c = kk - k * C;
      ra[i] = *reinterpret_cast<const float4*>(
          a_pt[i] + (size_t)s_trace[a_anchor[i] * K + k] * C + c);
    }
  }
#pragma unroll
  for (int i = 0; i < T::kBLoads; ++i) {
    const int e = tid + i * T::kThreads;
    const int kk = kk0 + e / (BN / 4), c4 = e % (BN / 4);
    rb[i] = kk < KC ? *reinterpret_cast<const float4*>(
                          W + (size_t)kk * D + n0 + 4 * c4)
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

template <int BN>
__global__ void __launch_bounds__(Tile<BN>::kThreads)
intra_conv_kernel(const float* __restrict__ f,
                  const int* __restrict__ trace_idx,
                  const float* __restrict__ W, float* __restrict__ out, int M,
                  int na, int K, int C, int D) {
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
  const float* a_pt[T::kALoads];
  int a_anchor[T::kALoads];
#pragma unroll
  for (int i = 0; i < T::kALoads; ++i) {
    const int gm = m0 + (tid + i * T::kThreads) / 4;
    const int pt = gm / na;
    a_anchor[i] = gm < M ? gm - pt * na : -1;
    a_pt[i] = f + (size_t)pt * na * C;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  float4 ra[T::kALoads], rb[T::kBLoads];
  load_slice<BN>(W, s_trace, a_pt, a_anchor, 0, tid, K, C, D, n0, ra, rb);
  store_slice<BN>(As[0], Bs[0], tid, ra, rb);
  __syncthreads();
  const int n_slices = (K * C + BK - 1) / BK;
  for (int s = 0; s < n_slices; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_slices) {
      load_slice<BN>(W, s_trace, a_pt, a_anchor, (s + 1) * BK, tid, K, C, D,
                     n0, ra, rb);
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
      float* op = out + (size_t)gm * D + n0;
      *reinterpret_cast<float4*>(op + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(op + BN / 2 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

template <int BN>
int launch(const float* f, const int* trace_idx, const float* W, float* out,
           int M, int na, int K, int C, int D, cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, D / BN);
  intra_conv_kernel<BN><<<grid, Tile<BN>::kThreads, 0, stream>>>(
      f, trace_idx, W, out, M, na, K, C, D);
  return (int)cudaGetLastError();
}

}  // namespace

// f [b, P, na, C], trace_idx [na, K] int32 (device), W [K, C, D],
// out [b, P, na, D]; C must be a multiple of 4 and D of 32.
extern "C" int epn_intra_conv(const void* f, const void* trace_idx,
                              const void* W, void* out, int b, int P, int na,
                              int K, int C, int D, void* stream) {
  if (na * K > kMaxTrace || C % 4 != 0 || D % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* fp = (const float*)f;
  const int* tp = (const int*)trace_idx;
  const float* wp = (const float*)W;
  float* op = (float*)out;
  const int M = b * P * na;
  if (D % 128 == 0) return launch<128>(fp, tp, wp, op, M, na, K, C, D, s);
  if (D % 64 == 0) return launch<64>(fp, tp, wp, op, M, na, K, C, D, s);
  return launch<32>(fp, tp, wp, op, M, na, K, C, D, s);
}
