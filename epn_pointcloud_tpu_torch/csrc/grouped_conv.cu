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
// lane = a * D + d. Everything is computed in fp32; x, W, y and out are
// fp32 or bf16.
//
// Replaces: epn_pointcloud_tpu/ops/pallas/grouped_conv.py, grouped_conv1x1
// (_fwd -> _fwd_kernel) and grouped_conv1x1_skip_epilogue
// (_fwd_skip_kernel). The TPU kernels group g anchors into a block-diagonal
// weight so every lane slice is 128-aligned; none of that comes over: a
// contiguous [b, p, na, C] tensor is a [b * p * na, C] matrix, so here the
// conv is one GEMM over all (point, anchor) rows and takes every C and D
// the model has.
//
// Backward (B9: _gc_bwd -> _bwd_kernel, which computes dx and dW in its
// body): dx = dout @ W^T is the plain form above on (dout, W^T) with no
// bias; dW = x^T dout (grouped_dw_kernel) reduces over the rows, written as
// per-row-range partials and added in a fixed order (split_sum.cuh), so it
// is deterministic. dbias is a plain reduce of dout outside, as in the JAX
// package. Both run in fp32 or bf16, with fp32 FMAs, bound by the fp32 FMA
// rate as the forward.
//
// What bounds it on the H100: as written, the fp32 FMA rate of the CUDA
// cores (2 * rows * C * D operations; flagship layer 1 at b=32: 983,040
// rows, 64 x 64, 8 GFLOP). The same work on bf16 tensor cores would be
// bound by device memory instead (x, y and out: 377 MB in bf16 at layer 1).
//
// Design: the register-blocked SGEMM of intra_conv.cu without the gather: a
// block computes a 128-row x BN-column tile (BN = 128, 64 or 32, whichever
// divides D) with 8 x 8 outputs a thread, walking C in slices of 16 staged
// through two shared buffers (the next slice's global loads are in flight
// while the current one is used). The epilogue runs on the accumulator in
// registers: the skip conv output, the activated branches and the residual
// never exist in device memory.

#include <cuda_runtime.h>

#include "elem.cuh"
#include "split_sum.cuh"

namespace {

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

struct Tail {
  const void* y;       // [rows, D], the raw intra output
  const float* ssk;    // skip fold [., 2, L] at batch stride ssk_stride
  const float* ssm;    // main fold [., 2, L] at batch stride ssm_stride
  int ssk_stride, ssm_stride, P, na;
};

template <typename T, int BN>
__device__ __forceinline__ void load_slice(
    const T* __restrict__ x, const T* __restrict__ W, int m0, int kk0,
    int tid, int M, int C, int D, int n0, float4 (&ra)[Tile<BN>::kALoads],
    float4 (&rb)[Tile<BN>::kBLoads]) {
  using G = Tile<BN>;
#pragma unroll
  for (int i = 0; i < G::kALoads; ++i) {
    const int e = tid + i * G::kThreads;
    const int gm = m0 + e / 4, kk = kk0 + 4 * (e % 4);
    ra[i] = gm < M && kk < C ? epn::load4(x + (size_t)gm * C + kk)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < G::kBLoads; ++i) {
    const int e = tid + i * G::kThreads;
    const int kk = kk0 + e / (BN / 4), c4 = e % (BN / 4);
    rb[i] = kk < C ? epn::load4(W + (size_t)kk * D + n0 + 4 * c4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
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

// four outputs of row gm at columns n .. n + 3 from the accumulators v
template <typename T, bool TAIL>
__device__ __forceinline__ void epilogue(T* __restrict__ out,
                                         const float* __restrict__ bias,
                                         const Tail& tl, int gm, int n, int D,
                                         float4 v) {
  if (bias != nullptr) {
    v.x += bias[n];
    v.y += bias[n + 1];
    v.z += bias[n + 2];
    v.w += bias[n + 3];
  }
  if (TAIL) {
    const int a = gm % tl.na, bi = gm / (tl.na * tl.P);
    const int L = tl.na * D, lane = a * D + n;
    const float* sk = tl.ssk + (size_t)bi * tl.ssk_stride + lane;
    const float* sm = tl.ssm + (size_t)bi * tl.ssm_stride + lane;
    const float4 y = epn::load4((const T*)tl.y + (size_t)gm * D + n);
    v.x = epn::leaky(fmaf(y.x, sm[0], sm[L])) +
          epn::leaky(fmaf(v.x, sk[0], sk[L]));
    v.y = epn::leaky(fmaf(y.y, sm[1], sm[L + 1])) +
          epn::leaky(fmaf(v.y, sk[1], sk[L + 1]));
    v.z = epn::leaky(fmaf(y.z, sm[2], sm[L + 2])) +
          epn::leaky(fmaf(v.z, sk[2], sk[L + 2]));
    v.w = epn::leaky(fmaf(y.w, sm[3], sm[L + 3])) +
          epn::leaky(fmaf(v.w, sk[3], sk[L + 3]));
  }
  epn::store4(out + (size_t)gm * D + n, v);
}

template <typename T, bool TAIL, int BN>
__global__ void __launch_bounds__(Tile<BN>::kThreads)
grouped_conv_kernel(const T* __restrict__ x, const T* __restrict__ W,
                    const float* __restrict__ bias, T* __restrict__ out,
                    Tail tl, int M, int C, int D) {
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
  load_slice<T, BN>(x, W, m0, 0, tid, M, C, D, n0, ra, rb);
  store_slice<BN>(As[0], Bs[0], tid, ra, rb);
  __syncthreads();
  const int n_slices = (C + BK - 1) / BK;
  for (int s = 0; s < n_slices; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_slices) {
      load_slice<T, BN>(x, W, m0, (s + 1) * BK, tid, M, C, D, n0, ra, rb);
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
      epilogue<T, TAIL>(out, bias, tl, gm, n0 + tx * 4, D,
                        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      epilogue<T, TAIL>(out, bias, tl, gm, n0 + BN / 2 + tx * 4, D,
                        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
    }
  }
}

template <typename T, bool TAIL>
int launch(const void* x, const void* W, const float* bias, void* out,
           const Tail& tl, int M, int C, int D, cudaStream_t s) {
  const T* xp = (const T*)x;
  const T* wp = (const T*)W;
  T* op = (T*)out;
  const unsigned gx = (M + BM - 1) / BM;
  if (D % 128 == 0) {
    grouped_conv_kernel<T, TAIL, 128><<<dim3(gx, D / 128), Tile<128>::kThreads,
                                        0, s>>>(xp, wp, bias, op, tl, M, C, D);
  } else if (D % 64 == 0) {
    grouped_conv_kernel<T, TAIL, 64><<<dim3(gx, D / 64), Tile<64>::kThreads,
                                       0, s>>>(xp, wp, bias, op, tl, M, C, D);
  } else {
    grouped_conv_kernel<T, TAIL, 32><<<dim3(gx, D / 32), Tile<32>::kThreads,
                                       0, s>>>(xp, wp, bias, op, tl, M, C, D);
  }
  return (int)cudaGetLastError();
}

template <bool TAIL>
int dispatch(const void* x, const void* W, const void* bias, void* out,
             const Tail& tl, int rows, int C, int D, int bf16, void* stream) {
  if (C % 4 != 0 || D % 32 != 0 || rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* bp = (const float*)bias;
  if (bf16) return launch<epn::bf16, TAIL>(x, W, bp, out, tl, rows, C, D, s);
  return launch<float, TAIL>(x, W, bp, out, tl, rows, C, D, s);
}

constexpr int WBK = 16;  // rows a reduction slice of dW

// dW[c, d] = sum_m x[m, c] dout[m, d] over one range of rows m: the block's
// 128 (c) x BN (d) tile of the partial dW of its range, rows staged 16 at a
// time, 8 x 8 outputs a thread (the intra conv's dW without the gather)
template <typename T, int BN>
__global__ void __launch_bounds__(Tile<BN>::kThreads)
grouped_dw_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                  float* __restrict__ part, int M, int C, int D,
                  int rows_per_split) {
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

  float* dst = part + (size_t)split * C * D;
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

template <typename T, int BN>
int launch_dw(const void* x, const void* dout, float* ws, float* dW, int M,
              int C, int D, int splits, cudaStream_t s) {
  const int slices = (M + WBK - 1) / WBK;
  const int rows_per_split = (slices + splits - 1) / splits * WBK;
  dim3 grid((C + BM - 1) / BM, D / BN, splits);
  grouped_dw_kernel<T, BN><<<grid, Tile<BN>::kThreads, 0, s>>>(
      (const T*)x, (const T*)dout, ws, M, C, D, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_splits(ws, dW, splits, (size_t)C * D, s);
}

template <typename T>
int launch_dw_cols(const void* x, const void* dout, float* ws, float* dW,
                   int M, int C, int D, int splits, cudaStream_t s) {
  if (D % 128 == 0) return launch_dw<T, 128>(x, dout, ws, dW, M, C, D, splits, s);
  if (D % 64 == 0) return launch_dw<T, 64>(x, dout, ws, dW, M, C, D, splits, s);
  return launch_dw<T, 32>(x, dout, ws, dW, M, C, D, splits, s);
}

}  // namespace

// x [rows, C], W [C, D], out [rows, D] (fp32, or bf16 when bf16 != 0),
// bias [D] fp32 or null (no bias: the backward's dx = dout W^T runs this
// with W^T); rows = b * p * na. C must be a multiple of 4, D of 32.
extern "C" int epn_grouped_conv(const void* x, const void* W,
                                const void* bias, void* out, int rows, int C,
                                int D, int bf16, void* stream) {
  const Tail tl = {nullptr, nullptr, nullptr, 0, 0, 1, 1};
  return dispatch<false>(x, W, bias, out, tl, rows, C, D, bf16, stream);
}

// The fused separable-block tail. x [b, P, na, C], W [C, D], y and out
// [b, P, na, D] (fp32, or bf16 when bf16 != 0), bias [D], ssk and ssm
// fp32 [., 2, na * D] at batch strides ssk_stride / ssm_stride (elements;
// 0 broadcasts one row pair over the batch).
extern "C" int epn_grouped_conv_tail(const void* x, const void* W,
                                     const void* bias, const void* ssk,
                                     const void* y, const void* ssm,
                                     void* out, int b, int P, int na, int C,
                                     int D, int ssk_stride, int ssm_stride,
                                     int bf16, void* stream) {
  const Tail tl = {y, (const float*)ssk, (const float*)ssm, ssk_stride,
                   ssm_stride, P, na};
  return dispatch<true>(x, W, bias, out, tl, b * P * na, C, D, bf16, stream);
}

// dW [C, D] fp32 = x^T dout over x [rows, C] and dout [rows, D] (fp32, or
// bf16 when bf16 != 0): per-row-range partials in ws [splits, C, D] fp32,
// added in a fixed order. C must be a multiple of 4, D of 32.
extern "C" int epn_grouped_conv_bwd_w(const void* x, const void* dout,
                                      void* ws, void* dW, int rows, int C,
                                      int D, int splits, int bf16,
                                      void* stream) {
  if (C % 4 != 0 || D % 32 != 0 || rows < 1 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return launch_dw_cols<epn::bf16>(x, dout, (float*)ws, (float*)dW, rows, C,
                                     D, splits, s);
  }
  return launch_dw_cols<float>(x, dout, (float*)ws, (float*)dW, rows, C, D,
                               splits, s);
}
