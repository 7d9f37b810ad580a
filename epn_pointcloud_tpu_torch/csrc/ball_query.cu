// Ball query: for each query point, the first n_sample support indices in
// index order with squared distance < r^2, then the periodic repeat fill.
//
// Replaces: epn_pointcloud_tpu/ops/pallas/ball_query.py, ball_query_pallas
// (_kernel), which computes the hit mask for a query tile and extracts the
// first hits by unrolled min steps, leaving the repeat fill to XLA
// (epn_pointcloud_tpu/ops/sampling.py:237-262). Here the fill is done in the
// kernel, so its output is the final neighbor index table.
//
// What bounds it on the H100: each query scans the support cloud until it
// has n_sample hits: at most n distance tests of 3 subtractions and 3
// multiply-adds. At the flagship (b=32, m<=512, n<=1024) that is < 0.2
// GFLOP per layer; the cost is the latency of the scan loop and the write
// of the [b, m, n_sample] int32 table.
//
// Two kernels, picked by the wrapper (ops/kernels/ball_query.py, `route`):
//
// ball_query_warp_kernel (`epn_ball_query_warp`, n_sample <=
// kWarpMaxSample): kLanes lanes a query (32: a warp), kWarps warps of one
// cloud a block; the lanes read the support through L1 (kStage: the block
// stages it through shared memory in tiles of kTile points instead). The
// query's lanes test kUnroll * kLanes consecutive support points a step;
// __ballot_sync gives each group of kLanes points' hit mask and
// __popc(mask & lanes below) each hit's slot in index order. The hits go
// to the query's row in shared memory, and the scan stops when the row is
// full. Then the lanes write the row to the table, coalesced, with the
// periodic fill read from the row.
//
// ball_query_kernel (`epn_ball_query`, larger n_sample): one thread a
// query, 128 queries of one cloud a block, the support staged as above,
// each hit stored as it is found.
//
// Both: the distance is the direct difference, never |q|^2 + |s|^2 - 2 q.s
// (that expansion flips borderline hits), with __fmul_rn/__fadd_rn in the
// plain version's order (dx*dx + dy*dy) + dz*dz, and the test is strict
// (<). Slot s >= cnt takes slot s % cnt; a query with no hit gets zeros.
// With ref_fill (the launch argument the wrapper sets under the reference
// anchor convention) the fill is the original EPN kernel's
// (grouping_cuda_kernel.cu:99-104, which fills only while cnt <
// n_sample - 1): a query with exactly n_sample - 1 hits keeps 0 in its last
// slot, as epn_pointcloud_tpu/ops/sampling.py:256-261 writes it.

#include <cuda_runtime.h>

namespace {

constexpr int kQueries = 128;
constexpr int kTile = 1024;
constexpr int kLanes = 32;
constexpr int kUnroll = 4;
constexpr int kWarps = 4;
constexpr bool kStage = false;
constexpr int kWarpMaxSample = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dist2(float qx, float qy, float qz,
                                       const float* p) {
  const float dx = __fsub_rn(qx, p[0]);
  const float dy = __fsub_rn(qy, p[1]);
  const float dz = __fsub_rn(qz, p[2]);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// dynamic shared memory: the staged tile (S), then kWarps * 32 / L rows
// of n_sample ints. A query's L lanes test U * L consecutive points a
// step, lane l the points l, L + l, ..., so the slots of a step's hits
// follow (u, lane).
template <int L, int U, bool S>
__global__ void __launch_bounds__(kWarps * 32)
ball_query_warp_kernel(const float* __restrict__ query,
                       const float* __restrict__ support,
                       int* __restrict__ out, int m, int n, int n_sample,
                       float r2, int ref_fill) {
  constexpr int G = 32 / L;  // queries a warp
  extern __shared__ float smem[];
  float* ss = smem;
  int* rows = (int*)(smem + (S ? kTile * 3 : 0));
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / L, gl = lane % L;
  const int q = (blockIdx.x * kWarps + warp) * G + g;
  const bool active = q < m;
  const unsigned gmask = L == 32 ? kFull : ((1u << L) - 1) << (g * L);
  const unsigned below = (1u << lane) - 1;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = query + ((size_t)b * m + q) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  int* row = rows + (warp * G + g) * n_sample;
  const float* sp = support + (size_t)b * n * 3;
  int cnt = 0;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
    if (S) {
      __syncthreads();
      for (int i = threadIdx.x; i < len * 3; i += blockDim.x) {
        ss[i] = sp[(size_t)t0 * 3 + i];
      }
      __syncthreads();
    }
    const float* tile = S ? ss : sp + (size_t)t0 * 3;
    for (int j0 = 0; j0 < len; j0 += U * L) {
      const bool need = active && cnt < n_sample;
      if (!__any_sync(kFull, need)) break;
      bool hit[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * L + gl;
        hit[u] = need && j < len && dist2(qx, qy, qz, tile + 3 * j) < r2;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const unsigned mask = __ballot_sync(kFull, hit[u]) & gmask;
        if (hit[u]) {
          const int pos = cnt + __popc(mask & below);
          if (pos < n_sample) row[pos] = t0 + j0 + u * L + gl;
        }
        cnt += __popc(mask);
      }
    }
  }
  __syncwarp();
  if (!active) return;
  cnt = min(cnt, n_sample);
  // the reference fill leaves the last slot 0 at exactly n_sample - 1 hits
  const int last = ref_fill && cnt == n_sample - 1 ? cnt : n_sample;
  int* o = out + ((size_t)b * m + q) * n_sample;
  for (int s = gl; s < n_sample; s += L) {
    o[s] = cnt == 0 || s >= last ? 0 : row[s < cnt ? s : s % cnt];
  }
}

__global__ void ball_query_kernel(const float* __restrict__ query,
                                  const float* __restrict__ support,
                                  int* __restrict__ out, int m, int n,
                                  int n_sample, float r2, int ref_fill) {
  __shared__ float ss[kTile * 3];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kQueries + threadIdx.x;
  const bool active = q < m;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = query + ((size_t)b * m + q) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  int* o = out + ((size_t)b * m + (active ? q : 0)) * n_sample;
  const float* sp = support + (size_t)b * n * 3;
  int cnt = 0;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < len * 3; i += blockDim.x) {
      ss[i] = sp[(size_t)t0 * 3 + i];
    }
    __syncthreads();
    if (active && cnt < n_sample) {
      for (int j = 0; j < len; ++j) {
        if (dist2(qx, qy, qz, ss + 3 * j) < r2) {
          o[cnt++] = t0 + j;
          if (cnt == n_sample) break;
        }
      }
    }
  }
  if (!active) return;
  // periodic repeat fill: slot s >= cnt takes slot s % cnt (cnt == 0 -> 0);
  // the reference fill leaves the last slot 0 at exactly n_sample - 1 hits
  if (cnt == 0 || (ref_fill && cnt == n_sample - 1)) {
    for (int s = cnt; s < n_sample; ++s) o[s] = 0;
  } else {
    for (int s = cnt; s < n_sample; ++s) o[s] = o[s % cnt];
  }
}

}  // namespace

extern "C" int epn_ball_query(const void* query, const void* support, void* out,
                              int b, int m, int n, int n_sample, float r2,
                              int ref_fill, void* stream) {
  dim3 grid((m + kQueries - 1) / kQueries, b);
  ball_query_kernel<<<grid, kQueries, 0, (cudaStream_t)stream>>>(
      (const float*)query, (const float*)support, (int*)out, m, n, n_sample, r2,
      ref_fill);
  return (int)cudaGetLastError();
}

// The warp kernel: n_sample <= kWarpMaxSample (the wrapper's
// WARP_MAX_SAMPLE), which keeps its shared memory under 48 KB.
extern "C" int epn_ball_query_warp(const void* query, const void* support,
                                   void* out, int b, int m, int n,
                                   int n_sample, float r2, int ref_fill,
                                   void* stream) {
  if (n_sample > kWarpMaxSample) return (int)cudaErrorInvalidValue;
  constexpr int per_block = kWarps * 32 / kLanes;
  const size_t smem = (kStage ? kTile * 3 * sizeof(float) : 0) +
                      (size_t)per_block * n_sample * sizeof(int);
  dim3 grid((m + per_block - 1) / per_block, b);
  ball_query_warp_kernel<kLanes, kUnroll, kStage>
      <<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
          (const float*)query, (const float*)support, (int*)out, m, n,
          n_sample, r2, ref_fill);
  return (int)cudaGetLastError();
}
