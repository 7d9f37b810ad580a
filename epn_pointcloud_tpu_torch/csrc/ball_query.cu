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
// Design: one thread per query; a block of 128 queries of one cloud stages
// the support cloud through shared memory in tiles of 1024 points (12 KB),
// so every support coordinate is read from device memory once per block.
// The distance is the direct difference, never |q|^2 + |s|^2 - 2 q.s (that
// expansion flips borderline hits), with __fmul_rn/__fadd_rn in the plain
// version's order (dx*dx + dy*dy) + dz*dz, and the test is strict (<).

#include <cuda_runtime.h>

namespace {

constexpr int kQueries = 128;
constexpr int kTile = 1024;

__global__ void ball_query_kernel(const float* __restrict__ query,
                                  const float* __restrict__ support,
                                  int* __restrict__ out, int m, int n,
                                  int n_sample, float r2) {
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
        float dx = __fsub_rn(qx, ss[3 * j]);
        float dy = __fsub_rn(qy, ss[3 * j + 1]);
        float dz = __fsub_rn(qz, ss[3 * j + 2]);
        float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
        if (d2 < r2) {
          o[cnt++] = t0 + j;
          if (cnt == n_sample) break;
        }
      }
    }
  }
  if (!active) return;
  // periodic repeat fill: slot s >= cnt takes slot s % cnt (cnt == 0 -> 0)
  if (cnt == 0) {
    for (int s = 0; s < n_sample; ++s) o[s] = 0;
  } else {
    for (int s = cnt; s < n_sample; ++s) o[s] = o[s % cnt];
  }
}

}  // namespace

extern "C" int epn_ball_query(const void* query, const void* support, void* out,
                              int b, int m, int n, int n_sample, float r2,
                              void* stream) {
  dim3 grid((m + kQueries - 1) / kQueries, b);
  ball_query_kernel<<<grid, kQueries, 0, (cudaStream_t)stream>>>(
      (const float*)query, (const float*)support, (int*)out, m, n, n_sample, r2);
  return (int)cudaGetLastError();
}
