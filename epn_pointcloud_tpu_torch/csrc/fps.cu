// Furthest point sampling.
//
// Replaces: epn_pointcloud_tpu/ops/pallas/fps.py, fps_pallas (_kernel), the
// TPU kernel that keeps a whole cloud batch in VMEM and runs the sequential
// sample loop inside one kernel.
//
// What bounds it on the H100: the loop is sequential over samples, so the
// cost is n_sample iterations of (one pass over the cloud + one block-wide
// argmax). At 1024 points the pass is tiny; the block-wide reduction and its
// two barriers per iteration are the cost, i.e. latency, not bandwidth or
// FLOPs.
//
// Design: one block per cloud. The cloud's coordinates and the running
// min-distance live in shared memory (16 bytes a point, 16 KB at 1024
// points); each thread walks a strided slice, then a warp-shuffle argmax
// and a second-level argmax over the warps' winners pick the next sample.
// Ties go to the lowest index, like jnp.argmax / torch.argmax. Distances
// use __fmul_rn/__fadd_rn in the order (dx*dx + dy*dy) + dz*dz, so FMA
// contraction cannot flip a near-tie against the plain version.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// (value, index) max with ties to the lower index
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__global__ void fps_kernel(const float* __restrict__ xyz, int* __restrict__ out,
                           int n, int n_sample, float shadow_eps) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* temp = sz + n;
  __shared__ float wv[32];
  __shared__ int wi[32];
  __shared__ int s_old;

  const int b = blockIdx.x;
  const float* cloud = xyz + (size_t)b * n * 3;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float x = cloud[3 * i], y = cloud[3 * i + 1], z = cloud[3 * i + 2];
    sx[i] = x;
    sy[i] = y;
    sz[i] = z;
    // invalid (shadow-guarded) points carry -inf forever
    temp[i] = sq3(x, y, z) > shadow_eps ? CUDART_INF_F : -CUDART_INF_F;
  }
  if (threadIdx.x == 0) {
    out[(size_t)b * n_sample] = 0;
    s_old = 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int j = 1; j < n_sample; ++j) {
    const int old = s_old;
    const float x1 = sx[old], y1 = sy[old], z1 = sz[old];
    float bv = -CUDART_INF_F;
    int bi = n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float t = temp[i];
      if (t != -CUDART_INF_F) {
        float d = sq3(__fsub_rn(sx[i], x1), __fsub_rn(sy[i], y1),
                      __fsub_rn(sz[i], z1));
        t = fminf(t, d);
        temp[i] = t;
      }
      better(bv, bi, t, i);
    }
    for (int off = 16; off > 0; off >>= 1) {
      float v2 = __shfl_down_sync(0xffffffffu, bv, off);
      int i2 = __shfl_down_sync(0xffffffffu, bi, off);
      better(bv, bi, v2, i2);
    }
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? wv[lane] : -CUDART_INF_F;
      bi = lane < nwarps ? wi[lane] : n;
      for (int off = 16; off > 0; off >>= 1) {
        float v2 = __shfl_down_sync(0xffffffffu, bv, off);
        int i2 = __shfl_down_sync(0xffffffffu, bi, off);
        better(bv, bi, v2, i2);
      }
      if (lane == 0) {
        // all candidates -inf (every point shadow-guarded): argmax picks 0
        int pick = bi < n ? bi : 0;
        s_old = pick;
        out[(size_t)b * n_sample + j] = pick;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int epn_fps(const void* xyz, void* out, int b, int n, int n_sample,
                       float shadow_eps, void* stream) {
  const size_t smem = (size_t)n * 4 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  int threads = n < kThreads ? ((n + 31) / 32) * 32 : kThreads;
  fps_kernel<<<b, threads, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, (int*)out, n, n_sample, shadow_eps);
  return (int)cudaGetLastError();
}
