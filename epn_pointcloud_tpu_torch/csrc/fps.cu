// Furthest point sampling.
//
// Replaces: epn_pointcloud_tpu/ops/pallas/fps.py, fps_pallas (_kernel), the
// TPU kernel that keeps a whole cloud batch in VMEM and runs the sequential
// sample loop inside one kernel.
//
// What bounds it on the H100: the loop is sequential over samples, so the
// cost is n_sample steps of (one pass over the cloud + one block-wide
// argmax). At 1024 points the pass is tiny; the argmax and the barrier of
// each step are the cost, i.e. latency, not bandwidth or FLOPs.
//
// Two kernels, picked by the wrapper (ops/kernels/fps.py, `route`):
//
// fps_reg_kernel (`epn_fps_reg`, n <= kRegThreads * kRegMaxPoints): one
// block of kRegThreads threads a cloud; each thread holds P = n / threads
// points (x, y, z and the running minimum) in registers, point
// tid + k * threads in slot k, so no step touches shared memory for the
// cloud. The argmax runs on the key (hi, index): hi = bits(min distance)
// + 1 for a valid point (a distance >= 0 orders as an unsigned int) and 0
// for a shadow-guarded or padding point; the larger hi wins, ties go to
// the lower index. A warp reduces it with two redux.sync
// (__reduce_max_sync on hi, then __reduce_min_sync on the index among the
// lanes holding that hi), the lane that owns the winner writes its key and
// x, y, z into its warp's slot, and after the step's one barrier every
// warp reduces the slots itself the same way. The slots are
// double-buffered on the step's parity, so no second barrier is needed.
// 512 threads (2 points a thread at the models' 1024) measured fastest
// (PERF.md, `sampling_variants.py`).
//
// fps_kernel (`epn_fps`, larger n): one block of up to 1024 threads a
// cloud, the coordinates and running minimum in shared memory, a
// warp-shuffle argmax and a second level over the warps' winners.
//
// Both: ties go to the lowest index, like jnp.argmax / torch.argmax; an
// all-invalid cloud picks 0. Distances use __fsub_rn / __fmul_rn /
// __fadd_rn in the order (dx*dx + dy*dy) + dz*dz, so FMA contraction
// cannot flip a near-tie against the plain version.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kRegThreads = 512;
constexpr int kRegMaxPoints = 16;
constexpr unsigned kFull = 0xffffffffu;

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

// a point's squared distance to the last pick
__device__ __forceinline__ float pick_dist(float x, float y, float z,
                                           float x1, float y1, float z1) {
  return sq3(__fsub_rn(x, x1), __fsub_rn(y, y1), __fsub_rn(z, z1));
}

struct Slot {
  unsigned hi, idx;
  float x, y, z;
};

template <int T, int P>
__global__ void __launch_bounds__(T)
fps_reg_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n,
               int n_sample, float shadow_eps) {
  constexpr int W = T / 32;
  __shared__ Slot slots[2][W];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* cloud = xyz + (size_t)b * n * 3;
  int* o = out + (size_t)b * n_sample;

  float px[P], py[P], pz[P], t[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = tid + k * T;
    px[k] = py[k] = pz[k] = 0.f;
    t[k] = -CUDART_INF_F;  // padding and shadow-guarded points: never valid
    if (i < n) {
      px[k] = cloud[3 * i];
      py[k] = cloud[3 * i + 1];
      pz[k] = cloud[3 * i + 2];
      if (sq3(px[k], py[k], pz[k]) > shadow_eps) t[k] = CUDART_INF_F;
    }
  }
  float x1 = cloud[0], y1 = cloud[1], z1 = cloud[2];
  if (tid == 0) o[0] = 0;

  for (int j = 1; j < n_sample; ++j) {
    // this thread's best (hi, slot k): k ascending, so a strict > keeps
    // the lowest index on a tie
    unsigned bhi = 0;
    int bk = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      unsigned hi = 0;
      if (t[k] != -CUDART_INF_F) {
        t[k] = fminf(t[k], pick_dist(px[k], py[k], pz[k], x1, y1, z1));
        hi = __float_as_uint(t[k]) + 1u;
      }
      if (k == 0 || hi > bhi) {
        bhi = hi;
        bk = k;
      }
    }
    const unsigned bidx = (unsigned)(tid + bk * T);
    const unsigned whi = __reduce_max_sync(kFull, bhi);
    const unsigned widx = __reduce_min_sync(kFull, bhi == whi ? bidx : ~0u);
    Slot* s = slots[j & 1];
    if (bidx == widx) {
      float wx = px[0], wy = py[0], wz = pz[0];
#pragma unroll
      for (int k = 1; k < P; ++k) {
        if (bk == k) {
          wx = px[k];
          wy = py[k];
          wz = pz[k];
        }
      }
      s[warp] = Slot{whi, widx, wx, wy, wz};
    }
    __syncthreads();
    const unsigned shi = lane < W ? s[lane].hi : 0u;
    const unsigned sidx = lane < W ? s[lane].idx : ~0u;
    const unsigned ghi = __reduce_max_sync(kFull, shi);
    const unsigned gidx = __reduce_min_sync(kFull, shi == ghi ? sidx : ~0u);
    const Slot& win = s[(gidx % T) >> 5];
    x1 = win.x;
    y1 = win.y;
    z1 = win.z;
    if (tid == 0) o[j] = (int)gidx;
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
      float v2 = __shfl_down_sync(kFull, bv, off);
      int i2 = __shfl_down_sync(kFull, bi, off);
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
        float v2 = __shfl_down_sync(kFull, bv, off);
        int i2 = __shfl_down_sync(kFull, bi, off);
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

template <int P>
void launch_reg(const float* xyz, int* out, int b, int n, int n_sample,
                float shadow_eps, cudaStream_t stream) {
  fps_reg_kernel<kRegThreads, P><<<b, kRegThreads, 0, stream>>>(
      xyz, out, n, n_sample, shadow_eps);
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

// The register kernel: n <= kRegThreads * kRegMaxPoints (the wrapper's
// REG_MAX_N); P, the points a thread, is the least power of two that
// holds the cloud.
extern "C" int epn_fps_reg(const void* xyz, void* out, int b, int n,
                           int n_sample, float shadow_eps, void* stream) {
  const float* x = (const float*)xyz;
  int* o = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int p = (n + kRegThreads - 1) / kRegThreads;
  if (p > kRegMaxPoints) return (int)cudaErrorInvalidValue;
  if (p <= 1) launch_reg<1>(x, o, b, n, n_sample, shadow_eps, s);
  else if (p <= 2) launch_reg<2>(x, o, b, n, n_sample, shadow_eps, s);
  else if (p <= 4) launch_reg<4>(x, o, b, n, n_sample, shadow_eps, s);
  else if (p <= 8) launch_reg<8>(x, o, b, n, n_sample, shadow_eps, s);
  else launch_reg<16>(x, o, b, n, n_sample, shadow_eps, s);
  return (int)cudaGetLastError();
}
