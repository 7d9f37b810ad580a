// Element access shared by the kernels that run in both compute dtypes
// (fp32 parity mode, bf16 production mode): four consecutive elements load
// as one float4 and store from one, whatever the storage type, and
// round_to<T> rounds an fp32 value to T and back (the identity for float).
// The kernels that use these widen bf16 on load and compute in fp32 on the
// CUDA cores. The bf16 grouped conv does not: its products take bf16
// operands straight from shared memory into the tensor cores (tc.cuh,
// grouped_conv.cu), and it uses these helpers only for its epilogues.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace epn {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 8-byte aligned: element 0 is the low half of the first word
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// eight consecutive elements into t[0..7]: two 16-byte loads (fp32) or one
// (bf16); p 32- / 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float (&t)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  t[0] = a.x; t[1] = a.y; t[2] = a.z; t[3] = a.w;
  t[4] = b.x; t[5] = b.y; t[6] = b.z; t[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&t)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    t[2 * i] = __uint_as_float(w[i] << 16);
    t[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const bf16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

__device__ __forceinline__ void store4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, const float4& v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return v;
}

template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The activations the kernels apply, as the slope of a leaky ReLU with the
// mask u > 0 (torch's subgradient convention): 0.01 for the leaky ReLU
// (LEAKY_SLOPE in ops/kernels/build.py), 0 for the ReLU (ACT_SLOPES there).
// The slope is a launch argument of each kernel that applies it.
__device__ __forceinline__ float leaky(float u, float slope) {
  return u > 0.f ? u : slope * u;
}

}  // namespace epn
