// Tensor-core building blocks for the bf16 kernels (sm_80+ instructions,
// run on Hopper): cp.async staging with zero fill, ldmatrix fragment loads
// from XOR-swizzled shared-memory tiles, and the bf16 x bf16 -> fp32
// mma.sync.m16n8k16; stmatrix (sm_90) to write fragments back transposed,
// and a streaming 16-byte store.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major)  a0: (g, 2t..2t+1)   a1: (g+8, 2t..)
//                           a2: (g, 2t+8..)     a3: (g+8, 2t+8..)
//   B (16 x 8, "col")       b0: (k 2t..2t+1, n g)  b1: (k 2t+8.., n g)
//   C (16 x 8, fp32)        c0, c1: (g, 2t..2t+1)  c2, c3: (g+8, 2t..)
// A tile stored [m][k] loads with ldmatrix, one stored [k][m] with
// ldmatrix.trans; a B tile stored [n][k] with ldmatrix, [k][n] with .trans.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Element offset of (r, col) in a bf16 tile whose rows are `cpr` 16-byte
// chunks (cpr >= 4): the chunk index is XORed within its 128-byte line so
// that the eight rows an ldmatrix reads at one column fall in eight
// different bank groups.
__device__ __forceinline__ int swz(int r, int col, int cpr) {
  const int lin = r * cpr + (col >> 3);
  const int s = (cpr >= 8 ? r : (r * cpr) >> 3) & 7;
  return (((lin & ~7) | ((lin & 7) ^ s)) << 3) | (col & 7);
}

// 16 (8) bytes global -> shared, bypassing registers; zeros when !valid
// (src is then not read, but must be a valid address)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp8(uint32_t dst, const void* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// lanes 0-15 give the addresses
__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// stmatrix (sm_90), transposed: the 8 x 8 bf16 fragment of matrix m held
// as ldmatrix gives it (lane l: row l / 4, columns 2 (l % 4) .. + 1) in
// r[m] is stored with its columns as rows: fragment column c goes to the
// 16-byte row whose address lane 8 m + c gives
__device__ __forceinline__ void stsm4t(uint32_t addr, uint32_t r0,
                                       uint32_t r1, uint32_t r2,
                                       uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// 16 bytes to global memory, marked evict-first in L2 (st.global.cs): for
// outputs written once and not read again by the kernel, so that they do
// not push its gathered operand out of L2
__device__ __forceinline__ void st_stream16(void* p, const uint4& v) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// d += a b (bf16 operands, fp32 accumulators)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the current device's SM count (host)
inline int num_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

}  // namespace tc
