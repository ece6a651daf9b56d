// Tensor-core helpers for the hand-written Hopper kernels: 16-byte cp.async
// copies into shared memory, ldmatrix fragment loads and the bf16
// mma.sync.m16n8k16 with f32 accumulation.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a[0] (row g, cols 2t, 2t+1), a[1] (row g+8, the
//     same cols), a[2] (row g, cols 2t+8, 2t+9), a[3] (row g+8, cols 2t+8..9)
//   B (16 x 8, k x n): b0 (k 2t, 2t+1; col g), b1 (k 2t+8, 2t+9; col g)
//   C (16 x 8, f32): c[0], c[1] (row g, cols 2t, 2t+1), c[2], c[3] (row g+8)
// The lower-indexed element of a pair sits in the low 16 bits of its register.
#pragma once

#include "common.cuh"

namespace tt {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies the first `bytes` (0-16) of 16 bytes at gmem to smem and fills the
// rest with zeros; both addresses 16-byte aligned. bytes = 0 reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// The same for one 4-byte value: bytes is 4 or 0 (zero-fill).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lanes 8m..8m+7 give the row addresses of matrix m,
// and register m receives matrix m in the A/B fragment order above.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem))
               : "memory");
}

// The same with each 8x8 matrix transposed: B fragments from a (k, n) tile
// stored n-contiguous.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem))
               : "memory");
}

// d += a b on the tensor cores: bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tt
