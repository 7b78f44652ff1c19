// Warp-level bf16 tensor-core helpers for the kernels that run their
// products on mma.sync (mdcn_bf16.cu): cp.async copies into shared memory,
// the m16n8k16 bf16 -> f32 product, and the fragment loads.
//
// Fragments of mma.sync.m16n8k16.row.col (lane = 4 * gid + tig):
//   A (16 x 16, row-major): a0 = A[gid][2 tig, +1], a1 = A[gid + 8][2 tig, +1],
//                           a2 = A[gid][2 tig + 8, +1], a3 = A[gid + 8][2 tig + 8, +1]
//   B (16 x 8, k-major):    b0 = B[2 tig, +1][gid], b1 = B[2 tig + 8, +1][gid]
//   C (16 x 8, f32):        c0, c1 = C[gid][2 tig, +1], c2, c3 = C[gid + 8][2 tig, +1]
// An operand staged with its k dimension contiguous is read with
// `ldmatrix_x4` / `ldmatrix_x2` (whole fragments); one staged with k across
// rows is read transposed with `ldmatrix_x4_trans` / `ldmatrix_x2_trans`.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

// 16 bytes from global to shared memory; `src_bytes` 0 writes zeros
// (a ragged edge) and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// c += a * b, bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices of shared memory: lanes 8 i .. 8 i + 7 give the
// addresses of matrix i's 8 rows (16 bytes each, 16-byte aligned); lane
// (gid, tig) receives in r[i] matrix i's elements [gid][2 tig, +1].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Two such matrices: lanes 0 .. 15 give the addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// Four 8 x 8 bf16 matrices of shared memory, transposed: lanes 8 i .. 8 i + 7
// give the addresses of matrix i's 8 rows (16 bytes each, 16-byte aligned);
// lane (gid, tig) receives in r[i] matrix i's elements [2 tig][gid] and
// [2 tig + 1][gid].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Two such transposed matrices: lanes 0 .. 15 give the addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

}  // namespace tc
