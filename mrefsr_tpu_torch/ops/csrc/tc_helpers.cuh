// Helpers of the fused deformable conv's walks (mdcn_fused.cuh,
// mdcn_wgmma.cuh): cp.async copies into shared memory and the TF32 split of
// 3xTF32.
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

// The 3xTF32 split of an f32 x (its bits) for the TF32 wgmma: hi =
// tf32_rna(x), its low 13 bits cleared (adding half of the dropped part to
// the bits and clearing it rounds the magnitude to nearest, ties away from
// zero, as cvt.rna.tf32.f32 in feature_match.cu does, in two integer
// operations), and lo = x - hi, exact, handed over whole: the tensor cores
// read a TF32 operand's top 19 bits, so lo loses at most 2^-11 of itself,
// 2^-22 of x, in either direction (hi was rounded to nearest, so lo's sign
// is x's or not alike). Three operations an element where a rounded lo
// takes five.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (x + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

}  // namespace tc
