// Top-1 patch matching on bf16 patches, on Hopper's warpgroup tensor cores
// (wgmma) fed by the Tensor Memory Accelerator (TMA): for every input patch,
// the best-scoring reference patch and its score.
//
// Replaces mrefsr_tpu/ops/correlation.py::feature_match_index
// (correlation.py:45-104) at bf16, where its score tile is
// jnp.dot(pin, pref_c.T, preferred_element_type=jnp.float32) (:86): bf16
// operands, f32 sums, an f32 running max and argmax across reference tiles.
// The unfold and the norms (bf16, rounded where XLA rounds them) run before
// it in feature_match_prologue.cu; the division by the input norm stays in
// PyTorch (ops/correlation.py). The products of two bf16 values are exact
// in f32, so the scores differ from the plain version's (an f32 matmul of
// the same values) only in the order of the f32 sums.
//
// Bound on the H100: operations. One 500x500 CUFED5 request runs 5 pairs of
// 15129 patches a side with d = 9 * 256 = 2304: 5.3 TFLOP, 5.33 ms at the
// 989 TFLOP/s of dense bf16; a stage-3 training step (30 pairs of 1444,
// 40x40 maps) 0.29 TFLOP, 0.29 ms. The 128 x 256 tiles move 85 FLOP an L2
// byte, against 64 for 128 x 128 tiles with 32-deep slices, which on
// mma.sync reached 196 TFLOP/s while pulling about 3 TB/s from L2.
//
// Design: the tile walk of feature_match_wgmma.cuh with one wgmma.m64n256k16
// (bf16 in, f32 sums) a 16-deep k step, 64-deep slices, a ring of 4 stages
// of 48 KB.
#include "feature_match_wgmma.cuh"

namespace {

// d (64 x 256, f32) = a (64 x 16) b (256 x 16)^T + (accumulate ? d : 0),
// a and b bf16, K-major, in shared memory. Thread (warp w, lane 4 gid +
// tig) holds d[4 j + e] at row 16 w + gid and d[4 j + 2 + e] at row
// 16 w + gid + 8, column 8 j + 2 tig + e.
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

struct Bf16 {
  static constexpr int BK = 64;
  static constexpr int PARTS = 1;
  static constexpr int STAGES = 4;
  static __device__ __forceinline__ void step(float (&acc)[128], uint32_t a,
                                              uint32_t b, int accumulate) {
    wgmma_bf16(acc, fm::desc_sw128(a), fm::desc_sw128(b), accumulate);
  }
};

int launch(const void* pin, const void* pref, int pairs, int n_in, int n_ref,
           int d, int ld, void* idx, void* val, void* stream) {
  return fm::launch_match<Bf16>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, pin,
                                pref, pairs, n_in, n_ref, d, ld, idx, val,
                                (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// pin and pref are device pointers of bf16 patch matrices whose rows are ld
// elements apart (ld a multiple of 8, pairs n * ld apart, 16-byte aligned),
// idx of int32, val of f32; the stream is a cudaStream_t. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue if a tensor
// map cannot be encoded).
int feature_match_bf16_launch(const void* pin, const void* pref, int pairs,
                              int n_in, int n_ref, int d, int ld, void* idx,
                              void* val, void* stream) {
  return launch(pin, pref, pairs, n_in, n_ref, d, ld, idx, val, stream);
}

// The same kernel on one rank's band of reference rows, for
// mrefsr_tpu/ops/correlation.py::feature_match_index_sharded
// (correlation.py:140-180) at bf16: a second name only, so that the sharded
// match counts its launches apart from the single-device one.
int feature_match_sharded_bf16_launch(const void* pin, const void* pref,
                                      int pairs, int n_in, int n_ref, int d,
                                      int ld, void* idx, void* val,
                                      void* stream) {
  return launch(pin, pref, pairs, n_in, n_ref, d, ld, idx, val, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
