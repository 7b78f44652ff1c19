// Top-1 patch matching on f32 patches, on the TF32 tensor cores with the
// 3xTF32 split, through Hopper's wgmma fed by TMA: for every input patch,
// the best-scoring reference patch and its score.
//
// Replaces mrefsr_tpu/ops/correlation.py::feature_match_index
// (correlation.py:45-104), whose score tile is an XLA matmul with a running
// max/argmax carried across a lax.scan over reference tiles. The unfold and
// the norms run before it in feature_match_prologue.cu; the division by
// the input norm stays in PyTorch (ops/correlation.py).
//
// Arithmetic: 3xTF32. A first kernel splits each f32 operand x into
// hi = tf32_rna(x) and lo = tf32_rna(x - hi) (10 + 10 explicit mantissa
// bits, so hi + lo holds 21-22 of x's 24; the low 13 bits of both cleared),
// written to two planes of a scratch buffer; the match then accumulates each
// product in f32 as lo*hi + hi*lo + hi*hi (small terms first) with
// wgmma.m64n256k8.tf32. The dropped lo*lo and the rounding of lo leave an
// error near 2^-21 of |a||b| a product (tests/test_torch_correlation.py
// emulates the split: within 1e-7 of the f64 score at d = 2304 on
// unit-norm features); the tensor cores' f32 sums, which truncate, add the
// rest (about 2e-6 of a score of 1 at that depth, measured on the H100).
// Built this way rather than plain TF32 with an exact f32 re-rank of
// near-ties: on flat image regions the set of near-ties has no bound and a
// re-rank needs a second pass, while 3xTF32 costs a fixed three products
// and is the same from run to run. Integer scores of small integers are
// exact (lo = 0), so exact ties stay exact.
//
// Bound on the H100: operations. One 500x500 CUFED5 request runs 5 pairs of
// 15129 patches a side with d = 9 * 256 = 2304: 5.3 TFLOP, 78.7 ms at the
// 67 TFLOP/s of the f32 CUDA cores, 32.0 ms for the three TF32 products at
// 495 TFLOP/s; a stage-3 training step (30 pairs of 1444) 4.30 and 1.75 ms.
// The split moves 3 bytes out for each byte in (1.3 ms at eval).
//
// Design: the split, one pass of 16-byte vectors over both patch matrices;
// then the tile walk of feature_match_wgmma.cuh with three
// wgmma.m64n256k8 (TF32 in, f32 sums) an 8-deep k step, 32-deep slices, and
// a ring of 2 stages of 96 KB (hi and lo of 128 input and 256 ref rows).
// The split is a pass of its own because wgmma reads its operands from
// shared memory as TMA writes them; splitting fragments as they are loaded
// needs a register-fed mma.sync walk, which on the H100 measured 123 ms at
// eval, slower than cuBLAS's f32 product of the scores alone (101 ms).
#include "feature_match_wgmma.cuh"

namespace {

constexpr int SPLIT_THREADS = 256;
constexpr uint32_t TF32_MASK = 0xFFFFE000u;

__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & TF32_MASK);
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32(x);
  lo = tf32(x - hi);
}

// x (n4 vectors of 4 f32) -> hi at out[0, n4), lo at out[n4, 2 n4)
__global__ void __launch_bounds__(SPLIT_THREADS)
split_tf32_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                  long long n4) {
  for (long long i = (long long)blockIdx.x * SPLIT_THREADS + threadIdx.x;
       i < n4; i += (long long)gridDim.x * SPLIT_THREADS) {
    const float4 v = x[i];
    float4 hi, lo;
    split(v.x, hi.x, lo.x);
    split(v.y, hi.y, lo.y);
    split(v.z, hi.z, lo.z);
    split(v.w, hi.w, lo.w);
    out[i] = hi;
    out[n4 + i] = lo;
  }
}

// d (64 x 256, f32) = a (64 x 8) b (256 x 8)^T + (accumulate ? d : 0),
// a and b TF32, K-major, in shared memory. Thread (warp w, lane 4 gid +
// tig) holds d[4 j + e] at row 16 w + gid and d[4 j + 2 + e] at row
// 16 w + gid + 8, column 8 j + 2 tig + e.
__device__ __forceinline__ void wgmma_tf32(float (&d)[128], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1;\n"
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

// three products a k step: lo*hi + hi*lo + hi*hi; part 0 of a tile is hi,
// part 1 lo
struct Tf32x3 {
  static constexpr int BK = 32;
  static constexpr int PARTS = 2;
  static constexpr int STAGES = 2;
  static __device__ __forceinline__ void step(float (&acc)[128], uint32_t a,
                                              uint32_t b, int accumulate) {
    const uint32_t a_lo = a + fm::BM * fm::ROW_BYTES;
    const uint32_t b_lo = b + fm::BN * fm::ROW_BYTES;
    wgmma_tf32(acc, fm::desc_sw128(a_lo), fm::desc_sw128(b), accumulate);
    wgmma_tf32(acc, fm::desc_sw128(a), fm::desc_sw128(b_lo), 1);
    wgmma_tf32(acc, fm::desc_sw128(a), fm::desc_sw128(b), 1);
  }
};

int split_into(const void* x, float* out, long long elements,
               cudaStream_t stream) {
  const long long n4 = elements / 4;
  const long long blocks = (n4 + SPLIT_THREADS - 1) / SPLIT_THREADS;
  split_tf32_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192),
                      SPLIT_THREADS, 0, stream>>>((const float4*)x,
                                                  (float4*)out, n4);
  return (int)cudaGetLastError();
}

// The launch both entry points share: the split of both matrices into the
// scratch, then the match on the split planes.
int launch(const void* pin, const void* pref, int pairs, int n_in, int n_ref,
           int d, int ld, void* scratch, void* idx, void* val, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long in_elems = (long long)pairs * n_in * ld;
  const long long ref_elems = (long long)pairs * n_ref * ld;
  float* in_split = (float*)scratch;
  float* ref_split = in_split + 2 * in_elems;
  int err = split_into(pin, in_split, in_elems, s);
  if (err == 0) err = split_into(pref, ref_split, ref_elems, s);
  if (err != 0) return err;
  return fm::launch_match<Tf32x3>(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                  in_split, ref_split, pairs, n_in, n_ref, d,
                                  ld, idx, val, s);
}

}  // namespace

extern "C" {

// pin and pref are device pointers of f32 patch matrices whose rows are ld
// elements apart (ld a multiple of 8, pairs n * ld apart, 16-byte aligned);
// scratch holds 2 * pairs * (n_in + n_ref) * ld f32 (the hi and lo planes,
// written here); idx of int32, val of f32; the stream is a cudaStream_t.
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue if a
// tensor map cannot be encoded).
int feature_match_launch(const void* pin, const void* pref, int pairs,
                         int n_in, int n_ref, int d, int ld, void* scratch,
                         void* idx, void* val, void* stream) {
  return launch(pin, pref, pairs, n_in, n_ref, d, ld, scratch, idx, val,
                stream);
}

// The same kernels on one rank's band of reference rows, for
// mrefsr_tpu/ops/correlation.py::feature_match_index_sharded
// (correlation.py:140-180): a second name only, so that the sharded match
// counts its launches apart from the single-device one. The index remap
// and the MAX / MIN all-reduce across ranks stay in PyTorch.
int feature_match_sharded_launch(const void* pin, const void* pref, int pairs,
                                 int n_in, int n_ref, int d, int ld,
                                 void* scratch, void* idx, void* val,
                                 void* stream) {
  return launch(pin, pref, pairs, n_in, n_ref, d, ld, scratch, idx, val,
                stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
