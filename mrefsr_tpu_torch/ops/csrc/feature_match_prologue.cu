// K1's prologue: the unfold of both feature maps into patch matrices and the
// patch norms, in one pass, for the match kernels (feature_match.cu at f32,
// feature_match_bf16.cu at bf16).
//
// Replaces, in mrefsr_tpu/ops/correlation.py::feature_match_index
// (correlation.py:45), sample_patches (:20), the ref-patch norms plus 1e-5
// (:70-71) and the input-patch norms of norm_input (:101-103). From
//     feat_in  (P, H_in,  W_in,  C)
//     feat_ref (P, H_ref, W_ref, C)
// it writes, in the features' dtype T (f32 or bf16),
//     pin     (P, n_in,  ld)   the raw input patches, element order (i, j, c);
//     pref    (P, n_ref, ld)   each ref patch over its norm plus eps (or raw
//                              when is_norm is 0);
//     in_norm (P, n_in)        each input patch's norm,
// with d = patch^2 C and the row stride ld >= d a multiple of 8, the padding
// [d, ld) zero: the match kernels load 16-byte rows (TMA needs every row
// stride a multiple of 16 bytes), so d = 9 (C = 1) goes through them too.
//
// Rounding, as the plain version (ops/correlation.py: sample_patches,
// l2_norm, add_scalar) and XLA on the JAX side round: the squares summed in
// f32; at bf16 the sum rounded to bf16, its f32 root rounded to bf16, eps
// rounded to bf16 (the caller passes it so), the sum norm + eps rounded to
// bf16, and each element divided in f32 with IEEE division (__fdiv_rn; the
// build has no fast math) and rounded to bf16. At f32 nothing rounds but
// the f32 operations themselves. Only the order of the f32 sum of squares
// differs from PyTorch's reduction, so a bf16 norm can differ where that
// sum lies within a few f32 ulps of a bf16 rounding midpoint.
//
// Bound on the H100: bytes. The CUFED5 eval at bf16 (5 pairs of 125x125x256
// maps, n = 15129 a side, d = 2304) reads 80 MB of features and writes
// 0.70 GB of patches: 0.23 ms at 3.35 TB/s, twice that at f32.
//
// Design: a warp a patch (8 a block), rows of pin first, then of pref. A
// lane moves 16-byte vectors when C is a multiple of a vector (8 bf16, 4
// f32) and the features are 16-byte aligned, else single elements. A first
// pass sums the squares (and copies the patch where nothing scales it), a
// butterfly of shuffles gives every lane the same sum, and for a ref patch
// that is normalised a second pass reads it again (from L1 / L2: the nine
// taps of neighbouring patches overlap) and writes the quotients.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back: the identity at f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
prologue_kernel(const T* __restrict__ fin, const T* __restrict__ fref,
                int pairs, int h_in, int w_in, int h_ref, int w_ref, int c,
                int patch, int in_stride, int ref_stride, int is_norm, int ld,
                float eps, int vec, T* __restrict__ pin, T* __restrict__ pref,
                T* __restrict__ in_norm) {
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte vector
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int pw_in = (w_in - patch) / in_stride + 1;
  const int n_in = ((h_in - patch) / in_stride + 1) * pw_in;
  const int pw_ref = (w_ref - patch) / ref_stride + 1;
  const int n_ref = ((h_ref - patch) / ref_stride + 1) * pw_ref;
  const long long in_rows = (long long)pairs * n_in;
  if (w >= in_rows + (long long)pairs * n_ref) return;

  const bool ref = w >= in_rows;
  const long long r = ref ? w - in_rows : w;  // the row of pin or pref
  const int n = ref ? n_ref : n_in;
  const int pw = ref ? pw_ref : pw_in;
  const int stride = ref ? ref_stride : in_stride;
  const int width = ref ? w_ref : w_in;
  const int p = (int)(r / n);
  const int q = (int)(r % n);
  const int y0 = (q / pw) * stride;
  const int x0 = (q % pw) * stride;
  const T* src = (ref ? fref : fin) +
                 (size_t)p * (ref ? h_ref : h_in) * width * c;
  T* dst = (ref ? pref : pin) + (size_t)r * ld;
  const int d = patch * patch * c;
  const bool scale = ref && is_norm;  // the quotients come in a second pass

  // element e of the patch: tap (di, dj) = divmod(e / c, patch), channel e % c
  auto at = [&](int e) {
    const int tap = e / c;
    const int ch = e - tap * c;
    const int di = tap / patch;
    const int dj = tap - di * patch;
    return src + ((size_t)(y0 + di) * width + x0 + dj) * c + ch;
  };

  float sq = 0.f;
  if (vec) {
    for (int e = lane * V; e < d; e += 32 * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(at(e));
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float f = to_f(v[i]);
        sq += f * f;
      }
      if (!scale) *reinterpret_cast<uint4*>(dst + e) = raw;
    }
  } else {
    for (int e = lane; e < d; e += 32) {
      const T x = *at(e);
      const float f = to_f(x);
      sq += f * f;
      if (!scale) dst[e] = x;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  // the norm as the plain version rounds it: the sum, then the root
  const float norm = round_to<T>(sqrtf(round_to<T>(sq)));

  if (!ref) {
    if (lane == 0) in_norm[r] = from_f<T>(norm);
  } else if (is_norm) {
    const float denom = round_to<T>(norm + eps);
    if (vec) {
      for (int e = lane * V; e < d; e += 32 * V) {
        const uint4 raw = *reinterpret_cast<const uint4*>(at(e));
        const T* v = reinterpret_cast<const T*>(&raw);
        uint4 out;
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] = from_f<T>(__fdiv_rn(to_f(v[i]),
                                                               denom));
        *reinterpret_cast<uint4*>(dst + e) = out;
      }
    } else {
      for (int e = lane; e < d; e += 32)
        dst[e] = from_f<T>(__fdiv_rn(to_f(*at(e)), denom));
    }
  }
  for (int e = d + lane; e < ld; e += 32) dst[e] = from_f<T>(0.f);
}

template <typename T>
int launch(const void* fin, const void* fref, int pairs, int h_in, int w_in,
           int h_ref, int w_ref, int c, int patch, int in_stride,
           int ref_stride, int is_norm, int ld, float eps, void* pin,
           void* pref, void* in_norm, void* stream) {
  const long long n_in = (long long)((h_in - patch) / in_stride + 1) *
                         ((w_in - patch) / in_stride + 1);
  const long long n_ref = (long long)((h_ref - patch) / ref_stride + 1) *
                          ((w_ref - patch) / ref_stride + 1);
  const long long blocks = (pairs * (n_in + n_ref) + WARPS - 1) / WARPS;
  const int vec = c % (16 / (int)sizeof(T)) == 0 &&
                  (uintptr_t)fin % 16 == 0 && (uintptr_t)fref % 16 == 0;
  prologue_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)fin, (const T*)fref, pairs, h_in, w_in, h_ref, w_ref, c, patch,
      in_stride, ref_stride, is_norm, ld, eps, vec, (T*)pin, (T*)pref,
      (T*)in_norm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// feat_in, feat_ref: contiguous (P, H, W, C) device tensors of f32 (bf16 for
// the _bf16 entry); pin (P, n_in, ld), pref (P, n_ref, ld) and in_norm
// (P, n_in) of the same dtype, written whole; eps already rounded to the
// dtype; the stream is a cudaStream_t. Returns cudaGetLastError() after the
// launch.
int feature_match_prologue_launch(const void* feat_in, const void* feat_ref,
                                  int pairs, int h_in, int w_in, int h_ref,
                                  int w_ref, int c, int patch, int in_stride,
                                  int ref_stride, int is_norm, int ld,
                                  float eps, void* pin, void* pref,
                                  void* in_norm, void* stream) {
  return launch<float>(feat_in, feat_ref, pairs, h_in, w_in, h_ref, w_ref, c,
                       patch, in_stride, ref_stride, is_norm, ld, eps, pin,
                       pref, in_norm, stream);
}

int feature_match_prologue_bf16_launch(const void* feat_in,
                                       const void* feat_ref, int pairs,
                                       int h_in, int w_in, int h_ref,
                                       int w_ref, int c, int patch,
                                       int in_stride, int ref_stride,
                                       int is_norm, int ld, float eps,
                                       void* pin, void* pref, void* in_norm,
                                       void* stream) {
  return launch<__nv_bfloat16>(feat_in, feat_ref, pairs, h_in, w_in, h_ref,
                               w_ref, c, patch, in_stride, ref_stride,
                               is_norm, ld, eps, pin, pref, in_norm, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
