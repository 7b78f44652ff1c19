// Bilinear corner arithmetic shared by the deformable kernels
// (mdcn_fused.cuh, deform_sample.cu): the CUDA form of
// mrefsr_tpu/ops/dcn.py::_corner_rows_and_weights (dcn.py:163-185) and of the
// derivative JAX's autodiff takes through it.
//
// A sample at f32 position (fy, fx) of an (H, W) map reads the 4 corners
// (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1) with y0 = floor(fy),
// x0 = floor(fx) and weights wy0 = 1 - (fy - y0), wy1 = fy - y0, likewise in
// x. mmcv's zero-outside rule: a corner counts only if it lies inside the
// image, judged on the unclipped floor coordinates. A corner that does not
// count is loaded as zero, so the sums below need no further masking.
//
// Derivative: floor and the validity tests carry no gradient, d wy1 / d fy
// = 1 and d wy0 / d fy = -1. So
//     d out / d fy = (v10 * wx0 + v11 * wx1) - (v00 * wx0 + v01 * wx1)
//     d out / d fx = (v01 * wy0 + v11 * wy1) - (v00 * wy0 + v10 * wy1)
// also where fy is an integer (wy1 = 0): the one-sided difference
// x[y0 + 1] - x[y0], not a symmetric one and not zero.
//
// A thread handles one run of 16 bytes of contiguous NHWC channels of one
// deform group, loaded as one vector: 4 f32 or 8 bf16 channels (Run<T>).
// Whatever T, the corners are widened to f32 and every weight, product and
// sum is f32; a result in T is rounded once, where it is stored. The `cg / N`
// threads that share one sampling position (one deform group) are
// neighbouring lanes of a warp.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace deform {

// A run of N channels of element type T: 16 bytes, one vector load.
template <typename T>
struct Run;

template <>
struct Run<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ static void unpack(const float4& r, float (&v)[4]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ static float4 pack(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float widen(float v) { return v; }
  __device__ static float narrow(float v) { return v; }
};

template <>
struct Run<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ static void unpack(const uint4& r, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  // round to nearest even, as torch's .to(torch.bfloat16)
  __device__ static uint4 pack(const float (&v)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
  __device__ static float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ static __nv_bfloat16 narrow(float v) {
    return __float2bfloat16_rn(v);
  }
};

struct Corners {
  int y0, x0;
  float wy0, wy1, wx0, wx1;
  bool in00, in01, in10, in11;
};

__device__ __forceinline__ Corners corners_at(float fy, float fx, int h,
                                              int w) {
  Corners c;
  const float y0f = floorf(fy);
  const float x0f = floorf(fx);
  c.wy1 = fy - y0f;
  c.wx1 = fx - x0f;
  c.wy0 = 1.f - c.wy1;
  c.wx0 = 1.f - c.wx1;
  // floor of a huge offset may not fit an int: clamp to [-2, H] first
  c.y0 = (int)fminf(fmaxf(y0f, -2.f), (float)h);
  c.x0 = (int)fminf(fmaxf(x0f, -2.f), (float)w);
  const bool vy0 = c.y0 >= 0 && c.y0 <= h - 1;
  const bool vy1 = c.y0 >= -1 && c.y0 <= h - 2;
  const bool vx0 = c.x0 >= 0 && c.x0 <= w - 1;
  const bool vx1 = c.x0 >= -1 && c.x0 <= w - 2;
  c.in00 = vy0 && vx0;
  c.in01 = vy0 && vx1;
  c.in10 = vy1 && vx0;
  c.in11 = vy1 && vx1;
  return c;
}

// The 4 corners of a run, widened to f32.
template <typename T>
struct Values {
  float v00[Run<T>::N], v01[Run<T>::N], v10[Run<T>::N], v11[Run<T>::N];
};

// The 4 corners of a run as loaded, not yet widened: a kernel can issue the
// loads early and widen them once they are needed (mdcn_fused.cuh issues a
// k-step's loads before the products of the step before).
template <typename T>
struct RawCorners {
  typename Run<T>::Raw r00, r01, r10, r11;
};

// `xn` points at this thread's run of pixel (0, 0) of its item; a pixel is
// `cv` runs wide. A corner outside the image is not read and comes as zero.
template <typename T>
__device__ __forceinline__ RawCorners<T> load_raw_corners(
    const typename Run<T>::Raw* __restrict__ xn, const Corners& c, int w,
    int cv) {
  using Raw = typename Run<T>::Raw;
  const Raw zero{};
  RawCorners<T> r;
  r.r00 = c.in00 ? xn[((size_t)c.y0 * w + c.x0) * cv] : zero;
  r.r01 = c.in01 ? xn[((size_t)c.y0 * w + c.x0 + 1) * cv] : zero;
  r.r10 = c.in10 ? xn[((size_t)(c.y0 + 1) * w + c.x0) * cv] : zero;
  r.r11 = c.in11 ? xn[((size_t)(c.y0 + 1) * w + c.x0 + 1) * cv] : zero;
  return r;
}

template <typename T>
__device__ __forceinline__ Values<T> widen_corners(const RawCorners<T>& r) {
  Values<T> v;
  Run<T>::unpack(r.r00, v.v00);
  Run<T>::unpack(r.r01, v.v01);
  Run<T>::unpack(r.r10, v.v10);
  Run<T>::unpack(r.r11, v.v11);
  return v;
}

template <typename T>
__device__ __forceinline__ Values<T> load_corners(
    const typename Run<T>::Raw* __restrict__ xn, const Corners& c, int w,
    int cv) {
  return widen_corners<T>(load_raw_corners<T>(xn, c, w, cv));
}

// (v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11) * m, in this order, in f32.
template <typename T>
__device__ __forceinline__ void bilinear(const Values<T>& v, const Corners& c,
                                         float m,
                                         float (&out)[Run<T>::N]) {
  const float w00 = c.in00 ? c.wy0 * c.wx0 : 0.f;
  const float w01 = c.in01 ? c.wy0 * c.wx1 : 0.f;
  const float w10 = c.in10 ? c.wy1 * c.wx0 : 0.f;
  const float w11 = c.in11 ? c.wy1 * c.wx1 : 0.f;
#pragma unroll
  for (int j = 0; j < Run<T>::N; ++j)
    out[j] = (v.v00[j] * w00 + v.v01[j] * w01 + v.v10[j] * w10 +
              v.v11[j] * w11) *
             m;
}

template <int N>
__device__ __forceinline__ float dot(const float (&a)[N],
                                     const float (&b)[N]) {
  float s = a[0] * b[0];
#pragma unroll
  for (int j = 1; j < N; ++j) s += a[j] * b[j];
  return s;
}

// This thread's share (its run of channels) of the gradients of
// sum_c g_c * bilinear_c with respect to fy, fx, and of the sum itself.
struct CoordGrad {
  float dfy, dfx, value;
};

template <typename T>
__device__ __forceinline__ CoordGrad coord_grad(const float (&g)[Run<T>::N],
                                                const Values<T>& v,
                                                const Corners& c) {
  const float g00 = dot(g, v.v00);
  const float g01 = dot(g, v.v01);
  const float g10 = dot(g, v.v10);
  const float g11 = dot(g, v.v11);
  CoordGrad r;
  r.dfy = (g10 * c.wx0 + g11 * c.wx1) - (g00 * c.wx0 + g01 * c.wx1);
  r.dfx = (g01 * c.wy0 + g11 * c.wy1) - (g00 * c.wy0 + g10 * c.wy1);
  r.value = g00 * (c.wy0 * c.wx0) + g01 * (c.wy0 * c.wx1)
            + g10 * (c.wy1 * c.wx0) + g11 * (c.wy1 * c.wx1);
  return r;
}

// Sum over the `width` neighbouring lanes that share a sampling position
// (width a power of two <= 32, segments aligned in the warp). Every lane of
// the warp must call it; every lane of a segment gets the sum. One fixed
// butterfly order: the result is the same from run to run.
__device__ __forceinline__ float segment_sum(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// p[0 .. 3] += v in f32: one 16-byte vector reduction (REDG.E.ADD.F32x4 on
// sm_90) where scalar atomics took four; `p` 16-byte aligned.
__device__ __forceinline__ void red_add4(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

// p[0 .. N - 1] += g * s, N / 4 vector reductions.
template <int N>
__device__ __forceinline__ void red_add_run(float* p, const float (&g)[N],
                                            float s) {
  static_assert(N % 4 == 0, "runs of 4 floats");
#pragma unroll
  for (int j = 0; j < N; j += 4)
    red_add4(p + j,
             make_float4(g[j] * s, g[j + 1] * s, g[j + 2] * s, g[j + 3] * s));
}

// grad_x += g * m * (corner weight), over the corners inside the image, into
// an f32 buffer whatever the type of x (no bf16 atomics), by vector
// reductions (red_add_run). `gxn` points at this thread's channels of pixel
// (0, 0) of its item; a pixel is `ch` floats wide, `ch` and the channels'
// start multiples of 4. Every lane of the warp calls it, `live` false for a
// lane that adds nothing: at bf16 (N = 8, a lane's run is one 32-byte
// sector of grad x, two reductions) the lanes of a pair l, l ^ 1 trade
// halves by shuffles, so that each of the pair's two reductions covers one
// whole sector, the even lane's and then the odd lane's, where on its own
// each lane would send two half-sector requests. Atomic adds: the order of
// the additions, and so the last bits of the sum, change from run to run.
template <int N>
__device__ __forceinline__ void scatter_corners(float* __restrict__ gxn,
                                                const Corners& c,
                                                const float (&g)[N], float m,
                                                int w, int ch, bool live) {
  static_assert(N == 4 || N == 8, "runs of 4 or 8 channels");
  const bool in[4] = {c.in00, c.in01, c.in10, c.in11};
  const float wt[4] = {m * c.wy0 * c.wx0, m * c.wy0 * c.wx1,
                       m * c.wy1 * c.wx0, m * c.wy1 * c.wx1};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool ok = live && in[k];
    const float s = wt[k];
    float* p = ok ? gxn + ((size_t)(c.y0 + (k >> 1)) * w + c.x0 + (k & 1)) * ch
                  : gxn;
    if constexpr (N == 4) {
      if (ok) red_add_run(p, g, s);
    } else {
      const bool odd = threadIdx.x & 1;
      // the half the partner sends: the odd lane its lower, the even its
      // upper
      float give[4], got[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        give[e] = (odd ? g[e] : g[e + 4]) * s;
        got[e] = __shfl_xor_sync(0xffffffffu, give[e], 1);
      }
      float* q = reinterpret_cast<float*>(__shfl_xor_sync(
          0xffffffffu, reinterpret_cast<unsigned long long>(p), 1));
      const bool q_ok = __shfl_xor_sync(0xffffffffu, (int)ok, 1);
      // the even lane's sector, then the odd lane's
      float4 first, second;
      if (odd) {
        first = make_float4(got[0], got[1], got[2], got[3]);
        second = make_float4(g[4] * s, g[5] * s, g[6] * s, g[7] * s);
      } else {
        first = make_float4(g[0] * s, g[1] * s, g[2] * s, g[3] * s);
        second = make_float4(got[0], got[1], got[2], got[3]);
      }
      if (odd ? q_ok : ok) red_add4(odd ? q + 4 : p, first);
      if (odd ? ok : q_ok) red_add4(odd ? p + 4 : q, second);
    }
  }
}

}  // namespace deform
