// Bilinear corner arithmetic shared by the deformable kernels (mdcn.cu,
// deform_sample.cu): the CUDA form of
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
// All values are float4 runs of 4 contiguous NHWC channels of one deform
// group; a thread handles one run, and the `cg4` threads that share one
// sampling position (one deform group) are neighbouring lanes of a warp.
#pragma once
#include <cuda_runtime.h>

namespace deform {

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

struct Values {
  float4 v00, v01, v10, v11;
};

// `xn` points at this thread's float4 of pixel (0, 0) of its item; a pixel
// is `c4` float4s wide.
__device__ __forceinline__ Values load_corners(const float4* __restrict__ xn,
                                               const Corners& c, int w,
                                               int c4) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  Values v;
  v.v00 = c.in00 ? xn[((size_t)c.y0 * w + c.x0) * c4] : zero;
  v.v01 = c.in01 ? xn[((size_t)c.y0 * w + c.x0 + 1) * c4] : zero;
  v.v10 = c.in10 ? xn[((size_t)(c.y0 + 1) * w + c.x0) * c4] : zero;
  v.v11 = c.in11 ? xn[((size_t)(c.y0 + 1) * w + c.x0 + 1) * c4] : zero;
  return v;
}

// (v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11) * m, in this order.
__device__ __forceinline__ float4 bilinear(const Values& v, const Corners& c,
                                           float m) {
  const float w00 = c.in00 ? c.wy0 * c.wx0 : 0.f;
  const float w01 = c.in01 ? c.wy0 * c.wx1 : 0.f;
  const float w10 = c.in10 ? c.wy1 * c.wx0 : 0.f;
  const float w11 = c.in11 ? c.wy1 * c.wx1 : 0.f;
  float4 out;
  out.x = (v.v00.x * w00 + v.v01.x * w01 + v.v10.x * w10 + v.v11.x * w11) * m;
  out.y = (v.v00.y * w00 + v.v01.y * w01 + v.v10.y * w10 + v.v11.y * w11) * m;
  out.z = (v.v00.z * w00 + v.v01.z * w01 + v.v10.z * w10 + v.v11.z * w11) * m;
  out.w = (v.v00.w * w00 + v.v01.w * w01 + v.v10.w * w10 + v.v11.w * w11) * m;
  return out;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// This thread's share (its 4 channels) of the gradients of
// sum_c g_c * bilinear_c with respect to fy, fx, and of the sum itself.
struct CoordGrad {
  float dfy, dfx, value;
};

__device__ __forceinline__ CoordGrad coord_grad(const float4& g,
                                                const Values& v,
                                                const Corners& c) {
  const float g00 = dot4(g, v.v00);
  const float g01 = dot4(g, v.v01);
  const float g10 = dot4(g, v.v10);
  const float g11 = dot4(g, v.v11);
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

__device__ __forceinline__ void atomic_add4(float* p, const float4& g,
                                            float s) {
  atomicAdd(p, g.x * s);
  atomicAdd(p + 1, g.y * s);
  atomicAdd(p + 2, g.z * s);
  atomicAdd(p + 3, g.w * s);
}

// grad_x += g * m * (corner weight), over the corners inside the image.
// `gxn` points at this thread's 4 channels of pixel (0, 0) of its item; a
// pixel is `c` floats wide. Atomic adds: the order of the additions, and so
// the last bits of the sum, change from run to run.
__device__ __forceinline__ void scatter_corners(float* __restrict__ gxn,
                                                const Corners& c,
                                                const float4& g, float m,
                                                int w, int ch) {
  if (c.in00)
    atomic_add4(gxn + ((size_t)c.y0 * w + c.x0) * ch, g, m * c.wy0 * c.wx0);
  if (c.in01)
    atomic_add4(gxn + ((size_t)c.y0 * w + c.x0 + 1) * ch, g,
                m * c.wy0 * c.wx1);
  if (c.in10)
    atomic_add4(gxn + ((size_t)(c.y0 + 1) * w + c.x0) * ch, g,
                m * c.wy1 * c.wx0);
  if (c.in11)
    atomic_add4(gxn + ((size_t)(c.y0 + 1) * w + c.x0 + 1) * ch, g,
                m * c.wy1 * c.wx1);
}

}  // namespace deform
