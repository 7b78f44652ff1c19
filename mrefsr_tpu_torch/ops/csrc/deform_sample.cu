// Per-pixel, per-group bilinear warp (the flow alignment's sampler), forward
// and backward.
//
// Replaces mrefsr_tpu/ops/dcn.py::deform_sample (dcn.py:296-342, through
// _pack_bilinear_corners, _corner_rows_and_weights, _slab_bilinear and
// _combine_corners) and the derivative JAX's autodiff takes through it; its
// gather is the row gather of scripts/benchmarks/bench_gather_pallas.py
// (pallas_take, out[s, m] = table[s, idx[s, m]]): with integer flows the
// forward copies x at the shifted positions bit for bit. For every pixel
// r = (n, y, x) and channel c in deform group g = c / cg
//     out[r, c] = bilinear(x[n, :, :, c], y + flow[r, g, 0], x + flow[r, g, 1])
// with mmcv's zero-outside corners (deform_bilinear.cuh). The backward writes
//     grad_flow[r, g, 0] = sum_c grad_out[r, c] * d bilinear / d fy
//     grad_flow[r, g, 1] = sum_c grad_out[r, c] * d bilinear / d fx
// with the sums over the cg channels of the group and, where asked,
// grad_x += grad_out * (corner weight) scattered over the 4 corners.
//
// Layouts (all contiguous, f32): x, out, grad_out, grad_x (N, H, W, C); flow
// and grad_flow (N, H, W, dg, 2) as (dy, dx).
//
// Bound on the H100: memory. The forward reads x once, the flow once and
// writes out once; it does some 30 operations per 16 bytes written. The 4
// corner reads of a pixel mostly hit L2, as neighbouring pixels share them.
//
// Design: one thread per (pixel, run of 4 channels), in the order of out, so
// a warp writes 512 contiguous bytes and reads each corner as one 16-byte
// load of 4 contiguous NHWC channels (mdcn.cu's design for one tap). In the
// backward the cg / 4 threads of one (pixel, group) are neighbouring lanes:
// they add their shares with warp shuffles and one lane writes, so grad_flow
// has one writer and is the same from run to run; grad_x uses atomic adds
// and is not. Coordinates are f32. Requires C % 4 == 0 and cg % 4 == 0, and
// for the backward cg / 4 a power of two <= 32, which the wrapper checks.
#include <cuda_runtime.h>

#include "deform_bilinear.cuh"

namespace {

struct Pixel {
  int n, cv;
  size_t flow_at;
  float fy, fx;
};

__device__ __forceinline__ Pixel pixel_of(int i, const float* __restrict__ flow,
                                          int h, int w, int c4, int dg,
                                          int cg4) {
  Pixel p;
  p.cv = i % c4;
  const int r = i / c4;
  const int x_i = r % w;
  const int t = r / w;
  const int y_i = t % h;
  p.n = t / h;
  p.flow_at = 2 * ((size_t)r * dg + p.cv / cg4);
  p.fy = (float)y_i + flow[p.flow_at];
  p.fx = (float)x_i + flow[p.flow_at + 1];
  return p;
}

__global__ void __launch_bounds__(256)
deform_sample_fwd_kernel(const float4* __restrict__ x,
                         const float* __restrict__ flow,
                         float4* __restrict__ out, int total, int h, int w,
                         int c4, int dg, int cg4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const Pixel p = pixel_of(i, flow, h, w, c4, dg, cg4);
  const deform::Corners cn = deform::corners_at(p.fy, p.fx, h, w);
  const deform::Values v =
      deform::load_corners(x + (size_t)p.n * h * w * c4 + p.cv, cn, w, c4);
  out[i] = deform::bilinear(v, cn, 1.f);
}

template <bool kScatter>
__global__ void __launch_bounds__(256)
deform_sample_bwd_kernel(const float4* __restrict__ grad_out,
                         const float4* __restrict__ x,
                         const float* __restrict__ flow,
                         float* __restrict__ grad_flow,
                         float* __restrict__ grad_x, int total, int h, int w,
                         int c4, int dg, int cg4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // a lane past the end takes the last element with a zero gradient: the
  // warp's shuffles need every lane
  const bool live = i < total;
  const int j = live ? i : total - 1;
  const Pixel p = pixel_of(j, flow, h, w, c4, dg, cg4);
  const float4 go = live ? grad_out[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  const deform::Corners cn = deform::corners_at(p.fy, p.fx, h, w);
  const deform::Values v =
      deform::load_corners(x + (size_t)p.n * h * w * c4 + p.cv, cn, w, c4);
  const deform::CoordGrad cg = deform::coord_grad(go, v, cn);
  const float dfy = deform::segment_sum(cg.dfy, cg4);
  const float dfx = deform::segment_sum(cg.dfx, cg4);
  if (live && p.cv % cg4 == 0) {
    grad_flow[p.flow_at] = dfy;
    grad_flow[p.flow_at + 1] = dfx;
  }
  if (kScatter && live)
    deform::scatter_corners(grad_x + (size_t)p.n * h * w * c4 * 4 + p.cv * 4,
                            cn, go, 1.f, w, c4 * 4);
}

}  // namespace

extern "C" {

// Pointers are device pointers of contiguous f32 tensors (16-byte aligned);
// the stream is a cudaStream_t. `n * h * w * c / 4` must fit an int. Each
// returns cudaGetLastError() after its launch.
int deform_sample_fwd_launch(const void* x, const void* flow, void* out,
                             int n, int h, int w, int c, int dg,
                             void* stream) {
  const int c4 = c / 4;
  const int total = n * h * w * c4;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  deform_sample_fwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (const float*)flow, (float4*)out, total, h, w, c4, dg,
      (c / dg) / 4);
  return (int)cudaGetLastError();
}

// With `grad_x` not null the kernel also adds into it (zero it first).
static int bwd_launch(const void* grad_out, const void* x, const void* flow,
                      void* grad_flow, void* grad_x, int n, int h, int w,
                      int c, int dg, void* stream) {
  const int c4 = c / 4;
  const int total = n * h * w * c4;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  auto kernel = grad_x ? deform_sample_bwd_kernel<true>
                       : deform_sample_bwd_kernel<false>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)grad_out, (const float4*)x, (const float*)flow,
      (float*)grad_flow, (float*)grad_x, total, h, w, c4, dg, (c / dg) / 4);
  return (int)cudaGetLastError();
}

// Two entry points, so that launches with and without the grad_x scatter
// are counted apart.
int deform_sample_bwd_launch(const void* grad_out, const void* x,
                             const void* flow, void* grad_flow, int n, int h,
                             int w, int c, int dg, void* stream) {
  return bwd_launch(grad_out, x, flow, grad_flow, nullptr, n, h, w, c, dg,
                    stream);
}

int deform_sample_bwd_scatter_launch(const void* grad_out, const void* x,
                                     const void* flow, void* grad_flow,
                                     void* grad_x, int n, int h, int w, int c,
                                     int dg, void* stream) {
  return bwd_launch(grad_out, x, flow, grad_flow, grad_x, n, h, w, c, dg,
                    stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
