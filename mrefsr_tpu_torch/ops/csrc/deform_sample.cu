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
// Layouts (all contiguous): x, out, grad_out (N, H, W, C) in f32 or, for the
// *_bf16 entry points, bf16; flow and grad_flow (N, H, W, dg, 2) as (dy,
// dx), f32 always; grad_x (N, H, W, C) an f32 buffer (the wrapper casts a
// bf16 grad x once).
//
// At bf16 this is the flow alignment's K4 under the JAX package's mixed
// precision: FlowAgg adds the conv's bf16 flow residual to the f32 centre
// pre-offset, so the flow is f32 (jax.make_jaxpr of a bf16 FlowAgg: add ->
// f32[N,H,W,dg,2]), and the coordinates are f32 as at dcn.py:326-332. The
// corners are read in bf16 and widened, weights, products and sums are f32,
// and an output element is rounded to bf16 once (round to nearest even).
// The JAX function takes the corner weights, their products and the sum in
// bf16 (dcn.py:171-178, 197-198), so the two differ by a few bf16 ulps
// (tests/test_torch_bf16.py states the tolerance). The backward reads bf16
// grad_out and writes grad_flow in f32.
//
// Bound on the H100: memory. The forward reads x once, the flow once and
// writes out once; it does some 30 operations per 16 bytes written. The 4
// corner reads of a pixel mostly hit L2, as neighbouring pixels share them.
//
// Design: one thread per (pixel, run of N channels: 16 bytes, 4 f32 or 8
// bf16), in the order of out, so a warp writes 512 contiguous bytes and
// reads each corner as one 16-byte load of N contiguous NHWC channels.
// In the backward the cg / N threads of one
// (pixel, group) are neighbouring lanes: they add their shares with warp
// shuffles and one lane writes, so grad_flow has one writer and is the same
// from run to run; grad_x uses atomic adds and is not. Coordinates are f32.
// Requires C % N == 0 and cg % N == 0, and for the backward cg / N a power
// of two <= 32, which the wrapper checks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "deform_bilinear.cuh"

namespace {

using deform::Run;

struct Pixel {
  int n, cv;
  size_t flow_at;
  float fy, fx;
};

// i indexes runs of N channels; a pixel is `cvn` runs, a group `cgv`.
__device__ __forceinline__ Pixel pixel_of(int i, const float* __restrict__ flow,
                                          int h, int w, int cvn, int dg,
                                          int cgv) {
  Pixel p;
  p.cv = i % cvn;
  const int r = i / cvn;
  const int x_i = r % w;
  const int t = r / w;
  const int y_i = t % h;
  p.n = t / h;
  p.flow_at = 2 * ((size_t)r * dg + p.cv / cgv);
  p.fy = (float)y_i + flow[p.flow_at];
  p.fx = (float)x_i + flow[p.flow_at + 1];
  return p;
}

template <typename T>
__global__ void __launch_bounds__(256)
deform_sample_fwd_kernel(const typename Run<T>::Raw* __restrict__ x,
                         const float* __restrict__ flow,
                         typename Run<T>::Raw* __restrict__ out, int total,
                         int h, int w, int cvn, int dg, int cgv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const Pixel p = pixel_of(i, flow, h, w, cvn, dg, cgv);
  const deform::Corners cn = deform::corners_at(p.fy, p.fx, h, w);
  const deform::Values<T> v = deform::load_corners<T>(
      x + (size_t)p.n * h * w * cvn + p.cv, cn, w, cvn);
  float o[Run<T>::N];
  deform::bilinear(v, cn, 1.f, o);
  out[i] = Run<T>::pack(o);
}

template <typename T, bool kScatter>
__global__ void __launch_bounds__(256)
deform_sample_bwd_kernel(const typename Run<T>::Raw* __restrict__ grad_out,
                         const typename Run<T>::Raw* __restrict__ x,
                         const float* __restrict__ flow,
                         float* __restrict__ grad_flow,
                         float* __restrict__ grad_x, int total, int h, int w,
                         int cvn, int dg, int cgv) {
  constexpr int N = Run<T>::N;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // a lane past the end takes the last element with a zero gradient: the
  // warp's shuffles need every lane
  const bool live = i < total;
  const int j = live ? i : total - 1;
  const Pixel p = pixel_of(j, flow, h, w, cvn, dg, cgv);
  float go[N];
  Run<T>::unpack(live ? grad_out[j] : typename Run<T>::Raw{}, go);
  const deform::Corners cn = deform::corners_at(p.fy, p.fx, h, w);
  const deform::Values<T> v = deform::load_corners<T>(
      x + (size_t)p.n * h * w * cvn + p.cv, cn, w, cvn);
  const deform::CoordGrad cg = deform::coord_grad(go, v, cn);
  const float dfy = deform::segment_sum(cg.dfy, cgv);
  const float dfx = deform::segment_sum(cg.dfx, cgv);
  if (live && p.cv % cgv == 0) {
    grad_flow[p.flow_at] = dfy;
    grad_flow[p.flow_at + 1] = dfx;
  }
  if (kScatter && live)
    deform::scatter_corners(grad_x + (size_t)p.n * h * w * cvn * N + p.cv * N,
                            cn, go, 1.f, w, cvn * N);
}

template <typename T>
int fwd_launch(const void* x, const void* flow, void* out, int n, int h,
               int w, int c, int dg, void* stream) {
  using Raw = typename Run<T>::Raw;
  constexpr int N = Run<T>::N;
  const int cvn = c / N;
  const int total = n * h * w * cvn;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  deform_sample_fwd_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const Raw*)x, (const float*)flow, (Raw*)out, total, h, w, cvn, dg,
      (c / dg) / N);
  return (int)cudaGetLastError();
}

// With `grad_x` not null the kernel also adds into it (zero it first).
template <typename T>
int bwd_launch(const void* grad_out, const void* x, const void* flow,
               void* grad_flow, void* grad_x, int n, int h, int w, int c,
               int dg, void* stream) {
  using Raw = typename Run<T>::Raw;
  constexpr int N = Run<T>::N;
  const int cvn = c / N;
  const int total = n * h * w * cvn;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  auto kernel = grad_x ? deform_sample_bwd_kernel<T, true>
                       : deform_sample_bwd_kernel<T, false>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const Raw*)grad_out, (const Raw*)x, (const float*)flow,
      (float*)grad_flow, (float*)grad_x, total, h, w, cvn, dg, (c / dg) / N);
  return (int)cudaGetLastError();
}

using bf16 = __nv_bfloat16;

}  // namespace

extern "C" {

// Pointers are device pointers of contiguous tensors (16-byte aligned): x,
// out and grad_out f32, or bf16 for the *_bf16 entry points; flow,
// grad_flow and grad_x f32. The stream is a cudaStream_t.
// `n * h * w * c / N` must fit an int. Each returns cudaGetLastError() after
// its launch. The backward has two entry points a type, so that launches
// with and without the grad_x scatter are counted apart.
int deform_sample_fwd_launch(const void* x, const void* flow, void* out,
                             int n, int h, int w, int c, int dg,
                             void* stream) {
  return fwd_launch<float>(x, flow, out, n, h, w, c, dg, stream);
}

int deform_sample_bwd_launch(const void* grad_out, const void* x,
                             const void* flow, void* grad_flow, int n, int h,
                             int w, int c, int dg, void* stream) {
  return bwd_launch<float>(grad_out, x, flow, grad_flow, nullptr, n, h, w, c,
                           dg, stream);
}

int deform_sample_bwd_scatter_launch(const void* grad_out, const void* x,
                                     const void* flow, void* grad_flow,
                                     void* grad_x, int n, int h, int w, int c,
                                     int dg, void* stream) {
  return bwd_launch<float>(grad_out, x, flow, grad_flow, grad_x, n, h, w, c,
                           dg, stream);
}

int deform_sample_fwd_bf16_launch(const void* x, const void* flow, void* out,
                                  int n, int h, int w, int c, int dg,
                                  void* stream) {
  return fwd_launch<bf16>(x, flow, out, n, h, w, c, dg, stream);
}

int deform_sample_bwd_bf16_launch(const void* grad_out, const void* x,
                                  const void* flow, void* grad_flow, int n,
                                  int h, int w, int c, int dg, void* stream) {
  return bwd_launch<bf16>(grad_out, x, flow, grad_flow, nullptr, n, h, w, c,
                          dg, stream);
}

int deform_sample_bwd_scatter_bf16_launch(const void* grad_out, const void* x,
                                          const void* flow, void* grad_flow,
                                          void* grad_x, int n, int h, int w,
                                          int c, int dg, void* stream) {
  return bwd_launch<bf16>(grad_out, x, flow, grad_flow, grad_x, n, h, w, c,
                          dg, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
