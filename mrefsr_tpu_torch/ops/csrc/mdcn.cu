// Modulated deformable conv (DCNv2, conv groups == 1): the deformable im2col
// of the forward and the col2im of the backward.
//
// Replaces the gather half of mrefsr_tpu/ops/dcn.py::modulated_deform_conv2d
// (_mdcn_slab_scan, dcn.py:60-160, with _corner_rows_and_weights,
// _slab_bilinear and _combine_corners, dcn.py:163-211) and the row gather of
// scripts/benchmarks/bench_gather_pallas.py (pallas_take), and, for the
// backward, the derivative JAX's autodiff takes through them. For every
// output row r = (n, ho, wo), tap k = (ky, kx) and input channel c in deform
// group g = c / cg the forward writes
//     col[r, k*C + c] = mask[r, g, k] * bilinear(x[n, :, :, c], fy, fx)
//     fy = ho*sh - ph + ky*dh + offset[r, g, k, 0]
//     fx = wo*sw - pw + kx*dw + offset[r, g, k, 1]
// with mmcv's zero-outside corners (deform_bilinear.cuh). The column index
// k*C + c matches weight.reshape(K*C, Cout) of an HWIO weight, so the
// contraction is one matmul in the wrapper (ops/dcn.py), as the JAX package
// leaves it to an XLA einsum. The backward takes grad_col = grad_out * w2d^T
// from the wrapper (a matmul again) and writes
//     grad_offset[r, g, k, 0] = mask * sum_c grad_col * d bilinear / d fy
//     grad_offset[r, g, k, 1] = mask * sum_c grad_col * d bilinear / d fx
//     grad_mask[r, g, k]      = sum_c grad_col * bilinear
// with the sums over the cg channels of the group, and, where asked,
// grad_x += grad_col * mask * (corner weight) scattered over the 4 corners.
//
// Layouts (all contiguous): x (N, H, W, C) f32; offset (N, Ho, Wo, dg, K, 2)
// as (dy, dx); mask (N, Ho, Wo, dg, K); col and grad_col (rows, K, C) for the
// rows [row0, row0 + rows) of the flattened (N, Ho, Wo); grad_offset,
// grad_mask and grad_x whole, as offset, mask and x.
//
// Bound on the H100: memory. Per element of col the kernels read 4 corners
// (mostly from L2: neighbouring taps and rows share them) and read or write
// one value; the offset and mask are read once per (row, g, k) and shared by
// the group's channels. At the 500x500 relu1_1 scale of one CUFED5 request
// (N = 5, C = 64) the column is 5 * 250000 * 576 * 4 B = 2.9 GB, written
// once and read once by the matmul: ~5.8 GB of column traffic against
// ~1.7 GB of essential bytes per scale. Fusing the gather into the matmul's
// operand load (wgmma) removes it; that is later work.
//
// Design: one thread per (row, tap, run of 4 channels), in the order of
// col, so a warp moves 512 contiguous bytes of col and reads each corner as
// one 16-byte load of 4 contiguous NHWC channels. In the backward the cg / 4
// threads of one (row, tap, group) are neighbouring lanes: they add their
// shares with warp shuffles and one lane writes, so grad_offset and
// grad_mask have one writer each and are the same from run to run; grad_x
// uses atomic adds and is not. Coordinates are f32 (a bf16 position above
// 256 is off by up to 1 pixel). Requires C % 4 == 0 and cg % 4 == 0, and for
// the backward cg / 4 a power of two <= 32, which the wrapper checks.
#include <cuda_runtime.h>

#include "deform_bilinear.cuh"

namespace {

__global__ void __launch_bounds__(256)
mdcn_im2col_kernel(const float4* __restrict__ x,
                   const float* __restrict__ offset,
                   const float* __restrict__ mask, float4* __restrict__ col,
                   int row0, int total, int h, int w, int c4, int ho,
                   int wo, int kw, int k_taps, int sh, int sw, int ph,
                   int pw, int dh, int dw, int dg, int cg4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int cv = i % c4;
  const int t = i / c4;
  const int k = t % k_taps;
  const int r = row0 + t / k_taps;
  const int wo_i = r % wo;
  const int t2 = r / wo;
  const int ho_i = t2 % ho;
  const int n = t2 / ho;
  const int g = cv / cg4;

  const size_t om = ((size_t)r * dg + g) * k_taps + k;
  const float fy = (float)(ho_i * sh - ph + (k / kw) * dh) + offset[2 * om];
  const float fx = (float)(wo_i * sw - pw + (k % kw) * dw) + offset[2 * om + 1];
  const float m = mask[om];

  const deform::Corners cn = deform::corners_at(fy, fx, h, w);
  const deform::Values v =
      deform::load_corners(x + (size_t)n * h * w * c4 + cv, cn, w, c4);
  const float4 out = deform::bilinear(v, cn, m);
  col[i] = out;
}

template <bool kScatter>
__global__ void __launch_bounds__(256)
mdcn_col2im_kernel(const float4* __restrict__ grad_col,
                   const float4* __restrict__ x,
                   const float* __restrict__ offset,
                   const float* __restrict__ mask,
                   float* __restrict__ grad_offset,
                   float* __restrict__ grad_mask, float* __restrict__ grad_x,
                   int row0, int total, int h, int w, int c4, int ho, int wo,
                   int kw, int k_taps, int sh, int sw, int ph, int pw, int dh,
                   int dw, int dg, int cg4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // a lane past the end takes the last element with a zero gradient: the
  // warp's shuffles need every lane
  const bool live = i < total;
  const int j = live ? i : total - 1;
  const int cv = j % c4;
  const int t = j / c4;
  const int k = t % k_taps;
  const int r = row0 + t / k_taps;
  const int wo_i = r % wo;
  const int t2 = r / wo;
  const int ho_i = t2 % ho;
  const int n = t2 / ho;
  const int g = cv / cg4;

  const size_t om = ((size_t)r * dg + g) * k_taps + k;
  const float fy = (float)(ho_i * sh - ph + (k / kw) * dh) + offset[2 * om];
  const float fx = (float)(wo_i * sw - pw + (k % kw) * dw) + offset[2 * om + 1];
  const float m = mask[om];
  const float4 gc = live ? grad_col[j] : make_float4(0.f, 0.f, 0.f, 0.f);

  const deform::Corners cn = deform::corners_at(fy, fx, h, w);
  const deform::Values v =
      deform::load_corners(x + (size_t)n * h * w * c4 + cv, cn, w, c4);
  const deform::CoordGrad cg = deform::coord_grad(gc, v, cn);
  const float dfy = deform::segment_sum(cg.dfy, cg4);
  const float dfx = deform::segment_sum(cg.dfx, cg4);
  const float value = deform::segment_sum(cg.value, cg4);
  if (live && cv % cg4 == 0) {
    grad_offset[2 * om] = m * dfy;
    grad_offset[2 * om + 1] = m * dfx;
    grad_mask[om] = value;
  }
  if (kScatter && live)
    deform::scatter_corners(grad_x + (size_t)n * h * w * c4 * 4 + cv * 4, cn,
                            gc, m, w, c4 * 4);
}

}  // namespace

extern "C" {

// Pointers are device pointers of contiguous f32 tensors (x 16-byte
// aligned); the stream is a cudaStream_t. `rows * kh * kw * c / 4` must fit
// an int. Returns cudaGetLastError() after the launch.
int mdcn_im2col_launch(const void* x, const void* offset, const void* mask,
                       void* col, int row0, int rows, int h, int w, int c,
                       int ho, int wo, int kh, int kw, int sh, int sw, int ph,
                       int pw, int dh, int dw, int dg, void* stream) {
  const int c4 = c / 4;
  const int total = rows * kh * kw * c4;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  mdcn_im2col_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (const float*)offset, (const float*)mask,
      (float4*)col, row0, total, h, w, c4, ho, wo, kw, kh * kw, sh, sw, ph,
      pw, dh, dw, dg, (c / dg) / 4);
  return (int)cudaGetLastError();
}

// The backward of the rows [row0, row0 + rows): grad_col is (rows, K, C);
// grad_offset and grad_mask are the whole tensors and get these rows'
// entries. With `grad_x` not null the kernel also adds into it (zero it
// before the first chunk).
static int col2im_launch(const void* grad_col, const void* x,
                         const void* offset, const void* mask,
                         void* grad_offset, void* grad_mask, void* grad_x,
                         int row0, int rows, int h, int w, int c, int ho,
                         int wo, int kh, int kw, int sh, int sw, int ph,
                         int pw, int dh, int dw, int dg, void* stream) {
  const int c4 = c / 4;
  const int total = rows * kh * kw * c4;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  auto kernel = grad_x ? mdcn_col2im_kernel<true> : mdcn_col2im_kernel<false>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)grad_col, (const float4*)x, (const float*)offset,
      (const float*)mask, (float*)grad_offset, (float*)grad_mask,
      (float*)grad_x, row0, total, h, w, c4, ho, wo, kw, kh * kw, sh, sw, ph,
      pw, dh, dw, dg, (c / dg) / 4);
  return (int)cudaGetLastError();
}

// Two entry points, so that launches with and without the grad_x scatter
// are counted apart.
int mdcn_col2im_launch(const void* grad_col, const void* x,
                       const void* offset, const void* mask,
                       void* grad_offset, void* grad_mask, int row0, int rows,
                       int h, int w, int c, int ho, int wo, int kh, int kw,
                       int sh, int sw, int ph, int pw, int dh, int dw, int dg,
                       void* stream) {
  return col2im_launch(grad_col, x, offset, mask, grad_offset, grad_mask,
                       nullptr, row0, rows, h, w, c, ho, wo, kh, kw, sh, sw,
                       ph, pw, dh, dw, dg, stream);
}

int mdcn_col2im_scatter_launch(const void* grad_col, const void* x,
                               const void* offset, const void* mask,
                               void* grad_offset, void* grad_mask,
                               void* grad_x, int row0, int rows, int h, int w,
                               int c, int ho, int wo, int kh, int kw, int sh,
                               int sw, int ph, int pw, int dh, int dw, int dg,
                               void* stream) {
  return col2im_launch(grad_col, x, offset, mask, grad_offset, grad_mask,
                       grad_x, row0, rows, h, w, c, ho, wo, kh, kw, sh, sw,
                       ph, pw, dh, dw, dg, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
