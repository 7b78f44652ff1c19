// Deformable conv, DCNv2 (modulated) with conv groups > 1 and DCNv1
// (without a mask, any number of conv groups): the deformable im2col of the
// forward and the col2im of the backward.
//
// Replaces the gather half of mrefsr_tpu/ops/dcn.py::modulated_deform_conv2d
// with conv groups > 1, _mdcn_tap_scan (dcn.py:214-246), with
// _corner_rows_and_weights, _slab_bilinear, _combine_corners and
// _deform_gather_tap_packed
// (dcn.py:163-211, 273-293); deform_conv2d (dcn.py:345-366, DCNv1: mask 1,
// no bias); the row gather of scripts/benchmarks/bench_gather_pallas.py
// (pallas_take); and, for the backward, the derivative JAX's autodiff takes
// through them. For every output row r = (n, ho, wo), tap k = (ky, kx) and
// input channel c in deform group g = c / cg and conv group q = c / cin_g
// (cin_g = C / groups, c' = c % cin_g) the forward writes
//     col[q, r, k*cin_g + c'] = mask[r, g, k] * bilinear(x[n, :, :, c], fy, fx)
//     fy = ho*sh - ph + ky*dh + offset[r, g, k, 0]
//     fx = wo*sw - pw + kx*dw + offset[r, g, k, 1]
// with mmcv's zero-outside corners (deform_bilinear.cuh), and mask 1 in the
// no-mask variant. The columns are group-major, (groups, rows, K, cin_g): the
// wrapper (ops/dcn.py) contracts them with the weight as one batched matmul,
// (groups, rows, K*cin_g) x (groups, K*cin_g, Cout/groups), as the JAX
// package leaves the per-group einsum to XLA. With groups 1 the layout is
// (rows, K, C), and k*C + c matches weight.reshape(K*C, Cout) of an HWIO
// weight. The backward takes grad_col (same layout; the wrapper's
// grad_out x W_q^T) and writes
//     grad_offset[r, g, k, 0] = mask * sum_c grad_col * d bilinear / d fy
//     grad_offset[r, g, k, 1] = mask * sum_c grad_col * d bilinear / d fx
//     grad_mask[r, g, k]      = sum_c grad_col * bilinear   (not without mask)
// with the sums over the cg channels of the group, and, where asked,
// grad_x += grad_col * mask * (corner weight) scattered over the 4 corners.
//
// Layouts (all contiguous): x (N, H, W, C); offset (N, Ho, Wo, dg, K, 2)
// as (dy, dx); mask (N, Ho, Wo, dg, K); col and grad_col (groups, rows, K,
// cin_g) for the rows [row0, row0 + rows) of the flattened (N, Ho, Wo);
// grad_offset, grad_mask and grad_x whole, as offset, mask and x.
//
// Element types. x, mask, col, grad_col and grad_mask are all of the
// template parameter T; offset and grad_offset are f32 always, and grad_x is
// an f32 buffer. The entry points below instantiate T = f32 only: K3 and K5
// have no bf16 path yet (ROADMAP A7, which instantiates these templates at
// bf16: the corners and the mask read in bf16 and widened, every weight,
// product and sum f32, a column element rounded to bf16 once where it is
// stored). The contraction's products are cuBLAS's, in the wrapper. K2
// (conv groups 1, with a mask: _mdcn_slab_scan, dcn.py:111-160) runs the
// fused kernels of mdcn_fused.cuh at both types, which gather the columns
// into shared memory and contract them there.
//
// Bound on the H100: memory. Per element of col the kernels read 4 corners
// (mostly from L2: neighbouring taps and rows share them) and read or write
// one value; the offset and mask are read once per (row, g, k) and shared by
// the group's channels. At EDVR-M's L1 scale (N = 5, 180x320, C = 64) the
// column is 5 * 57600 * 576 * 4 B = 0.66 GB, written once and read once by
// the matmul: ~1.3 GB of column traffic against ~0.4 GB of essential bytes.
// Fusing the gather into the matmul's operand load removes it, as the
// fused K2 does (ROADMAP B2).
//
// Design: the forward runs one thread per (conv group, row, tap, run of N
// channels), in the order of col, so a warp writes contiguous bytes of col
// and reads each corner as one 16-byte load of N contiguous NHWC channels.
// The backward runs one thread per (row, tap, run of N channels of C), so the
// cg / N threads of one (row, tap, deform group) are neighbouring lanes
// whatever the conv groups: they add their shares with warp shuffles and one
// lane writes, so grad_offset and grad_mask have one writer each and are the
// same from run to run; grad_x uses atomic adds and is not. A thread reads its
// grad_col run at the group-major address: runs of cin_g / N vectors, 16-byte
// loads still. Coordinates are f32 (a bf16 position above 256 is off by up
// to 1 pixel). A thread's run is 16 bytes: N = 4 f32 or 8 bf16 channels.
// Requires C, cg and cin_g multiples of N, and for the backward cg / N a
// power of two <= 32, which the wrapper checks (cg is 8 at relu1_1,
// C 64 and dg 8, and 32 at relu3_1). The no-mask variant (kMask false) is a
// separate instance: it reads no mask and writes no grad_mask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "deform_bilinear.cuh"

namespace {

using deform::Run;

// Widths in runs of N channels: cv = C / N, cgv = cg / N, cinv = cin_g / N.
struct Geometry {
  int row0, rows, h, w, cv, ho, wo, kw, k_taps, sh, sw, ph, pw, dh, dw, dg,
      cgv, cinv;
};

// The sampling position of (row r, tap k, deform group g), and its offset
// and mask index om.
struct Sample {
  int n;
  size_t om;
  float fy, fx;
};

__device__ __forceinline__ Sample sample_of(const Geometry& g, int r, int k,
                                            int group,
                                            const float* __restrict__ offset) {
  Sample s;
  const int wo_i = r % g.wo;
  const int t2 = r / g.wo;
  const int ho_i = t2 % g.ho;
  s.n = t2 / g.ho;
  s.om = ((size_t)r * g.dg + group) * g.k_taps + k;
  s.fy = (float)(ho_i * g.sh - g.ph + (k / g.kw) * g.dh) + offset[2 * s.om];
  s.fx = (float)(wo_i * g.sw - g.pw + (k % g.kw) * g.dw) +
         offset[2 * s.om + 1];
  return s;
}

template <typename T, bool kMask>
__global__ void __launch_bounds__(256)
mdcn_im2col_kernel(const typename Run<T>::Raw* __restrict__ x,
                   const float* __restrict__ offset,
                   const T* __restrict__ mask,
                   typename Run<T>::Raw* __restrict__ col, int total,
                   Geometry g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  // i = ((q * rows + rr) * K + k) * cinv + cl
  const int cl = i % g.cinv;
  const int t = i / g.cinv;
  const int k = t % g.k_taps;
  const int t1 = t / g.k_taps;
  const int r = g.row0 + t1 % g.rows;
  const int cv = (t1 / g.rows) * g.cinv + cl;  // run of N channels of C

  const Sample s = sample_of(g, r, k, cv / g.cgv, offset);
  const float m = kMask ? Run<T>::widen(mask[s.om]) : 1.f;
  const deform::Corners cn = deform::corners_at(s.fy, s.fx, g.h, g.w);
  const deform::Values<T> v = deform::load_corners<T>(
      x + (size_t)s.n * g.h * g.w * g.cv + cv, cn, g.w, g.cv);
  float out[Run<T>::N];
  deform::bilinear(v, cn, m, out);
  col[i] = Run<T>::pack(out);
}

template <typename T, bool kMask, bool kScatter>
__global__ void __launch_bounds__(256)
mdcn_col2im_kernel(const typename Run<T>::Raw* __restrict__ grad_col,
                   const typename Run<T>::Raw* __restrict__ x,
                   const float* __restrict__ offset,
                   const T* __restrict__ mask,
                   float* __restrict__ grad_offset, T* __restrict__ grad_mask,
                   float* __restrict__ grad_x, int total, Geometry g) {
  constexpr int N = Run<T>::N;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // a lane past the end takes the last element with a zero gradient: the
  // warp's shuffles need every lane
  const bool live = i < total;
  const int j = live ? i : total - 1;
  // j = (rr * K + k) * cv + c_run
  const int c_run = j % g.cv;
  const int t = j / g.cv;
  const int k = t % g.k_taps;
  const int rr = t / g.k_taps;
  const int r = g.row0 + rr;

  const Sample s = sample_of(g, r, k, c_run / g.cgv, offset);
  const float m = kMask ? Run<T>::widen(mask[s.om]) : 1.f;
  const int q = c_run / g.cinv;
  const size_t at = (((size_t)q * g.rows + rr) * g.k_taps + k) * g.cinv +
                    c_run % g.cinv;
  float gc[N];
  Run<T>::unpack(live ? grad_col[at] : typename Run<T>::Raw{}, gc);

  const deform::Corners cn = deform::corners_at(s.fy, s.fx, g.h, g.w);
  const deform::Values<T> v = deform::load_corners<T>(
      x + (size_t)s.n * g.h * g.w * g.cv + c_run, cn, g.w, g.cv);
  const deform::CoordGrad cg = deform::coord_grad(gc, v, cn);
  const float dfy = deform::segment_sum(cg.dfy, g.cgv);
  const float dfx = deform::segment_sum(cg.dfx, g.cgv);
  const float value = kMask ? deform::segment_sum(cg.value, g.cgv) : 0.f;
  if (live && c_run % g.cgv == 0) {
    grad_offset[2 * s.om] = m * dfy;
    grad_offset[2 * s.om + 1] = m * dfx;
    if (kMask) grad_mask[s.om] = Run<T>::narrow(value);
  }
  if (kScatter && live)
    deform::scatter_corners(
        grad_x + (size_t)s.n * g.h * g.w * g.cv * N + c_run * N, cn, gc, m,
        g.w, g.cv * N);
}

template <typename T>
Geometry geometry(int row0, int rows, int h, int w, int c, int ho, int wo,
                  int kh, int kw, int sh, int sw, int ph, int pw, int dh,
                  int dw, int dg, int groups) {
  constexpr int N = Run<T>::N;
  return Geometry{row0, rows,   h,  w,  c / N, ho, wo, kw, kh * kw,
                  sh,   sw,     ph, pw, dh,    dw, dg, (c / dg) / N,
                  (c / groups) / N};
}

template <typename T, bool kMask>
int im2col(const void* x, const void* offset, const void* mask, void* col,
           int row0, int rows, int h, int w, int c, int ho, int wo, int kh,
           int kw, int sh, int sw, int ph, int pw, int dh, int dw, int dg,
           int groups, void* stream) {
  using Raw = typename Run<T>::Raw;
  const Geometry g = geometry<T>(row0, rows, h, w, c, ho, wo, kh, kw, sh, sw,
                                 ph, pw, dh, dw, dg, groups);
  const int total = rows * kh * kw * g.cv;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  mdcn_im2col_kernel<T, kMask><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const Raw*)x, (const float*)offset, (const T*)mask, (Raw*)col, total,
      g);
  return (int)cudaGetLastError();
}

template <typename T, bool kMask>
int col2im(const void* grad_col, const void* x, const void* offset,
           const void* mask, void* grad_offset, void* grad_mask, void* grad_x,
           int row0, int rows, int h, int w, int c, int ho, int wo, int kh,
           int kw, int sh, int sw, int ph, int pw, int dh, int dw, int dg,
           int groups, void* stream) {
  using Raw = typename Run<T>::Raw;
  const Geometry g = geometry<T>(row0, rows, h, w, c, ho, wo, kh, kw, sh, sw,
                                 ph, pw, dh, dw, dg, groups);
  const int total = rows * kh * kw * g.cv;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  auto kernel = grad_x ? mdcn_col2im_kernel<T, kMask, true>
                       : mdcn_col2im_kernel<T, kMask, false>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const Raw*)grad_col, (const Raw*)x, (const float*)offset,
      (const T*)mask, (float*)grad_offset, (T*)grad_mask, (float*)grad_x,
      total, g);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers are device pointers of contiguous f32 tensors (x 16-byte
// aligned); the stream is a cudaStream_t. `rows * kh * kw * c / N` must fit an int. Each returns
// cudaGetLastError() after its launch. The entry points name the TPU kernel
// they replace, so that the wrapper counts their launches apart:
// mdcn_*_groups K3 (_mdcn_tap_scan, groups > 1), deform_* K5
// (deform_conv2d, no mask, any groups). The col2im entry points
// write these rows' entries of the whole grad_offset (and grad_mask); the
// *_scatter ones also add into grad_x (zero it before the first chunk).
#define IM2COL_ARGS                                                          \
  int row0, int rows, int h, int w, int c, int ho, int wo, int kh, int kw,   \
      int sh, int sw, int ph, int pw, int dh, int dw, int dg, int groups,    \
      void *stream
#define IM2COL_PASS                                                          \
  row0, rows, h, w, c, ho, wo, kh, kw, sh, sw, ph, pw, dh, dw, dg, groups,   \
      stream

extern "C" {

int mdcn_im2col_groups_launch(const void* x, const void* offset,
                              const void* mask, void* col, IM2COL_ARGS) {
  return im2col<float, true>(x, offset, mask, col, IM2COL_PASS);
}

int deform_im2col_launch(const void* x, const void* offset, void* col,
                         IM2COL_ARGS) {
  return im2col<float, false>(x, offset, nullptr, col, IM2COL_PASS);
}

int mdcn_col2im_groups_launch(const void* grad_col, const void* x,
                              const void* offset, const void* mask,
                              void* grad_offset, void* grad_mask,
                              IM2COL_ARGS) {
  return col2im<float, true>(grad_col, x, offset, mask, grad_offset,
                             grad_mask, nullptr, IM2COL_PASS);
}

int mdcn_col2im_groups_scatter_launch(const void* grad_col, const void* x,
                                      const void* offset, const void* mask,
                                      void* grad_offset, void* grad_mask,
                                      void* grad_x, IM2COL_ARGS) {
  return col2im<float, true>(grad_col, x, offset, mask, grad_offset,
                             grad_mask, grad_x, IM2COL_PASS);
}

int deform_col2im_launch(const void* grad_col, const void* x,
                         const void* offset, void* grad_offset, IM2COL_ARGS) {
  return col2im<float, false>(grad_col, x, offset, nullptr, grad_offset,
                              nullptr, nullptr, IM2COL_PASS);
}

int deform_col2im_scatter_launch(const void* grad_col, const void* x,
                                 const void* offset, void* grad_offset,
                                 void* grad_x, IM2COL_ARGS) {
  return col2im<float, false>(grad_col, x, offset, nullptr, grad_offset,
                              nullptr, grad_x, IM2COL_PASS);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
