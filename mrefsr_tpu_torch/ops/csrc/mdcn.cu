// Modulated deformable im2col (DCNv2 forward, conv groups == 1).
//
// Replaces the gather half of mrefsr_tpu/ops/dcn.py::modulated_deform_conv2d
// (_mdcn_slab_scan, dcn.py:60-160, with _corner_rows_and_weights,
// _slab_bilinear and _combine_corners, dcn.py:163-211) and the row gather of
// scripts/benchmarks/bench_gather_pallas.py (pallas_take). For every output
// row r = (n, ho, wo), tap k = (ky, kx) and input channel c in deform group
// g = c / cg it writes
//     col[r, k*C + c] = mask[r, g, k] * bilinear(x[n, :, :, c], fy, fx)
//     fy = ho*sh - ph + ky*dh + offset[r, g, k, 0]
//     fx = wo*sw - pw + kx*dw + offset[r, g, k, 1]
// with mmcv's zero-outside corners: each of the 4 corners counts only if it
// lies inside the image, judged on the unclipped floor coordinates. The
// column index k*C + c matches weight.reshape(K*C, Cout) of an HWIO weight,
// so the contraction is one matmul in the wrapper (ops/dcn.py), as the JAX
// package leaves it to an XLA einsum.
//
// Layouts (all contiguous): x (N, H, W, C) f32; offset (N, Ho, Wo, dg, K, 2)
// as (dy, dx); mask (N, Ho, Wo, dg, K); col (rows, K, C) for the rows
// [row0, row0 + rows) of the flattened (N, Ho, Wo).
//
// Bound on the H100: memory. Per element of col the kernel reads 4 corners
// (mostly from L2: neighbouring taps and rows share them) and writes one
// value; the offset and mask are read once per (row, g, k) and shared by the
// group's channels. At the 500x500 relu1_1 scale of one CUFED5 request
// (N = 5, C = 64) the column is 5 * 250000 * 576 * 4 B = 2.9 GB, written
// once and read once by the matmul: ~5.8 GB of column traffic against
// ~1.7 GB of essential bytes per scale. Fusing the gather into the matmul's
// operand load (wgmma) removes it; that is later work.
//
// Design: one thread per (row, tap, run of 4 channels), in the order of
// col, so a warp writes 512 contiguous bytes and reads each corner as one
// 16-byte load of 4 contiguous NHWC channels. Coordinates are f32 (a bf16
// position above 256 is off by up to 1 pixel). Requires C % 4 == 0 and
// cg % 4 == 0, which the wrapper checks.
#include <cuda_runtime.h>

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

  const float y0f = floorf(fy);
  const float x0f = floorf(fx);
  const float wy1 = fy - y0f;
  const float wx1 = fx - x0f;
  const float wy0 = 1.f - wy1;
  const float wx0 = 1.f - wx1;
  // floor of a huge offset may not fit an int: clamp to [-2, H] first
  const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)h);
  const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)w);
  const bool vy0 = y0 >= 0 && y0 <= h - 1;
  const bool vy1 = y0 >= -1 && y0 <= h - 2;
  const bool vx0 = x0 >= 0 && x0 <= w - 1;
  const bool vx1 = x0 >= -1 && x0 <= w - 2;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* xn = x + (size_t)n * h * w * c4 + cv;
  const float4 v00 = (vy0 && vx0) ? xn[((size_t)y0 * w + x0) * c4] : zero;
  const float4 v01 = (vy0 && vx1) ? xn[((size_t)y0 * w + x0 + 1) * c4] : zero;
  const float4 v10 = (vy1 && vx0) ? xn[((size_t)(y0 + 1) * w + x0) * c4] : zero;
  const float4 v11 =
      (vy1 && vx1) ? xn[((size_t)(y0 + 1) * w + x0 + 1) * c4] : zero;
  const float w00 = (vy0 && vx0) ? wy0 * wx0 : 0.f;
  const float w01 = (vy0 && vx1) ? wy0 * wx1 : 0.f;
  const float w10 = (vy1 && vx0) ? wy1 * wx0 : 0.f;
  const float w11 = (vy1 && vx1) ? wy1 * wx1 : 0.f;

  float4 out;
  out.x = (v00.x * w00 + v01.x * w01 + v10.x * w10 + v11.x * w11) * m;
  out.y = (v00.y * w00 + v01.y * w01 + v10.y * w10 + v11.y * w11) * m;
  out.z = (v00.z * w00 + v01.z * w01 + v10.z * w10 + v11.z * w11) * m;
  out.w = (v00.w * w00 + v01.w * w01 + v10.w * w10 + v11.w * w11) * m;
  col[i] = out;
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

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
