// upfirdn2d: upsample by zero-stuffing, pad or crop, FIR filter, downsample,
// per channel plane, in one gather.
//
// Replaces mrefsr_tpu/ops/upfirdn2d.py::upfirdn2d (upfirdn2d.py:13-45, one
// lax.conv_general_dilated with lhs_dilation, explicit padding and window
// strides) and the derivatives JAX's autodiff takes through it, first and
// second order. For every plane p = (n, c) and output sample (oy, ox)
//     out[p, oy, ox] = sum_{ky, kx} fir[kh-1-ky, kw-1-kx] * u[p, oy*down + ky - pad_y0,
//                                                               ox*down + kx - pad_x0]
// where u is x with up - 1 zeros after every sample (u[y*up, x*up] = x[y, x],
// size H*up, zeros after the last sample too) and zero outside [0, H*up): the
// FIR is applied flipped, a true convolution. A negative pad crops. The
// output size, (H*up + pad_y0 + pad_y1 - kh) / down + 1 rows, is the caller's.
//
// The gradient in x is the same function with up and down swapped and the
// FIR flipped (the wrapper computes its pads), so the backward and the double
// backward launch this kernel too, through entry points of their own that
// only count apart.
//
// Layout: x (planes, H, W) and out (planes, out_h, out_w), contiguous f32:
// an NCHW tensor with N*C planes.
//
// Bound on the H100: memory. Each output takes at most kh*kw / up^2
// multiply-adds (16 for the 4x4 filter) for 8 bytes moved, under the card's
// 20 f32 operations per byte. Neither the zero-stuffed nor the padded map
// exists in memory: a thread visits only the taps that fall on a real
// sample of x.
//
// Design: one thread per output sample in the order of out, so a warp writes
// 128 contiguous bytes and its reads of one tap row are contiguous (stride
// down / up); neighbouring threads and rows share their taps through L1 and
// L2. The FIR (at most 64 taps) comes by value in the kernel's arguments. The
// 4x4 filter with (up, down) = (1, 1), (2, 1) and (1, 2), which is all
// StyleGAN2 uses, is compiled with constant loop bounds and reads its taps
// straight from the arguments; every other case takes the same code with
// bounds from the arguments and the FIR staged in shared memory. Sums run
// over ky, then kx, ascending, in f32.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 64;

struct Fir {
  float v[kMaxTaps];
};

struct Geom {
  int h, w, out_h, out_w, kh, kw, up, down, pad_y0, pad_x0;
};

// kUp, kDown, kK: 0 takes the value from the arguments. Index is the type of
// the flat output index: int where the output has fewer than 2^31 samples
// (its divisions are several times cheaper than 64-bit ones).
template <int kUp, int kDown, int kK, typename Index>
__global__ void __launch_bounds__(256)
upfirdn2d_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const Fir fir, const Geom g, const long long total) {
  const int up = kUp ? kUp : g.up;
  const int down = kDown ? kDown : g.down;
  const int kh = kK ? kK : g.kh;
  const int kw = kK ? kK : g.kw;
  __shared__ float s_fir[kMaxTaps];
  if (!kK) {
    if (threadIdx.x < kh * kw) s_fir[threadIdx.x] = fir.v[threadIdx.x];
    __syncthreads();
  }
  const long long at = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= total) return;
  const Index i = (Index)at;
  const int ox = (int)(i % g.out_w);
  const Index t = i / g.out_w;
  const int oy = (int)(t % g.out_h);
  const float* __restrict__ plane = x + (size_t)(t / g.out_h) * g.h * g.w;
  const int y0 = oy * down - g.pad_y0;
  const int x0 = ox * down - g.pad_x0;
  const int uh = g.h * up;
  const int uw = g.w * up;
  float acc = 0.f;
#pragma unroll
  for (int ky = 0; ky < kh; ++ky) {
    const int uy = y0 + ky;
    if (uy < 0 || uy >= uh || uy % up) continue;
    const float* __restrict__ row = plane + (size_t)(uy / up) * g.w;
#pragma unroll
    for (int kx = 0; kx < kw; ++kx) {
      const int ux = x0 + kx;
      if (ux < 0 || ux >= uw || ux % up) continue;
      const int tap = (kh - 1 - ky) * kw + kw - 1 - kx;
      // with constant loop bounds the tap index is a constant, and the tap
      // is read straight from the kernel's arguments (the constant bank)
      acc = fmaf(kK ? fir.v[tap] : s_fir[tap], row[ux / up], acc);
    }
  }
  out[at] = acc;
}

int launch(const void* x, void* out, const float* fir_host, int planes, int h,
           int w, int kh, int kw, int up, int down, int pad_y0, int pad_y1,
           int pad_x0, int pad_x1, void* stream) {
  if (kh * kw > kMaxTaps || kh < 1 || kw < 1 || up < 1 || down < 1)
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.h = h; g.w = w; g.kh = kh; g.kw = kw; g.up = up; g.down = down;
  g.pad_y0 = pad_y0; g.pad_x0 = pad_x0;
  g.out_h = (h * up + pad_y0 + pad_y1 - kh) / down + 1;
  g.out_w = (w * up + pad_x0 + pad_x1 - kw) / down + 1;
  if (h * up + pad_y0 + pad_y1 < kh || w * up + pad_x0 + pad_x1 < kw)
    return (int)cudaErrorInvalidValue;
  Fir fir;
  for (int i = 0; i < kh * kw; ++i) fir.v[i] = fir_host[i];
  const long long total = (long long)planes * g.out_h * g.out_w;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const bool wide = total > 2147483647LL;
#define UPFIRDN2D_PICK(u, d, k) \
  (wide ? upfirdn2d_kernel<u, d, k, long long> : upfirdn2d_kernel<u, d, k, int>)
  auto kernel = UPFIRDN2D_PICK(0, 0, 0);
  if (kh == 4 && kw == 4) {
    if (up == 1 && down == 1) kernel = UPFIRDN2D_PICK(1, 1, 4);
    if (up == 2 && down == 1) kernel = UPFIRDN2D_PICK(2, 1, 4);
    if (up == 1 && down == 2) kernel = UPFIRDN2D_PICK(1, 2, 4);
  }
#undef UPFIRDN2D_PICK
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, fir, g, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `x` and `out` are device pointers of contiguous f32 tensors (planes, h, w)
// and (planes, out_h, out_w); `fir` is a host pointer to kh * kw floats, row
// major, read before the call returns; the stream is a cudaStream_t. Each
// returns cudaGetLastError() after its launch (cudaErrorInvalidValue for a
// FIR of more than 64 taps, an empty output or more than 2^31 - 1 blocks).
// Three names for one function, so that the forward, the backward and the
// double backward of the op are counted apart.
#define UPFIRDN2D_ENTRY(name)                                                 \
  int name(const void* x, void* out, const float* fir, int planes, int h,     \
           int w, int kh, int kw, int up, int down, int pad_y0, int pad_y1,   \
           int pad_x0, int pad_x1, void* stream) {                            \
    return launch(x, out, fir, planes, h, w, kh, kw, up, down, pad_y0,        \
                  pad_y1, pad_x0, pad_x1, stream);                            \
  }
UPFIRDN2D_ENTRY(upfirdn2d_fwd_launch)
UPFIRDN2D_ENTRY(upfirdn2d_bwd_launch)
UPFIRDN2D_ENTRY(upfirdn2d_bwd2_launch)

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
