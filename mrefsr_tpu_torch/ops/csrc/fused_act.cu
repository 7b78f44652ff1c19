// fused_leaky_relu: bias add over the channel axis, leaky ReLU, scale, in one
// pass, and its derivative.
//
// Replaces mrefsr_tpu/ops/fused_act.py::fused_leaky_relu (fused_act.py:12-16,
// a composition XLA fuses) and the derivatives JAX's autodiff takes through
// it, first and second order:
//     v      = x + bias[channel]            (bias may be absent)
//     out    = (v >= 0 ? v : slope * v) * scale
//     grad_x = grad_out * scale * (out >= 0 ? 1 : slope)
// At exactly 0 the derivative is 1, as jax.nn.leaky_relu's `where(x >= 0, ...)`
// gives it. out has the sign of v, so the backward reads the saved output and
// never x. The backward is linear in grad_out, so its own backward (the
// double backward) is the same kernel on the incoming second-order gradient,
// through an entry point of its own that only counts apart. grad_bias is a
// sum of grad_x, which the wrapper leaves to torch.sum.
//
// Layout: flat contiguous f32 memory; the channel of element i is
// (i / inner) % channels, with inner = H * W for an NCHW tensor and 1 for a
// channels-last one or a 2-D (batch, channel) one.
//
// Bound on the H100: memory (3 operations for 8 bytes forward, 12 backward).
// Design: one thread per element in memory order, so every access is
// coalesced; the index is an int where the tensor has fewer than 2^31
// elements (its division is several times cheaper than a 64-bit one).
#include <cuda_runtime.h>

namespace {

template <typename Index>
__global__ void __launch_bounds__(256)
fused_leaky_relu_fwd_kernel(const float* __restrict__ x,
                            const float* __restrict__ bias,
                            float* __restrict__ out, long long total,
                            int inner, int channels, float slope,
                            float scale) {
  const long long at = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= total) return;
  float v = x[at];
  if (bias != nullptr) v += bias[((Index)at / inner) % channels];
  out[at] = (v >= 0.f ? v : v * slope) * scale;
}

__global__ void __launch_bounds__(256)
fused_leaky_relu_bwd_kernel(const float* __restrict__ grad_out,
                            const float* __restrict__ out,
                            float* __restrict__ grad_x, long long total,
                            float slope, float scale) {
  const long long at = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= total) return;
  // in autograd's order: the scale first, then the branch
  const float g = grad_out[at] * scale;
  grad_x[at] = out[at] >= 0.f ? g : g * slope;
}

bool blocks_for(long long total, unsigned* blocks) {
  const long long n = (total + 255) / 256;
  *blocks = (unsigned)n;
  return n <= 2147483647LL;
}

int bwd_launch(const void* grad_out, const void* out, void* grad_x,
               long long total, float slope, float scale, void* stream) {
  unsigned blocks;
  if (total <= 0 || !blocks_for(total, &blocks))
    return (int)cudaErrorInvalidValue;
  fused_leaky_relu_bwd_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)grad_out, (const float*)out, (float*)grad_x, total, slope,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Pointers are device pointers of contiguous f32 memory of `total` elements
// (`bias`: `channels` elements, or null); the stream is a cudaStream_t. Each
// returns cudaGetLastError() after its launch (cudaErrorInvalidValue for an
// empty tensor or more than 2^31 - 1 blocks).
int fused_leaky_relu_fwd_launch(const void* x, const void* bias, void* out,
                                long long total, int inner, int channels,
                                float slope, float scale, void* stream) {
  unsigned blocks;
  if (total <= 0 || inner < 1 || channels < 1 || !blocks_for(total, &blocks))
    return (int)cudaErrorInvalidValue;
  auto kernel = total > 2147483647LL ? fused_leaky_relu_fwd_kernel<long long>
                                     : fused_leaky_relu_fwd_kernel<int>;
  kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)bias, (float*)out, total, inner,
      channels, slope, scale);
  return (int)cudaGetLastError();
}

// Two names for one function, so that the backward and the double backward
// are counted apart.
int fused_leaky_relu_bwd_launch(const void* grad_out, const void* out,
                                void* grad_x, long long total, float slope,
                                float scale, void* stream) {
  return bwd_launch(grad_out, out, grad_x, total, slope, scale, stream);
}

int fused_leaky_relu_bwd2_launch(const void* grad_out, const void* out,
                                 void* grad_x, long long total, float slope,
                                 float scale, void* stream) {
  return bwd_launch(grad_out, out, grad_x, total, slope, scale, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
