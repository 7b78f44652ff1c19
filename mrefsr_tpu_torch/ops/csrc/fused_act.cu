// fused_leaky_relu: bias add over the channel axis, leaky ReLU, scale, in one
// pass, and its derivatives.
//
// Replaces mrefsr_tpu/ops/fused_act.py::fused_leaky_relu (fused_act.py:12-16,
// a composition XLA fuses) and the derivatives JAX's autodiff takes through
// it, first and second order:
//     v         = x + bias[channel]            (bias may be absent)
//     out       = (v >= 0 ? v : slope * v) * scale
//     grad_x    = grad_out * scale * (out >= 0 ? 1 : slope)
//     grad_bias = sum of grad_x over all axes but the channel axis
// At exactly 0 the derivative is 1, as jax.nn.leaky_relu's `where(x >= 0, ...)`
// gives it. out has the sign of v, so the backward reads the saved output and
// never x. The backward is linear in grad_out, and its own backward (the
// double backward) is, for the incoming gg_x and gg_bias,
//     ggo = (gg_x + gg_bias[channel]) * scale * (out >= 0 ? 1 : slope)
// whose backward is the backward again. So one kernel serves every order:
//     res = (a + b[channel]) * scale * (out >= 0 ? 1 : slope),  sum(res)
// with a = grad_out and no b for the backward (and the sum where the bias
// takes a gradient), a = gg_x and b = gg_bias for the double backward
// (either may be absent), through entry points that only count apart.
//
// Layout: flat contiguous f32 memory, (outer, channels, inner): inner = H * W
// for an NCHW tensor, 1 for a channels-last one or a 2-D (batch, channel)
// one.
//
// Bound on the H100: memory (3 operations for 8 bytes forward; 2 to 4 for
// 12 bytes backward, 8 where a is absent). Design:
// * forward: one thread per element in memory order, so every access is
//   coalesced; the index is an int where the tensor has fewer than 2^31
//   elements (its division is several times cheaper than a 64-bit one).
// * backward, inner > 1 (`planes`): a block takes one channel and a
//   contiguous share of its (outer, inner) elements, so the channel is the
//   block's and no element needs a division: the walk steps its (outer,
//   inner) position by carries. 16-byte loads and stores where inner is a
//   multiple of 4 and the pointers are 16-byte aligned.
// * backward, inner == 1 (`rows`): threads stride over the channels (4 a
//   thread with 16-byte accesses where the channel count and the pointers
//   allow) and over the rows, a block a share of the rows.
// * grad bias: each thread sums its elements in order, a block reduces its
//   threads by warp shuffles and shared memory into one partial per
//   channel, and where a channel's elements span several blocks (`splits`,
//   the wrapper's choice) a second launch sums the partials in split order.
//   No atomics: the result is the same bits on every run.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename Index>
__global__ void __launch_bounds__(kThreads)
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

struct Bwd {
  const float* a;          // grad_out or gg_x; null reads 0
  const float* b;          // gg_bias (channels); null reads 0
  const float* out;        // the forward's output
  float* res;              // grad_x or ggo
  float* partial;          // (splits, channels) where splits > 1
  float* grad_bias;        // (channels), or null: no sum
  long long outer;         // elements before the channel axis
  int inner, channels;
  float slope, scale;
};

template <int V> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ float get(const T& v, int) { return v; }
  static __device__ void set(T& v, int, float f) { v = f; }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ float get(const T& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  static __device__ void set(T& v, int i, float f) {
    if (i == 0) v.x = f; else if (i == 1) v.y = f;
    else if (i == 2) v.z = f; else v.w = f;
  }
};

// in autograd's order for the backward: the scale first, then the branch
__device__ __forceinline__ float bwd_of(float a, float add, bool has_b,
                                        float out, float slope, float scale) {
  const float g = (has_b ? a + add : a) * scale;
  return out >= 0.f ? g : g * slope;
}

// the block's sum of v, in thread 0: a fixed tree, the same bits every run
__device__ float block_sum(float v) {
  __shared__ float warps[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warps[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warps[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// inner > 1: block (c, s) walks units [s * chunk, (s + 1) * chunk) of
// channel c's outer * inner / V vectors
template <int V>
__global__ void __launch_bounds__(kThreads)
fused_leaky_relu_bwd_kernel(const Bwd g, long long chunk) {
  using T = typename Vec<V>::T;
  const int c = blockIdx.x, s = blockIdx.y;
  const int inner_v = g.inner / V;
  const long long units = g.outer * inner_v;
  const long long end = min(units, (s + 1) * chunk);
  const bool has_a = g.a != nullptr, has_b = g.b != nullptr;
  const float add = has_b ? g.b[c] : 0.f;
  const T* __restrict__ a = reinterpret_cast<const T*>(g.a);
  const T* __restrict__ out = reinterpret_cast<const T*>(g.out);
  T* __restrict__ res = reinterpret_cast<T*>(g.res);
  long long u = s * chunk + threadIdx.x;
  // the walk's first position: a 32-bit division where the count fits
  long long o = units + kThreads <= 2147483647LL
                    ? (long long)((int)u / inner_v)
                    : u / inner_v;
  int j = (int)(u - o * inner_v);
  const int step_o = blockDim.x / inner_v, step_j = blockDim.x % inner_v;
  float sum = 0.f;
  for (; u < end; u += blockDim.x) {
    const size_t at = ((size_t)o * g.channels + c) * inner_v + j;
    const T ov = out[at];
    T av = T();
    if (has_a) av = a[at];
    T r;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float v = bwd_of(has_a ? Vec<V>::get(av, i) : 0.f, add, has_b,
                             Vec<V>::get(ov, i), g.slope, g.scale);
      Vec<V>::set(r, i, v);
      sum += v;
    }
    res[at] = r;
    j += step_j;
    o += step_o;
    if (j >= inner_v) { j -= inner_v; ++o; }
  }
  if (g.grad_bias == nullptr) return;
  sum = block_sum(sum);
  if (threadIdx.x == 0) {
    if (gridDim.y == 1) g.grad_bias[c] = sum;
    else g.partial[(size_t)s * g.channels + c] = sum;
  }
}

// inner == 1: (outer rows, channels / V column vectors); a block is tc
// column vectors by blockDim.x / tc rows at a time, block (x, s) columns
// [x * tc, (x + 1) * tc) of rows [s * chunk, (s + 1) * chunk)
template <int V>
__global__ void __launch_bounds__(kThreads)
fused_leaky_relu_bwd_rows_kernel(const Bwd g, long long chunk, int tc) {
  using T = typename Vec<V>::T;
  const int cv = g.channels / V;
  const int tx = threadIdx.x % tc, tr = threadIdx.x / tc;
  const int rs = blockDim.x / tc;
  const int col = blockIdx.x * tc + tx;
  const long long begin = blockIdx.y * chunk;
  const long long end = min(g.outer, begin + chunk);
  const bool has_a = g.a != nullptr, has_b = g.b != nullptr;
  const T* __restrict__ a = reinterpret_cast<const T*>(g.a);
  const T* __restrict__ out = reinterpret_cast<const T*>(g.out);
  T* __restrict__ res = reinterpret_cast<T*>(g.res);
  float add[V], sum[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    add[i] = has_b && col < cv ? g.b[col * V + i] : 0.f;
    sum[i] = 0.f;
  }
  if (col < cv) {
    for (long long r = begin + tr; r < end; r += rs) {
      const size_t at = (size_t)r * cv + col;
      const T ov = out[at];
      T av = T();
      if (has_a) av = a[at];
      T rv;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float v = bwd_of(has_a ? Vec<V>::get(av, i) : 0.f, add[i],
                               has_b, Vec<V>::get(ov, i), g.slope, g.scale);
        Vec<V>::set(rv, i, v);
        sum[i] += v;
      }
      res[at] = rv;
    }
  }
  if (g.grad_bias == nullptr) return;
  __shared__ float part[kThreads * V];
#pragma unroll
  for (int i = 0; i < V; ++i) part[(tr * tc + tx) * V + i] = sum[i];
  __syncthreads();
  if (tr != 0 || col >= cv) return;
  float* to = gridDim.y == 1 ? g.grad_bias
                             : g.partial + (size_t)blockIdx.y * g.channels;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float total = 0.f;
    for (int t = 0; t < rs; ++t) total += part[(t * tc + tx) * V + i];
    to[col * V + i] = total;
  }
}

// grad_bias[c] = the partials of channel c summed in split order
__global__ void __launch_bounds__(kThreads)
fused_leaky_relu_bias_sum_kernel(const float* __restrict__ partial,
                                 int splits, int channels,
                                 float* __restrict__ grad_bias) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  float total = 0.f;
  for (int s = 0; s < splits; ++s) total += partial[(size_t)s * channels + c];
  grad_bias[c] = total;
}

bool blocks_for(long long total, unsigned* blocks) {
  const long long n = (total + kThreads - 1) / kThreads;
  *blocks = (unsigned)n;
  return n <= 2147483647LL;
}

bool aligned16(const void* p) {
  return p == nullptr || ((unsigned long long)p & 15) == 0;
}

int bwd_launch(const void* a, const void* b, const void* out, void* res,
               void* partial, void* grad_bias, long long total, int inner,
               int channels, int splits, float slope, float scale,
               void* stream) {
  if (total <= 0 || inner < 1 || channels < 1 || splits < 1 ||
      splits > 65535 || total % ((long long)inner * channels) != 0 ||
      (grad_bias != nullptr && splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  Bwd g;
  g.a = (const float*)a; g.b = (const float*)b; g.out = (const float*)out;
  g.res = (float*)res; g.partial = (float*)partial;
  g.grad_bias = (float*)grad_bias;
  g.inner = inner; g.channels = channels; g.slope = slope; g.scale = scale;
  const bool vec = aligned16(a) && aligned16(out) && aligned16(res) &&
                   (inner > 1 ? inner % 4 == 0 : channels % 4 == 0);
  const cudaStream_t st = (cudaStream_t)stream;
  // without a sum, splits only spread the work: as many as give every
  // thread one vector (row) at least, for small tensors' latency
  const bool sum = grad_bias != nullptr;
  if (inner > 1) {
    g.outer = total / ((long long)inner * channels);
    const long long units = g.outer * (inner / (vec ? 4 : 1));
    long long n = splits;
    if (!sum) n = (units + kThreads - 1) / kThreads;
    if (n > 65535) n = 65535;
    if (n < 1) n = 1;
    const long long chunk = (units + n - 1) / n;
    // a block of no more warps than its share of a channel needs
    const int threads = chunk < kThreads ? (int)((chunk + 31) / 32 * 32)
                                         : kThreads;
    const dim3 grid((unsigned)channels, (unsigned)n);
    if (vec)
      fused_leaky_relu_bwd_kernel<4><<<grid, threads, 0, st>>>(g, chunk);
    else
      fused_leaky_relu_bwd_kernel<1><<<grid, threads, 0, st>>>(g, chunk);
  } else {
    g.outer = total / channels;
    const int cv = channels / (vec ? 4 : 1);
    const int tc = cv < kThreads ? cv : kThreads;
    const int threads = kThreads / tc * tc;
    long long n = splits;
    if (!sum) n = (g.outer + threads / tc - 1) / (threads / tc);
    if (n > 65535) n = 65535;
    if (n < 1) n = 1;
    const long long chunk = (g.outer + n - 1) / n;
    const dim3 grid((unsigned)((cv + tc - 1) / tc), (unsigned)n);
    if (vec)
      fused_leaky_relu_bwd_rows_kernel<4><<<grid, threads, 0, st>>>(g, chunk,
                                                                    tc);
    else
      fused_leaky_relu_bwd_rows_kernel<1><<<grid, threads, 0, st>>>(g, chunk,
                                                                    tc);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0 || grad_bias == nullptr || splits == 1) return err;
  fused_leaky_relu_bias_sum_kernel<<<(channels + kThreads - 1) / kThreads,
                                     kThreads, 0, st>>>(
      (const float*)partial, splits, channels, (float*)grad_bias);
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
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)bias, (float*)out, total, inner,
      channels, slope, scale);
  return (int)cudaGetLastError();
}

// res = (a + b[channel]) * scale * (out >= 0 ? 1 : slope) over `total`
// elements of layout (outer, channels, inner); `a` (total elements) and
// `b` (channels) may be null, read as 0; where `grad_bias` is not null it
// gets sum(res) over all but the channel axis, through `partial`
// ((splits, channels) floats; may be null where splits is 1), `splits`
// blocks sharing a channel's elements. Two names for one function, so that
// the backward and the double backward (and higher orders) are counted
// apart. cudaErrorInvalidValue for an empty tensor, a total that is not a
// multiple of inner * channels, splits outside [1, 65535] or a sum over
// several splits without `partial`.
#define FUSED_BWD_ENTRY(name)                                                 \
  int name(const void* a, const void* b, const void* out, void* res,          \
           void* partial, void* grad_bias, long long total, int inner,        \
           int channels, int splits, float slope, float scale,                \
           void* stream) {                                                    \
    return bwd_launch(a, b, out, res, partial, grad_bias, total, inner,       \
                      channels, splits, slope, scale, stream);                \
  }
FUSED_BWD_ENTRY(fused_leaky_relu_bwd_launch)
FUSED_BWD_ENTRY(fused_leaky_relu_bwd2_launch)

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
