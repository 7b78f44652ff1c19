// Top-1 patch matching: for every input patch, the best-scoring reference
// patch and its score.
//
// Replaces mrefsr_tpu/ops/correlation.py::feature_match_index
// (correlation.py:42-104), whose score tile is an XLA matmul with a running
// max/argmax carried across a lax.scan over reference tiles. Here the
// unfold and the ref-patch normalisation stay in PyTorch
// (ops/correlation.py); this kernel takes the two patch matrices,
//     pin  (P, n_in,  d)   input patches,
//     pref (P, n_ref, d)   reference patches, each divided by its norm,
// and writes, per pair p and input patch i,
//     idx[p, i] = argmax_j <pin[p, i], pref[p, j]>   (lowest j on ties)
//     val[p, i] = max_j    <pin[p, i], pref[p, j]>.
// The score matrix is never written.
//
// Bound on the H100: arithmetic. One 500x500 CUFED5 request runs 5 pairs
// of 123^2 = 15129 patches a side with d = 9 * 256 = 2304, i.e.
// 5 * 2 * 15129^2 * 2304 = 5.3 TFLOP against < 0.1 GB of input features:
// about 79 ms at the 67 TFLOP/s of the f32 CUDA cores, 11 ms at the
// 495 TFLOP/s of TF32 tensor cores, 5 ms at 989 TFLOP/s bf16 (later work).
//
// Design: a plain f32 SGEMM-style tile walk. A block of 256 threads owns
// BM = 128 input patches; it walks all reference patches in BN = 128
// tiles, in ascending order, staging BK = 8 slices of d through shared
// memory. Each thread holds an 8 x 8 register tile of scores, so every
// value loaded from shared memory feeds 8 FMAs. After a reference tile,
// each thread folds its 8 columns into a running best per row with a
// strict '>' (ascending columns, so the lowest index wins within the
// thread); at the end the 16 threads sharing a row merge by value, then
// by lower index. That is the JAX tie rule: first max inside a tile,
// strict '>' across tiles, i.e. the lowest index among equal maxima.
// blockIdx.z is the pair. No tensor cores, no TMA yet.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = 256;  // (BM / TM) * (BN / TN)

__global__ void __launch_bounds__(THREADS)
feature_match_kernel(const float* __restrict__ pin,
                     const float* __restrict__ pref, int n_in, int n_ref,
                     int d, int* __restrict__ idx_out,
                     float* __restrict__ val_out) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];

  const int pair = blockIdx.z;
  pin += (size_t)pair * n_in * d;
  pref += (size_t)pair * n_ref * d;
  idx_out += (size_t)pair * n_in;
  val_out += (size_t)pair * n_in;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: columns tx*TN .. +TN
  const int ty = tid / 16;  // row group: rows ty*TM .. +TM
  const int row0 = blockIdx.x * BM;
  // tile loads: thread tid fills row tid/2, slice columns (tid%2)*4 .. +4
  const int lr = tid / 2;
  const int lk = (tid % 2) * 4;
  const int a_row = row0 + lr;

  float best_val[TM];
  int best_idx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best_val[i] = -INFINITY;
    best_idx[i] = 0;
  }

  for (int col0 = 0; col0 < n_ref; col0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    const int b_row = col0 + lr;
    for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + lk + q;
        As[lk + q][lr] =
            (a_row < n_in && k < d) ? pin[(size_t)a_row * d + k] : 0.f;
        Bs[lk + q][lr] =
            (b_row < n_ref && k < d) ? pref[(size_t)b_row * d + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx * TN + j;
      if (col < n_ref) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (acc[i][j] > best_val[i]) {
            best_val[i] = acc[i][j];
            best_idx[i] = col;
          }
        }
      }
    }
  }

  // The 16 threads of one row group are 16 consecutive lanes of a warp.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float v = best_val[i];
    int ix = best_idx[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
      if (ov > v || (ov == v && oi < ix)) {
        v = ov;
        ix = oi;
      }
    }
    const int row = row0 + ty * TM + i;
    if (tx == 0 && row < n_in) {
      idx_out[row] = ix;
      val_out[row] = v;
    }
  }
}

// The launch both entry points share.
int launch(const void* pin, const void* pref, int pairs, int n_in, int n_ref,
           int d, void* idx, void* val, void* stream) {
  dim3 grid((n_in + BM - 1) / BM, 1, pairs);
  feature_match_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)pin, (const float*)pref, n_in, n_ref, d, (int*)idx,
      (float*)val);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers of contiguous f32 / int32 tensors; the
// stream is a cudaStream_t. Returns cudaGetLastError() after the launch.
int feature_match_launch(const void* pin, const void* pref, int pairs,
                         int n_in, int n_ref, int d, void* idx, void* val,
                         void* stream) {
  return launch(pin, pref, pairs, n_in, n_ref, d, idx, val, stream);
}

// The same kernel on one rank's band of reference rows, for
// mrefsr_tpu/ops/correlation.py::feature_match_index_sharded
// (correlation.py:140-180): a second name only, so that the sharded match
// counts its launches apart from the single-device one. The index remap
// and the MAX / MIN all-reduce across ranks stay in PyTorch.
int feature_match_sharded_launch(const void* pin, const void* pref, int pairs,
                                 int n_in, int n_ref, int d, void* idx,
                                 void* val, void* stream) {
  return launch(pin, pref, pairs, n_in, n_ref, d, idx, val, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
