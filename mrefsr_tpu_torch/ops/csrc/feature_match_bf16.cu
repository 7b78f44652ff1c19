// Top-1 patch matching on bf16 patches, on the tensor cores: for every input
// patch, the best-scoring reference patch and its score.
//
// Replaces mrefsr_tpu/ops/correlation.py::feature_match_index
// (correlation.py:42-104) at bf16, where its score tile is
// jnp.dot(pin, pref_c.T, preferred_element_type=jnp.float32) (:86): bf16
// operands, f32 sums, an f32 running max and argmax across reference tiles.
// The unfold, the ref-patch normalisation (in bf16, rounded where XLA rounds
// it) and the optional division by the input norm stay in PyTorch
// (ops/correlation.py). This kernel takes
//     pin  (P, n_in,  d)   bf16 input patches,
//     pref (P, n_ref, d)   bf16 reference patches, each over its norm,
// and writes, per pair p and input patch i,
//     idx[p, i] = argmax_j <pin[p, i], pref[p, j]>   (lowest j on ties)
//     val[p, i] = max_j    <pin[p, i], pref[p, j]>   (f32)
// The products of two bf16 values are exact in f32, so the scores differ
// from the plain version's (an f32 matmul of the same values) only in the
// order of the f32 sums. The score matrix is never written.
//
// Bound on the H100: operations. One 500x500 CUFED5 request runs 5 pairs of
// 15129 patches a side with d = 9 * 256 = 2304: 5.3 TFLOP, 5.4 ms at the
// 989 TFLOP/s of dense bf16; a stage-3 training step (30 pairs of 1444,
// 40x40 maps) 0.29 TFLOP, 0.29 ms.
//
// Design: warp-level mma.sync.m16n8k16 (bf16 in, f32 accumulate). A block of
// 256 threads (8 warps, 2 along the input rows x 4 along the ref rows) owns
// BM = 128 input patches and walks all reference patches in BN = 128 tiles,
// in ascending order, through BK = 32 slices of d; each warp holds a 64 x 32
// accumulator tile (4 x 4 mma tiles, 64 f32 a thread). The tiles come through
// shared memory with cp.async, two stages deep, each row padded to 40 bf16
// (80 bytes), so the fragment loads (32-bit words at row gid, column 2 tig)
// hit 32 different banks. A ragged edge is zero-filled: rows past n_in or
// n_ref and the tail of d past its last multiple of 32; when d is not a
// multiple of 8 (or a matrix is not 16-byte aligned) the tiles are loaded
// element by element. After the last slice of a reference tile each thread
// folds its accumulators into a running best per row, columns ascending and
// a strict '>' (columns past n_ref are skipped, i.e. -inf), so the lowest
// index wins within the thread; at the end the 4 lanes of a row merge by
// shuffles and the 4 warps along the ref rows through shared memory, by value,
// then by lower index. That is the JAX tie rule: first max inside a tile,
// strict '>' across tiles, i.e. the lowest index among equal maxima.
// blockIdx.z is the pair. No wgmma or TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait_one;
using tc::mma_bf16;
using tc::word;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDS = BK + 8;  // a staged row, in bf16: 80 bytes
constexpr int THREADS = 256;
constexpr int WM = 64;       // warp tile: 2 warps along the input rows
constexpr int WN = 32;       //            4 warps along the ref rows
constexpr int MT = WM / 16;  // m16 tiles of a warp
constexpr int NT = WN / 8;   // n8 tiles of a warp

struct Stage {
  __nv_bfloat16 a[BM * LDS];
  __nv_bfloat16 b[BN * LDS];
};

// Rows [row0, row0 + 128) x columns [k0, k0 + 32) of the (n, d) matrix
// `src` into the staged tile `dst`, zeros outside the matrix. A thread moves
// two runs of 8 bf16.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n, int k0, int d, bool vec,
                                          int tid) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int run = tid + q * THREADS;
    const int r = run >> 2;
    const int kc = (run & 3) * 8;
    const int row = row0 + r;
    const int k = k0 + kc;
    __nv_bfloat16* s = dst + r * LDS + kc;
    if (vec) {  // d % 8 == 0: a run lies wholly inside d or wholly past it
      const bool in = row < n && k < d;
      cp_async16(s, in ? src + (size_t)row * d + k : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s[e] = (row < n && k + e < d) ? src[(size_t)row * d + k + e]
                                      : __float2bfloat16(0.f);
    }
  }
}

// (v, ix) takes (ov, oi) if that is larger, or equal with a lower index.
__device__ __forceinline__ void merge(float& v, int& ix, float ov, int oi) {
  if (ov > v || (ov == v && oi < ix)) {
    v = ov;
    ix = oi;
  }
}

__global__ void __launch_bounds__(THREADS)
feature_match_bf16_kernel(const __nv_bfloat16* __restrict__ pin,
                          const __nv_bfloat16* __restrict__ pref, int n_in,
                          int n_ref, int d, int vec,
                          int* __restrict__ idx_out,
                          float* __restrict__ val_out) {
  __shared__ __align__(16) Stage stages[2];
  __shared__ float part_val[BN / WN][BM];
  __shared__ int part_idx[BN / WN][BM];

  const int pair = blockIdx.z;
  pin += (size_t)pair * n_in * d;
  pref += (size_t)pair * n_ref * d;
  idx_out += (size_t)pair * n_in;
  val_out += (size_t)pair * n_in;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / (BN / WN);  // 0..1
  const int wn = warp % (BN / WN);  // 0..3
  const int gid = lane >> 2;        // row within an mma tile (and + 8)
  const int tig = lane & 3;         // column pair within an mma tile
  const int row0 = blockIdx.x * BM;
  const int nk = (d + BK - 1) / BK;
  const int steps = nk * ((n_ref + BN - 1) / BN);

  // this thread's rows: wm * WM + mi * 16 + h * 8 + gid
  float best_val[MT][2];
  int best_idx[MT][2];
  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best_val[mi][h] = -INFINITY;
      best_idx[mi][h] = 0;
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  }

  load_tile(stages[0].a, pin, row0, n_in, 0, d, vec, tid);
  load_tile(stages[0].b, pref, 0, n_ref, 0, d, vec, tid);
  cp_async_commit();

  // step s = (reference tile s / nk, slice s % nk); step s + 1 is in flight
  // while step s is multiplied
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      Stage& next = stages[(s + 1) & 1];
      const int k1 = ((s + 1) % nk) * BK;
      load_tile(next.a, pin, row0, n_in, k1, d, vec, tid);
      load_tile(next.b, pref, ((s + 1) / nk) * BN, n_ref, k1, d, vec, tid);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const Stage& cur = stages[s & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const __nv_bfloat16* p =
            cur.a + (wm * WM + mi * 16 + gid) * LDS + kk + tig * 2;
        a[mi][0] = word(p);
        a[mi][1] = word(p + 8 * LDS);
        a[mi][2] = word(p + 8);
        a[mi][3] = word(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const __nv_bfloat16* q =
            cur.b + (wn * WN + ni * 8 + gid) * LDS + kk + tig * 2;
        b[ni][0] = word(q);
        b[ni][1] = word(q + 8);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();  // the next prefetch overwrites this stage

    if (s % nk == nk - 1) {  // a reference tile is complete: fold it in
      const int col0 = (s / nk) * BN + wn * WN + tig * 2;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int col = col0 + ni * 8 + j;
              const float v = acc[mi][ni][h * 2 + j];
              if (col < n_ref && v > best_val[mi][h]) {
                best_val[mi][h] = v;
                best_idx[mi][h] = col;
              }
            }
          }
        }
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      }
    }
  }

  // the 4 lanes of a row (same gid), then the 4 warps along the ref rows
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = best_val[mi][h];
      int ix = best_idx[mi][h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        merge(v, ix, __shfl_xor_sync(0xffffffffu, v, off),
              __shfl_xor_sync(0xffffffffu, ix, off));
      if (tig == 0) {
        const int r = wm * WM + mi * 16 + h * 8 + gid;
        part_val[wn][r] = v;
        part_idx[wn][r] = ix;
      }
    }
  }
  __syncthreads();
  if (tid < BM) {
    float v = part_val[0][tid];
    int ix = part_idx[0][tid];
#pragma unroll
    for (int w = 1; w < BN / WN; ++w) merge(v, ix, part_val[w][tid],
                                            part_idx[w][tid]);
    const int row = row0 + tid;
    if (row < n_in) {
      idx_out[row] = ix;
      val_out[row] = v;
    }
  }
}

// The launch both entry points share.
int launch(const void* pin, const void* pref, int pairs, int n_in, int n_ref,
           int d, void* idx, void* val, void* stream) {
  const int vec = d % 8 == 0 && (uintptr_t)pin % 16 == 0 &&
                  (uintptr_t)pref % 16 == 0;
  dim3 grid((n_in + BM - 1) / BM, 1, pairs);
  feature_match_bf16_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)pin, (const __nv_bfloat16*)pref, n_in, n_ref, d,
      vec, (int*)idx, (float*)val);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pin and pref are device pointers of contiguous bf16 tensors, idx of int32,
// val of f32; the stream is a cudaStream_t. Returns cudaGetLastError() after
// the launch.
int feature_match_bf16_launch(const void* pin, const void* pref, int pairs,
                              int n_in, int n_ref, int d, void* idx,
                              void* val, void* stream) {
  return launch(pin, pref, pairs, n_in, n_ref, d, idx, val, stream);
}

// The same kernel on one rank's band of reference rows, for
// mrefsr_tpu/ops/correlation.py::feature_match_index_sharded
// (correlation.py:140-180) at bf16: a second name only, so that the sharded
// match counts its launches apart from the single-device one.
int feature_match_sharded_bf16_launch(const void* pin, const void* pref,
                                      int pairs, int n_in, int n_ref, int d,
                                      void* idx, void* val, void* stream) {
  return launch(pin, pref, pairs, n_in, n_ref, d, idx, val, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
