// The tile walk of K1's match kernels on Hopper, shared by
// feature_match.cu (f32, 3xTF32) and feature_match_bf16.cu (bf16): for every
// input patch, the best-scoring reference patch and its score, with wgmma
// fed by the Tensor Memory Accelerator (TMA).
//
// Contract: pin (P, n_in, d) and pref (P, n_ref, d), each row ld elements
// apart (ld a multiple of 8: TMA needs every global stride a multiple of 16
// bytes), in PARTS planes P * n * ld elements apart (bf16: 1; the f32
// kernel's hi and lo split: 2); out, per pair p and input patch i,
//     idx[p, i] = argmax_j <pin[p, i], pref[p, j]>   (lowest j on ties)
//     val[p, i] = max_j    <pin[p, i], pref[p, j]>   (f32).
// The score matrix is never written.
//
// Design: a block of three warpgroups owns BM = 128 input patches and walks
// all reference patches in BN = 256 tiles, in ascending order, through
// slices of d 128 bytes wide (64 bf16, 32 f32: one row of the 128-byte
// swizzle). Warpgroup 0 is the producer: after setmaxnreg gives its
// registers away, one thread keeps a ring of STAGES stages (PARTS x 16 KB of
// pin, PARTS x 32 KB of pref each) in dynamic shared memory, filled with
// 4-D TMA loads (d, row, pair, part; 128-byte swizzle), each stage's full
// barrier counting the bytes in, its empty barrier counting the 8 consumer
// warps out. Warpgroups 1 and 2 are consumers of 64 input rows each: per
// stage four k steps of 32 bytes (the configuration's products: one
// wgmma.m64n256k16 at bf16, three m64n256k8 at f32), f32 sums in 128
// registers a thread, then wgmma.wait and the stage goes back to the
// producer, which already fills the stages ahead. A ragged edge needs no
// code in the loads: TMA fills rows past n_in or n_ref and the tail of d
// past its last slice with zeros. After the last slice of a reference tile
// each thread folds its accumulators (rows gid and gid + 8 of its warp's 16,
// columns 8 j + 2 tig, +1) into a running best per row, columns ascending
// and a strict '>' (columns past n_ref skipped, i.e. -inf), so the lowest
// index wins within the thread; the first product of the next tile
// overwrites the accumulators. At the end the 4 lanes of a row merge by
// shuffles, by value, then by lower index: the two consumer warpgroups own
// other rows, so nothing merges across them. That is the JAX tie rule:
// first max inside a tile, strict '>' across tiles, i.e. the lowest index
// among equal maxima. blockIdx.y is the pair.
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// taken from libcuda.so.1, which the process has already loaded (dlopen
// and dlsym): the plain C build links no libcuda.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace fm {

constexpr int BM = 128;         // input rows of a block, 64 a consumer
constexpr int BN = 256;         // reference rows of a tile
constexpr int ROW_BYTES = 128;  // a slice of d: one swizzled row
constexpr int K_STEP_BYTES = 32;  // a wgmma's depth: k16 bf16, k8 tf32
constexpr int THREADS = 384;    // producer warpgroup + 2 consumers
constexpr int CONSUMER_WARPS = 8;

// Cfg: the element's BK (elements a slice), PARTS and STAGES, and
// step(acc, a, b, accumulate), the products of one 32-byte k step on the A
// tile at shared address a and the B tile at b (part 1 of each at
// + BM * ROW_BYTES and + BN * ROW_BYTES).
template <class Cfg>
struct Ring {
  static constexpr int A_BYTES = Cfg::PARTS * BM * ROW_BYTES;
  static constexpr int B_BYTES = Cfg::PARTS * BN * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the ring, and slack to align it to 1024 bytes (the swizzle's period)
  static constexpr int SMEM_BYTES = Cfg::STAGES * STAGE_BYTES + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

// one arrival that also announces `bytes` to come from TMA
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// the box at (k, row, pair, part 0) of `map` into shared memory at `dst`;
// the bytes are counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row,
                                         int pair) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(k), "r"(row), "r"(pair),
      "r"(0)
      : "memory");
}

// wgmma's descriptor of a K-major tile in shared memory whose rows are 128
// bytes, 128-byte swizzled (as TMA writes it), 1024-byte aligned: the
// address, LBO 16 bytes (unused by this layout), SBO 1024 bytes (8 rows).
// A k step inside the row is an offset of 32 bytes on the address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <class Cfg>
__global__ void __launch_bounds__(THREADS, 1)
match_kernel(const __grid_constant__ CUtensorMap tm_in,
             const __grid_constant__ CUtensorMap tm_ref, int n_in, int n_ref,
             int d, int* __restrict__ idx_out, float* __restrict__ val_out) {
  using R = Ring<Cfg>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[Cfg::STAGES];
  __shared__ __align__(8) uint64_t empty_bar[Cfg::STAGES];

  const int pair = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int nk = (d + Cfg::BK - 1) / Cfg::BK;
  const int steps = nk * ((n_ref + BN - 1) / BN);
  // the ring, 1024-byte aligned in the shared address space
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = raw + ((1024 - (raw & 1023)) & 1023);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < Cfg::STAGES; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int s = 0; s < steps; ++s) {
        const int stage = s % Cfg::STAGES;
        // round 0 passes: the ring starts empty
        mbar_wait(&empty_bar[stage], ((s / Cfg::STAGES) & 1) ^ 1);
        const uint32_t a = ring + stage * R::STAGE_BYTES;
        const int k = (s % nk) * Cfg::BK;
        mbar_expect_tx(&full_bar[stage], R::STAGE_BYTES);
        tma_load(a, &tm_in, &full_bar[stage], k, row0, pair);
        tma_load(a + R::A_BYTES, &tm_ref, &full_bar[stage], k, (s / nk) * BN,
                 pair);
      }
    }
  } else {
    // the consumers: 64 input rows a warpgroup against each ref tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x - 128;
    const int cw = ct >> 7;  // consumer warpgroup: rows cw * 64 ..
    const int warp = (ct >> 5) & 3;
    const int lane = ct & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    float best_val[2] = {-INFINITY, -INFINITY};
    int best_idx[2] = {0, 0};

    for (int s = 0; s < steps; ++s) {
      const int stage = s % Cfg::STAGES;
      mbar_wait(&full_bar[stage], (s / Cfg::STAGES) & 1);
      const uint32_t a = ring + stage * R::STAGE_BYTES + cw * 64 * ROW_BYTES;
      const uint32_t b = ring + stage * R::STAGE_BYTES + R::A_BYTES;
      const int first = s % nk == 0;  // a new reference tile
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ROW_BYTES / K_STEP_BYTES; ++kk)
        Cfg::step(acc, a + kk * K_STEP_BYTES, b + kk * K_STEP_BYTES,
                  !(first && kk == 0));
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[stage]);

      if (s % nk == nk - 1) {  // a reference tile is complete: fold it in
        const int col0 = (s / nk) * BN + tig * 2;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = col0 + j * 8 + e;
            if (col < n_ref) {
              const float v0 = acc[4 * j + e];
              const float v1 = acc[4 * j + 2 + e];
              if (v0 > best_val[0]) {
                best_val[0] = v0;
                best_idx[0] = col;
              }
              if (v1 > best_val[1]) {
                best_val[1] = v1;
                best_idx[1] = col;
              }
            }
          }
        }
      }
    }

    // the 4 lanes of a row (same gid), by value, then by lower index
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = best_val[h];
      int ix = best_idx[h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
        if (ov > v || (ov == v && oi < ix)) {
          v = ov;
          ix = oi;
        }
      }
      const int row = row0 + cw * 64 + warp * 16 + h * 8 + gid;
      if (tig == 0 && row < n_in) {
        idx_out[(size_t)pair * n_in + row] = ix;
        val_out[(size_t)pair * n_in + row] = v;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = (EncodeTiled)dlsym(lib, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// The (d, n, pairs, parts) patch matrix at `base` (elements of `bytes`),
// rows ld elements apart, as boxes of (ROW_BYTES / bytes, rows, 1, parts)
// with the 128-byte swizzle; out-of-bounds elements read as zeros.
inline bool make_map(EncodeTiled encode, CUtensorMap* map,
                     CUtensorMapDataType type, int bytes, const void* base,
                     int d, int n, int pairs, int ld, int parts, int rows) {
  const cuuint64_t row = (cuuint64_t)ld * bytes;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)n,
                              (cuuint64_t)pairs, (cuuint64_t)parts};
  const cuuint64_t strides[3] = {row, row * n, row * n * pairs};
  const cuuint32_t box[4] = {(cuuint32_t)(ROW_BYTES / bytes),
                             (cuuint32_t)rows, 1, (cuuint32_t)parts};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Encodes the two maps and launches match_kernel<Cfg>; returns a cudaError
// code (cudaErrorInvalidValue if a map cannot be encoded).
template <class Cfg>
int launch_match(CUtensorMapDataType type, int bytes, const void* pin,
                 const void* pref, int pairs, int n_in, int n_ref, int d,
                 int ld, void* idx, void* val, cudaStream_t stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap tm_in, tm_ref;
  if (!make_map(encode, &tm_in, type, bytes, pin, d, n_in, pairs, ld,
                Cfg::PARTS, BM) ||
      !make_map(encode, &tm_ref, type, bytes, pref, d, n_ref, pairs, ld,
                Cfg::PARTS, BN))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      match_kernel<Cfg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<Cfg>::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_in + BM - 1) / BM, pairs);
  match_kernel<Cfg><<<grid, THREADS, Ring<Cfg>::SMEM_BYTES, stream>>>(
      tm_in, tm_ref, n_in, n_ref, d, (int*)idx, (float*)val);
  return (int)cudaGetLastError();
}

}  // namespace fm
