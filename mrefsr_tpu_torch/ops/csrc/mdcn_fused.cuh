// The fused deformable convs: the modulated deformable conv (DCNv2) and
// DCNv1 whose deformable-im2col columns never reach device memory, forward
// and backward, with the products on the tensor cores: one tile walk for
// two element types T. mdcn_bf16.cu instantiates it at bf16 (m16n8k16
// products), mdcn_fused.cu at f32 (3xTF32 on m16n8k8); each says what it
// replaces and what bounds it. It runs three TPU kernels of the JAX
// package: K2 (conv groups 1, a mask), K3 (conv groups > 1: the wrapper,
// ops/dcn.py, hands the walk a block-diagonal weight, exact zeros off the
// groups' blocks) and K5 (DCNv1: a null mask, read as a mask of ones).
//
// For output row r = (n, ho, wo), tap k = (ky, kx), input channel c of
// deform group g = c / cg:
//     col[r, k, c] = T(mask[r, g, k] * bilinear(x[n, :, :, c], fy, fx))
//     fy = ho*sh - ph + ky*dh + offset[r, g, k, 0]   (f32)
// with mmcv's zero-outside corners (deform_bilinear.cuh), sampled in f32
// and rounded to T once (exact at f32), and no mask at all where the mask
// pointer is null (kMask false: nothing read, staged or written for it);
// then
//   forward  out[r, o]  = sum_{k,c} col[r,k,c] W[k,c,o], + bias[o]
//   dgrad    gcol[r,k,c] = sum_o go[r, o] W[k, c, o], and from it the
//            col2im arithmetic: grad offset (f32, times the mask) and grad
//            mask (T, none without a mask) summed over the group's
//            channels, grad x (f32, atomic) in the _scatter variant;
//   wgrad    gW[k*C + c, o] = sum_r col[r, k, c] go[r, o]   (f32), and
//            grad bias gb[o] = sum_r go[r, o]                  (f32)
// with every sum over (k, c), o or r in f32 on the tensor cores. Where the
// type rounds is Prec<T>'s: at bf16 the forward rounds its sum, adds the
// bias and rounds again, and dgrad rounds gcol, where torch.mm of the plain
// version (ops/dcn.py) and JAX's vjp round; at f32 nothing is rounded below
// f32 and the bias is added to the f32 sum, as torch.addmm does. wgrad
// writes one f32 partial per slice of rows and a second kernel adds the
// slices in a fixed order: no float atomics, so grad weight and grad bias,
// like grad offset and grad mask (one writer each), are the same from run
// to run.
//
// Layouts (contiguous): x (N, H, W, C) T; offset (N, Ho, Wo, dg, K, 2) f32
// as (dy, dx); mask (N, Ho, Wo, dg, K) T or null; the weight HWIO
// (K * C, Cout) T
// for dgrad and transposed, wt (Cout, K * C), for the forward (its B
// operand wants k contiguous); go and out (rows, Cout) T; grad_offset,
// grad_mask, grad_x as offset, mask and x (grad_x f32); partial (splits,
// K * C + 1, Cout) f32, grad weight's rows and then grad bias.
//
// Design. mma.sync products, two warps along the 64 rows of a tile and the
// rest along its width (dgrad at f32: see DgradShape). A block's 64 output rows are an 8 x 8 patch of
// output pixels of one item, not 64 pixels of one image row, so that its
// samples fall in a window of about (8 + 2 * reach)^2 pixels rather than a
// strip 64 pixels wide. A thread gathers runs of 16 bytes of one pixel's
// channels (N = 8 bf16 or 4 f32), and a k-step or chunk is 8 runs: BK = 64
// bf16 or 32 f32 channels, a staged row of 128 bytes and 16 of padding
// whatever T, so that the tiles' bytes and their ldmatrix addresses are the
// same at both types; the deform group is taken per run (a step spans 8
// groups at cg 8 bf16). A step's corner loads are issued before the
// products they can overlap and widened into shared memory after.
//  - Forward: a block owns a patch and all of Cout (BN = Cout rounded up
//    to 64, 128 or 256, padded with zeros; 256 threads, 512 at BN 256 so
//    that no thread holds more than 32 accumulators), so each sample is
//    gathered once. The k loop runs over (tap, BK channels), 2 runs a
//    thread (1 at 512): the offsets and mask of step s + 2 are read and
//    the corner loads of step s + 1 issued before step s's products. The
//    weight tile comes by cp.async; both double-buffered. The sums are
//    rounded as Prec<T> says, staged in shared memory and stored as
//    16-byte NHWC runs.
//  - dgrad: a block owns a patch; its grad_out tile (64 x BN) and its
//    offsets and masks (one coalesced copy: scattered reads and writes of
//    them cost as much L2 traffic as the gather) stay in shared memory.
//    For each (tap, BK channels) it multiplies the tile by W[k, chunk,
//    :]^T (the next chunk's weight rows load meanwhile), stores gcol in T
//    into shared memory and runs the col2im arithmetic on it: a thread per
//    (pixel, run), the group's cg / N runs neighbouring lanes summed by
//    shuffles, one writer per (pixel, group, tap), whose gradients replace
//    the staged offset and mask just read; they are written back,
//    coalesced, at the end.
//  - wgrad: a block owns (tap, BK channels) x all of Cout and a slice of
//    patches, one patch a step: the gathered column tile and the grad_out
//    tile are staged row-major and read across (A = col^T, B = go); the
//    blocks of the first (tap, chunk) also sum the grad_out tile's
//    columns, rows in order, for grad bias. The wrapper cuts the slices
//    from the shapes alone, so the sum of the slices' partials (a last
//    small kernel, in order) does not depend on the card.
//  - Index arithmetic: a block walks its patches, and a k-step's tap and
//    deform group are worked out once a step, so that a sample costs no
//    integer division.
//  - No mask (K5): each kernel is a template on kMask, chosen once a
//    launch by whether the mask pointer is null, so K2's code is the same
//    with or without K5 beside it and no sample tests for a mask.
//  - Conv groups (K3): the walk knows none. The block-diagonal weight costs
//    G times the products of the grouped conv and no extra gather; at C 64
//    a k step of 32 f32 channels spans several conv groups, so a step of
//    zeros cannot simply be skipped.
// Requires C and cg multiples of N, Cout a multiple of 8, Cout <= 256,
// dg * K <= 144, for the backward cg / N a power of two <= 8, x, weight, go
// and out 16-byte aligned and the offset 8-byte aligned; the wrapper
// (ops/dcn.py) checks each by name and the launches check them again.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "deform_bilinear.cuh"
#include "mma_sync.cuh"

namespace mdcn_fused {

using bf16 = __nv_bfloat16;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait_all;

constexpr int PATCH = 8;           // a block's rows: an 8 x 8 pixel patch
constexpr int BM = PATCH * PATCH;  // 64
constexpr int RUNS_K = 8;          // runs of 16 bytes in a k-step or chunk
constexpr int MAX_STAGED = 144;    // dg * K of a block's staged offsets

// What depends on the element type: the run and tile widths, the
// fragments and products, and where a value is rounded.
template <typename T>
struct Prec;

// bf16: one m16n8k16 product, fragments by ldmatrix (transposed where k
// runs across rows); the forward's sum and gcol rounded to bf16.
template <>
struct Prec<bf16> {
  using Raw = uint4;
  static constexpr int N = 8;   // channels of a run
  static constexpr int KP = 16;  // depth of one product
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };

  // rows m0 .. m0 + 15, k0 .. k0 + 15 of a tile stored m-major
  static __device__ __forceinline__ void load_a(A& a, const bf16* s, int ld,
                                                int m0, int k0, int lane) {
    tc::ldmatrix_x4(a.r, s + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                             k0 + (lane >> 4) * 8);
  }

  // NT tiles of 8 columns n0 .. n0 + 8 NT - 1 over k0 .. k0 + 15, from a
  // tile stored n-major (k contiguous)
  template <int NT>
  static __device__ __forceinline__ void load_b(B (&b)[NT], const bf16* s,
                                                int ld, int n0, int k0,
                                                int lane) {
    if constexpr (NT % 2 == 0) {
#pragma unroll
      for (int ni = 0; ni < NT; ni += 2) {
        uint32_t r[4];
        tc::ldmatrix_x4(r, s + (n0 + ni * 8 + (lane & 7) + (lane >> 4) * 8) *
                                   ld +
                               k0 + ((lane >> 3) & 1) * 8);
        b[ni].r[0] = r[0];
        b[ni].r[1] = r[1];
        b[ni + 1].r[0] = r[2];
        b[ni + 1].r[1] = r[3];
      }
    } else {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        tc::ldmatrix_x2(b[ni].r, s + (n0 + ni * 8 + (lane & 7)) * ld + k0 +
                                     ((lane >> 3) & 1) * 8);
    }
  }

  // The same from tiles stored k-major (a row per k), read across
  template <int MT>
  static __device__ __forceinline__ void load_a_t(A (&a)[MT], const bf16* s,
                                                  int ld, int m0, int k0,
                                                  int lane) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
      tc::ldmatrix_x4_trans(a[mi].r, s + (k0 + (lane & 7) + (lane >> 4) * 8) *
                                             ld +
                                         m0 + mi * 16 +
                                         ((lane >> 3) & 1) * 8);
  }

  template <int NT>
  static __device__ __forceinline__ void load_b_t(B (&b)[NT], const bf16* s,
                                                  int ld, int n0, int k0,
                                                  int lane) {
    static_assert(NT % 2 == 0, "pairs of n tiles");
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];
      tc::ldmatrix_x4_trans(r, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                       ld +
                                   n0 + np * 16 + (lane >> 4) * 8);
      b[2 * np].r[0] = r[0];
      b[2 * np].r[1] = r[1];
      b[2 * np + 1].r[0] = r[2];
      b[2 * np + 1].r[1] = r[3];
    }
  }

  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    tc::mma_bf16(c, a.r, b.r);
  }

  // Sums kept in the products' own accumulators (see Prec<float>).
  static constexpr bool kStepSums = false;
  // The gathered column tile: one plane, stored as it is.
  static constexpr int kPlanes = 1;
  static __device__ __forceinline__ void store_run(bf16* p, int, uint4 v) {
    *reinterpret_cast<uint4*>(p) = v;
  }
  static __device__ __forceinline__ void load_a_planes(A& a, const bf16* s,
                                                       int, int ld, int m0,
                                                       int k0, int lane) {
    load_a(a, s, ld, m0, k0, lane);
  }
  template <int MT>
  static __device__ __forceinline__ void load_a_t_planes(
      A (&a)[MT], const bf16* s, int, int ld, int m0, int k0, int lane) {
    load_a_t<MT>(a, s, ld, m0, k0, lane);
  }

  static __device__ __forceinline__ float widen(bf16 v) {
    return __bfloat162float(v);
  }
  // the forward's sum, rounded before the bias is added
  static __device__ __forceinline__ float sum_out(float acc) {
    return __bfloat162float(__float2bfloat16_rn(acc));
  }
  // two neighbouring values, rounded once, into shared memory
  static __device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  }
};

// f32: 3xTF32, three m16n8k8 products lo*hi + hi*lo + hi*hi (small terms
// first) of operands split by tc::split_tf32, as they load into registers
// or, the gathered column tile, once as it is stored (kPlanes); nothing
// rounded below f32.
template <>
struct Prec<float> {
  using Raw = float4;
  static constexpr int N = 4;
  static constexpr int KP = 8;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };

  template <int K>
  static __device__ __forceinline__ void split(const uint32_t (&r)[K],
                                               uint32_t (&hi)[K],
                                               uint32_t (&lo)[K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) tc::split_tf32(r[i], hi[i], lo[i]);
  }

  static __device__ __forceinline__ void load_a(A& a, const float* s, int ld,
                                                int m0, int k0, int lane) {
    uint32_t r[4];
    tc::ldmatrix_x4(r, s + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                           k0 + (lane >> 4) * 4);
    split(r, a.hi, a.lo);
  }

  template <int NT>
  static __device__ __forceinline__ void load_b(B (&b)[NT], const float* s,
                                                int ld, int n0, int k0,
                                                int lane) {
    if constexpr (NT % 2 == 0) {
#pragma unroll
      for (int ni = 0; ni < NT; ni += 2) {
        uint32_t r[4];
        tc::ldmatrix_x4(r, s + (n0 + ni * 8 + (lane & 7) + (lane >> 4) * 8) *
                                   ld +
                               k0 + ((lane >> 3) & 1) * 4);
        const uint32_t r0[2] = {r[0], r[1]}, r1[2] = {r[2], r[3]};
        split(r0, b[ni].hi, b[ni].lo);
        split(r1, b[ni + 1].hi, b[ni + 1].lo);
      }
    } else {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        uint32_t r[2];
        tc::ldmatrix_x2(r, s + (n0 + ni * 8 + (lane & 7)) * ld + k0 +
                               ((lane >> 3) & 1) * 4);
        split(r, b[ni].hi, b[ni].lo);
      }
    }
  }

  // Read across by plain 32-bit loads: a row stride of 8 mod 32 words puts
  // the 32 lanes of each load on 32 banks.
  template <int NT>
  static __device__ __forceinline__ void load_b_t(B (&b)[NT], const float* s,
                                                  int ld, int n0, int k0,
                                                  int lane) {
    const int gid = lane >> 2, tig = lane & 3;
    const float* p = s + (k0 + tig) * ld + n0 + gid;
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const uint32_t r[2] = {__float_as_uint(p[ni * 8]),
                             __float_as_uint(p[4 * ld + ni * 8])};
      split(r, b[ni].hi, b[ni].lo);
    }
  }

  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    tc::mma_tf32(c, a.lo, b.hi);
    tc::mma_tf32(c, a.hi, b.lo);
    tc::mma_tf32(c, a.hi, b.hi);
  }

  // The tensor cores' f32 sums truncate, and over a wgrad slice's
  // thousands of k-steps their error builds up to 1e-4 of the sum (a
  // forward's few hundred stay below 2e-5): there each k-step's products
  // go into a fresh accumulator, added to the running sums on the CUDA
  // cores, rounded to nearest.
  static constexpr bool kStepSums = true;
  // The gathered column tile, which every warp along the output's width
  // reads: split once, as it is stored, into a hi plane and, `plane`
  // elements on, a lo plane; its fragments load both, split already.
  static constexpr int kPlanes = 2;
  static __device__ __forceinline__ void store_run(float* p, int plane,
                                                   float4 v) {
    uint4 hi, lo;
    tc::split_tf32(__float_as_uint(v.x), hi.x, lo.x);
    tc::split_tf32(__float_as_uint(v.y), hi.y, lo.y);
    tc::split_tf32(__float_as_uint(v.z), hi.z, lo.z);
    tc::split_tf32(__float_as_uint(v.w), hi.w, lo.w);
    *reinterpret_cast<uint4*>(p) = hi;
    *reinterpret_cast<uint4*>(p + plane) = lo;
  }
  static __device__ __forceinline__ void load_a_planes(A& a, const float* s,
                                                       int plane, int ld,
                                                       int m0, int k0,
                                                       int lane) {
    const float* at = s + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                      k0 + (lane >> 4) * 4;
    tc::ldmatrix_x4(a.hi, at);
    tc::ldmatrix_x4(a.lo, at + plane);
  }
  template <int MT>
  static __device__ __forceinline__ void load_a_t_planes(
      A (&a)[MT], const float* s, int plane, int ld, int m0, int k0,
      int lane) {
    const int gid = lane >> 2, tig = lane & 3;
    const float* p = s + (k0 + tig) * ld + m0 + gid;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      load_t(a[mi].hi, p + mi * 16, ld);
      load_t(a[mi].lo, p + plane + mi * 16, ld);
    }
  }
  // a0 .. a3 of an A fragment read across, `q` at [k0 + tig][m0 + gid]
  static __device__ __forceinline__ void load_t(uint32_t (&r)[4],
                                                const float* q, int ld) {
    r[0] = __float_as_uint(q[0]);
    r[1] = __float_as_uint(q[8]);
    r[2] = __float_as_uint(q[4 * ld]);
    r[3] = __float_as_uint(q[4 * ld + 8]);
  }

  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float sum_out(float acc) { return acc; }
  static __device__ __forceinline__ void store2(float* p, float v0, float v1) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  }
};

// Tile widths of type T: a k-step's channels, and the padded rows of a
// tile read k-contiguous (ldmatrix: 16 bytes of padding put 8 rows on 8
// distinct 16-byte bank groups) or read across (`LDT`: rows 8 elements
// longer, which at f32 puts each plain load's 32 lanes on 32 banks and at
// bf16 is the same 16 bytes).
template <typename T>
struct Tiles {
  static constexpr int N = Prec<T>::N;
  static constexpr int BK = RUNS_K * N;        // 64 bf16, 32 f32
  static constexpr int PAD = 16 / sizeof(T);   // 8 bf16, 4 f32
  static constexpr int LDK = BK + PAD;         // 144 bytes
  static constexpr int LDT = BK + 8;           // wgrad's column tile
};

// A block of kThreads: its warps, those along a tile's width beside 2
// along its rows, and the runs a thread gathers of a k-step's 64 rows x 8.
template <int kThreads_>
struct Block {
  static constexpr int kThreads = kThreads_;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kWarpsN = kThreads / 64;
  static constexpr int kRuns = BM * RUNS_K / kThreads;
};

// The block for an output tile BN wide: 512 threads at BN 256 so that no
// thread holds more than 32 accumulators, else 256.
template <int BN>
using Shape = Block<BN == 256 ? 512 : 256>;

struct Geom {
  int rows, h, w, c, cout, ho, wo, kh, kw, sh, sw, ph, pw, dh, dw, dg;
  int taps, cv, cg;             // K, C / N, C / dg
  int tiles_x, tiles, patches;  // patches along Wo, of an item, in all
};

// Patch p's first output pixel: its item, row and column.
struct Patch {
  int n, y, x;
};

__device__ __forceinline__ Patch patch_of(const Geom& g, int p) {
  const int t = p % g.tiles;
  return {p / g.tiles, (t / g.tiles_x) * PATCH, (t % g.tiles_x) * PATCH};
}

// the patch numbered after pt: item-major, then row-major over the map
__device__ __forceinline__ void next_patch(const Geom& g, Patch& pt) {
  pt.x += PATCH;
  if (pt.x < g.wo) return;
  pt.x = 0;
  pt.y += PATCH;
  if (pt.y < g.ho) return;
  pt.y = 0;
  ++pt.n;
}

// Output pixel rr (0 .. 63) of a patch: its row of the flattened
// (N, Ho, Wo), its item and unshifted sampling origin, and whether it lies
// inside the map.
struct Pixel {
  int r, n, y, x;
  bool live;
};

__device__ __forceinline__ Pixel pixel_of(const Geom& g, const Patch& pt,
                                          int rr) {
  const int oy = pt.y + rr / PATCH, ox = pt.x + rr % PATCH;
  Pixel px;
  px.live = oy < g.ho && ox < g.wo;
  px.r = px.live ? (pt.n * g.ho + oy) * g.wo + ox : 0;
  px.n = pt.n;
  px.y = oy * g.sh - g.ph;
  px.x = ox * g.sw - g.pw;
  return px;
}

// A thread's part of a k-step (tap, chunk ci of BK channels): its run j of
// N channels, whether C holds it, and the index of (its deform group, the
// tap) among a pixel's dg x K offsets; tap k shifts the sampling origin by
// (k / kw * dh, k % kw * dw). Worked out once a step, not once a sample.
struct Step {
  int ci, og, dy, dx;
  bool in;
};

template <typename T>
__device__ __forceinline__ Step step_of(const Geom& g, int k, int ci, int j) {
  Step st;
  const int c = ci * Tiles<T>::BK + j * Prec<T>::N;
  st.ci = ci;
  st.in = c < g.c;
  st.og = (st.in ? c / g.cg : 0) * g.taps + k;
  st.dy = (k / g.kw) * g.dh;
  st.dx = (k % g.kw) * g.dw;
  return st;
}

// A sample's offset and mask, read a step ahead of its gather; `live`
// false (a pixel outside the map, a channel past C) samples nothing.
struct Coord {
  float dy, dx, m;
  bool live;
};

template <typename T, bool kMask>
__device__ __forceinline__ Coord coord_of(const Geom& g, const Pixel& o,
                                          const Step& st,
                                          const float* __restrict__ offset,
                                          const T* __restrict__ mask) {
  Coord t{0.f, 0.f, 0.f, o.live && st.in};
  if (t.live) {
    const size_t om = (size_t)o.r * g.dg * g.taps + st.og;
    const float2 d = *reinterpret_cast<const float2*>(offset + 2 * om);
    t.dy = d.x;
    t.dx = d.y;
    if constexpr (kMask)
      t.m = Prec<T>::widen(mask[om]);
    else
      t.m = 1.f;
  }
  return t;
}

// Copy `bytes` (a multiple of 2) between global and shared memory, all
// threads; `to_smem` by cp.async where both ends allow 16-byte copies
// (complete at the next cp_async_wait_all), else by plain loads and stores.
__device__ __forceinline__ void copy_span(void* dst, const void* src,
                                          int bytes, bool to_smem, int tid,
                                          int threads) {
  if (((uintptr_t)src & 15) == 0 && ((uintptr_t)dst & 15) == 0 &&
      (bytes & 15) == 0) {
    for (int i = tid; i < bytes / 16; i += threads) {
      if (to_smem)
        cp_async16((char*)dst + 16 * i, (const char*)src + 16 * i, 16);
      else
        ((uint4*)dst)[i] = ((const uint4*)src)[i];
    }
  } else {
    for (int i = tid; i < bytes / 2; i += threads)
      ((uint16_t*)dst)[i] = ((const uint16_t*)src)[i];
  }
}

// A patch's offsets and masks as [64][dg][K][2] f32 and [64][dg][K] T in
// shared memory (no masks without kMask): one contiguous span per pixel
// row of the patch, read (`in` true) or, with their gradients in their
// place, written back.
template <typename T, bool kMask>
__device__ __forceinline__ void move_offsets(float* off_s, T* msk_s,
                                             float* offset, T* mask,
                                             const Patch& pt, const Geom& g,
                                             bool in, int tid, int threads) {
  const int per_px = g.dg * g.taps;
#pragma unroll 1
  for (int ty = 0; ty < PATCH; ++ty) {
    const Pixel first = pixel_of(g, pt, ty * PATCH);
    if (!first.live) continue;
    const int cols = min(PATCH, g.wo - pt.x);
    const size_t at = (size_t)first.r * per_px;
    float* o_s = off_s + ty * PATCH * per_px * 2;
    T* m_s = msk_s + ty * PATCH * per_px;
    const int ob = cols * per_px * 2 * (int)sizeof(float);
    const int mb = cols * per_px * (int)sizeof(T);
    if (in) {
      copy_span(o_s, offset + 2 * at, ob, true, tid, threads);
      if constexpr (kMask) copy_span(m_s, mask + at, mb, true, tid, threads);
    } else {
      copy_span(offset + 2 * at, o_s, ob, false, tid, threads);
      if constexpr (kMask) copy_span(mask + at, m_s, mb, false, tid, threads);
    }
  }
}

template <typename T, bool kMask>
size_t staged_offset_bytes(const Geom& g) {
  return (size_t)BM * g.dg * g.taps *
         (2 * sizeof(float) + (kMask ? sizeof(T) : 0));
}

// One run of one sample, its corner loads in flight.
template <typename T>
struct Sample {
  deform::RawCorners<T> raw;
  deform::Corners cn;
  float m;
};

// Start the gather of a run of x at pixel o's origin shifted by the step's
// tap and the offset t; `xn` is the run's channels of pixel (0, 0) of o's
// item. A dead sample loads nothing and yields zeros.
template <typename T>
__device__ __forceinline__ void issue(Sample<T>& p, const Geom& g,
                                     const typename Prec<T>::Raw* __restrict__ xn,
                                     const Pixel& o, const Step& st,
                                     const Coord& t) {
  using Raw = typename Prec<T>::Raw;
  const float fy = (float)(o.y + st.dy) + t.dy;
  const float fx = (float)(o.x + st.dx) + t.dx;
  deform::Corners& cn = p.cn;
  cn = deform::corners_at(fy, fx, g.h, g.w);
  if (!t.live) cn.in00 = cn.in01 = cn.in10 = cn.in11 = false;
  p.m = t.m;
  // corner (0, 0) and its neighbours one run-row and one pixel-row on; the
  // clamped corners keep these indices within an int
  const Raw zero{};
  const int at = (cn.y0 * g.w + cn.x0) * g.cv, down = g.w * g.cv;
  p.raw.r00 = cn.in00 ? xn[at] : zero;
  p.raw.r01 = cn.in01 ? xn[at + g.cv] : zero;
  p.raw.r10 = cn.in10 ? xn[at + down] : zero;
  p.raw.r11 = cn.in11 ? xn[at + down + g.cv] : zero;
}

// The column value of a gathered run, rounded to T once.
template <typename T>
__device__ __forceinline__ typename Prec<T>::Raw finish(const Sample<T>& p) {
  const deform::Values<T> v = deform::widen_corners<T>(p.raw);
  float out[Prec<T>::N];
  deform::bilinear(v, p.cn, p.m, out);
  return deform::Run<T>::pack(out);
}

// the run `j` of pixel o's item: its channels of pixel (0, 0)
template <typename Raw>
__device__ __forceinline__ const Raw* item_run(const Raw* x, const Geom& g,
                                               const Pixel& o, int j) {
  return x + (size_t)o.n * g.h * g.w * g.cv + j;
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// acc += the products `step` adds into an accumulator: into acc itself,
// or, where Prec<T>::kStepSums, into a fresh one added to acc after
template <typename T, int MT, int NT, typename Step>
__device__ __forceinline__ void accumulate(float (&acc)[MT][NT][4],
                                           Step step) {
  if constexpr (Prec<T>::kStepSums) {
    float part[MT][NT][4];
    zero(part);
    step(part);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  } else {
    step(acc);
  }
}

// ------------------------------------------------------------------ forward

// 128 registers a thread at most: two blocks of 256 threads an SM, or one
// of 512
template <typename T, int BN, bool kMask>
__global__ void __launch_bounds__(Shape<BN>::kThreads, BN == 256 ? 1 : 2)
fwd_kernel(const typename Prec<T>::Raw* __restrict__ x,
           const float* __restrict__ offset, const T* __restrict__ mask,
           const T* __restrict__ wt, const T* __restrict__ bias,
           T* __restrict__ out, Geom g) {
  using S = Shape<BN>;
  using P = Prec<T>;
  using Raw = typename P::Raw;
  constexpr int BK = Tiles<T>::BK, LDK = Tiles<T>::LDK, N = P::N;
  constexpr int WN = BN / S::kWarpsN;  // warp tile 32 x WN
  constexpr int MT = 2, NT = WN / 8, RUNS = S::kRuns;
  constexpr int LDO = BN + 8;
  constexpr int A_PLANE = BM * LDK, A_STAGE = P::kPlanes * A_PLANE;
  extern __shared__ __align__(16) unsigned char smem[];
  T* a_s = (T*)smem;               // [2][planes][BM][LDK]
  T* b_s = a_s + 2 * A_STAGE;      // [2][BN][LDK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
  const int gid = lane >> 2, tig = lane & 3;
  const Patch pt = patch_of(g, blockIdx.x);
  const int nchunk = (g.c + BK - 1) / BK;
  const int steps = g.taps * nchunk;
  const size_t wrow = (size_t)g.taps * g.c;  // a row of wt

  // this thread's slots of a k-step: pixels rr[q], run j
  const int j = tid & 7;
  int rr[RUNS];
  Pixel px[RUNS];
  const Raw* xn[RUNS];
#pragma unroll
  for (int q = 0; q < RUNS; ++q) {
    rr[q] = (tid >> 3) + (S::kThreads / 8) * q;
    px[q] = pixel_of(g, pt, rr[q]);
    xn[q] = item_run(x, g, px[q], j);
  }
  auto step = [&](int s) {
    return step_of<T>(g, s / nchunk, s % nchunk, j);
  };

  auto load_w = [&](int s, int stage) {
    const int k = s / nchunk, c0 = (s % nchunk) * BK;
    T* dst = b_s + stage * BN * LDK;
    for (int i = tid; i < BN * RUNS_K; i += S::kThreads) {
      const int n = i >> 3, c = c0 + (i & 7) * N;
      const bool in = n < g.cout && c < g.c;
      cp_async16(dst + n * LDK + (i & 7) * N,
                 in ? wt + n * wrow + (size_t)k * g.c + c : wt, in ? 16 : 0);
    }
  };
  auto coords = [&](Coord(&t)[RUNS], int s) {
    const Step st = step(s);
#pragma unroll
    for (int q = 0; q < RUNS; ++q)
      t[q] = coord_of<T, kMask>(g, px[q], st, offset, mask);
  };
  auto gather = [&](Sample<T>(&p)[RUNS], int s, const Coord(&t)[RUNS]) {
    const Step st = step(s);
#pragma unroll
    for (int q = 0; q < RUNS; ++q)
      issue<T>(p[q], g, xn[q] + st.ci * RUNS_K, px[q], st, t[q]);
  };
  auto store_a = [&](int stage, const Sample<T>(&p)[RUNS]) {
#pragma unroll
    for (int q = 0; q < RUNS; ++q)
      P::store_run(a_s + stage * A_STAGE + rr[q] * LDK + j * N, A_PLANE,
                   finish<T>(p[q]));
  };

  float acc[MT][NT][4];
  zero(acc);

  // two steps ahead: offsets (s + 2), corner loads (s + 1), products (s)
  Coord next[RUNS];
  Sample<T> p[RUNS];
  coords(next, 0);
  gather(p, 0, next);
  if (steps > 1) coords(next, 1);
  load_w(0, 0);
  cp_async_commit();
  store_a(0, p);

  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s & 1 is complete; stage (s + 1) & 1 is free
    const bool more = s + 1 < steps;
    if (more) {
      load_w(s + 1, (s + 1) & 1);
      cp_async_commit();
      gather(p, s + 1, next);
      if (s + 2 < steps) coords(next, s + 2);
    }
    const T* A_ = a_s + (s & 1) * A_STAGE;
    const T* B_ = b_s + (s & 1) * BN * LDK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += P::KP) {
      typename P::A a[MT];
      typename P::B b[NT];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        P::load_a_planes(a[mi], A_, A_PLANE, LDK, wm * 32 + mi * 16, kk,
                         lane);
      P::template load_b<NT>(b, B_, LDK, wn * WN, kk, lane);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) P::mma(acc[mi][ni], a[mi], b[ni]);
    }
    if (more) store_a((s + 1) & 1, p);
  }

  // epilogue: the sums as T has them, plus the bias; staged; 16-byte
  // stores
  __syncthreads();
  T* o_s = (T*)smem;  // [BM][LDO], over the operand stages
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int col = wn * WN + ni * 8 + tig * 2;
      const float b0 = bias && col < g.cout ? P::widen(bias[col]) : 0.f;
      const float b1 =
          bias && col + 1 < g.cout ? P::widen(bias[col + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mi * 16 + h * 8 + gid;
        float v0 = P::sum_out(acc[mi][ni][2 * h]);
        float v1 = P::sum_out(acc[mi][ni][2 * h + 1]);
        if (bias) {
          v0 += b0;
          v1 += b1;
        }
        P::store2(o_s + row * LDO + col, v0, v1);
      }
    }
  __syncthreads();
  const int runs = g.cout / N;
  Raw* out4 = reinterpret_cast<Raw*>(out);
  for (int i = tid; i < BM * runs; i += S::kThreads) {
    const int r = i / runs, q = i % runs;
    const Pixel o = pixel_of(g, pt, r);
    if (o.live)
      out4[(size_t)o.r * runs + q] =
          *reinterpret_cast<const Raw*>(o_s + r * LDO + q * N);
  }
}

// -------------------------------------------------------------------- dgrad

// dgrad's block and product, a 64 x BK tile a step. At bf16 Shape<BN>'s
// block, 2 warps along the tile's rows and the rest along its BK channels
// while the warp tiles stay 8 channels wide or more. At f32 256 threads
// whatever BN (its accumulators are one step's: few), 4 warps along the
// rows and 2 along the 32 channels: each fragment of the grad_out tile,
// which every step reads whole, is loaded by 2 warps, not 4. And the
// planes of that tile: at f32 and BN 128 split once into hi and lo
// planes, else split as fragments load (at BN 256 shared memory cannot
// hold both planes; at BN 64 they would leave room for one block an SM,
// not two, and cost more than the splits they save).
template <typename T, int BN>
struct DgradShape {
  using S = Block<Prec<T>::kPlanes == 2 ? 256 : Shape<BN>::kThreads>;
  static constexpr int kWarps = S::kWarps;
  static constexpr int kN =
      Prec<T>::kPlanes == 2 ? kWarps / 4
      : kWarps / 2 < Tiles<T>::BK / 8 ? kWarps / 2 : Tiles<T>::BK / 8;
  static constexpr int kM = kWarps / kN;
  static constexpr int kGoPlanes = Prec<T>::kPlanes == 2 && BN == 128 ? 2 : 1;
};

template <typename T, int BN, bool kScatter, bool kMask>
__global__ void __launch_bounds__(DgradShape<T, BN>::S::kThreads,
                                  BN == 256 ? 1 : 2)
dgrad_kernel(const T* __restrict__ go, const typename Prec<T>::Raw* __restrict__ x,
             const float* __restrict__ offset, const T* __restrict__ mask,
             const T* __restrict__ w, float* __restrict__ grad_offset,
             T* __restrict__ grad_mask, float* __restrict__ grad_x, Geom g) {
  using Wp = DgradShape<T, BN>;
  using S = typename Wp::S;
  using P = Prec<T>;
  using Raw = typename P::Raw;
  constexpr int BK = Tiles<T>::BK, LDK = Tiles<T>::LDK, N = P::N;
  constexpr int WM = BM / Wp::kM, WN = BK / Wp::kN;
  constexpr int MT = WM / 16, NT = WN / 8, RUNS = S::kRuns;
  constexpr int LDO = BN + Tiles<T>::PAD, GO_PLANE = BM * LDO;
  extern __shared__ __align__(16) unsigned char smem[];
  T* go_s = (T*)smem;                       // [planes][BM][LDO]
  T* w_s = go_s + Wp::kGoPlanes * GO_PLANE;  // [2][BK][LDO]
  T* gc_s = w_s + 2 * BK * LDO;     // [BM][LDK]
  // the patch's offsets and masks, each replaced by its gradient once read
  float* off_s = (float*)(gc_s + BM * LDK);  // [BM][dg][K][2]
  T* msk_s = (T*)(off_s + BM * g.dg * g.taps * 2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Wp::kN, wn = warp % Wp::kN;
  const int gid = lane >> 2, tig = lane & 3;
  const Patch pt = patch_of(g, blockIdx.x);
  const int nchunk = (g.c + BK - 1) / BK;
  const int steps = g.taps * nchunk;
  const int per_px = g.dg * g.taps;
  const int seg = g.cg / N;  // runs of a deform group: neighbouring lanes

  // this thread's col2im slots: pixels rr[q], run j of a chunk
  const int j = tid & 7;
  const bool writer = (j & (seg - 1)) == 0;  // the first run of its group
  int rr[RUNS];
  Pixel px[RUNS];
  const Raw* xn[RUNS];
#pragma unroll
  for (int q = 0; q < RUNS; ++q) {
    rr[q] = (tid >> 3) + (S::kThreads / 8) * q;
    px[q] = pixel_of(g, pt, rr[q]);
    xn[q] = item_run(x, g, px[q], j);
  }

  // the grad_out tile, zeros outside the map and past Cout
  for (int i = tid; i < BM * (BN / N); i += S::kThreads) {
    const int r = i / (BN / N), q = i % (BN / N);
    const Pixel o = pixel_of(g, pt, r);
    const bool in = o.live && q * N < g.cout;
    cp_async16(go_s + r * LDO + q * N,
               in ? go + (size_t)o.r * g.cout + q * N : go, in ? 16 : 0);
  }
  auto load_w = [&](int s, int stage) {
    const int k = s / nchunk, c0 = (s % nchunk) * BK;
    T* dst = w_s + stage * BK * LDO;
    for (int i = tid; i < BK * (BN / N); i += S::kThreads) {
      const int cc = i / (BN / N), q = i % (BN / N);
      const bool in = c0 + cc < g.c && q * N < g.cout;
      cp_async16(dst + cc * LDO + q * N,
                 in ? w + ((size_t)k * g.c + c0 + cc) * g.cout + q * N : w,
                 in ? 16 : 0);
    }
  };
  move_offsets<T, kMask>(off_s, msk_s, const_cast<float*>(offset),
                         const_cast<T*>(mask), pt, g, true, tid,
                         S::kThreads);
  load_w(0, 0);
  cp_async_commit();

  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // this chunk's weights (and at s 0 the rest) are in
    if constexpr (Wp::kGoPlanes == 2) {
      if (s == 0) {  // the grad_out tile, split in place into two planes
        for (int i = tid; i < BM * (BN / N); i += S::kThreads) {
          T* at = go_s + (i / (BN / N)) * LDO + (i % (BN / N)) * N;
          P::store_run(at, GO_PLANE, *reinterpret_cast<const Raw*>(at));
        }
        __syncthreads();
      }
    }
    if (s + 1 < steps) {
      load_w(s + 1, (s + 1) & 1);
      cp_async_commit();
    }

    // the corner loads of this chunk's samples fly during the products
    const Step st = step_of<T>(g, s / nchunk, s % nchunk, j);
    Sample<T> p[RUNS];
    bool live[RUNS];
    int at[RUNS];
#pragma unroll
    for (int q = 0; q < RUNS; ++q) {
      at[q] = rr[q] * per_px + st.og;
      live[q] = px[q].live && st.in;
      const Coord t{live[q] ? off_s[2 * at[q]] : 0.f,
                    live[q] ? off_s[2 * at[q] + 1] : 0.f,
                    !live[q] ? 0.f : kMask ? P::widen(msk_s[at[q]]) : 1.f,
                    live[q]};
      issue<T>(p[q], g, xn[q] + st.ci * RUNS_K, px[q], st, t);
    }

    // grad_col tile = go (BM x BN) . W[k, chunk, :]^T, stored in T
    const T* W = w_s + (s & 1) * BK * LDO;
    float acc[MT][NT][4];
    zero(acc);
#pragma unroll 4
    for (int kk = 0; kk < BN; kk += P::KP) {
      typename P::A a[MT];
      typename P::B b[NT];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if constexpr (Wp::kGoPlanes == 2)
          P::load_a_planes(a[mi], go_s, GO_PLANE, LDO, wm * WM + mi * 16, kk,
                           lane);
        else
          P::load_a(a[mi], go_s, LDO, wm * WM + mi * 16, kk, lane);
      }
      P::template load_b<NT>(b, W, LDO, wn * WN, kk, lane);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) P::mma(acc[mi][ni], a[mi], b[ni]);
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * WM + mi * 16 + h * 8 + gid;
          const int col = wn * WN + ni * 8 + tig * 2;
          P::store2(gc_s + row * LDK + col, acc[mi][ni][2 * h],
                    acc[mi][ni][2 * h + 1]);
        }
    __syncthreads();  // grad_col staged

    // col2im on the staged grad_col
#pragma unroll
    for (int q = 0; q < RUNS; ++q) {
      float gc[N];
      deform::Run<T>::unpack(
          *reinterpret_cast<const Raw*>(gc_s + rr[q] * LDK + j * N), gc);
      const deform::Values<T> v = deform::widen_corners<T>(p[q].raw);
      const deform::CoordGrad cg = deform::coord_grad<T>(gc, v, p[q].cn);
      const float dfy = deform::segment_sum(cg.dfy, seg);
      const float dfx = deform::segment_sum(cg.dfx, seg);
      if constexpr (kMask) {
        const float value = deform::segment_sum(cg.value, seg);
        if (live[q] && writer) {
          off_s[2 * at[q]] = p[q].m * dfy;  // read once, at this step
          off_s[2 * at[q] + 1] = p[q].m * dfx;
          msk_s[at[q]] = deform::Run<T>::narrow(value);
        }
      } else if (live[q] && writer) {  // no mask: no grad mask, no scaling
        off_s[2 * at[q]] = dfy;
        off_s[2 * at[q] + 1] = dfx;
      }
      if (kScatter && live[q])
        deform::scatter_corners(
            grad_x + (size_t)px[q].n * g.h * g.w * g.c +
                (st.ci * RUNS_K + j) * N,
            p[q].cn, gc, p[q].m, g.w, g.c);
    }
  }
  __syncthreads();  // every gradient of the patch is staged
  move_offsets<T, kMask>(off_s, msk_s, grad_offset, grad_mask, pt, g, false,
                         tid, S::kThreads);
}

// -------------------------------------------------------------------- wgrad

template <typename T, int BN, bool kMask>
__global__ void __launch_bounds__(Shape<BN>::kThreads, BN == 256 ? 1 : 2)
wgrad_kernel(const T* __restrict__ go, const typename Prec<T>::Raw* __restrict__ x,
             const float* __restrict__ offset, const T* __restrict__ mask,
             float* __restrict__ partial, int split_patches, Geom g) {
  using S = Shape<BN>;
  using P = Prec<T>;
  using Raw = typename P::Raw;
  constexpr int BK = Tiles<T>::BK, LDC = Tiles<T>::LDT, N = P::N;
  constexpr int WM = BK / 2, WN = BN / S::kWarpsN;  // warp tile WM x WN
  constexpr int MT = WM / 16, NT = WN / 8, RUNS = S::kRuns;
  constexpr int LDO = BN + 8;
  constexpr int C_PLANE = BM * LDC, C_STAGE = P::kPlanes * C_PLANE;
  extern __shared__ __align__(16) unsigned char smem[];
  T* col_s = (T*)smem;               // [2][planes][BM][LDC]
  T* go_s = col_s + 2 * C_STAGE;     // [2][BM][LDO]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
  const int gid = lane >> 2, tig = lane & 3;
  const int nchunk = (g.c + BK - 1) / BK;
  const int k = blockIdx.x / nchunk, c0 = (blockIdx.x % nchunk) * BK;
  const int p_begin = blockIdx.y * split_patches;
  const int steps = max(0, min(g.patches - p_begin, split_patches));
  // the first (tap, chunk) also sums grad out's columns: grad bias
  const bool bias_sums = blockIdx.x == 0 && tid < g.cout;

  // this thread's slots of a patch: pixels rr[q], run j of the chunk
  const int j = tid & 7;
  const Step st = step_of<T>(g, k, c0 / BK, j);
  int rr[RUNS];
#pragma unroll
  for (int q = 0; q < RUNS; ++q) rr[q] = (tid >> 3) + (S::kThreads / 8) * q;

  auto coords = [&](Coord(&t)[RUNS], const Patch& pt) {
#pragma unroll
    for (int q = 0; q < RUNS; ++q)
      t[q] = coord_of<T, kMask>(g, pixel_of(g, pt, rr[q]), st, offset,
                                mask);
  };
  auto gather = [&](Sample<T>(&p)[RUNS], const Patch& pt,
                    const Coord(&t)[RUNS]) {
#pragma unroll
    for (int q = 0; q < RUNS; ++q) {
      const Pixel o = pixel_of(g, pt, rr[q]);
      issue<T>(p[q], g, item_run(x, g, o, c0 / N + j), o, st, t[q]);
    }
  };
  auto load_go = [&](const Patch& pt, int stage) {
    T* dst = go_s + stage * BM * LDO;
    for (int i = tid; i < BM * (BN / N); i += S::kThreads) {
      const int r = i / (BN / N), q = i % (BN / N);
      const Pixel o = pixel_of(g, pt, r);
      const bool in = o.live && q * N < g.cout;
      cp_async16(dst + r * LDO + q * N,
                 in ? go + (size_t)o.r * g.cout + q * N : go, in ? 16 : 0);
    }
  };
  auto store_col = [&](int stage, const Sample<T>(&p)[RUNS]) {
#pragma unroll
    for (int q = 0; q < RUNS; ++q)
      P::store_run(col_s + stage * C_STAGE + rr[q] * LDC + j * N, C_PLANE,
                   finish<T>(p[q]));
  };

  float acc[MT][NT][4];
  zero(acc);
  float bias_sum = 0.f;

  if (steps > 0) {
    // two patches ahead: offsets (s + 2, patch pc), corner loads and the
    // grad_out tile (s + 1, patch pg), products (s)
    Patch pc = patch_of(g, p_begin), pg = pc;
    Coord next[RUNS];
    Sample<T> p[RUNS];
    coords(next, pc);
    gather(p, pg, next);
    if (steps > 1) {
      next_patch(g, pc);
      coords(next, pc);
    }
    load_go(pg, 0);
    cp_async_commit();
    store_col(0, p);

    for (int s = 0; s < steps; ++s) {
      cp_async_wait_all();
      __syncthreads();
      const bool more = s + 1 < steps;
      if (more) {
        next_patch(g, pg);
        load_go(pg, (s + 1) & 1);
        cp_async_commit();
        gather(p, pg, next);
        if (s + 2 < steps) {
          next_patch(g, pc);
          coords(next, pc);
        }
      }
      const T* A_ = col_s + (s & 1) * C_STAGE;
      const T* B_ = go_s + (s & 1) * BM * LDO;
      if (bias_sums) {  // rows in order; zeros outside the map
#pragma unroll 8
        for (int r = 0; r < BM; ++r) bias_sum += P::widen(B_[r * LDO + tid]);
      }
      accumulate<T>(acc, [&](float(&sum)[MT][NT][4]) {
#pragma unroll
        for (int kk = 0; kk < BM; kk += P::KP) {
          typename P::A a[MT];
          typename P::B b[NT];
          P::template load_a_t_planes<MT>(a, A_, C_PLANE, LDC, wm * WM, kk,
                                          lane);
          P::template load_b_t<NT>(b, B_, LDO, wn * WN, kk, lane);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int ni = 0; ni < NT; ++ni)
              P::mma(sum[mi][ni], a[mi], b[ni]);
        }
      });
      if (more) store_col((s + 1) & 1, p);
    }
  }

  // this slice's partial of rows (k, c0 .. c0 + BK - 1) x Cout, and of
  // grad bias, the row after the last (tap, channel)
  float* out = partial + (size_t)blockIdx.y * (g.taps * g.c + 1) * g.cout;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cc = c0 + wm * WM + mi * 16 + h * 8 + gid;
        const int col = wn * WN + ni * 8 + tig * 2;
        if (cc < g.c && col < g.cout)
          *reinterpret_cast<float2*>(
              out + ((size_t)k * g.c + cc) * g.cout + col) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
  if (bias_sums) out[(size_t)g.taps * g.c * g.cout + tid] = bias_sum;
}

// grad_w[i] = partial[0][i] + partial[1][i] + ..., in this order
__global__ void __launch_bounds__(256)
wgrad_sum_kernel(const float* __restrict__ partial, float* __restrict__ grad_w,
                 int splits, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = partial[i];
  for (int t = 1; t < splits; ++t) s += partial[(size_t)t * n + i];
  grad_w[i] = s;
}

// ------------------------------------------------------------------ launches

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The shape rules of the kernels (ops/dcn.py raises on each by name first).
template <typename T>
bool supported(const Geom& g, bool backward) {
  constexpr int N = Prec<T>::N;
  const int seg = g.dg > 0 && g.c % g.dg == 0 ? g.c / g.dg / N : 0;
  return g.rows > 0 && g.ho > 0 && g.wo > 0 && g.rows % (g.ho * g.wo) == 0 &&
         g.c % N == 0 && g.dg > 0 && g.c % g.dg == 0 &&
         (g.c / g.dg) % N == 0 && g.cout % 8 == 0 && g.cout > 0 &&
         g.cout <= 256 && g.dg * g.taps <= MAX_STAGED &&
         (!backward || (seg <= 8 && (seg & (seg - 1)) == 0));
}

inline int tile_width(int cout) {
  return cout <= 64 ? 64 : cout <= 128 ? 128 : 256;
}

template <typename T>
Geom geom_of(int rows, int h, int w, int c, int cout, int ho, int wo, int kh,
             int kw, int sh, int sw, int ph, int pw, int dh, int dw, int dg) {
  Geom g{rows, h, w, c, cout, ho, wo, kh, kw, sh, sw, ph, pw, dh, dw, dg};
  g.taps = kh * kw;
  g.cv = c / Prec<T>::N;
  g.cg = dg > 0 ? c / dg : 0;
  g.tiles_x = (wo + PATCH - 1) / PATCH;
  g.tiles = g.tiles_x * ((ho + PATCH - 1) / PATCH);
  g.patches = ho > 0 && wo > 0 ? rows / (ho * wo) * g.tiles : 0;
  return g;
}

// let `kernel` take `smem` bytes of dynamic shared memory (above 48 KB)
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int BN>
int fwd(const void* x, const void* offset, const void* mask, const void* wt,
        const void* bias, void* out, const Geom& g, cudaStream_t stream) {
  const size_t smem =
      (size_t)2 * (Prec<T>::kPlanes * BM + BN) * Tiles<T>::LDK * sizeof(T);
  // no mask (K5): the kernels that read none
  auto kernel = mask ? fwd_kernel<T, BN, true> : fwd_kernel<T, BN, false>;
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<g.patches, Shape<BN>::kThreads, smem, stream>>>(
      (const typename Prec<T>::Raw*)x, (const float*)offset, (const T*)mask,
      (const T*)wt, (const T*)bias, (T*)out, g);
  return (int)cudaGetLastError();
}

template <typename T, int BN, bool kScatter>
int dgrad(const void* go, const void* x, const void* offset, const void* mask,
          const void* w, void* grad_offset, void* grad_mask, void* grad_x,
          const Geom& g, cudaStream_t stream) {
  const size_t smem =
      ((size_t)(DgradShape<T, BN>::kGoPlanes * BM + 2 * Tiles<T>::BK) *
           (BN + Tiles<T>::PAD) +
       BM * Tiles<T>::LDK) * sizeof(T) +
      (mask ? staged_offset_bytes<T, true>(g)
            : staged_offset_bytes<T, false>(g));
  auto kernel = mask ? dgrad_kernel<T, BN, kScatter, true>
                     : dgrad_kernel<T, BN, kScatter, false>;
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<g.patches, DgradShape<T, BN>::S::kThreads, smem, stream>>>(
      (const T*)go, (const typename Prec<T>::Raw*)x, (const float*)offset,
      (const T*)mask, (const T*)w, (float*)grad_offset, (T*)grad_mask,
      (float*)grad_x, g);
  return (int)cudaGetLastError();
}

template <typename T, int BN>
int wgrad(const void* go, const void* x, const void* offset, const void* mask,
          void* partial, int splits, int split_patches, const Geom& g,
          cudaStream_t stream) {
  const size_t smem = (size_t)2 * BM *
                      (Prec<T>::kPlanes * Tiles<T>::LDT + BN + 8) *
                      sizeof(T);
  auto kernel =
      mask ? wgrad_kernel<T, BN, true> : wgrad_kernel<T, BN, false>;
  if (int err = allow_smem(kernel, smem)) return err;
  const dim3 grid(g.taps * ((g.c + Tiles<T>::BK - 1) / Tiles<T>::BK), splits);
  kernel<<<grid, Shape<BN>::kThreads, smem, stream>>>(
      (const T*)go, (const typename Prec<T>::Raw*)x, (const float*)offset,
      (const T*)mask, (float*)partial, split_patches, g);
  return (int)cudaGetLastError();
}

// The entry points' bodies; each .cu names them. Pointers are device
// pointers of contiguous tensors (x, wt, weight, go and out 16-byte
// aligned; offset 8-byte aligned); bias may be null, and so may mask (no
// mask: a mask of ones, DCNv1), dgrad's grad_mask then too; the stream is a
// cudaStream_t. The geometry: rows = N * Ho * Wo, the input map H x W x C,
// Cout, the output map Ho x Wo, the kernel kh x kw, stride, padding,
// dilation, deform groups. Each returns cudaErrorInvalidValue for a shape
// the kernels do not take, else cudaGetLastError() after its launch. The
// forward writes out (rows, Cout); dgrad writes grad_offset and, with a
// mask, grad_mask whole (with grad_x it also adds into grad_x, zeroed by the
// caller);
// wgrad writes the partials of `splits` slices of `split_patches` 8 x 8
// output patches each (patches numbered item-major, then row-major over
// the map; every patch in one slice), (K * C + 1) x Cout floats a slice,
// grad weight's rows and then grad bias; the sum adds the slices' n floats
// into grad_w.
template <typename T>
int fwd_launch(const void* x, const void* offset, const void* mask,
               const void* wt, const void* bias, void* out, const Geom& g,
               void* stream) {
  if (!supported<T>(g, false) || !aligned16(x) || !aligned16(wt) ||
      !aligned16(out) || ((uintptr_t)offset & 7))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile_width(g.cout)) {
    case 64: return fwd<T, 64>(x, offset, mask, wt, bias, out, g, s);
    case 128: return fwd<T, 128>(x, offset, mask, wt, bias, out, g, s);
    default: return fwd<T, 256>(x, offset, mask, wt, bias, out, g, s);
  }
}

template <typename T>
int dgrad_launch(const void* go, const void* x, const void* offset,
                 const void* mask, const void* w, void* grad_offset,
                 void* grad_mask, void* grad_x, const Geom& g, void* stream) {
  if (!supported<T>(g, true) || !aligned16(go) || !aligned16(x) ||
      !aligned16(w) || ((uintptr_t)offset & 7) || (mask && !grad_mask))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define MDCN_DGRAD(BN)                                                       \
  (grad_x ? dgrad<T, BN, true>(go, x, offset, mask, w, grad_offset,          \
                               grad_mask, grad_x, g, s)                      \
          : dgrad<T, BN, false>(go, x, offset, mask, w, grad_offset,         \
                                grad_mask, nullptr, g, s))
  switch (tile_width(g.cout)) {
    case 64: return MDCN_DGRAD(64);
    case 128: return MDCN_DGRAD(128);
    default: return MDCN_DGRAD(256);
  }
#undef MDCN_DGRAD
}

template <typename T>
int wgrad_launch(const void* go, const void* x, const void* offset,
                 const void* mask, void* partial, int splits,
                 int split_patches, const Geom& g, void* stream) {
  if (!supported<T>(g, false) || !aligned16(go) || !aligned16(x) ||
      ((uintptr_t)offset & 7) || splits < 1 || split_patches < 1 ||
      (long long)splits * split_patches < g.patches)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile_width(g.cout)) {
    case 64: return wgrad<T, 64>(go, x, offset, mask, partial, splits,
                                 split_patches, g, s);
    case 128: return wgrad<T, 128>(go, x, offset, mask, partial, splits,
                                   split_patches, g, s);
    default: return wgrad<T, 256>(go, x, offset, mask, partial, splits,
                                  split_patches, g, s);
  }
}

inline int wgrad_sum_launch(const void* partial, void* grad_w, int splits,
                            int n, void* stream) {
  if (splits < 1 || n < 1) return (int)cudaErrorInvalidValue;
  wgrad_sum_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)partial, (float*)grad_w, splits, n);
  return (int)cudaGetLastError();
}

}  // namespace mdcn_fused

// The geometry arguments of every fused entry point, and the Geom they make.
#define FUSED_ARGS                                                           \
  int rows, int h, int w, int c, int cout, int ho, int wo, int kh, int kw,   \
      int sh, int sw, int ph, int pw, int dh, int dw, int dg, void *stream
#define FUSED_GEOM(T)                                                        \
  mdcn_fused::geom_of<T>(rows, h, w, c, cout, ho, wo, kh, kw, sh, sw, ph,    \
                         pw, dh, dw, dg)
