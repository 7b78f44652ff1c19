// The fused deformable convs: the modulated deformable conv (DCNv2) and
// DCNv1 whose deformable-im2col columns never reach device memory, forward
// and backward, with the products on the tensor cores: one tile walk for
// two element types T. mdcn_bf16.cu instantiates it at bf16, mdcn_fused.cu
// at f32 (3xTF32); each says what it replaces and what bounds it. It runs
// three TPU kernels of the JAX package: K2 (conv groups 1, a mask), K3
// (conv groups > 1: the wrapper, ops/dcn.py, hands the walk a
// block-diagonal weight, exact zeros off the groups' blocks) and K5 (DCNv1:
// a null mask, read as a mask of ones).
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
//            channels, grad x (f32, vector reductions) in the _scatter
//            variant;
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
// (K * C, Cout) T for dgrad and transposed, wt (Cout, K * C), for the
// forward (its B operand wants k contiguous), at f32 each as its TF32 hi
// and lo planes (2, ...), split once a call (mdcn_wgmma.cuh's
// split_kernel); go and out (rows, Cout) T; grad_offset, grad_mask, grad_x
// as offset, mask and x (grad_x f32); partial (splits, K * C + 1, Cout)
// f32, grad weight's rows and then grad bias.
//
// Design. A block's 64 output rows are an 8 x 8 patch of output pixels of
// one item, not 64 pixels of one image row, so that its samples fall in a
// window of about (8 + 2 * reach)^2 pixels rather than a strip 64 pixels
// wide. A thread gathers runs of 16 bytes of one pixel's channels (N = 8
// bf16 or 4 f32), and a k-step or chunk is 8 runs: BK = 64 bf16 or 32 f32
// channels, 128 bytes whatever T; the deform group is taken per run (a step
// spans 8 groups at cg 8 bf16).
//  - Forward, dgrad and wgrad run on Hopper's own units: wgmma fed by TMA
//    and by producer warps through mbarrier rings, the walk of
//    mdcn_wgmma.cuh, which says how.
//  - The _scatter dgrad also adds each sample's grad_col run, times its
//    corner weights and mask, into grad x at its four corners: f32 in
//    device memory, whatever T, so the additions land by atomics, their
//    order (the last bits of grad x) changing from run to run. Each is one
//    16-byte vector reduction (REDG.E.ADD.F32x4) for each 4 channels and
//    corner, where a scalar atomic took each channel; at bf16 a lane's 8
//    channels are one 32-byte sector, which the lanes of a pair trade
//    halves of so that each of their two reductions covers one sector
//    whole (deform_bilinear.cuh's scatter_corners). What bounds it is the
//    L2's rate of reductions: at C 64 and dg 8 a (pixel, tap, corner) is
//    16 of them whatever T. A window of grad x in shared memory, summing a
//    patch's corners before they leave, does not pay on the H100: a shared
//    f32 atomicAdd is a compare-and-swap loop (ATOMS.CAST.SPIN), and a
//    window made the kernel slower at every shape and offset spread tried
//    (PERF.md, Findings).
//  - wgrad: a block owns (tap, BK channels) x all of Cout and a slice of
//    patches; the blocks of the first (tap, chunk) also sum the grad_out
//    tile's columns, rows in order, for grad bias. The wrapper cuts the
//    slices from the shapes alone, so the sum of the slices' partials (a
//    last small kernel, wgrad_sum_kernel, in order) does not depend on the
//    card.
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
#include "tc_helpers.cuh"

namespace mdcn_fused {

using bf16 = __nv_bfloat16;
using tc::cp_async16;
using tc::cp_async_commit;

constexpr int PATCH = 8;           // a block's rows: an 8 x 8 pixel patch
constexpr int BM = PATCH * PATCH;  // 64
constexpr int RUNS_K = 8;          // runs of 16 bytes in a k-step or chunk
constexpr int MAX_STAGED = 144;    // dg * K of a block's staged offsets

// What depends on the element type: the run and tile widths, the
// fragments and products, and where a value is rounded.
template <typename T>
struct Prec;

// bf16: the forward's sum and gcol rounded to bf16.
template <>
struct Prec<bf16> {
  using Raw = uint4;
  static constexpr int N = 8;   // channels of a run

  // The gathered column tile: one plane, stored as it is.
  static constexpr int kPlanes = 1;
  static __device__ __forceinline__ void store_run(bf16* p, int, uint4 v) {
    *reinterpret_cast<uint4*>(p) = v;
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

// f32: 3xTF32, three products lo*hi + hi*lo + hi*hi (small terms first)
// of operands split by tc::split_tf32: a gathered column tile split once as
// it is stored (kPlanes), grad out and the weight as mdcn_wgmma.cuh says;
// nothing rounded below f32.
template <>
struct Prec<float> {
  using Raw = float4;
  static constexpr int N = 4;

  // The gathered column tile, which the tensor cores read: split once, as
  // it is stored, into a hi plane and, `plane` elements on, a lo plane.
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

  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float sum_out(float acc) { return acc; }
  static __device__ __forceinline__ void store2(float* p, float v0, float v1) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  }
};

// Tile widths of type T: a k-step's channels, and 16 bytes of padding of
// a staged row (dgrad's gcol).
template <typename T>
struct Tiles {
  static constexpr int N = Prec<T>::N;
  static constexpr int BK = RUNS_K * N;        // 64 bf16, 32 f32
  static constexpr int PAD = 16 / sizeof(T);   // 8 bf16, 4 f32
};

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

// The corners of a sample of pixel o at its origin shifted by the step's
// tap and the offset t; a dead sample has none inside the map.
__device__ __forceinline__ deform::Corners corners_of(const Geom& g,
                                                      const Pixel& o,
                                                      const Step& st,
                                                      const Coord& t) {
  const float fy = (float)(o.y + st.dy) + t.dy;
  const float fx = (float)(o.x + st.dx) + t.dx;
  deform::Corners cn = deform::corners_at(fy, fx, g.h, g.w);
  if (!t.live) cn.in00 = cn.in01 = cn.in10 = cn.in11 = false;
  return cn;
}

// Start the gather of a run of x at the sample's corners; `xn` is the
// run's channels of pixel (0, 0) of o's item. A dead sample loads nothing
// and yields zeros.
template <typename T>
__device__ __forceinline__ void issue(Sample<T>& p, const Geom& g,
                                     const typename Prec<T>::Raw* __restrict__ xn,
                                     const Pixel& o, const Step& st,
                                     const Coord& t) {
  using Raw = typename Prec<T>::Raw;
  deform::Corners& cn = p.cn;
  cn = corners_of(g, o, st, t);
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

// ------------------------------------------------------------- wgrad's sum

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
