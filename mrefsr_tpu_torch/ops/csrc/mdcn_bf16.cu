// K2 at bf16, fused: the modulated deformable conv (DCNv2, conv groups 1,
// with a mask) whose deformable-im2col columns never reach device memory,
// forward and backward, with the products on the tensor cores.
//
// Replaces mrefsr_tpu/ops/dcn.py::_mdcn_slab_scan (dcn.py:111-160) at bf16,
// and the derivative JAX's autodiff takes through it. Like that scan, which
// contracts each tap's gathered slab at once (einsum with
// preferred_element_type=f32, :142-144) so that "im2col never
// materializes", these kernels gather a tile of columns into shared memory
// and contract it there with mma.sync. For output row r = (n, ho, wo), tap
// k = (ky, kx), input channel c of deform group g = c / cg:
//     col[r, k, c] = bf16(mask[r, g, k] * bilinear(x[n, :, :, c], fy, fx))
//     fy = ho*sh - ph + ky*dh + offset[r, g, k, 0]   (f32, as mdcn.cu)
// rounded to bf16 once, as mdcn.cu's im2col stores it; then
//   forward  out[r, o]  = bf16(bf16(sum_{k,c} col[r,k,c] W[k,c,o]) + bias[o])
//   dgrad    gcol[r,k,c] = bf16(sum_o go[r, o] W[k, c, o]), and from it
//            mdcn.cu's col2im arithmetic: grad offset (f32) and grad mask
//            (bf16) summed over the group's channels, grad x (f32,
//            atomic) in the _scatter variant;
//   wgrad    gW[k*C + c, o] = sum_r col[r, k, c] go[r, o]   (f32), and
//            grad bias gb[o] = sum_r go[r, o]                  (f32)
// with every sum over (k, c), o or r in f32 on the tensor cores. The
// forward and dgrad round where torch.mm of the plain version (ops/dcn.py)
// rounds and where JAX's vjp rounds the sampled slab's cotangent
// (dot_general with preferred_element_type f32, then a convert to bf16);
// they differ from it only in the order of the f32 sums. wgrad writes one
// f32 partial per slice of rows and a second kernel adds the slices in a
// fixed order: no float atomics, so grad weight and grad bias, like grad
// offset and grad mask (one writer each), are the same from run to run.
//
// Layouts (contiguous): x (N, H, W, C) bf16; offset (N, Ho, Wo, dg, K, 2)
// f32 as (dy, dx); mask (N, Ho, Wo, dg, K) bf16; the weight HWIO
// (K * C, Cout) bf16 for dgrad and transposed, wt (Cout, K * C), for the
// forward (its B operand wants k contiguous); go and out (rows, Cout) bf16;
// grad_offset, grad_mask, grad_x as offset, mask and x; partial
// (splits, K * C + 1, Cout) f32, grad weight's rows and then grad bias.
//
// Bound on the H100 (989 TFLOP/s dense bf16, 3.35 TB/s): bytes. One CUFED5
// request's forward (3 scales, N = 5) is 2 * rows * 9C * Cout = 276 GFLOP,
// 0.28 ms at the tensor cores' peak, against 1.7 GB of essential bytes
// (mostly the f32 offsets: 0.72 GB at relu1_1), 0.52 ms; so mma.sync at
// half its peak keeps up and wgmma is not needed yet. What the kernels
// save is the column matrix: rows * 9C bf16 written and read back
// (1.44 GB at relu1_1 of a request), and in the backward the recomputed
// columns and the grad_col matrix, each as large. What they cannot save
// is the gather: 4 corner loads of 16 bytes for every 8 channels of a
// sample, a warp's 32 lanes touching up to 32 cache lines at 8 channels a
// deform group (relu1_1: each lane of a pixel samples its own group). At
// the training relu1_1 layer (ops/mdcn_bf16_ablation.py on the H100) the
// backward's time falls most where the gather is cut out (wgrad 1.38 ->
// 0.58 ms, dgrad 1.46 -> 0.94), next where wgrad's scattered offset reads
// are (-> 0.92); cutting the products or the operand tiles saves 0.1-0.35
// ms a kernel. At C 256 the products weigh most (dgrad 0.76 -> 0.47).
//
// Design. m16n8k16 products with ldmatrix fragments, two warps along the
// 64 rows of a tile and the rest along its width. A block's 64 output rows
// are an 8 x 8 patch of output pixels of one item, not 64 pixels of one
// image row, so that its samples fall in a window of about
// (8 + 2 * reach)^2 pixels rather than a strip 64 pixels wide. A step
// gathers 64 pixels x 64 channels; the deform group is taken per run of 8
// channels (a step spans 8 groups at cg 8). A step's corner loads are
// issued before the products they can overlap and widened into shared
// memory after.
//  - Forward: a block owns a patch and all of Cout (BN = Cout rounded up
//    to 64, 128 or 256, padded with zeros; 256 threads, 512 at BN 256 so
//    that no thread holds more than 32 accumulators), so each sample is
//    gathered once. The k loop runs over (tap, 64 channels), 2 runs a
//    thread (1 at 512): the offsets and mask of step s + 2 are read and
//    the corner loads of step s + 1 issued before step s's products. The
//    weight tile comes by cp.async; both double-buffered in rows padded to
//    72 bf16 (no bank conflicts). The f32 sums are rounded, the bias added
//    and rounded, staged in shared memory and stored as 16-byte NHWC runs.
//  - dgrad: a block owns a patch; its grad_out tile (64 x BN) and its
//    offsets and masks (one coalesced copy: scattered 8-byte reads and
//    writes of them cost as much L2 traffic as the gather) stay in shared
//    memory. For each (tap, 64 channels) it multiplies the tile by
//    W[k, chunk, :]^T (the next chunk's weight rows load meanwhile),
//    rounds to bf16 into shared memory and runs the col2im arithmetic on
//    it: a thread per (pixel, run of 8 channels), the group's cg / 8 runs
//    neighbouring lanes summed by shuffles, one writer per (pixel, group,
//    tap), whose gradients replace the staged offset and mask just read;
//    they are written back, coalesced, at the end.
//  - wgrad: a block owns (tap, 64 channels) x all of Cout and a slice of
//    patches, one patch a step: the gathered column tile and the grad_out
//    tile are staged row-major and read transposed (ldmatrix.trans) as
//    A = col^T and B = go; the blocks of the first (tap, chunk) also sum
//    the grad_out tile's columns, rows in order, for grad bias. The
//    wrapper cuts the slices from the shapes alone, so the sum of the
//    slices' partials (a last small kernel, in order) does not depend on
//    the card.
//  - Index arithmetic: a block walks its patches, and a k-step's tap and
//    deform group are worked out once a step, so that a sample costs no
//    integer division.
// Requires C, cg and Cout multiples of 8, Cout <= 256, dg * K <= 144, for
// the backward cg / 8 a power of two <= 8, x, weight, go and out 16-byte
// aligned and the offset 8-byte aligned; the wrapper (ops/dcn.py) checks
// each by name and the launches check them again.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "deform_bilinear.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using R = deform::Run<bf16>;  // 8 channels, one uint4
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait_all;
using tc::ldmatrix_x2;
using tc::ldmatrix_x4;
using tc::ldmatrix_x4_trans;
using tc::mma_bf16;

constexpr int PATCH = 8;           // a block's rows: an 8 x 8 pixel patch
constexpr int BM = PATCH * PATCH;  // 64
constexpr int BK = 64;             // channels of a k-step or a chunk
constexpr int LDK = BK + 8;        // a staged row, in bf16 (144 bytes)
constexpr int MAX_STAGED = 144;    // dg * K of a block's staged offsets

// The block shape for an output tile BN wide: two warps along the 64 rows
// (or, in wgrad, channels), the rest along BN (or, in dgrad, the 64
// channels); 512 threads at BN 256 so that no thread holds more than 32
// accumulators, else 256. A k-step gathers 64 rows x 8 runs of 8
// channels: kRuns per thread.
template <int BN>
struct Shape {
  static constexpr int kThreads = BN == 256 ? 512 : 256;
  static constexpr int kWarpsN = kThreads / 64;
  static constexpr int kRuns = BM * (BK / 8) / kThreads;
};

struct Geom {
  int rows, h, w, c, cout, ho, wo, kh, kw, sh, sw, ph, pw, dh, dw, dg;
  int taps, cv, cg;             // K, C / 8, C / dg
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

// A thread's part of a k-step (tap, 64-channel chunk ci): its run j of 8
// channels, whether C holds it, and the index of (its deform group, the
// tap) among a pixel's dg x K offsets; tap k shifts the sampling origin by
// (k / kw * dh, k % kw * dw). Worked out once a step, not once a sample.
struct Step {
  int ci, og, dy, dx;
  bool in;
};

__device__ __forceinline__ Step step_of(const Geom& g, int k, int ci, int j) {
  Step st;
  const int c = ci * BK + j * 8;
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

__device__ __forceinline__ Coord coord_of(const Geom& g, const Pixel& o,
                                          const Step& st,
                                          const float* __restrict__ offset,
                                          const bf16* __restrict__ mask) {
  Coord t{0.f, 0.f, 0.f, o.live && st.in};
  if (t.live) {
    const size_t om = (size_t)o.r * g.dg * g.taps + st.og;
    const float2 d = *reinterpret_cast<const float2*>(offset + 2 * om);
    t.dy = d.x;
    t.dx = d.y;
    t.m = __bfloat162float(mask[om]);
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

// A patch's offsets and masks as [64][dg][K][2] f32 and [64][dg][K] bf16
// in shared memory: one contiguous span per pixel row of the patch, read
// (`in` true) or, with their gradients in their place, written back.
__device__ __forceinline__ void move_offsets(float* off_s, bf16* msk_s,
                                             float* offset, bf16* mask,
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
    bf16* m_s = msk_s + ty * PATCH * per_px;
    const int ob = cols * per_px * 2 * (int)sizeof(float);
    const int mb = cols * per_px * (int)sizeof(bf16);
    if (in) {
      copy_span(o_s, offset + 2 * at, ob, true, tid, threads);
      copy_span(m_s, mask + at, mb, true, tid, threads);
    } else {
      copy_span(offset + 2 * at, o_s, ob, false, tid, threads);
      copy_span(mask + at, m_s, mb, false, tid, threads);
    }
  }
}

size_t staged_offset_bytes(const Geom& g) {
  return (size_t)BM * g.dg * g.taps * (2 * sizeof(float) + sizeof(bf16));
}

// One run of one sample, its corner loads in flight.
struct Sample {
  deform::RawCorners<bf16> raw;
  deform::Corners cn;
  float m;
};

// Start the gather of a run of x at pixel o's origin shifted by the step's
// tap and the offset t; `xn` is the run's channels of pixel (0, 0) of o's
// item. A dead sample loads nothing and yields zeros.
__device__ __forceinline__ void issue(Sample& p, const Geom& g,
                                     const uint4* __restrict__ xn,
                                     const Pixel& o, const Step& st,
                                     const Coord& t) {
  const float fy = (float)(o.y + st.dy) + t.dy;
  const float fx = (float)(o.x + st.dx) + t.dx;
  deform::Corners& cn = p.cn;
  cn = deform::corners_at(fy, fx, g.h, g.w);
  if (!t.live) cn.in00 = cn.in01 = cn.in10 = cn.in11 = false;
  p.m = t.m;
  // corner (0, 0) and its neighbours one run-row and one pixel-row on; the
  // clamped corners keep these indices within an int
  const uint4 zero{};
  const int at = (cn.y0 * g.w + cn.x0) * g.cv, down = g.w * g.cv;
  p.raw.r00 = cn.in00 ? xn[at] : zero;
  p.raw.r01 = cn.in01 ? xn[at + g.cv] : zero;
  p.raw.r10 = cn.in10 ? xn[at + down] : zero;
  p.raw.r11 = cn.in11 ? xn[at + down + g.cv] : zero;
}

// The column value of a gathered run, rounded to bf16 once.
__device__ __forceinline__ uint4 finish(const Sample& p) {
  const deform::Values<bf16> v = deform::widen_corners<bf16>(p.raw);
  float out[8];
  deform::bilinear(v, p.cn, p.m, out);
  return R::pack(out);
}

// the run `j` of pixel o's item: its channels of pixel (0, 0)
__device__ __forceinline__ const uint4* item_run(const uint4* x,
                                                 const Geom& g,
                                                 const Pixel& o, int j) {
  return x + (size_t)o.n * g.h * g.w * g.cv + j;
}

// A fragments of rows m0 .. m0 + 15, k0 .. k0 + 15 of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int ld, int m0, int k0, int lane) {
  ldmatrix_x4(a, s + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 +
                     (lane >> 4) * 8);
}

// B fragments of NT tiles of 8 columns n0 .. n0 + 8 NT - 1 over k0 .. k0 +
// 15, from a tile stored n-major (k contiguous).
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&b)[NT][2], const bf16* s,
                                       int ld, int n0, int k0, int lane) {
  if constexpr (NT % 2 == 0) {
#pragma unroll
    for (int ni = 0; ni < NT; ni += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, s + (n0 + ni * 8 + (lane & 7) + (lane >> 4) * 8) * ld +
                         k0 + ((lane >> 3) & 1) * 8);
      b[ni][0] = r[0];
      b[ni][1] = r[1];
      b[ni + 1][0] = r[2];
      b[ni + 1][1] = r[3];
    }
  } else {
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
      ldmatrix_x2(b[ni], s + (n0 + ni * 8 + (lane & 7)) * ld + k0 +
                             ((lane >> 3) & 1) * 8);
  }
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

// ------------------------------------------------------------------ forward

// 128 registers a thread at most: two blocks of 256 threads an SM, or one
// of 512
template <int BN>
__global__ void __launch_bounds__(Shape<BN>::kThreads, BN == 256 ? 1 : 2)
mdcn_fused_fwd_kernel(const uint4* __restrict__ x,
                      const float* __restrict__ offset,
                      const bf16* __restrict__ mask,
                      const bf16* __restrict__ wt,
                      const bf16* __restrict__ bias, bf16* __restrict__ out,
                      Geom g) {
  using S = Shape<BN>;
  constexpr int WN = BN / S::kWarpsN;  // warp tile 32 x WN
  constexpr int MT = 2, NT = WN / 8, RUNS = S::kRuns;
  constexpr int LDO = BN + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a_s = (bf16*)smem;         // [2][BM][LDK]
  bf16* b_s = a_s + 2 * BM * LDK;  // [2][BN][LDK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
  const int gid = lane >> 2, tig = lane & 3;
  const Patch pt = patch_of(g, blockIdx.x);
  const int nchunk = (g.c + BK - 1) / BK;
  const int steps = g.taps * nchunk;
  const size_t wrow = (size_t)g.taps * g.c;  // a row of wt

  // this thread's slots of a k-step: pixels rr[q], run j of 8 channels
  const int j = tid & 7;
  int rr[RUNS];
  Pixel px[RUNS];
  const uint4* xn[RUNS];
#pragma unroll
  for (int q = 0; q < RUNS; ++q) {
    rr[q] = (tid >> 3) + (S::kThreads / 8) * q;
    px[q] = pixel_of(g, pt, rr[q]);
    xn[q] = item_run(x, g, px[q], j);
  }
  auto step = [&](int s) { return step_of(g, s / nchunk, s % nchunk, j); };

  auto load_w = [&](int s, int stage) {
    const int k = s / nchunk, c0 = (s % nchunk) * BK;
    bf16* dst = b_s + stage * BN * LDK;
    for (int i = tid; i < BN * (BK / 8); i += S::kThreads) {
      const int n = i >> 3, c = c0 + (i & 7) * 8;
      const bool in = n < g.cout && c < g.c;
      cp_async16(dst + n * LDK + (i & 7) * 8,
                 in ? wt + n * wrow + (size_t)k * g.c + c : wt, in ? 16 : 0);
    }
  };
  auto coords = [&](Coord(&t)[RUNS], int s) {
    const Step st = step(s);
#pragma unroll
    for (int q = 0; q < RUNS; ++q)
      t[q] = coord_of(g, px[q], st, offset, mask);
  };
  auto gather = [&](Sample(&p)[RUNS], int s, const Coord(&t)[RUNS]) {
    const Step st = step(s);
#pragma unroll
    for (int q = 0; q < RUNS; ++q)
      issue(p[q], g, xn[q] + st.ci * 8, px[q], st, t[q]);
  };
  auto store_a = [&](int stage, const Sample(&p)[RUNS]) {
#pragma unroll
    for (int q = 0; q < RUNS; ++q)
      *reinterpret_cast<uint4*>(a_s + stage * BM * LDK + rr[q] * LDK +
                                j * 8) = finish(p[q]);
  };

  float acc[MT][NT][4];
  zero(acc);

  // two steps ahead: offsets (s + 2), corner loads (s + 1), products (s)
  Coord next[RUNS];
  Sample p[RUNS];
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
    const bf16* A = a_s + (s & 1) * BM * LDK;
    const bf16* B = b_s + (s & 1) * BN * LDK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        load_a(a[mi], A, LDK, wm * 32 + mi * 16, kk, lane);
      load_b<NT>(b, B, LDK, wn * WN, kk, lane);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    if (more) store_a((s + 1) & 1, p);
  }

  // epilogue: round, add the bias, round; stage the tile; 16-byte stores
  __syncthreads();
  bf16* o_s = (bf16*)smem;  // [BM][LDO], over the operand stages
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int col = wn * WN + ni * 8 + tig * 2;
      const float b0 = bias && col < g.cout ? __bfloat162float(bias[col]) : 0.f;
      const float b1 =
          bias && col + 1 < g.cout ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mi * 16 + h * 8 + gid;
        float v0 = __bfloat162float(__float2bfloat16_rn(acc[mi][ni][2 * h]));
        float v1 =
            __bfloat162float(__float2bfloat16_rn(acc[mi][ni][2 * h + 1]));
        if (bias) {
          v0 += b0;
          v1 += b1;
        }
        *reinterpret_cast<__nv_bfloat162*>(o_s + row * LDO + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  __syncthreads();
  const int runs = g.cout / 8;
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (int i = tid; i < BM * runs; i += S::kThreads) {
    const int r = i / runs, q = i % runs;
    const Pixel o = pixel_of(g, pt, r);
    if (o.live)
      out4[(size_t)o.r * runs + q] =
          *reinterpret_cast<const uint4*>(o_s + r * LDO + q * 8);
  }
}

// -------------------------------------------------------------------- dgrad

template <int BN, bool kScatter>
__global__ void __launch_bounds__(Shape<BN>::kThreads, BN == 256 ? 1 : 2)
mdcn_fused_dgrad_kernel(const bf16* __restrict__ go,
                        const uint4* __restrict__ x,
                        const float* __restrict__ offset,
                        const bf16* __restrict__ mask,
                        const bf16* __restrict__ w,
                        float* __restrict__ grad_offset,
                        bf16* __restrict__ grad_mask,
                        float* __restrict__ grad_x, Geom g) {
  using S = Shape<BN>;
  constexpr int WN = BK / S::kWarpsN;  // warp tile 32 pixels x WN channels
  constexpr int MT = 2, NT = WN / 8, RUNS = S::kRuns;
  constexpr int LDO = BN + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* go_s = (bf16*)smem;         // [BM][LDO]
  bf16* w_s = go_s + BM * LDO;      // [2][BK][LDO]
  bf16* gc_s = w_s + 2 * BK * LDO;  // [BM][LDK]
  // the patch's offsets and masks, each replaced by its gradient once read
  float* off_s = (float*)(gc_s + BM * LDK);  // [BM][dg][K][2]
  bf16* msk_s = (bf16*)(off_s + BM * g.dg * g.taps * 2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
  const int gid = lane >> 2, tig = lane & 3;
  const Patch pt = patch_of(g, blockIdx.x);
  const int nchunk = (g.c + BK - 1) / BK;
  const int steps = g.taps * nchunk;
  const int per_px = g.dg * g.taps;
  const int seg = g.cg / 8;  // runs of a deform group: neighbouring lanes

  // this thread's col2im slots: pixels rr[q], run j of a chunk
  const int j = tid & 7;
  const bool writer = (j & (seg - 1)) == 0;  // the first run of its group
  int rr[RUNS];
  Pixel px[RUNS];
  const uint4* xn[RUNS];
#pragma unroll
  for (int q = 0; q < RUNS; ++q) {
    rr[q] = (tid >> 3) + (S::kThreads / 8) * q;
    px[q] = pixel_of(g, pt, rr[q]);
    xn[q] = item_run(x, g, px[q], j);
  }

  // the grad_out tile, zeros outside the map and past Cout
  for (int i = tid; i < BM * (BN / 8); i += S::kThreads) {
    const int r = i / (BN / 8), q = i % (BN / 8);
    const Pixel o = pixel_of(g, pt, r);
    const bool in = o.live && q * 8 < g.cout;
    cp_async16(go_s + r * LDO + q * 8,
               in ? go + (size_t)o.r * g.cout + q * 8 : go, in ? 16 : 0);
  }
  auto load_w = [&](int s, int stage) {
    const int k = s / nchunk, c0 = (s % nchunk) * BK;
    bf16* dst = w_s + stage * BK * LDO;
    for (int i = tid; i < BK * (BN / 8); i += S::kThreads) {
      const int cc = i / (BN / 8), q = i % (BN / 8);
      const bool in = c0 + cc < g.c && q * 8 < g.cout;
      cp_async16(dst + cc * LDO + q * 8,
                 in ? w + ((size_t)k * g.c + c0 + cc) * g.cout + q * 8 : w,
                 in ? 16 : 0);
    }
  };
  move_offsets(off_s, msk_s, const_cast<float*>(offset),
               const_cast<bf16*>(mask), pt, g, true, tid, S::kThreads);
  load_w(0, 0);
  cp_async_commit();

  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // this chunk's weights (and at s 0 the rest) are in
    if (s + 1 < steps) {
      load_w(s + 1, (s + 1) & 1);
      cp_async_commit();
    }

    // the corner loads of this chunk's samples fly during the products
    const Step st = step_of(g, s / nchunk, s % nchunk, j);
    Sample p[RUNS];
    bool live[RUNS];
    int at[RUNS];
#pragma unroll
    for (int q = 0; q < RUNS; ++q) {
      at[q] = rr[q] * per_px + st.og;
      live[q] = px[q].live && st.in;
      const Coord t{live[q] ? off_s[2 * at[q]] : 0.f,
                    live[q] ? off_s[2 * at[q] + 1] : 0.f,
                    live[q] ? __bfloat162float(msk_s[at[q]]) : 0.f, live[q]};
      issue(p[q], g, xn[q] + st.ci * 8, px[q], st, t);
    }

    // grad_col tile = go (BM x BN) . W[k, chunk, :]^T, rounded to bf16
    const bf16* W = w_s + (s & 1) * BK * LDO;
    float acc[MT][NT][4];
    zero(acc);
#pragma unroll 4
    for (int kk = 0; kk < BN; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        load_a(a[mi], go_s, LDO, wm * 32 + mi * 16, kk, lane);
      load_b<NT>(b, W, LDO, wn * WN, kk, lane);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + mi * 16 + h * 8 + gid;
          const int col = wn * WN + ni * 8 + tig * 2;
          *reinterpret_cast<__nv_bfloat162*>(gc_s + row * LDK + col) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h],
                                    acc[mi][ni][2 * h + 1]);
        }
    __syncthreads();  // grad_col staged

    // col2im on the staged grad_col
#pragma unroll
    for (int q = 0; q < RUNS; ++q) {
      float gc[8];
      R::unpack(*reinterpret_cast<const uint4*>(gc_s + rr[q] * LDK + j * 8),
                gc);
      const deform::Values<bf16> v = deform::widen_corners<bf16>(p[q].raw);
      const deform::CoordGrad cg = deform::coord_grad<bf16>(gc, v, p[q].cn);
      const float dfy = deform::segment_sum(cg.dfy, seg);
      const float dfx = deform::segment_sum(cg.dfx, seg);
      const float value = deform::segment_sum(cg.value, seg);
      if (live[q] && writer) {
        off_s[2 * at[q]] = p[q].m * dfy;  // read once, at this step
        off_s[2 * at[q] + 1] = p[q].m * dfx;
        msk_s[at[q]] = __float2bfloat16_rn(value);
      }
      if (kScatter && live[q])
        deform::scatter_corners(
            grad_x + (size_t)px[q].n * g.h * g.w * g.c + (st.ci * 8 + j) * 8,
            p[q].cn, gc, p[q].m, g.w, g.c);
    }
  }
  __syncthreads();  // every gradient of the patch is staged
  move_offsets(off_s, msk_s, grad_offset, grad_mask, pt, g, false, tid,
               S::kThreads);
}

// -------------------------------------------------------------------- wgrad

template <int BN>
__global__ void __launch_bounds__(Shape<BN>::kThreads, BN == 256 ? 1 : 2)
mdcn_fused_wgrad_kernel(const bf16* __restrict__ go,
                        const uint4* __restrict__ x,
                        const float* __restrict__ offset,
                        const bf16* __restrict__ mask,
                        float* __restrict__ partial, int split_patches,
                        Geom g) {
  using S = Shape<BN>;
  constexpr int WN = BN / S::kWarpsN;  // warp tile 32 channels x WN
  constexpr int MT = 2, NT = WN / 8, RUNS = S::kRuns;
  constexpr int LDO = BN + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* col_s = (bf16*)smem;          // [2][BM][LDK]
  bf16* go_s = col_s + 2 * BM * LDK;  // [2][BM][LDO]

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
  const Step st = step_of(g, k, c0 / BK, j);
  int rr[RUNS];
#pragma unroll
  for (int q = 0; q < RUNS; ++q) rr[q] = (tid >> 3) + (S::kThreads / 8) * q;

  auto coords = [&](Coord(&t)[RUNS], const Patch& pt) {
#pragma unroll
    for (int q = 0; q < RUNS; ++q)
      t[q] = coord_of(g, pixel_of(g, pt, rr[q]), st, offset, mask);
  };
  auto gather = [&](Sample(&p)[RUNS], const Patch& pt,
                    const Coord(&t)[RUNS]) {
#pragma unroll
    for (int q = 0; q < RUNS; ++q) {
      const Pixel o = pixel_of(g, pt, rr[q]);
      issue(p[q], g, item_run(x, g, o, c0 / 8 + j), o, st, t[q]);
    }
  };
  auto load_go = [&](const Patch& pt, int stage) {
    bf16* dst = go_s + stage * BM * LDO;
    for (int i = tid; i < BM * (BN / 8); i += S::kThreads) {
      const int r = i / (BN / 8), q = i % (BN / 8);
      const Pixel o = pixel_of(g, pt, r);
      const bool in = o.live && q * 8 < g.cout;
      cp_async16(dst + r * LDO + q * 8,
                 in ? go + (size_t)o.r * g.cout + q * 8 : go, in ? 16 : 0);
    }
  };
  auto store_col = [&](int stage, const Sample(&p)[RUNS]) {
#pragma unroll
    for (int q = 0; q < RUNS; ++q)
      *reinterpret_cast<uint4*>(col_s + stage * BM * LDK + rr[q] * LDK +
                                j * 8) = finish(p[q]);
  };

  float acc[MT][NT][4];
  zero(acc);
  float bias_sum = 0.f;

  if (steps > 0) {
    // two patches ahead: offsets (s + 2, patch pc), corner loads and the
    // grad_out tile (s + 1, patch pg), products (s)
    Patch pc = patch_of(g, p_begin), pg = pc;
    Coord next[RUNS];
    Sample p[RUNS];
    coords(next, pc);
    gather(p, pg, next);
    if (steps > 1) {
      next_patch(g, pc);
      coords(next, pc);
    }
    load_go(pg, 0);
    cp_async_commit();
    store_col(0, p);

    const int lrow = lane & 7, lhi = (lane >> 3) & 1, lmat = lane >> 4;
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
      const bf16* A = col_s + (s & 1) * BM * LDK;
      const bf16* B = go_s + (s & 1) * BM * LDO;
      if (bias_sums) {  // rows in order; zeros outside the map
#pragma unroll 8
        for (int r = 0; r < BM; ++r)
          bias_sum += __bfloat162float(B[r * LDO + tid]);
      }
#pragma unroll
      for (int kk = 0; kk < BM; kk += 16) {
        uint32_t a[MT][4], b[NT][2];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          ldmatrix_x4_trans(a[mi], A + (kk + lrow + lmat * 8) * LDK +
                                       wm * 32 + mi * 16 + lhi * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, B + (kk + lrow + lhi * 8) * LDO + wn * WN +
                                   np * 16 + lmat * 8);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
            mma_bf16(acc[mi][ni], a[mi], b[ni]);
      }
      if (more) store_col((s + 1) & 1, p);
    }
  }

  // this slice's partial of rows (k, c0 .. c0 + 63) x Cout, and of grad
  // bias, the row after the last (tap, channel)
  float* out = partial + (size_t)blockIdx.y * (g.taps * g.c + 1) * g.cout;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cc = c0 + wm * 32 + mi * 16 + h * 8 + gid;
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
mdcn_fused_wgrad_sum_kernel(const float* __restrict__ partial,
                            float* __restrict__ grad_w, int splits, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = partial[i];
  for (int t = 1; t < splits; ++t) s += partial[(size_t)t * n + i];
  grad_w[i] = s;
}

// ------------------------------------------------------------------ launches

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The shape rules of the kernels (ops/dcn.py raises on each by name first).
bool supported(const Geom& g, bool backward) {
  const int seg = g.dg > 0 && g.c % g.dg == 0 ? g.c / g.dg / 8 : 0;
  return g.rows > 0 && g.ho > 0 && g.wo > 0 && g.rows % (g.ho * g.wo) == 0 &&
         g.c % 8 == 0 && g.dg > 0 && g.c % g.dg == 0 &&
         (g.c / g.dg) % 8 == 0 && g.cout % 8 == 0 && g.cout > 0 &&
         g.cout <= 256 && g.dg * g.taps <= MAX_STAGED &&
         (!backward || (seg <= 8 && (seg & (seg - 1)) == 0));
}

int tile_width(int cout) { return cout <= 64 ? 64 : cout <= 128 ? 128 : 256; }

Geom geom_of(int rows, int h, int w, int c, int cout, int ho, int wo, int kh,
             int kw, int sh, int sw, int ph, int pw, int dh, int dw, int dg) {
  Geom g{rows, h, w, c, cout, ho, wo, kh, kw, sh, sw, ph, pw, dh, dw, dg};
  g.taps = kh * kw;
  g.cv = c / 8;
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

template <int BN>
int fwd(const void* x, const void* offset, const void* mask, const void* wt,
        const void* bias, void* out, const Geom& g, cudaStream_t stream) {
  const size_t smem = (size_t)2 * (BM + BN) * LDK * sizeof(bf16);
  auto kernel = mdcn_fused_fwd_kernel<BN>;
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<g.patches, Shape<BN>::kThreads, smem, stream>>>(
      (const uint4*)x, (const float*)offset, (const bf16*)mask,
      (const bf16*)wt, (const bf16*)bias, (bf16*)out, g);
  return (int)cudaGetLastError();
}

template <int BN, bool kScatter>
int dgrad(const void* go, const void* x, const void* offset, const void* mask,
          const void* w, void* grad_offset, void* grad_mask, void* grad_x,
          const Geom& g, cudaStream_t stream) {
  const size_t smem =
      ((size_t)(BM + 2 * BK) * (BN + 8) + BM * LDK) * sizeof(bf16) +
      staged_offset_bytes(g);
  auto kernel = mdcn_fused_dgrad_kernel<BN, kScatter>;
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<g.patches, Shape<BN>::kThreads, smem, stream>>>(
      (const bf16*)go, (const uint4*)x, (const float*)offset,
      (const bf16*)mask, (const bf16*)w, (float*)grad_offset,
      (bf16*)grad_mask, (float*)grad_x, g);
  return (int)cudaGetLastError();
}

template <int BN>
int wgrad(const void* go, const void* x, const void* offset, const void* mask,
          void* partial, int splits, int split_patches, const Geom& g,
          cudaStream_t stream) {
  const size_t smem = (size_t)2 * BM * (LDK + BN + 8) * sizeof(bf16);
  auto kernel = mdcn_fused_wgrad_kernel<BN>;
  if (int err = allow_smem(kernel, smem)) return err;
  const dim3 grid(g.taps * ((g.c + BK - 1) / BK), splits);
  kernel<<<grid, Shape<BN>::kThreads, smem, stream>>>(
      (const bf16*)go, (const uint4*)x, (const float*)offset,
      (const bf16*)mask, (float*)partial, split_patches, g);
  return (int)cudaGetLastError();
}

int dgrad_launch(const void* go, const void* x, const void* offset,
                 const void* mask, const void* w, void* grad_offset,
                 void* grad_mask, void* grad_x, const Geom& g, void* stream) {
  if (!supported(g, true) || !aligned16(go) || !aligned16(x) ||
      !aligned16(w) || ((uintptr_t)offset & 7))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define DGRAD(BN)                                                             \
  (grad_x ? dgrad<BN, true>(go, x, offset, mask, w, grad_offset, grad_mask,  \
                            grad_x, g, s)                                    \
          : dgrad<BN, false>(go, x, offset, mask, w, grad_offset, grad_mask, \
                             nullptr, g, s))
  switch (tile_width(g.cout)) {
    case 64: return DGRAD(64);
    case 128: return DGRAD(128);
    default: return DGRAD(256);
  }
#undef DGRAD
}

}  // namespace

// Pointers are device pointers of contiguous tensors (x, wt, weight, go and
// out 16-byte aligned; offset 8-byte aligned); bias may be null; the stream
// is a cudaStream_t. The geometry: rows = N * Ho * Wo, the input map H x W x
// C, Cout, the output map Ho x Wo, the kernel kh x kw, stride, padding,
// dilation, deform groups. Each returns cudaErrorInvalidValue for a shape
// the kernels do not take, else cudaGetLastError() after its launch. The
// forward writes out (rows, Cout); dgrad writes grad_offset and grad_mask
// whole (its _scatter variant also adds into grad_x, zeroed by the caller);
// wgrad writes the partials of `splits` slices of `split_patches` 8 x 8
// output patches each (patches numbered item-major, then row-major over the
// map; every patch in one slice), (K * C + 1) x Cout floats a slice, grad
// weight's rows and then grad bias; the sum adds the slices' n floats into
// grad_w.
#define FUSED_ARGS                                                           \
  int rows, int h, int w, int c, int cout, int ho, int wo, int kh, int kw,   \
      int sh, int sw, int ph, int pw, int dh, int dw, int dg, void *stream
#define FUSED_GEOM                                                           \
  geom_of(rows, h, w, c, cout, ho, wo, kh, kw, sh, sw, ph, pw, dh, dw, dg)

extern "C" {

int mdcn_fused_fwd_bf16_launch(const void* x, const void* offset,
                               const void* mask, const void* wt,
                               const void* bias, void* out, FUSED_ARGS) {
  const Geom g = FUSED_GEOM;
  if (!supported(g, false) || !aligned16(x) || !aligned16(wt) ||
      !aligned16(out) || ((uintptr_t)offset & 7))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile_width(cout)) {
    case 64: return fwd<64>(x, offset, mask, wt, bias, out, g, s);
    case 128: return fwd<128>(x, offset, mask, wt, bias, out, g, s);
    default: return fwd<256>(x, offset, mask, wt, bias, out, g, s);
  }
}

int mdcn_fused_dgrad_bf16_launch(const void* go, const void* x,
                                 const void* offset, const void* mask,
                                 const void* weight, void* grad_offset,
                                 void* grad_mask, FUSED_ARGS) {
  return dgrad_launch(go, x, offset, mask, weight, grad_offset, grad_mask,
                      nullptr, FUSED_GEOM, stream);
}

int mdcn_fused_dgrad_scatter_bf16_launch(const void* go, const void* x,
                                         const void* offset,
                                         const void* mask, const void* weight,
                                         void* grad_offset, void* grad_mask,
                                         void* grad_x, FUSED_ARGS) {
  if (!grad_x) return (int)cudaErrorInvalidValue;
  return dgrad_launch(go, x, offset, mask, weight, grad_offset, grad_mask,
                      grad_x, FUSED_GEOM, stream);
}

int mdcn_fused_wgrad_bf16_launch(const void* go, const void* x,
                                 const void* offset, const void* mask,
                                 void* partial, int splits,
                                 int split_patches, FUSED_ARGS) {
  const Geom g = FUSED_GEOM;
  if (!supported(g, false) || !aligned16(go) || !aligned16(x) ||
      ((uintptr_t)offset & 7) || splits < 1 || split_patches < 1 ||
      (long long)splits * split_patches < g.patches)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile_width(cout)) {
    case 64: return wgrad<64>(go, x, offset, mask, partial, splits,
                              split_patches, g, s);
    case 128: return wgrad<128>(go, x, offset, mask, partial, splits,
                                split_patches, g, s);
    default: return wgrad<256>(go, x, offset, mask, partial, splits,
                               split_patches, g, s);
  }
}

int mdcn_fused_wgrad_sum_bf16_launch(const void* partial, void* grad_w,
                                     int splits, int n, void* stream) {
  if (splits < 1 || n < 1) return (int)cudaErrorInvalidValue;
  mdcn_fused_wgrad_sum_kernel<<<(n + 255) / 256, 256, 0,
                                (cudaStream_t)stream>>>(
      (const float*)partial, (float*)grad_w, splits, n);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
