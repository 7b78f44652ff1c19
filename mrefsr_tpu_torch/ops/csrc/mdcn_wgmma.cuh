// The Hopper walk of the fused deformable conv's forward and dgrad (K2, K3
// and K5; mdcn_fused.cuh says what they compute and holds what this walk
// shares with wgrad): wgmma fed by TMA (the weight, grad out) and by
// producer warps (the gathered columns), through mbarrier rings in shared
// memory. mdcn_fused.cu instantiates it at f32 (3xTF32), mdcn_bf16.cu at
// bf16.
//
// A block is producer warpgroups and then one consumer warpgroup, one
// block an SM; it walks 8 x 8 patches of output pixels, 64 rows (one
// wgmma M tile) each.
//  - Forward. Persistent: block b walks patches b, b + gridDim.x, ..., its
//    steps one sequence through the ring, so that the producers gather the
//    next patch while the consumer finishes this one. The consumer owns all
//    of Cout (N = BN: Cout rounded up to 64, 128 or 256) in BN / 2 f32
//    accumulators a thread, so each sample is gathered once. A patch's k
//    loop runs over (tap, BK channels), BK = 128 bytes (64 bf16, 32 f32),
//    chunk-major. The producers (512 threads, one run of 16 bytes of a
//    step's 64 x 8 each; 256 with two at BN 256, whose 128 accumulators need
//    the 168 registers of a 384-thread block: ptxas compiles every warp
//    within the one cap __launch_bounds__ gives, and setmaxnreg cannot
//    raise it) read the offsets and mask two steps ahead and keep the next
//    step's corner loads in flight while they blend, mask and round to T
//    (at f32 split into hi and lo planes) this one's, and store each run
//    where the canonical K-major 128-byte swizzle puts it (`sw128`: a
//    pixel's BK channels are one 128-byte row, its 16-byte chunk j at j ^
//    (row & 7)) in a ring of stages (96 KB: the rest of the SM's 256 KB is
//    L1 for the corner loads); one of them loads the step's weight tile by
//    TMA, a box over wt seen as (C, K, Cout[, plane]) whose rows past C or
//    Cout come as zeros, counted on the stage's full barrier. The consumer
//    runs the step's products (bf16: wgmma.m64nBNk16, four a step; f32:
//    three m64nBNk8 a k group, lo*hi + hi*lo + hi*hi, as K1 f32), keeps
//    one wgmma group in flight and hands each stage back on its empty
//    barrier; its epilogue is Prec<T>'s rounding and the bias, stored from
//    the registers.
//  - dgrad. Persistent too, 256 or 512 producers (DgradRoles). The
//    consumer's step is 64 channels of one tap (N 64: one chunk at bf16,
//    two at f32, whose A fragments it then loads and splits once for
//    both): gcol[64, 64] = go[64, Cout] . W[k, channels, :]^T, M 64, K =
//    Cout, both operands K-major. The grad-out tile comes once a patch, by
//    4-D TMA boxes over go seen as (Cout, Wo, Ho, N), 128 bytes of Cout
//    each (zeros outside the map); W's rows come by TMA in slabs of 128
//    bytes of Cout into a ring, refilled by the consumer's first thread. At
//    bf16 A is read by descriptor and a step's slabs are one commit group;
//    at f32 A is loaded into registers and split as it loads (A of wgmma
//    may sit in registers; a split copy of the tile does not fit beside the
//    staged offsets at Cout 256), a group a slab, the weight's planes split
//    once a call. The consumer writes gcol, rounded as Prec<T> says, into
//    one of two buffers while the producers run the col2im arithmetic of a
//    step before on the other: corner reloads (the next step's in flight),
//    grad offset and grad mask summed by shuffles with one writer per
//    (pixel, group, tap), and in the _scatter variant the vector reductions
//    of scatter_corners. The patch's offsets and masks are staged in shared
//    memory, the next patch's copied in while this one runs where two
//    copies fit. Grad offset and grad mask keep one writer each and the
//    wgmma sums run in a fixed order: the results are the same from run to
//    run.
// The weight's f32 planes: hi = tf32_rna(w) and lo = w - hi (tc::
// split_tf32), split by split_kernel into a scratch the wrapper allocates
// (a B operand must come from shared memory, so it cannot be split as
// fragments load).
#pragma once
#include <algorithm>

#include "feature_match_wgmma.cuh"
#include "mdcn_fused.cuh"

namespace mdcn_wgmma {

using namespace mdcn_fused;
using fm::desc_sw128;
using fm::mbar_arrive;
using fm::mbar_expect_tx;
using fm::mbar_init;
using fm::mbar_wait;
using fm::smem_u32;
using fm::wgmma_commit;
using fm::wgmma_fence;

constexpr int CONSUMER_WARPS = 4;  // one warpgroup
constexpr int ROW = 128;         // bytes of a swizzled row: BK channels
constexpr int SLAB = BM * ROW;   // a 64-row tile, 128 bytes deep
constexpr int K_STEP = 32;       // bytes of one wgmma's depth
// A block's roles: kProducers threads gathering, RUNS runs of 16 bytes of
// a step's 64 x 8 each, then the consumer warpgroup.
template <int kProducers>
struct Roles {
  static constexpr int PRODUCERS = kProducers;
  static constexpr int PRODUCER_WARPS = kProducers / 32;
  static constexpr int THREADS = kProducers + CONSUMER_WARPS * 32;
  static constexpr int RUNS = BM * RUNS_K / kProducers;
};
template <int BN>
using FwdRoles = Roles<BN == 256 ? 256 : 512>;

// The canonical 128-byte swizzle of a K-major tile of 128-byte rows (what
// TMA writes and a wgmma descriptor of mode 1 reads): the byte offset of
// 16-byte chunk j of row r, the tile 1024-byte aligned.
__device__ __forceinline__ uint32_t sw128(int r, int j) {
  return r * ROW + ((j ^ (r & 7)) << 4);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a barrier of `count` threads, id 1 and up (0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// the box of `map` at the coordinates into shared memory at `dst`, its
// bytes counted on `bar`
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1,
                                       int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(dst),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// --------------------------------------------------------------- products
// d (64 x N f32) = a . b^T + (accumulate ? d : 0), a and b K-major in
// shared memory (descriptors) or a in registers; thread (warp w, lane
// 4 gid + tig) holds d[4 j + e] at row 16 w + gid and d[4 j + 2 + e] at row
// 16 w + gid + 8, column 8 j + 2 tig + e.
__device__ __forceinline__ void tf32_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void tf32_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void tf32_ss(float (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void bf16_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void bf16_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void bf16_ss(float (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// One stage of the forward's products: four k steps of 32 bytes of the A
// tile at `a` (64 rows) and the B tile at `b` (BN rows), each K-major and
// 128-byte swizzled; `first` starts the sums. At f32 each tile's lo plane
// lies `a_plane` / `b_plane` bytes after its hi plane.
template <typename T>
struct Mma;

template <>
struct Mma<bf16> {
  template <int R>
  static __device__ __forceinline__ void stage(float (&d)[R], uint32_t a,
                                               uint32_t b, int, int,
                                               bool first) {
#pragma unroll
    for (int kk = 0; kk < ROW / K_STEP; ++kk)
      bf16_ss(d, desc_sw128(a + kk * K_STEP), desc_sw128(b + kk * K_STEP),
              first && kk == 0 ? 0 : 1);
  }
};

template <>
struct Mma<float> {
  template <int R>
  static __device__ __forceinline__ void stage(float (&d)[R], uint32_t a,
                                               uint32_t b, int a_plane,
                                               int b_plane, bool first) {
#pragma unroll
    for (int kk = 0; kk < ROW / K_STEP; ++kk) {
      const uint32_t ah = a + kk * K_STEP, bh = b + kk * K_STEP;
      tf32_ss(d, desc_sw128(ah + a_plane), desc_sw128(bh),
              first && kk == 0 ? 0 : 1);
      tf32_ss(d, desc_sw128(ah), desc_sw128(bh + b_plane), 1);
      tf32_ss(d, desc_sw128(ah), desc_sw128(bh), 1);
    }
  }
};

// ------------------------------------------------------------------ forward

// The forward's ring at type T and width BN: a stage is the A tile (64
// rows, its planes) and the B tile (BN rows, its planes), as deep as 96 KB
// of shared memory holds (2 stages at least, 6 at most): the SM's 256 KB
// are shared memory and L1 together, and the rest is L1 for the gather's
// corner loads.
template <typename T, int BN>
struct FwdRing {
  static constexpr int PLANES = Prec<T>::kPlanes;
  static constexpr int A_PLANE = SLAB;
  static constexpr int B_PLANE = BN * ROW;
  static constexpr int A_BYTES = PLANES * A_PLANE;
  static constexpr int B_BYTES = PLANES * B_PLANE;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int FIT = 96 * 1024 / STAGE_BYTES;
  static constexpr int STAGES = FIT < 2 ? 2 : FIT < 6 ? FIT : 6;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;
};

// A block's place in its walk: step s (tap k of chunk ci) of patch p,
// whose first output pixel is pt; the block's patches are `stride` apart.
struct Cursor {
  int p, s, k, ci;
  Patch pt;
};

__device__ __forceinline__ Cursor cursor_at(const Geom& g, int p) {
  return {p, 0, 0, 0, patch_of(g, p)};
}

// the next step: the next tap, the next chunk, or the block's next patch
// (past the block's last patch, a place that is never used)
__device__ __forceinline__ void advance(const Geom& g, Cursor& c, int steps,
                                        int stride) {
  if (++c.s == steps) {
    c.s = c.k = c.ci = 0;
    c.p += stride;
    c.pt = patch_of(g, c.p);
  } else if (++c.k == g.taps) {
    c.k = 0;
    ++c.ci;
  }
}

// Persistent: one block an SM, gridDim.x blocks, block b walks patches b,
// b + gridDim.x, ..., its steps one sequence through the ring, so that the
// producers gather the next patch while the consumer finishes this one.
template <typename T, int BN, bool kMask>
__global__ void __launch_bounds__(FwdRoles<BN>::THREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tm_w,
           const typename Prec<T>::Raw* __restrict__ x,
           const float* __restrict__ offset, const T* __restrict__ mask,
           const T* __restrict__ bias, T* __restrict__ out, Geom g) {
  using R = FwdRing<T, BN>;
  using P = Prec<T>;
  using Raw = typename P::Raw;
  constexpr int BK = Tiles<T>::BK, RUNS = FwdRoles<BN>::RUNS;
  constexpr int PRODUCERS = FwdRoles<BN>::PRODUCERS;
  constexpr int PRODUCER_WARPS = FwdRoles<BN>::PRODUCER_WARPS;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[R::STAGES];
  __shared__ __align__(8) uint64_t empty[R::STAGES];
  // the ring, 1024-byte aligned (the swizzle's period)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t ring = raw + pad;
  unsigned char* ring_p = smem_raw + pad;

  const int steps = g.taps * ((g.c + BK - 1) / BK);
  const int stride = gridDim.x;
  const int mine = ((int)blockIdx.x < g.patches)
                       ? (g.patches - 1 - (int)blockIdx.x) / stride + 1
                       : 0;
  const int total = mine * steps;  // the block's steps

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], PRODUCER_WARPS + 1);  // the runs, then the TMA
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < PRODUCERS) {
    const int tid = threadIdx.x, lane = tid & 31;
    // this thread's slots of a step: pixels rr[q], run j
    const int j = tid & 7;
    int rr[RUNS];
#pragma unroll
    for (int q = 0; q < RUNS; ++q) rr[q] = (tid >> 3) + (PRODUCERS / 8) * q;
    auto coords = [&](Coord(&t)[RUNS], const Cursor& c) {
      const Step st = step_of<T>(g, c.k, c.ci, j);
#pragma unroll
      for (int q = 0; q < RUNS; ++q)
        t[q] = coord_of<T, kMask>(g, pixel_of(g, c.pt, rr[q]), st, offset,
                                  mask);
    };
    auto gather = [&](Sample<T>(&p)[RUNS], const Cursor& c,
                      const Coord(&t)[RUNS]) {
      const Step st = step_of<T>(g, c.k, c.ci, j);
#pragma unroll
      for (int q = 0; q < RUNS; ++q) {
        const Pixel o = pixel_of(g, c.pt, rr[q]);
        issue<T>(p[q], g, item_run(x, g, o, j) + st.ci * RUNS_K, o, st,
                 t[q]);
      }
    };
    // step t's weight tile, by TMA into the B part of the stage at a
    auto load_w = [&](int t, int stage, uint32_t a) {
      mbar_expect_tx(&full[stage], R::B_BYTES);
      const int s = t % steps, k = s % g.taps, c0 = (s / g.taps) * BK;
      if constexpr (R::PLANES == 2)
        tma_4d(a + R::A_BYTES, &tm_w, &full[stage], c0, k, 0, 0);
      else
        tma_3d(a + R::A_BYTES, &tm_w, &full[stage], c0, k, 0);
    };

    // offsets two steps ahead, corner loads one step ahead: step t + 1's
    // loads fly while step t is blended and stored, across patches too
    Cursor at_c = cursor_at(g, blockIdx.x), at_g = at_c;
    Coord next[RUNS];
    Sample<T> pa[RUNS], pb[RUNS];
    auto ahead = [&](Sample<T>(&p)[RUNS], int t) {  // step t's loads
      gather(p, at_g, next);
      advance(g, at_g, steps, stride);
      if (t + 1 < total) {
        coords(next, at_c);
        advance(g, at_c, steps, stride);
      }
    };
    if (total > 0) {
      coords(next, at_c);
      advance(g, at_c, steps, stride);
      ahead(pa, 0);
    }
    if (total > 1) ahead(pb, 1);
    auto body = [&](int t, Sample<T>(&cur)[RUNS]) {
      const int stage = t % R::STAGES;
      mbar_wait(&empty[stage], ((t / R::STAGES) & 1) ^ 1);
      const uint32_t a = ring + stage * R::STAGE_BYTES;
      if (tid == 0) load_w(t, stage, a);
      unsigned char* a_p = ring_p + stage * R::STAGE_BYTES;
#pragma unroll
      for (int q = 0; q < RUNS; ++q)
        P::store_run((T*)(a_p + sw128(rr[q], j)), R::A_PLANE / (int)sizeof(T),
                     finish<T>(cur[q]));
      fence_proxy_async();  // the runs, for the tensor cores' reads
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[stage]);
      if (t + 2 < total) ahead(cur, t + 2);
    };
    for (int t = 0; t < total; t += 2) {
      body(t, pa);
      if (t + 1 < total) body(t + 1, pb);
    }
  } else {
    const int ct = threadIdx.x - PRODUCERS, lane = ct & 31, cw = ct >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int t = 0;
    for (int pi = 0; pi < mine; ++pi) {
      for (int s = 0; s < steps; ++s, ++t) {
        const int stage = t % R::STAGES;
        mbar_wait(&full[stage], (t / R::STAGES) & 1);
        const uint32_t a = ring + stage * R::STAGE_BYTES;
        fence_regs(acc);
        wgmma_fence();
        Mma<T>::stage(acc, a, a + R::A_BYTES, R::A_PLANE, R::B_PLANE, s == 0);
        wgmma_commit();
        // one group in flight: the step before this one is read
        wgmma_wait<1>();
        fence_regs(acc);
        if (t > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(t - 1) % R::STAGES]);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);

      // epilogue: the sums as T has them, plus the bias, stored from the
      // registers (4 lanes of a row fill a 32-byte sector at f32, half one
      // at bf16) while the producers gather the next patch
      const Patch pt = patch_of(g, blockIdx.x + pi * stride);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Pixel o = pixel_of(g, pt, cw * 16 + h * 8 + gid);
        if (!o.live) continue;
        T* row = out + (size_t)o.r * g.cout;
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn) {
          const int col = jn * 8 + tig * 2;  // cout is a multiple of 8
          if (col >= g.cout) continue;
          float v0 = P::sum_out(acc[4 * jn + 2 * h]);
          float v1 = P::sum_out(acc[4 * jn + 2 * h + 1]);
          if (bias) {
            v0 += P::widen(bias[col]);
            v1 += P::widen(bias[col + 1]);
          }
          P::store2(row + col, v0, v1);
        }
      }
    }
  }
}

// -------------------------------------------------------------------- dgrad

// dgrad's roles: producers, then the consumer warpgroup, whose first
// thread also keeps the weight ring full by TMA. 512 producers (one run of
// a step each) for the f32 dgrad without grad x up to Cout 128, else 256
// (two runs each). Measured on the H100 at the stage-3 training and EDVR-M
// L1 shapes: 512 are 9-13 % faster there at C 64; 256 are 15 % faster at
// f32 C 256 (the consumer's steps, 8 slabs deep, then weigh more than the
// gather), 3-7 % faster at bf16, and the f32 scatter without a mask (K5)
// spills at 512's 96 registers and runs 30 % slower with them.
template <typename T, int kCout, bool kScatter>
using DgradRoles =
    Roles<sizeof(T) == 4 && kCout < 256 && !kScatter ? 512 : 256>;

// dgrad's tiles. The consumer's step is NC = 64 channels (wgmma N 64):
// one producer step of BK channels at bf16, two at f32, whose A fragments
// it then loads and splits once for both. Its shared memory: the grad-out
// tile (Cout in slabs of 128 bytes), a ring of weight slabs (NC rows of 128
// bytes of Cout, their planes), GC_BUFS gcol buffers of 64 x NC, and one or
// two copies of a patch's offsets and masks (two where they fit: the next
// patch's load while this one's are in use). The launch picks the ring's
// depth, up to MAX_W_STAGES, and the offsets' copies for the shape.
template <typename T>
struct DgradSmem {
  static constexpr int NC = 64;
  static constexpr int CPS = NC / Tiles<T>::BK;  // producer steps a step
  static constexpr int MAX_W_STAGES = Prec<T>::kPlanes == 2 ? 4 : 8;
  static constexpr int GC_BUFS = 2;
  static constexpr int W_STAGE = Prec<T>::kPlanes * NC * ROW;
  static constexpr int LDG = NC + Tiles<T>::PAD;  // a gcol row, 16 B padded
  static constexpr int GC_BYTES = BM * LDG * (int)sizeof(T);
  static __host__ __device__ int slabs(const Geom& g) {
    return (g.cout * (int)sizeof(T) + ROW - 1) / ROW;
  }
  // the fixed part: the grad-out tile, the gcol buffers, the alignment
  static size_t fixed(const Geom& g) {
    return (size_t)slabs(g) * SLAB + GC_BUFS * GC_BYTES + 1024;
  }
};

template <typename T, int BN, bool kScatter, bool kMask>
__global__ void __launch_bounds__(DgradRoles<T, BN, kScatter>::THREADS, 1)
dgrad_kernel(const __grid_constant__ CUtensorMap tm_go,
             const __grid_constant__ CUtensorMap tm_w,
             const typename Prec<T>::Raw* __restrict__ x,
             const float* __restrict__ offset, const T* __restrict__ mask,
             float* __restrict__ grad_offset, T* __restrict__ grad_mask,
             float* __restrict__ grad_x, Geom g, int w_stages,
             int off_bufs) {
  using D = DgradSmem<T>;
  using P = Prec<T>;
  using Raw = typename P::Raw;
  using Ro = DgradRoles<T, BN, kScatter>;
  constexpr int BK = Tiles<T>::BK, NC = D::NC, CPS = D::CPS, LDG = D::LDG;
  constexpr int N = P::N, RUNS = Ro::RUNS, PRODUCERS = Ro::PRODUCERS;
  constexpr int GCB = D::GC_BUFS;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t go_full;
  __shared__ __align__(8) uint64_t w_full[D::MAX_W_STAGES];
  __shared__ __align__(8) uint64_t gc_full[GCB];
  __shared__ __align__(8) uint64_t gc_empty[GCB];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const int slabs = D::slabs(g);
  const uint32_t go_s = raw + pad;           // [slabs][64][128 B]
  const uint32_t w_s = go_s + slabs * SLAB;  // [w_stages][planes][NC][128 B]
  unsigned char* go_p = smem_raw + pad;
  T* gc_s = (T*)(go_p + slabs * SLAB + w_stages * D::W_STAGE);  // [GCB][BM][LDG]
  // the patch's offsets and masks, [off_bufs][BM][dg][K][2] f32 then
  // [BM][dg][K] T each, replaced by their gradients once read
  unsigned char* off_p = (unsigned char*)(gc_s + GCB * BM * LDG);
  const int per_px = g.dg * g.taps;
  const int off_bytes = BM * per_px * (2 * (int)sizeof(float) +
                                       (kMask ? (int)sizeof(T) : 0));

  // a patch's walk, NC channels at a time, chunk-major so that the taps
  // of those channels sample one window of x in a row: consumer step u is
  // tap u % K of channels (u / K) NC ..; producer step s its part h, the
  // chunk of BK channels (u / K) CPS + h (the last NC may hold one chunk)
  const int nchunk = (g.c + BK - 1) / BK;
  const int upt = (nchunk + CPS - 1) / CPS;  // consumer steps a tap
  const int steps = g.taps * nchunk, usteps = g.taps * upt;
  const int paired = nchunk / CPS * CPS * g.taps;  // steps in whole NCs
  const int stride = gridDim.x;
  const int mine = ((int)blockIdx.x < g.patches)
                       ? (g.patches - 1 - (int)blockIdx.x) / stride + 1
                       : 0;
  const int per_patch = usteps * slabs;  // weight slabs a patch
  const int items = mine * per_patch;

  if (threadIdx.x == 0) {
    mbar_init(&go_full, 1);
    for (int s = 0; s < w_stages; ++s) mbar_init(&w_full[s], 1);
#pragma unroll
    for (int b = 0; b < GCB; ++b) {
      mbar_init(&gc_full[b], CONSUMER_WARPS);
      mbar_init(&gc_empty[b], Ro::PRODUCER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < PRODUCERS) {
    const int tid = threadIdx.x, lane = tid & 31;
    const int seg = g.cg / N;  // runs of a deform group: neighbouring lanes
    // this thread's col2im slots: pixels rr[q], run j of a chunk
    const int j = tid & 7;
    const bool writer = (j & (seg - 1)) == 0;  // the first run of its group
    int rr[RUNS];
#pragma unroll
    for (int q = 0; q < RUNS; ++q) rr[q] = (tid >> 3) + (PRODUCERS / 8) * q;
    auto buffer = [&](int pi, float*& off_s, T*& msk_s) {
      off_s = (float*)(off_p + (pi % off_bufs) * off_bytes);
      msk_s = (T*)(off_s + BM * per_px * 2);
    };
    // patch pi's offsets and masks into its buffer, one cp.async group
    auto stage_offsets = [&](int pi) {
      float* off_s;
      T* msk_s;
      buffer(pi, off_s, msk_s);
      move_offsets<T, kMask>(off_s, msk_s, const_cast<float*>(offset),
                             const_cast<T*>(mask),
                             patch_of(g, blockIdx.x + pi * stride), g, true,
                             tid, PRODUCERS);
      cp_async_commit();
    };
    if (mine > 0) stage_offsets(0);
    if (off_bufs == 2 && mine > 1) stage_offsets(1);

    for (int pi = 0; pi < mine; ++pi) {
      // this patch's offsets and masks are in; with two buffers the next
      // patch's copies, issued at the end of the patch before, may fly
      if (off_bufs == 2 && pi + 1 < mine)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      named_sync(1, PRODUCERS);
      float* off_s;
      T* msk_s;
      buffer(pi, off_s, msk_s);
      const Patch pt = patch_of(g, blockIdx.x + pi * stride);
      Pixel px[RUNS];
      const Raw* xn[RUNS];
#pragma unroll
      for (int q = 0; q < RUNS; ++q) {
        px[q] = pixel_of(g, pt, rr[q]);
        xn[q] = item_run(x, g, px[q], j);
      }
      // producer step s: its consumer step u, part h, tap k, chunk ci
      auto place = [&](int s, int& u, int& h, int& k, int& ci) {
        if (s < paired) {
          u = s / CPS;
          h = s - u * CPS;
        } else {  // the last NC channels, one chunk
          u = paired / CPS + (s - paired);
          h = 0;
        }
        k = u % g.taps;
        ci = u / g.taps * CPS + h;
      };
      // step s's corner loads, from the staged offsets
      auto gather = [&](Sample<T>(&p)[RUNS], int s) {
        int u, h, k, ci;
        place(s, u, h, k, ci);
        const Step st = step_of<T>(g, k, ci, j);
#pragma unroll
        for (int q = 0; q < RUNS; ++q) {
          const int at = rr[q] * per_px + st.og;
          const bool live = px[q].live && st.in;
          const Coord t{live ? off_s[2 * at] : 0.f,
                        live ? off_s[2 * at + 1] : 0.f,
                        !live ? 0.f : kMask ? P::widen(msk_s[at]) : 1.f,
                        live};
          issue<T>(p[q], g, xn[q] + st.ci * RUNS_K, px[q], st, t);
        }
      };
      // col2im of step s on its staged gcol, `gcs` at its first channel
      auto col2im = [&](const Sample<T>(&p)[RUNS], int k, int ci,
                        const T* gcs) {
        const Step st = step_of<T>(g, k, ci, j);
#pragma unroll
        for (int q = 0; q < RUNS; ++q) {
          const int at = rr[q] * per_px + st.og;
          const bool live = px[q].live && st.in;
          float gc[N];
          deform::Run<T>::unpack(
              *reinterpret_cast<const Raw*>(gcs + rr[q] * LDG + j * N), gc);
          const deform::Values<T> v = deform::widen_corners<T>(p[q].raw);
          const deform::CoordGrad cg = deform::coord_grad<T>(gc, v, p[q].cn);
          const float dfy = deform::segment_sum(cg.dfy, seg);
          const float dfx = deform::segment_sum(cg.dfx, seg);
          if constexpr (kMask) {
            const float value = deform::segment_sum(cg.value, seg);
            if (live && writer) {
              off_s[2 * at] = p[q].m * dfy;  // read once, a step before
              off_s[2 * at + 1] = p[q].m * dfx;
              msk_s[at] = deform::Run<T>::narrow(value);
            }
          } else if (live && writer) {  // no mask: no grad mask, no scaling
            off_s[2 * at] = dfy;
            off_s[2 * at + 1] = dfx;
          }
          if constexpr (kScatter)  // every lane: bf16 pairs trade by shuffles
            deform::scatter_corners(
                grad_x + (size_t)px[q].n * g.h * g.w * g.c +
                    (st.ci * RUNS_K + j) * N,
                p[q].cn, gc, p[q].m, g.w, g.c, live);
        }
      };
      // step s + 1's corner loads fly while step s's col2im runs; the
      // consumer meanwhile multiplies the steps ahead. Step s is part h of
      // the patch's consumer step u, the block's t.
      auto body = [&](int s, Sample<T>(&cur)[RUNS], Sample<T>(&nxt)[RUNS]) {
        if (s + 1 < steps) gather(nxt, s + 1);
        int u, h, k, ci;
        place(s, u, h, k, ci);
        const int t = pi * usteps + u, b = t % GCB;
        if (h == 0) mbar_wait(&gc_full[b], (t / GCB) & 1);
        col2im(cur, k, ci, gc_s + b * BM * LDG + h * BK);
        if (h == CPS - 1 || ci == nchunk - 1) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&gc_empty[b]);
        }
      };
      Sample<T> pa[RUNS], pb[RUNS];
      gather(pa, 0);
      for (int s = 0; s < steps; s += 2) {
        body(s, pa, pb);
        if (s + 1 < steps) body(s + 1, pb, pa);
      }
      named_sync(1, PRODUCERS);  // every gradient of the patch is staged
      move_offsets<T, kMask>(off_s, msk_s, grad_offset, grad_mask, pt, g,
                             false, tid, PRODUCERS);
      if (pi + off_bufs < mine) {
        named_sync(1, PRODUCERS);  // the buffer is read out
        stage_offsets(pi + off_bufs);
      }
    }
  } else {
    const int ct = threadIdx.x - PRODUCERS, lane = ct & 31, cw = ct >> 5;
    const int gid = lane >> 2, tig = lane & 3, row = cw * 16 + gid;
    constexpr int CH = ROW / (int)sizeof(T);  // Cout elements of a slab
    constexpr int KS = ROW / K_STEP;          // k steps of a slab
    auto load_go = [&](int pi) {  // patch pi's grad-out tile
      const Patch pt = patch_of(g, blockIdx.x + pi * stride);
      mbar_expect_tx(&go_full, slabs * SLAB);
      for (int q = 0; q < slabs; ++q)
        tma_4d(go_s + q * SLAB, &tm_go, &go_full, q * CH, pt.x, pt.y, pt.n);
    };
    // weight slab `item` of the block's walk: slab i of a patch is
    // consumer step i / slabs, Cout slab i % slabs; each patch walks the
    // same slabs
    auto load_w = [&](int item) {
      const int stage = item % w_stages, i = item % per_patch;
      const int u = i / slabs, q = i - u * slabs;
      const int k = u % g.taps, c0 = u / g.taps * NC;
      mbar_expect_tx(&w_full[stage], D::W_STAGE);
      if constexpr (P::kPlanes == 2)
        tma_4d(w_s + stage * D::W_STAGE, &tm_w, &w_full[stage], q * CH, c0,
               k, 0);
      else
        tma_3d(w_s + stage * D::W_STAGE, &tm_w, &w_full[stage], q * CH, c0,
               k);
    };
    if (ct == 0) {
      if (mine > 0) load_go(0);
      for (int i = 0; i < w_stages && i < items; ++i) load_w(i);
    }
    int item = 0;  // the block's weight slabs so far
    for (int pi = 0, t = 0; pi < mine; ++pi) {
      mbar_wait(&go_full, pi & 1);
      for (int u = 0; u < usteps; ++u, ++t) {
        float acc[NC / 2];
#pragma unroll
        for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
        const int first = item;
        if constexpr (P::kPlanes == 2) {
          // f32: A's fragments in registers, split as they load, one
          // group a slab, its stage refilled at once
          for (int q = 0; q < slabs; ++q, ++item) {
            const int stage = item % w_stages;
            mbar_wait(&w_full[stage], (item / w_stages) & 1);
            const unsigned char* slab = go_p + q * SLAB;
            uint32_t hi[KS][4], lo[KS][4];
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
              // a0 (row, k tig), a1 (row + 8, tig), a2 (row, tig + 4),
              // a3 (row + 8, tig + 4) of the 8-deep k step kk
              const uint32_t r[4] = {
                  *(const uint32_t*)(slab + sw128(row, 2 * kk) + 4 * tig),
                  *(const uint32_t*)(slab + sw128(row + 8, 2 * kk) + 4 * tig),
                  *(const uint32_t*)(slab + sw128(row, 2 * kk + 1) + 4 * tig),
                  *(const uint32_t*)(slab + sw128(row + 8, 2 * kk + 1) +
                                     4 * tig)};
#pragma unroll
              for (int e = 0; e < 4; ++e)
                tc::split_tf32(r[e], hi[kk][e], lo[kk][e]);
            }
            const uint32_t w = w_s + stage * D::W_STAGE;
            constexpr int LO = NC * ROW;  // the weight's lo plane
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
              const uint32_t wh = w + kk * K_STEP;
              tf32_rs(acc, lo[kk], desc_sw128(wh), q == 0 && kk == 0 ? 0 : 1);
              tf32_rs(acc, hi[kk], desc_sw128(wh + LO), 1);
              tf32_rs(acc, hi[kk], desc_sw128(wh), 1);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {  // read until now
              fence_regs(hi[kk]);
              fence_regs(lo[kk]);
            }
            named_sync(2, CONSUMER_WARPS * 32);  // every warp is done
            if (ct == 0 && item + w_stages < items) load_w(item + w_stages);
          }
        } else {
          // bf16: every slab of the step in one group, A by descriptor
          fence_regs(acc);
          wgmma_fence();
          for (int q = 0; q < slabs; ++q, ++item) {
            const int stage = item % w_stages;
            mbar_wait(&w_full[stage], (item / w_stages) & 1);
            const uint32_t w = w_s + stage * D::W_STAGE;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
              bf16_ss(acc, desc_sw128(go_s + q * SLAB + kk * K_STEP),
                      desc_sw128(w + kk * K_STEP), q == 0 && kk == 0 ? 0 : 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          named_sync(2, CONSUMER_WARPS * 32);  // every warp is done
          if (ct == 0)
            for (int i = first; i < item && i + w_stages < items; ++i)
              load_w(i + w_stages);
        }
        if (u == usteps - 1 && pi + 1 < mine && ct == 0) {
          // no warp reads this patch's grad-out tile any more: the next's
          fence_proxy_async();
          load_go(pi + 1);
        }
        // gcol of step t, rounded as Prec<T> says, into its buffer once
        // the producers are done with step t - GCB's
        const int b = t % GCB;
        mbar_wait(&gc_empty[b], ((t / GCB) & 1) ^ 1);
        T* gcs = gc_s + b * BM * LDG;
#pragma unroll
        for (int jn = 0; jn < NC / 8; ++jn)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            P::store2(gcs + (row + h * 8) * LDG + jn * 8 + tig * 2,
                      acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&gc_full[b]);
      }
    }
  }
}

// ------------------------------------------------------------ weight split

// w (n4 vectors of 4 f32) -> its TF32 hi plane at out[0, n4) and lo plane
// at out[n4, 2 n4), tc::split_tf32's arithmetic
__global__ void __launch_bounds__(256)
split_kernel(const float4* __restrict__ w, float4* __restrict__ out,
             long long n4) {
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n4;
       i += (long long)gridDim.x * 256) {
    const float4 v = w[i];
    uint4 hi, lo;
    tc::split_tf32(__float_as_uint(v.x), hi.x, lo.x);
    tc::split_tf32(__float_as_uint(v.y), hi.y, lo.y);
    tc::split_tf32(__float_as_uint(v.z), hi.z, lo.z);
    tc::split_tf32(__float_as_uint(v.w), hi.w, lo.w);
    reinterpret_cast<uint4*>(out)[i] = hi;
    reinterpret_cast<uint4*>(out)[n4 + i] = lo;
  }
}

// ------------------------------------------------------------------ launches

// A tensor map of `rank` dims (innermost first; `strides` in bytes of dims
// 1 ..), boxes of `box`, the 128-byte swizzle; reads past a dim give zeros.
template <typename T>
bool tensor_map(CUtensorMap* map, const void* base, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const fm::EncodeTiled encode = fm::encoder();
  if (encode == nullptr) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map,
                sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                rank, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int BN>
int fwd(const void* x, const void* offset, const void* mask, const void* wt,
        const void* bias, void* out, const Geom& g, cudaStream_t stream) {
  using R = FwdRing<T, BN>;
  constexpr size_t sz = sizeof(T);
  // wt (Cout, K * C) seen as (C, K, Cout[, plane]): a box is a step's BK
  // channels of one tap for BN output channels
  const cuuint64_t dims[4] = {(cuuint64_t)g.c, (cuuint64_t)g.taps,
                              (cuuint64_t)g.cout, 2};
  const cuuint64_t strides[3] = {g.c * sz, (cuuint64_t)g.taps * g.c * sz,
                                 (cuuint64_t)g.cout * g.taps * g.c * sz};
  const cuuint32_t box[4] = {(cuuint32_t)Tiles<T>::BK, 1, (cuuint32_t)BN, 2};
  CUtensorMap tm;
  if (!tensor_map<T>(&tm, wt, R::PLANES == 2 ? 4 : 3, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  auto kernel = mask ? fwd_kernel<T, BN, true> : fwd_kernel<T, BN, false>;
  if (int err = allow_smem(kernel, R::SMEM)) return err;
  int device, sms;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  const int blocks = g.patches < sms ? g.patches : sms;
  kernel<<<blocks, FwdRoles<BN>::THREADS, R::SMEM, stream>>>(
      tm, (const typename Prec<T>::Raw*)x, (const float*)offset,
      (const T*)mask, (const T*)bias, (T*)out, g);
  return (int)cudaGetLastError();
}

template <typename T, int BN, bool kScatter>
int dgrad(const void* go, const void* x, const void* offset, const void* mask,
          const void* w, void* grad_offset, void* grad_mask, void* grad_x,
          const Geom& g, cudaStream_t stream) {
  using D = DgradSmem<T>;
  constexpr size_t sz = sizeof(T);
  // go (N, Ho, Wo, Cout) seen as (Cout, Wo, Ho, N): a box is 128 bytes of
  // Cout of an 8 x 8 patch
  const int items = g.rows / (g.ho * g.wo);
  const cuuint64_t go_dims[4] = {(cuuint64_t)g.cout, (cuuint64_t)g.wo,
                                 (cuuint64_t)g.ho, (cuuint64_t)items};
  const cuuint64_t go_strides[3] = {
      g.cout * sz, (cuuint64_t)g.wo * g.cout * sz,
      (cuuint64_t)g.ho * g.wo * g.cout * sz};
  const cuuint32_t go_box[4] = {(cuuint32_t)(ROW / sz), PATCH, PATCH, 1};
  // the weight (K, C, Cout[, plane]) seen as (Cout, C, K[, plane]): a box
  // is 128 bytes of Cout of a chunk's BK channels of one tap
  const cuuint64_t w_dims[4] = {(cuuint64_t)g.cout, (cuuint64_t)g.c,
                                (cuuint64_t)g.taps, 2};
  const cuuint64_t w_strides[3] = {
      g.cout * sz, (cuuint64_t)g.c * g.cout * sz,
      (cuuint64_t)g.taps * g.c * g.cout * sz};
  const cuuint32_t w_box[4] = {(cuuint32_t)(ROW / sz), (cuuint32_t)D::NC,
                               1, 2};
  CUtensorMap tm_go, tm_w;
  if (!tensor_map<T>(&tm_go, go, 4, go_dims, go_strides, go_box) ||
      !tensor_map<T>(&tm_w, w, Prec<T>::kPlanes == 2 ? 4 : 3, w_dims,
                     w_strides, w_box))
    return (int)cudaErrorInvalidValue;
  // shared memory: the fixed part, two copies of the offsets where the
  // whole ring fits beside them, else one, then as many weight stages as
  // fit: at bf16 a step's slabs at least (one group takes them all), at
  // f32 one at least
  const size_t limit = 232448 - 512;  // the opt-in limit, less the barriers
  const size_t off = mask ? staged_offset_bytes<T, true>(g)
                          : staged_offset_bytes<T, false>(g);
  const int bufs =
      D::fixed(g) + 2 * off + D::MAX_W_STAGES * D::W_STAGE <= limit ? 2 : 1;
  const size_t room = limit - std::min(limit, D::fixed(g) + bufs * off);
  const int stages = (int)std::min<size_t>(D::MAX_W_STAGES,
                                           room / D::W_STAGE);
  if (stages < (Prec<T>::kPlanes == 2 ? 1 : D::slabs(g)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = D::fixed(g) + bufs * off + stages * D::W_STAGE;
  auto kernel = mask ? dgrad_kernel<T, BN, kScatter, true>
                     : dgrad_kernel<T, BN, kScatter, false>;
  if (int err = allow_smem(kernel, smem)) return err;
  int device, sms;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  const int blocks = g.patches < sms ? g.patches : sms;
  kernel<<<blocks, DgradRoles<T, BN, kScatter>::THREADS, smem, stream>>>(
      tm_go, tm_w, (const typename Prec<T>::Raw*)x, (const float*)offset,
      (const T*)mask, (float*)grad_offset, (T*)grad_mask, (float*)grad_x, g,
      stages, bufs);
  return (int)cudaGetLastError();
}

// The entry points' bodies; each .cu names them (mdcn_fused.cuh has the
// contract). At f32 `wt` and `w` point at the weight's hi and lo planes,
// split by split_launch; at bf16 at the weight itself.
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
  // the producers by Cout (DgradRoles): BN 256 above 128, else 128
#define MDCN_DGRAD(BN)                                                       \
  (grad_x ? dgrad<T, BN, true>(go, x, offset, mask, w, grad_offset,          \
                               grad_mask, grad_x, g, s)                      \
          : dgrad<T, BN, false>(go, x, offset, mask, w, grad_offset,         \
                                grad_mask, nullptr, g, s))
  return g.cout > 128 ? MDCN_DGRAD(256) : MDCN_DGRAD(128);
#undef MDCN_DGRAD
}

// planes (2, n) f32 = the TF32 split of w (n f32, a multiple of 4), both
// 16-byte aligned
inline int split_launch(const void* w, void* planes, long long n,
                        void* stream) {
  if (n < 1 || n % 4 || !aligned16(w) || !aligned16(planes))
    return (int)cudaErrorInvalidValue;
  const long long n4 = n / 4, blocks = (n4 + 255) / 256;
  split_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                 (cudaStream_t)stream>>>((const float4*)w, (float4*)planes,
                                         n4);
  return (int)cudaGetLastError();
}

}  // namespace mdcn_wgmma
