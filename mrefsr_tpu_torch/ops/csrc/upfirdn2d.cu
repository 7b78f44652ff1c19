// upfirdn2d: upsample by zero-stuffing, pad or crop, FIR filter, downsample,
// per channel plane.
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
// backward launch these kernels too, through entry points of their own that
// only count apart.
//
// Layout: x (planes, H, W) and out (planes, out_h, out_w), contiguous f32:
// an NCHW tensor with N*C planes. Rows are 4 * W bytes, odd widths included
// (StyleGAN2's maps are res + 1 wide), so no row is 16-byte aligned in
// general: no TMA (its tensor maps need 16-byte strides), no vector loads.
//
// Bound on the H100: memory. Each output takes at most kh*kw / up^2
// multiply-adds (16 for the 4x4 filter) for 8 bytes moved, under the card's
// 20 f32 operations per byte. Neither the zero-stuffed nor the padded map
// exists in memory.
//
// Two kernels; the wrapper picks one with the `tile` argument:
//
// * The tile kernel, for the 4x4 FIR with (up, down) = (1, 1), (2, 1) and
//   (1, 2): everything StyleGAN2 calls, forward, backward and double
//   backward. Each thread computes a strip of `rows` outputs down one
//   column (1 to 32, a template argument), sliding down its input window
//   a row at a time and applying each row it reads to the (at most 4)
//   outputs whose taps meet it: (rows + 3) * 4 reads for `rows` outputs at
//   (1, 1), where a gather reads 16 an output. A block owns a tile of
//   out, tw columns (at most 128) by rg strips of one plane, or of pb
//   whole planes where a plane is small (a 9x9 plane alone would idle
//   most of 256 threads). The window the tile reads (the tile's rows and
//   columns times `down`, or halved for up 2, plus the 3-sample halo) is
//   either staged in shared memory with 4-byte cp.async, whose zero fill
//   writes the pads and the samples outside the plane (a warp a window
//   row, or for narrow windows an element a thread, stepped by carries:
//   no division per element), or, for small planes and small calls, read
//   straight from x through L1 with the same zeros (the direct mode: no
//   barrier, no round trip through shared memory; on the H100 it is the
//   faster one up to 129x129 planes, staging above). For up 2 a strip
//   applies to each output only the 2x2 taps of its parity phase, on the
//   un-stuffed input; for down 2 the window is twice as wide and tall, a
//   staged one read two samples at a time. The tile, the plane and the
//   window's origin come once per block. The 16 flipped taps come by
//   value in the arguments and, at constant indices, are read straight
//   from the constant bank. The geometry (strip height, tile, planes a
//   block, staged or direct) is the wrapper's, ops/upfirdn2d.py's
//   tile_geometry, which picks the strip height from the plane's rows
//   and the call's thread count, tall strips for large planes (fewer
//   reads an output), short ones for small calls (more threads, shorter
//   chains). Several resident blocks a SM keep the loads in flight; a
//   block stages once, so no double buffer.
// * The gather kernel, one thread per output visiting the taps that fall on
//   a real sample of x, for any FIR of at most 64 taps and any up and down
//   (on no StyleGAN2 path); the FIR is staged in shared memory.
//
// Both sum over ky, then kx, ascending, in f32 (a zero-filled sample adds
// 0 * tap), so the two give the same bits inside the plane.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 64;

struct Fir {
  float v[kMaxTaps];
};

struct Geom {
  int h, w, out_h, out_w, kh, kw, up, down, pad_y0, pad_x0;
};

// ---------------------------------------------------------- gather kernel

// Index is the type of the flat output index: int where the output has
// fewer than 2^31 samples (its divisions are several times cheaper than
// 64-bit ones).
template <typename Index>
__global__ void __launch_bounds__(256)
upfirdn2d_gather_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const Fir fir, const Geom g, const long long total) {
  __shared__ float s_fir[kMaxTaps];
  if (threadIdx.x < g.kh * g.kw) s_fir[threadIdx.x] = fir.v[threadIdx.x];
  __syncthreads();
  const long long at = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= total) return;
  const Index i = (Index)at;
  const int ox = (int)(i % g.out_w);
  const Index t = i / g.out_w;
  const int oy = (int)(t % g.out_h);
  const float* __restrict__ plane = x + (size_t)(t / g.out_h) * g.h * g.w;
  const int y0 = oy * g.down - g.pad_y0;
  const int x0 = ox * g.down - g.pad_x0;
  const int uh = g.h * g.up;
  const int uw = g.w * g.up;
  float acc = 0.f;
  for (int ky = 0; ky < g.kh; ++ky) {
    const int uy = y0 + ky;
    if (uy < 0 || uy >= uh || uy % g.up) continue;
    const float* __restrict__ row = plane + (size_t)(uy / g.up) * g.w;
    for (int kx = 0; kx < g.kw; ++kx) {
      const int ux = x0 + kx;
      if (ux < 0 || ux >= uw || ux % g.up) continue;
      acc = fmaf(s_fir[(g.kh - 1 - ky) * g.kw + g.kw - 1 - kx],
                 row[ux / g.up], acc);
    }
  }
  out[at] = acc;
}

int launch_gather(const float* x, float* out, const float* fir_host,
                  int planes, int h, int w, int kh, int kw, int up, int down,
                  int pad_y0, int pad_y1, int pad_x0, int pad_x1,
                  cudaStream_t stream) {
  if (kh * kw > kMaxTaps) return (int)cudaErrorInvalidValue;
  Geom g;
  g.h = h; g.w = w; g.kh = kh; g.kw = kw; g.up = up; g.down = down;
  g.pad_y0 = pad_y0; g.pad_x0 = pad_x0;
  g.out_h = (h * up + pad_y0 + pad_y1 - kh) / down + 1;
  g.out_w = (w * up + pad_x0 + pad_x1 - kw) / down + 1;
  Fir fir;
  for (int i = 0; i < kh * kw; ++i) fir.v[i] = fir_host[i];
  const long long total = (long long)planes * g.out_h * g.out_w;
  const long long blocks = (total + 255) / 256;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  auto kernel = total > 2147483647LL ? upfirdn2d_gather_kernel<long long>
                                     : upfirdn2d_gather_kernel<int>;
  kernel<<<(unsigned)blocks, 256, 0, stream>>>(x, out, fir, g, total);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ tile kernel

constexpr int kThreads = 256;      // at most, a block

// taps[ky * 4 + kx] multiplies u[oy*down + ky - pad_y0, ox*down + kx - pad_x0]:
// the FIR flipped
struct Taps {
  float v[16];
};

struct Tile {
  int planes, h, w, out_h, out_w, pad_y0, pad_x0;
  int tw, rg, pb;                  // columns, strips down, planes: a block
  int nx, ny;                      // tiles across and down a plane
  int rows_in, cols_in;            // one plane's staged window, or 0
};

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool inside) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  // src-size 0 reads nothing and writes a zero
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to),
               "l"(src), "r"(inside ? 4 : 0));
}

// The window a strip reads, from the strip's first sample (r, c = 0, 0):
// staged in shared memory, or straight from x (the direct mode of small
// calls, where staging's round trip through shared memory and a barrier
// costs more than its loads save), zero outside the plane either way.
struct SharedWin {
  const float* at;
  int stride;
  __device__ float operator()(int r, int c) const {
    return at[r * stride + c];
  }
  // two samples at once: the caller's column and row stride are even
  __device__ float2 pair(int r, int c) const {
    return *reinterpret_cast<const float2*>(at + r * stride + c);
  }
};

struct GlobalWin {
  const float* plane;
  int h, w, iy, ix;
  __device__ float operator()(int r, int c) const {
    const int y = iy + r, xx = ix + c;
    return (unsigned)y < (unsigned)h && (unsigned)xx < (unsigned)w
               ? __ldg(plane + (size_t)y * w + xx)
               : 0.f;
  }
  __device__ float2 pair(int r, int c) const {
    return make_float2((*this)(r, c), (*this)(r, c + 1));
  }
};

// A strip of (1, 1) or (1, 2): output k takes window rows k * down + ky,
// columns kx, ky and kx in 0..3.
template <int kDown, int kRows, typename Win>
__device__ __forceinline__ void strip_up1(const Win& win, const Taps& t,
                                          float (&acc)[kRows]) {
#pragma unroll
  for (int rr = 0; rr < (kRows - 1) * kDown + 4; ++rr) {
    float v0, v1, v2, v3;
    if (kDown == 2) {
      const float2 lo = win.pair(rr, 0), hi = win.pair(rr, 2);
      v0 = lo.x; v1 = lo.y; v2 = hi.x; v3 = hi.y;
    } else {
      v0 = win(rr, 0); v1 = win(rr, 1); v2 = win(rr, 2); v3 = win(rr, 3);
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int ky = rr - k * kDown;
      if (ky >= 0 && ky < 4) {
        acc[k] = fmaf(t.v[ky * 4 + 0], v0, acc[k]);
        acc[k] = fmaf(t.v[ky * 4 + 1], v1, acc[k]);
        acc[k] = fmaf(t.v[ky * 4 + 2], v2, acc[k]);
        acc[k] = fmaf(t.v[ky * 4 + 3], v3, acc[k]);
      }
    }
  }
}

// A strip of up 2: output k takes the window's rows base_k + j, j = 0, 1,
// with tap row ky = 2j + ((kQ + k) & 1), where kQ is the parity of (first
// output row - pad_y0); f0 / f1 hold the taps at kx = qx and 2 + qx for
// the thread's column phase qx.
template <int kRows, int kQ, typename Win>
__device__ __forceinline__ void strip_up2(const Win& win,
                                          const float (&f0)[4],
                                          const float (&f1)[4],
                                          float (&acc)[kRows]) {
#pragma unroll
  for (int rr = 0; rr < kRows / 2 + 2; ++rr) {
    const float v0 = win(rr, 0), v1 = win(rr, 1);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int j = rr - (kQ == 0 ? (k + 1) / 2 : k / 2);
      if (j >= 0 && j < 2) {
        const int ky = 2 * j + ((kQ + k) & 1);
        acc[k] = fmaf(f0[ky], v0, acc[k]);
        acc[k] = fmaf(f1[ky], v1, acc[k]);
      }
    }
  }
}

// One strip from its window; for up 2, qx and qy are its column and row
// phases (the parities of ox - pad_x0 and oy - pad_y0).
template <int kUp, int kDown, int kRows, typename Win>
__device__ __forceinline__ void strip(const Win& win, const Taps& t, int qx,
                                      int qy, float (&acc)[kRows]) {
  if (kUp == 1) {
    strip_up1<kDown, kRows>(win, t, acc);
    return;
  }
  float f0[4], f1[4];
#pragma unroll
  for (int ky = 0; ky < 4; ++ky) {
    f0[ky] = qx ? t.v[ky * 4 + 1] : t.v[ky * 4 + 0];
    f1[ky] = qx ? t.v[ky * 4 + 3] : t.v[ky * 4 + 2];
  }
  if (qy)
    strip_up2<kRows, 1>(win, f0, f1, acc);
  else
    strip_up2<kRows, 0>(win, f0, f1, acc);
}

// Blocks are (tw, rg, pb) threads: a thread's column, strip and plane are
// its threadIdx, with no division; block b of the grid is tile (b % nx,
// b / nx % ny) of plane group b / (nx * ny).
template <int kUp, int kDown, int kRows, bool kStaged>
__global__ void __launch_bounds__(kThreads)
upfirdn2d_tile_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const Taps t, const Tile g) {
  extern __shared__ float win[];
  const int cx = threadIdx.x, ry = threadIdx.y, pz = threadIdx.z;
  const int tid = cx + g.tw * (ry + g.rg * pz);
  const int nthreads = g.tw * g.rg * g.pb;
  // the block's tile and its window's origin in x, once
  int b = blockIdx.x;
  const int tile_x = b % g.nx;
  b /= g.nx;
  const int ox0 = tile_x * g.tw;
  const int oy0 = b % g.ny * g.rg * kRows;
  const int plane0 = b / g.ny * g.pb;
  int iy0, ix0;
  if (kUp == 2) {
    iy0 = (oy0 - g.pad_y0 + 1) >> 1;         // ceil((oy0 - pad_y0) / 2)
    ix0 = (ox0 - g.pad_x0 + 1) >> 1;
  } else {
    iy0 = oy0 * kDown - g.pad_y0;
    ix0 = ox0 * kDown - g.pad_x0;
  }
  const size_t plane_size = (size_t)g.h * g.w;
  // this thread's strip: column ox, rows oy .. oy + kRows - 1 of a plane;
  // its first sample in the window, and for up 2 its phases: u column
  // ox - pad_x0 + kx is a sample where kx = 2j + qx, at x column
  // ceil((ox - pad_x0) / 2) + j
  const int ox = ox0 + cx, oy = oy0 + ry * kRows;
  const int tx = ox - g.pad_x0, ty = oy - g.pad_y0;
  const int r0 = kUp == 2 ? ((ty + 1) >> 1) - iy0 : ry * kRows * kDown;
  const int c0 = kUp == 2 ? ((tx + 1) >> 1) - ix0 : cx * kDown;

  if (kStaged) {
    // stage the windows of the block's planes. A wide window row (32
    // floats or more) goes a warp at a time (a whole warp's worth of
    // lanes: a last, partial warp stages nothing), its plane and bounds
    // once a row; narrow ones go an element a thread, (plane, row,
    // column) stepped by carries: no division per element either way
    const int staged = min(g.pb, g.planes - plane0) * g.rows_in;
    if (g.cols_in >= 32) {
      const int lanes = min(32, nthreads);
      const int warp = tid / lanes, lane = tid % lanes;
      const int warps = nthreads / lanes;
      for (int pr = warp < warps ? warp : staged; pr < staged;
           pr += warps) {
        const int p = pr / g.rows_in;
        const int iy = iy0 + pr - p * g.rows_in;
        const bool row_inside = (unsigned)iy < (unsigned)g.h;
        const float* src = x + (plane0 + p) * plane_size +
                           (size_t)(row_inside ? iy : 0) * g.w;
        float* dst = win + pr * g.cols_in;
        for (int c = lane; c < g.cols_in; c += lanes) {
          const int ix = ix0 + c;
          const bool inside = row_inside && (unsigned)ix < (unsigned)g.w;
          cp_async_f32(dst + c, inside ? src + ix : x, inside);
        }
      }
    } else {
      const int step_r = nthreads / g.cols_in, step_c = nthreads % g.cols_in;
      int e = tid;
      int pr = e / g.cols_in, c = e % g.cols_in;
      int p = pr / g.rows_in, r = pr % g.rows_in;
      const int n = staged * g.cols_in;
      for (; e < n; e += nthreads) {
        const int iy = iy0 + r, ix = ix0 + c;
        const bool inside = (unsigned)iy < (unsigned)g.h &&
                            (unsigned)ix < (unsigned)g.w;
        cp_async_f32(win + e,
                     inside ? x + (plane0 + p) * plane_size +
                                  (size_t)iy * g.w + ix
                            : x,
                     inside);
        c += step_c;
        r += step_r;
        if (c >= g.cols_in) { c -= g.cols_in; ++r; }
        while (r >= g.rows_in) { r -= g.rows_in; ++p; }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }

  const int plane = plane0 + pz;
  if (plane < g.planes && ox < g.out_w && oy < g.out_h) {
    float acc[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] = 0.f;
    if (kStaged) {
      const SharedWin at{win + (pz * g.rows_in + r0) * g.cols_in + c0,
                         g.cols_in};
      strip<kUp, kDown, kRows>(at, t, tx & 1, ty & 1, acc);
    } else {
      const GlobalWin at{x + plane * plane_size, g.h, g.w, iy0 + r0,
                         ix0 + c0};
      strip<kUp, kDown, kRows>(at, t, tx & 1, ty & 1, acc);
    }
    float* o = out + ((size_t)plane * g.out_h + oy) * g.out_w + ox;
    const int rows = min(kRows, g.out_h - oy);
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (k < rows) o[(size_t)k * g.out_w] = acc[k];
  }
}

using TileKernel = void (*)(const float*, float*, const Taps, const Tile);

template <int kRows, bool kStaged>
TileKernel tile_kernel(int up, int down) {
  return up == 2     ? upfirdn2d_tile_kernel<2, 1, kRows, kStaged>
         : down == 2 ? upfirdn2d_tile_kernel<1, 2, kRows, kStaged>
                     : upfirdn2d_tile_kernel<1, 1, kRows, kStaged>;
}

template <bool kStaged>
TileKernel tile_kernel(int rows, int up, int down) {
  return rows == 1    ? tile_kernel<1, kStaged>(up, down)
         : rows == 2  ? tile_kernel<2, kStaged>(up, down)
         : rows == 4  ? tile_kernel<4, kStaged>(up, down)
         : rows == 8  ? tile_kernel<8, kStaged>(up, down)
         : rows == 16 ? tile_kernel<16, kStaged>(up, down)
                      : tile_kernel<32, kStaged>(up, down);
}

// The geometry comes from the wrapper (ops/upfirdn2d.py's tile_geometry,
// which its CPU tests also walk): tile[] = {rows, tw, rg, pb, nx, ny,
// rows_in, cols_in}, rows the strip's outputs (1, 2, 4, 8, 16 or 32), rows_in =
// cols_in = 0 for the direct mode (no window staged). It is checked here
// against what the kernel reads and writes.
int launch_tile(const float* x, float* out, const float* fir_host,
                int planes, int h, int w, int up, int down, int pad_y0,
                int pad_y1, int pad_x0, int pad_x1, const int* tile,
                cudaStream_t stream) {
  Tile g;
  g.planes = planes; g.h = h; g.w = w;
  g.pad_y0 = pad_y0; g.pad_x0 = pad_x0;
  g.out_h = (h * up + pad_y0 + pad_y1 - 4) / down + 1;
  g.out_w = (w * up + pad_x0 + pad_x1 - 4) / down + 1;
  const int rows = tile[0];
  g.tw = tile[1]; g.rg = tile[2]; g.pb = tile[3]; g.nx = tile[4];
  g.ny = tile[5]; g.rows_in = tile[6]; g.cols_in = tile[7];
  if (rows != 1 && rows != 2 && rows != 4 && rows != 8 && rows != 16 &&
      rows != 32)
    return (int)cudaErrorInvalidValue;
  const int th = g.rg * rows;
  const bool staged = g.rows_in != 0 || g.cols_in != 0;
  const int need_rows = !staged ? 0 : up == 2 ? th / 2 + 2
                                              : (th - 1) * down + 4;
  const int need_cols = !staged ? 0 : up == 2 ? g.tw / 2 + 2
                                              : (g.tw - 1) * down + 4;
  const long long threads = (long long)g.tw * g.rg * g.pb;
  const size_t smem = (size_t)g.pb * g.rows_in * g.cols_in * sizeof(float);
  const long long blocks = (long long)((planes + g.pb - 1) / g.pb) * g.ny *
                           g.nx;
  if (g.tw < 1 || g.rg < 1 || g.pb < 1 || g.pb > 64 ||
      g.rows_in < need_rows || g.cols_in < need_cols ||
      (long long)g.nx * g.tw < g.out_w || (long long)g.ny * th < g.out_h ||
      threads > kThreads || smem > 48 * 1024 || blocks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const dim3 block((unsigned)g.tw, (unsigned)g.rg, (unsigned)g.pb);
  Taps t;
  for (int i = 0; i < 16; ++i) t.v[i] = fir_host[15 - i];
  const TileKernel kernel = staged ? tile_kernel<true>(rows, up, down)
                                  : tile_kernel<false>(rows, up, down);
  kernel<<<(unsigned)blocks, block, smem, stream>>>(x, out, t, g);
  return (int)cudaGetLastError();
}

bool tile_case(int kh, int kw, int up, int down) {
  return kh == 4 && kw == 4 &&
         ((up == 1 && down == 1) || (up == 2 && down == 1) ||
          (up == 1 && down == 2));
}

int launch(const void* x, void* out, const float* fir_host, int planes, int h,
           int w, int kh, int kw, int up, int down, int pad_y0, int pad_y1,
           int pad_x0, int pad_x1, const int* tile, void* stream) {
  if (kh < 1 || kw < 1 || up < 1 || down < 1 || planes < 1 || h < 1 ||
      w < 1 || h * up + pad_y0 + pad_y1 < kh || w * up + pad_x0 + pad_x1 < kw)
    return (int)cudaErrorInvalidValue;
  if (tile != nullptr) {
    if (!tile_case(kh, kw, up, down)) return (int)cudaErrorInvalidValue;
    return launch_tile((const float*)x, (float*)out, fir_host, planes, h, w,
                       up, down, pad_y0, pad_y1, pad_x0, pad_x1, tile,
                       (cudaStream_t)stream);
  }
  return launch_gather((const float*)x, (float*)out, fir_host, planes, h, w,
                       kh, kw, up, down, pad_y0, pad_y1, pad_x0, pad_x1,
                       (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// `x` and `out` are device pointers of contiguous f32 tensors (planes, h, w)
// and (planes, out_h, out_w); `fir` is a host pointer to kh * kw floats, row
// major, read before the call returns; `tile` a host pointer to the tile
// kernel's geometry, 7 ints (the 4x4 FIR with (up, down) = (1, 1), (2, 1)
// or (1, 2) only), or null for the gather kernel; the stream is a
// cudaStream_t. Each returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for an empty output, a FIR of more than 64 taps, a
// case or a geometry the tile kernel does not take or more than 2^31 - 1
// blocks). Three names for one function, so that the forward, the backward
// and the double backward of the op are counted apart.
#define UPFIRDN2D_ENTRY(name)                                                 \
  int name(const void* x, void* out, const float* fir, int planes, int h,     \
           int w, int kh, int kw, int up, int down, int pad_y0, int pad_y1,   \
           int pad_x0, int pad_x1, const int* tile, void* stream) {           \
    return launch(x, out, fir, planes, h, w, kh, kw, up, down, pad_y0,        \
                  pad_y1, pad_x0, pad_x1, tile, stream);                      \
  }
UPFIRDN2D_ENTRY(upfirdn2d_fwd_launch)
UPFIRDN2D_ENTRY(upfirdn2d_bwd_launch)
UPFIRDN2D_ENTRY(upfirdn2d_bwd2_launch)

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
