// K2, K3 and K5 at bf16, fused: the modulated deformable conv (DCNv2) with
// any number of conv groups and DCNv1 (no mask), whose deformable-im2col
// columns never reach device memory, forward and backward, with the
// products on the tensor cores: the walk at T = bf16, the forward, dgrad
// and wgrad on wgmma (m64nNk16, bf16 in, f32 sums) fed by TMA and producer
// warps (mdcn_wgmma.cuh).
//
// Replaces mrefsr_tpu/ops/dcn.py::_mdcn_slab_scan (dcn.py:111-160, K2),
// _mdcn_tap_scan (:214-246, K3, on the block-diagonal weight the wrapper
// builds) and deform_conv2d (:345-366, K5, a null mask) at bf16, and the
// derivative JAX's autodiff takes through them. Like that scan, which
// contracts each tap's gathered slab at once (einsum with
// preferred_element_type=f32, :142-144) so that "im2col never
// materializes", these kernels gather a tile of columns into shared memory
// and contract it there. A column element is rounded to bf16 once, as the
// plain version's im2col stores it; the forward rounds its f32 sum to bf16, adds
// the bias and rounds again (out = bf16(bf16(sum) + bias)); dgrad rounds
// grad_col to bf16 before the col2im arithmetic, where torch.mm of the
// plain version (ops/dcn.py) rounds and where JAX's vjp rounds the sampled
// slab's cotangent (dot_general with preferred_element_type f32, then a
// convert to bf16); grad mask is bf16, rounded once; grad offset, grad x,
// grad weight and grad bias are f32. They differ from the plain version
// only in the order of the f32 sums.
//
// Bound on the H100 (989 TFLOP/s dense bf16, 3.35 TB/s): bytes. One CUFED5
// request's forward (3 scales, N = 5) is 2 * rows * 9C * Cout = 276 GFLOP,
// 0.28 ms at the tensor cores' peak, against 1.7 GB of essential bytes
// (mostly the f32 offsets: 0.72 GB at relu1_1), 0.52 ms. What the kernels
// save is the column matrix: rows * 9C bf16 written and read back
// (1.44 GB at relu1_1 of a request), and in the backward the recomputed
// columns and the grad_col matrix, each as large. What they cannot save
// is the gather: 4 corner loads of 16 bytes for every 8 channels of a
// sample, a warp's 32 lanes touching up to 32 cache lines at 8 channels a
// deform group (relu1_1: each lane of a pixel samples its own group). So
// the forward and dgrad gather in producer warps that fill a ring of
// stages deep enough to keep many corner loads in flight, while a consumer
// warpgroup multiplies (mdcn_wgmma.cuh); PERF.md has what bounds each
// part (ops/mdcn_ablation.py --bf16 on the H100).
#include "mdcn_wgmma.cuh"

using mdcn_fused::bf16;

// The entry points of the walk's launches at bf16: x, mask, weight,
// bias, grad out and grad mask bf16, the offset and every other gradient
// f32. The mask may be null (DCNv1: a mask of ones), and dgrad's grad_mask
// with it: then no mask is read and no grad mask written.
extern "C" {

int mdcn_fused_fwd_bf16_launch(const void* x, const void* offset,
                               const void* mask, const void* wt,
                               const void* bias, void* out, FUSED_ARGS) {
  return mdcn_wgmma::fwd_launch<bf16>(x, offset, mask, wt, bias, out,
                                      FUSED_GEOM(bf16), stream);
}

int mdcn_fused_dgrad_bf16_launch(const void* go, const void* x,
                                 const void* offset, const void* mask,
                                 const void* weight, void* grad_offset,
                                 void* grad_mask, FUSED_ARGS) {
  return mdcn_wgmma::dgrad_launch<bf16>(go, x, offset, mask, weight,
                                        grad_offset, grad_mask, nullptr,
                                        FUSED_GEOM(bf16), stream);
}

int mdcn_fused_dgrad_scatter_bf16_launch(const void* go, const void* x,
                                         const void* offset,
                                         const void* mask, const void* weight,
                                         void* grad_offset, void* grad_mask,
                                         void* grad_x, FUSED_ARGS) {
  if (!grad_x) return (int)cudaErrorInvalidValue;
  return mdcn_wgmma::dgrad_launch<bf16>(go, x, offset, mask, weight,
                                        grad_offset, grad_mask, grad_x,
                                        FUSED_GEOM(bf16), stream);
}

int mdcn_fused_wgrad_bf16_launch(const void* go, const void* x,
                                 const void* offset, const void* mask,
                                 void* partial, int splits,
                                 int split_patches, FUSED_ARGS) {
  return mdcn_wgmma::wgrad_launch<bf16>(go, x, offset, mask, partial, splits,
                                        split_patches, FUSED_GEOM(bf16),
                                        stream);
}

int mdcn_fused_wgrad_sum_bf16_launch(const void* partial, void* grad_w,
                                     int splits, int n, void* stream) {
  return mdcn_fused::wgrad_sum_launch(partial, grad_w, splits, n, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
