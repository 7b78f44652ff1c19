// K2, K3 and K5 at f32, fused: the modulated deformable conv (DCNv2) with
// any number of conv groups and DCNv1 (no mask), whose deformable-im2col
// columns never reach device memory, forward and backward, with the
// contraction in the kernel on the TF32 tensor cores as 3xTF32: the walk
// of mdcn_fused.cuh at T = float.
//
// Replaces mrefsr_tpu/ops/dcn.py::_mdcn_slab_scan (dcn.py:111-160, K2:
// conv groups 1), _mdcn_tap_scan (:214-246, K3: conv groups > 1, here on
// the block-diagonal weight the wrapper builds) and deform_conv2d
// (:345-366, K5: a null mask) in f32, the JAX package's default, and the
// derivative JAX's autodiff takes through them. Like that scan, which contracts each tap's gathered slab at
// once (einsum with preferred_element_type=f32, :142-144) so that "im2col
// never materializes", these kernels gather a tile of columns into shared
// memory and contract it there: no column matrix in device memory, no
// chunks of rows, no cuBLAS call. The forward writes out = sum + bias in
// f32 (torch.addmm's order); dgrad computes grad_col = go . W^T in f32 and
// runs the col2im arithmetic on it (grad offset, grad mask, and in the
// _scatter variant grad x by f32 atomics); wgrad writes f32 partials
// of grad weight and grad bias per slice of 8 x 8 output patches, added
// in a fixed order by the sum kernel.
//
// Arithmetic: 3xTF32. Each operand value x is split into hi =
// tf32_rna(x) and lo = x - hi (tc::split_tf32: hi as feature_match.cu
// rounds it, lo handed over whole, the tensor cores reading its top 19
// bits), and each product accumulates lo*hi + hi*lo + hi*hi in f32 on
// mma.sync m16n8k8: the dropped lo*lo and what the tensor cores drop of
// lo leave about 2^-21 of |a||b| a product, in either direction, below
// the f32 sums' own error at these depths (9 C <= 2304). The tensor cores'
// f32 sums truncate: wgrad, whose chains of sums run over a slice's
// thousands of rows, adds each patch's products to its running sums on
// the CUDA cores (Prec<float>::kStepSums).
//
// Bound on the H100 (67 TFLOP/s f32 on the CUDA cores, 495 TF32 on the
// tensor cores, 3.35 TB/s): operations. One CUFED5 request's forward
// (3 scales, N = 5) is 276 GFLOP: 4.1 ms on the CUDA cores, 1.7 ms as the
// three TF32 products of 3xTF32, against about 2.6 GB of essential f32
// bytes (x, mask and out f32, the offsets), 0.8 ms. What the kernels save
// is the column matrix, rows * 9C f32 written and read back (2.9 GB at
// relu1_1 of a request), and in the backward the recomputed columns and
// the grad_col matrix, each as large; what they cannot save is the
// gather, twice as many 16-byte corner loads as at bf16 for the same
// channels (4 channels a load). So the gather should set the pace at C 64
// and 128, and the products at C 256, as at bf16.
//
// What the design does about it. The split costs three operations an
// element, so an operand that several warps read is split once, as it is
// stored in shared memory, into a hi and a lo plane: the gathered column
// tile of the forward and wgrad, and dgrad's grad_out tile at Cout 128
// (at 256 both planes do not fit beside the staged offsets; at 64 they
// would halve the blocks an SM holds, which cost more, measured, than the
// splits save). The weight tiles and wgrad's grad_out tiles, which one or
// two warps read, are split as fragments load. Shared memory otherwise
// keeps the bf16 walk's byte geometry: a k step is 32 channels (8 runs of
// 16 bytes) where bf16's is 64. Fragments of k-contiguous tiles load by
// ldmatrix as at bf16 (a 32-bit word is one TF32 element); wgrad's, whose
// k (the patch's pixels) runs across rows, by plain loads from rows padded
// to 8 mod 32 words (ldmatrix cannot transpose 32-bit elements). dgrad
// runs 256 threads at every Cout, its 64 x 32 product over 4 x 2 warps,
// so that 2 warps, not 4, load and split each grad_out fragment.
#include "mdcn_fused.cuh"

// The entry points of mdcn_fused.cuh's launches at f32: every tensor
// float32. The mask may be null (DCNv1: a mask of ones), and dgrad's
// grad_mask with it: then no mask is read and no grad mask written.
extern "C" {

int mdcn_fused_fwd_launch(const void* x, const void* offset, const void* mask,
                          const void* wt, const void* bias, void* out,
                          FUSED_ARGS) {
  return mdcn_fused::fwd_launch<float>(x, offset, mask, wt, bias, out,
                                       FUSED_GEOM(float), stream);
}

int mdcn_fused_dgrad_launch(const void* go, const void* x,
                            const void* offset, const void* mask,
                            const void* weight, void* grad_offset,
                            void* grad_mask, FUSED_ARGS) {
  return mdcn_fused::dgrad_launch<float>(go, x, offset, mask, weight,
                                         grad_offset, grad_mask, nullptr,
                                         FUSED_GEOM(float), stream);
}

int mdcn_fused_dgrad_scatter_launch(const void* go, const void* x,
                                    const void* offset, const void* mask,
                                    const void* weight, void* grad_offset,
                                    void* grad_mask, void* grad_x,
                                    FUSED_ARGS) {
  if (!grad_x) return (int)cudaErrorInvalidValue;
  return mdcn_fused::dgrad_launch<float>(go, x, offset, mask, weight,
                                         grad_offset, grad_mask, grad_x,
                                         FUSED_GEOM(float), stream);
}

int mdcn_fused_wgrad_launch(const void* go, const void* x,
                            const void* offset, const void* mask,
                            void* partial, int splits, int split_patches,
                            FUSED_ARGS) {
  return mdcn_fused::wgrad_launch<float>(go, x, offset, mask, partial,
                                         splits, split_patches,
                                         FUSED_GEOM(float), stream);
}

int mdcn_fused_wgrad_sum_launch(const void* partial, void* grad_w, int splits,
                                int n, void* stream) {
  return mdcn_fused::wgrad_sum_launch(partial, grad_w, splits, n, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
