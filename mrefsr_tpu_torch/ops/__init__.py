"""Ops of the port: PyTorch around hand-written CUDA kernels
(``csrc/feature_match.cu``, ``csrc/mdcn.cu``, ``csrc/deform_sample.cu``),
each with its plain PyTorch version beside it for CPU tensors."""
from .correlation import (feature_match_index, feature_match_index_ref,
                          index_to_flow, sample_patches, tensor_shift)
from .dcn import (deform_sample, deform_sample_ref, modulated_deform_conv2d,
                  modulated_deform_conv2d_ref, offset_mask_from_conv_out)

__all__ = [
    'feature_match_index', 'feature_match_index_ref', 'index_to_flow',
    'sample_patches', 'tensor_shift', 'deform_sample', 'deform_sample_ref',
    'modulated_deform_conv2d', 'modulated_deform_conv2d_ref',
    'offset_mask_from_conv_out',
]
