"""Ops of the port: PyTorch around hand-written CUDA kernels
(``csrc/feature_match_prologue.cu``, ``csrc/feature_match.cu``,
``csrc/feature_match_bf16.cu``, ``csrc/mdcn_fused.cu``,
``csrc/mdcn_bf16.cu``, ``csrc/deform_sample.cu``, ``csrc/upfirdn2d.cu``,
``csrc/fused_act.cu``), each with its plain PyTorch version beside it for
CPU tensors; and the resampling the video nets use
(``resize.py``, ``warp.py``), which is ATen's ``F.interpolate``,
``F.pixel_unshuffle`` and ``F.grid_sample`` at the JAX package's
layouts."""
from .correlation import (feature_match_index, feature_match_index_ref,
                          feature_match_index_sharded,
                          feature_match_index_sharded_ref, index_to_flow,
                          sample_patches, tensor_shift)
from .dcn import (deform_conv2d, deform_conv2d_ref, deform_sample,
                  deform_sample_ref, modulated_deform_conv2d,
                  modulated_deform_conv2d_ref, offset_mask_from_conv_out)
from .fused_act import fused_leaky_relu, fused_leaky_relu_ref
from .resize import interpolate, pixel_unshuffle
from .upfirdn2d import upfirdn2d, upfirdn2d_ref
from .warp import flow_warp, resize_flow

__all__ = [
    'feature_match_index', 'feature_match_index_ref',
    'feature_match_index_sharded', 'feature_match_index_sharded_ref',
    'index_to_flow',
    'sample_patches', 'tensor_shift', 'deform_conv2d', 'deform_conv2d_ref',
    'deform_sample', 'deform_sample_ref',
    'modulated_deform_conv2d', 'modulated_deform_conv2d_ref',
    'offset_mask_from_conv_out', 'fused_leaky_relu', 'fused_leaky_relu_ref',
    'upfirdn2d', 'upfirdn2d_ref', 'interpolate', 'pixel_unshuffle',
    'flow_warp', 'resize_flow',
]
