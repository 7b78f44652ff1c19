"""Correspondence generation: dense patch matching -> DCN pre-offsets
(port of ``mrefsr_tpu/archs/corres_generation_arch.py``).

Batched over B*T pairs where the JAX package vmaps one pair at a time.
Pre-offsets keep the JAX layout ``(N, H, W, 9, 2)``, last dim (x, y).
"""
import torch
from torch import nn

from mrefsr_tpu_torch.ops import (feature_match_index, index_to_flow,
                                  tensor_shift)
from mrefsr_tpu_torch.ops.correlation import add_scalar, l2_norm
from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .vgg_arch import VGGFeatureExtractor


def _shifted_offsets(flow, step):
    """The 9 tap-shifted copies of a flow field (reference
    corres_generation_arch.py:73-78): tap (i, j) is the flow shifted
    down/right by (i*step, j*step). ``(..., h, w, 2)`` ->
    ``(..., h, w, 9, 2)``."""
    return torch.stack([tensor_shift(flow, (i * step, j * step))
                        for i in range(3) for j in range(3)], dim=-2)


def _upsample_flow(flow, factor):
    """Repeat each flow vector ``factor`` x ``factor`` times and scale it
    by ``factor`` (reference corres_generation_arch.py:82-97)."""
    up = flow.repeat_interleave(factor, dim=-3)
    return up.repeat_interleave(factor, dim=-2) * factor


def compute_pre_offsets(feat_in, feat_ref, patch_size=3, stride=1):
    """``(N, H, W, C)`` feature pairs -> ``{relu1_1, relu2_1, relu3_1:
    (N, H_l, W_l, 9, 2)}`` pre-offset maps, f32 whatever the features'
    dtype (``index_to_flow`` makes f32 flows, as in the JAX package)."""
    # per-position channel-vector L2 normalisation (reference :57-59), in
    # the features' dtype and rounded where the JAX package rounds it
    feat_in = feat_in / add_scalar(l2_norm(feat_in, -1, keepdim=True), 1e-12)
    feat_ref = feat_ref / add_scalar(l2_norm(feat_ref, -1, keepdim=True),
                                     1e-12)
    max_idx, _ = feature_match_index(feat_in, feat_ref,
                                     patch_size=patch_size,
                                     input_stride=stride, ref_stride=stride,
                                     is_norm=True, norm_input=True)
    offset_relu3 = index_to_flow(max_idx)  # (N, h, w, 2), (x, y)
    offset_relu2 = _upsample_flow(offset_relu3, 2)
    offset_relu1 = _upsample_flow(offset_relu3, 4)
    return {
        'relu3_1': _shifted_offsets(offset_relu3, 1),
        'relu2_1': _shifted_offsets(offset_relu2, 2),
        'relu1_1': _shifted_offsets(offset_relu1, 4),
    }


@ARCH_REGISTRY.register()
class CorrespondenceGenerationArch(nn.Module):
    """Patch matching + VGG19 features of the HR refs (reference
    corres_generation_arch.py:15-118). Matching has no parameters.

    Call ``(dense_features, img_ref_hr)``: ``dense_features`` holds
    ``'dense_features1'`` and ``'dense_features2'``, both (N, C, h, w)
    for the N = B*T pairs; ``img_ref_hr`` is (N, 3, H, W) in [0, 1].
    Returns ``(pre_offset {level: (N, H_l, W_l, 9, 2)},
    img_ref_feat {level: (N, C_l, H_l, W_l)})``.
    """

    def __init__(self, patch_size=3, stride=1,
                 vgg_layer_list=('relu1_1', 'relu2_1', 'relu3_1'),
                 vgg_type='vgg19'):
        super().__init__()
        self.patch_size = patch_size
        self.stride = stride
        self.vgg_type = vgg_type
        self.vgg =VGGFeatureExtractor(layer_name_list=tuple(vgg_layer_list),
                                       vgg_type=vgg_type)

    def forward(self, dense_features, img_ref_hr):
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        pre_offset = compute_pre_offsets(
            nhwc(dense_features['dense_features1']),
            nhwc(dense_features['dense_features2']),
            patch_size=self.patch_size, stride=self.stride)
        return pre_offset, self.vgg(img_ref_hr)

    def init_weights(self, generator):
        self.vgg.init_weights(generator)
