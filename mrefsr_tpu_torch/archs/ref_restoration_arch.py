"""The single-reference restoration net, C2-Matching style (port of
``mrefsr_tpu/archs/ref_restoration_arch.py:22-102``).

MRAPA's 3-scale decoder with one reference: at each VGG level the ref
feature is aligned by a DynAgg deformable conv (K2, at either precision)
seeded with the match pre-offsets, and a concat + conv head takes the place
of MRAPA's attention fusion. NCHW activations, channels-last memory.
"""
import torch
from torch import nn

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import (ResidualBlockNoBN, lrelu, make_layer, normal_,
                        srntt_normal_init_)
from .ref_mrapa_restoration_arch import ContentExtractor, DynAgg


def _channels_last(x):
    return x.contiguous(memory_format=torch.channels_last)


class DynamicAggregationRestoration(nn.Module):
    """The single-ref 3-scale decoder (reference :139-259). Per scale
    ``p`` in small / medium / large (``_scale_stage``): offset convs ->
    DynAgg (``p_dyn_agg``) -> concat + conv head -> residual blocks ->
    tail.

    Call ``(x (B, ngf, h, w), pre_offset {level: (B, H, W, 9, 2)},
    img_ref_feat {level: (B, C, H, W)})``.
    """

    _SCALES = (('small', 'relu3_1', 256), ('medium', 'relu2_1', 128),
               ('large', 'relu1_1', 64))

    def __init__(self, ngf=64, n_blocks=16, groups=8):
        super().__init__()
        for p, _, ref_nf in self._SCALES:
            setattr(self, f'{p}_offset_conv1',
                    nn.Conv2d(ngf + ref_nf, ref_nf, 3, 1, 1))
            setattr(self, f'{p}_offset_conv2',
                    nn.Conv2d(ref_nf, ref_nf, 3, 1, 1))
            setattr(self, f'{p}_dyn_agg',
                    DynAgg(ref_nf, ref_nf, 3, deform_groups=groups))
            setattr(self, f'head_{p}', nn.Sequential(
                nn.Conv2d(ngf + ref_nf, ngf, 3, 1, 1), nn.LeakyReLU(0.1)))
            setattr(self, f'body_{p}',
                    make_layer(ResidualBlockNoBN, n_blocks, num_feat=ngf))
        self.tail_small = nn.Sequential(nn.Conv2d(ngf, ngf * 4, 3, 1, 1))
        self.tail_medium = nn.Sequential(nn.Conv2d(ngf, ngf * 4, 3, 1, 1))
        self.tail_large = nn.Sequential(
            nn.Conv2d(ngf, ngf // 2, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(ngf // 2, 3, 3, 1, 1))

    def _scale_stage(self, p, x, pre_offset, ref_feat):
        off = lrelu(getattr(self, f'{p}_offset_conv1')(
            torch.cat([x, ref_feat], 1)))
        off = lrelu(getattr(self, f'{p}_offset_conv2')(off))
        swapped = lrelu(getattr(self, f'{p}_dyn_agg')(ref_feat, off,
                                                      pre_offset))
        h = getattr(self, f'head_{p}')(torch.cat([x, swapped], 1))
        h = getattr(self, f'body_{p}')(h) + x
        h = getattr(self, f'tail_{p}')(h)
        if p == 'large':
            return h
        return _channels_last(lrelu(nn.functional.pixel_shuffle(h, 2)))

    def forward(self, x, pre_offset, img_ref_feat):
        for p, level, _ in self._SCALES:
            x = self._scale_stage(p, x, pre_offset[level],
                                  img_ref_feat[level])
        return x


@ARCH_REGISTRY.register()
class RestorationNet(nn.Module):
    """The single-reference restoration net (reference :100-136).

    Call ``(x (B, 3, h, w), pre_offset {level: (B, H, W, 9, 2)},
    img_ref_feat {level: (B, C, H, W)})``; returns (B, 3, 4h, 4w).
    ``dcn_outer_remat`` and ``fusion_remat`` shape only how XLA holds the
    JAX package's memory; they are accepted and ignored here, as by
    ``MRAPARestorationNet``.
    """

    def __init__(self, ngf=64, n_blocks=16, groups=8, dcn_outer_remat=False,
                 fusion_remat=False):
        super().__init__()
        self.content_extractor = ContentExtractor(ngf, n_blocks)
        self.dyn_agg_restore = DynamicAggregationRestoration(ngf, n_blocks,
                                                             groups)

    def forward(self, x, pre_offset, img_ref_feat):
        base = nn.functional.interpolate(x, scale_factor=4, mode='bilinear',
                                         align_corners=False)
        content_feat = self.content_extractor(x)
        return self.dyn_agg_restore(content_feat, pre_offset,
                                    img_ref_feat) + base

    @torch.no_grad()
    def init_weights(self, generator):
        """N(0, 0.02) for every conv and DynAgg weight, zero biases, and
        zero ``conv_offset_mask`` (sampling starts at the pre-offsets), as
        ``MRAPARestorationNet.init_weights``."""
        srntt_normal_init_(self, generator)
        for m in self.modules():
            if isinstance(m, DynAgg):
                normal_(m.weight, 0.02, generator)
                m.bias.zero_()
                m.conv_offset_mask.weight.zero_()
                m.conv_offset_mask.bias.zero_()
