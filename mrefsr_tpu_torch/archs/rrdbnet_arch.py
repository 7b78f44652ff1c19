"""RRDBNet, the ESRGAN generator (port of
``mrefsr_tpu/archs/rrdbnet_arch.py``, the reference's
basicsr/archs/rrdbnet_arch.py:1-119). NCHW, the reference's torch names.
It runs no kernel of this repository: cuDNN convolutions, a pixel
unshuffle at scales 1 and 2, and nearest x2 upsamples."""
import math

import torch
from torch import nn

from mrefsr_tpu_torch.ops import pixel_unshuffle
from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import make_layer, normal_, resize, torch_default_init_


def _lrelu(x):
    return nn.functional.leaky_relu(x, 0.2)


class ResidualDenseBlock(nn.Module):
    """Five densely connected convs, the last scaled by 0.2 onto the input
    (reference rrdbnet_arch.py:10-39)."""

    def __init__(self, num_feat=64, num_grow_ch=32):
        super().__init__()
        for i in range(5):
            setattr(self, f'conv{i + 1}', nn.Conv2d(
                num_feat + i * num_grow_ch,
                num_feat if i == 4 else num_grow_ch, 3, 1, 1))

    def forward(self, x):
        feats = [x]
        for i in range(1, 5):
            feats.append(_lrelu(getattr(self, f'conv{i}')(
                torch.cat(feats, 1))))
        return self.conv5(torch.cat(feats, 1)) * 0.2 + x


class RRDB(nn.Module):
    """Three dense blocks, scaled by 0.2 onto the input (reference
    rrdbnet_arch.py:42-66)."""

    def __init__(self, num_feat, num_grow_ch=32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


@ARCH_REGISTRY.register()
class RRDBNet(nn.Module):
    """``num_block`` RRDBs between a conv and two nearest x2 upsamples; at
    ``scale`` 2 (1) the input is first unshuffled by 2 (4), so the output
    is always ``scale`` times the input. Call ``x (B, num_in_ch, H, W)``
    in [0, 1]."""

    def __init__(self, num_in_ch, num_out_ch, scale=4, num_feat=64,
                 num_block=23, num_grow_ch=32):
        super().__init__()
        self.scale = scale
        folded = {2: 4, 1: 16}.get(scale, 1)
        self.conv_first = nn.Conv2d(num_in_ch * folded, num_feat, 3, 1, 1)
        self.body = make_layer(RRDB, num_block, num_feat=num_feat,
                               num_grow_ch=num_grow_ch)
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def init_weights(self, generator):
        """torch's default convs; every dense block's convs kaiming-normal
        (fan_in) x 0.1 with a zero bias (the reference's
        ``default_init_weights(..., 0.1)``)."""
        torch_default_init_(self, generator)
        for m in self.modules():
            if isinstance(m, ResidualDenseBlock):
                for conv in m.children():
                    normal_(conv.weight,
                            0.1 * math.sqrt(2 / conv.weight[0].numel()),
                            generator)
                    conv.bias.detach().zero_()

    def forward(self, x):
        if self.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif self.scale == 1:
            x = pixel_unshuffle(x, 4)
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        feat = _lrelu(self.conv_up1(resize(feat, 2, mode='nearest')))
        feat = _lrelu(self.conv_up2(resize(feat, 2, mode='nearest')))
        return self.conv_last(_lrelu(self.conv_hr(feat)))
