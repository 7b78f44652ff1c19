"""RCAN, the residual channel attention network (port of
``mrefsr_tpu/archs/rcan_arch.py``, the reference's
basicsr/archs/rcan_arch.py:1-135). NCHW, the reference's torch names. It
runs no kernel of this repository: cuDNN convolutions, pooled channel
attention and pixel shuffles."""
from torch import nn

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import Upsample, make_layer, torch_default_init_
from .edsr_arch import MeanRange


class ChannelAttention(nn.Module):
    """Squeeze and excite: the global mean through two 1x1 convs and a
    sigmoid scales the channels (reference rcan_arch.py:8-24; RIDNet's is
    the same, ridnet_arch.py:92-108). Children ``attention.1`` and
    ``attention.3`` as the reference's ``nn.Sequential``."""

    def __init__(self, num_feat, squeeze_factor=16):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(num_feat, num_feat // squeeze_factor, 1),
            nn.ReLU(), nn.Conv2d(num_feat // squeeze_factor, num_feat, 1),
            nn.Sigmoid())

    def forward(self, x):
        return x * self.attention(x)


class RCAB(nn.Module):
    """Conv, ReLU, conv, channel attention, x ``res_scale`` onto the input
    (reference rcan_arch.py:27-46)."""

    def __init__(self, num_feat, squeeze_factor=16, res_scale=1.0):
        super().__init__()
        self.res_scale = res_scale
        self.rcab = nn.Sequential(
            nn.Conv2d(num_feat, num_feat, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(num_feat, num_feat, 3, 1, 1),
            ChannelAttention(num_feat, squeeze_factor))

    def forward(self, x):
        return self.rcab(x) * self.res_scale + x


class ResidualGroup(nn.Module):
    """``num_block`` RCABs and a conv, onto the input (reference
    rcan_arch.py:49-69)."""

    def __init__(self, num_feat, num_block, squeeze_factor=16,
                 res_scale=1.0):
        super().__init__()
        self.residual_group = make_layer(
            RCAB, num_block, num_feat=num_feat,
            squeeze_factor=squeeze_factor, res_scale=res_scale)
        self.conv = nn.Conv2d(num_feat, num_feat, 3, 1, 1)

    def forward(self, x):
        return self.conv(self.residual_group(x)) + x


@ARCH_REGISTRY.register()
class RCAN(MeanRange):
    """A conv, ``num_group`` residual groups, a conv and the skip,
    pixel-shuffle upsampling by ``upscale``, a conv (reference
    rcan_arch.py:72-135). Call ``x (B, num_in_ch, H, W)`` in [0, 1]."""

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_group=10,
                 num_block=16, squeeze_factor=16, upscale=4, res_scale=1.0,
                 img_range=255., rgb_mean=(0.4488, 0.4371, 0.4040)):
        super().__init__(img_range, rgb_mean)
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(
            ResidualGroup, num_group, num_feat=num_feat, num_block=num_block,
            squeeze_factor=squeeze_factor, res_scale=res_scale)
        self.conv_after_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.upsample = Upsample(upscale, num_feat)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def init_weights(self, generator):
        """torch's default convs and the mean."""
        torch_default_init_(self, generator)
        self.reset_parameters_()

    def forward(self, x):
        x = self.conv_first(self.normalise(x))
        res = self.conv_after_body(self.body(x)) + x
        return self.restore(self.conv_last(self.upsample(res)))
