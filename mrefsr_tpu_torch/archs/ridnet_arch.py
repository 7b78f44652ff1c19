"""RIDNet, real image denoising with feature attention (port of
``mrefsr_tpu/archs/ridnet_arch.py``, the reference's
basicsr/archs/ridnet_arch.py: MeanShift :8, EResidualBlockNoBN :31,
MergeRun :59, EAM :111, RIDNet :141). NCHW, the reference's torch names.
It runs no kernel of this repository: cuDNN convolutions (dilated ones in
``MergeRun``) and pooled channel attention."""
import torch
from torch import nn

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import ResidualBlockNoBN, make_layer, torch_default_init_
from .rcan_arch import ChannelAttention


class MeanShift(nn.Conv2d):
    """A 1x1 conv set to ``(x + sign * rgb_range * mean) / std`` per
    channel (reference ridnet_arch.py:8-29). Its weight and bias are
    parameters and train, as the JAX package's ``SRModel`` trains them
    (the reference's ``requires_grad = False`` is set on the module, where
    no parameter reads it)."""

    def __init__(self, rgb_range, rgb_mean, rgb_std, sign=-1):
        super().__init__(3, 3, 1)
        self.rgb_range, self.sign = rgb_range, sign
        self.rgb_mean, self.rgb_std = tuple(rgb_mean), tuple(rgb_std)

    @torch.no_grad()
    def reset_parameters_(self, generator=None):
        std = torch.tensor(self.rgb_std)
        self.weight.copy_(torch.eye(3).view(3, 3, 1, 1) / std.view(3, 1, 1,
                                                                    1))
        self.bias.copy_(self.sign * self.rgb_range
                        * torch.tensor(self.rgb_mean) / std)


class EResidualBlockNoBN(nn.Module):
    """Conv, ReLU, conv, ReLU, 1x1 conv, plus the input, then a ReLU
    (reference ridnet_arch.py:31-57)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 1, 1, 0))

    def forward(self, x):
        return torch.relu(self.body(x) + x)


class MergeRun(nn.Module):
    """Two branches of dilated convs (dilations 1 then 2, 3 then 4),
    concatenated, a conv and a ReLU, plus the input (reference
    ridnet_arch.py:59-89)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.dilation1 = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 3, 1, 2, 2), nn.ReLU())
        self.dilation2 = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, 1, 3, 3), nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 3, 1, 4, 4), nn.ReLU())
        self.aggregation = nn.Sequential(
            nn.Conv2d(out_channels * 2, out_channels, 3, 1, 1), nn.ReLU())

    def forward(self, x):
        out = torch.cat([self.dilation1(x), self.dilation2(x)], dim=1)
        return self.aggregation(out) + x


class EAM(nn.Module):
    """Enhancement attention module (reference ridnet_arch.py:111-138):
    ``MergeRun``, a residual block and a ReLU, an enhanced residual block,
    channel attention."""

    def __init__(self, in_channels=64, mid_channels=64, out_channels=64):
        super().__init__()
        self.merge = MergeRun(in_channels, mid_channels)
        self.block1 = ResidualBlockNoBN(mid_channels)
        self.block2 = EResidualBlockNoBN(mid_channels, out_channels)
        self.ca = ChannelAttention(out_channels, squeeze_factor=16)

    def forward(self, x):
        out = torch.relu(self.block1(self.merge(x)))
        return self.ca(self.block2(out))


@ARCH_REGISTRY.register()
class RIDNet(nn.Module):
    """The mean taken off, a conv and a ReLU, ``num_block`` EAMs, a conv,
    the mean put back, plus the input (reference ridnet_arch.py:141-185).
    Call ``x (B, in_channels, H, W)`` in [0, ``img_range``]."""

    def __init__(self, in_channels, mid_channels, out_channels, num_block=4,
                 img_range=255., rgb_mean=(0.4488, 0.4371, 0.4040),
                 rgb_std=(1.0, 1.0, 1.0)):
        super().__init__()
        self.sub_mean = MeanShift(img_range, rgb_mean, rgb_std)
        self.add_mean = MeanShift(img_range, rgb_mean, rgb_std, 1)
        self.head = nn.Conv2d(in_channels, mid_channels, 3, 1, 1)
        self.body = make_layer(EAM, num_block, in_channels=mid_channels,
                               mid_channels=mid_channels,
                               out_channels=mid_channels)
        self.tail = nn.Conv2d(mid_channels, out_channels, 3, 1, 1)

    def init_weights(self, generator):
        """torch's default convs; the two mean shifts their constants."""
        torch_default_init_(self, generator)
        self.sub_mean.reset_parameters_()
        self.add_mean.reset_parameters_()

    def forward(self, x):
        res = torch.relu(self.head(self.sub_mean(x)))
        res = self.add_mean(self.tail(self.body(res)))
        return x + res
