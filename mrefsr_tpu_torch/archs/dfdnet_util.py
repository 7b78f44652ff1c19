"""DFDNet's building blocks (port of ``mrefsr_tpu/archs/dfdnet_util.py``,
the reference's basicsr/archs/dfdnet_util.py), NCHW."""
import torch
from torch import nn
from torch.nn import functional as F

from .arch_util import SNConv2d


def blur(x):
    """The fixed 3x3 binomial blur, a channel at a time, zero padding
    (reference dfdnet_util.py:8-55; its autograd Function only flips the
    symmetric kernel in the backward)."""
    kernel = torch.tensor([[1., 2., 1.], [2., 4., 2.], [1., 2., 1.]],
                          dtype=x.dtype, device=x.device) / 16
    c = x.shape[1]
    return F.conv2d(x, kernel.expand(c, 1, 3, 3), padding=1, groups=c)


def calc_mean_std(feat, eps=1e-5):
    """Each sample's channel means and standard deviations over H, W (the
    unbiased variance plus ``eps``), shaped (N, C, 1, 1) (reference
    dfdnet_util.py:57-72)."""
    mean = feat.mean((2, 3), keepdim=True)
    var = feat.var((2, 3), unbiased=True, keepdim=True) + eps
    return mean, var.sqrt()


def adaptive_instance_normalization(content_feat, style_feat):
    """``content_feat`` re-styled to ``style_feat``'s channel statistics
    (reference dfdnet_util.py:75-89)."""
    style_mean, style_std = calc_mean_std(style_feat)
    content_mean, content_std = calc_mean_std(content_feat)
    return (content_feat - content_mean) / content_std * style_std \
        + style_mean


def _sn_block(channels, kernel_size, dilation):
    pad = (kernel_size - 1) // 2 * dilation
    return nn.Sequential(
        SNConv2d(channels, channels, kernel_size, padding=pad,
                 dilation=dilation),
        nn.LeakyReLU(0.2),
        SNConv2d(channels, channels, kernel_size, padding=pad,
                 dilation=dilation))


class MSDilationBlock(nn.Module):
    """Four spectral-norm conv pairs at the dilations given, concatenated,
    fused by a spectral-norm conv, plus the input (reference
    dfdnet_util.py:122-146)."""

    def __init__(self, in_channels, kernel_size=3, dilation=(1, 1, 1, 1)):
        super().__init__()
        self.conv_blocks = nn.ModuleList(
            _sn_block(in_channels, kernel_size, d) for d in dilation)
        self.conv_fusion = SNConv2d(in_channels * 4, in_channels,
                                    kernel_size,
                                    padding=(kernel_size - 1) // 2)

    def forward(self, x):
        out = torch.cat([block(x) for block in self.conv_blocks], 1)
        return self.conv_fusion(out) + x


class UpResBlock(nn.Module):
    """``x + conv(LeakyReLU(0.2)(conv(x)))`` (reference
    dfdnet_util.py:149-161)."""

    def __init__(self, in_channel):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(in_channel, in_channel, 3, 1, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(in_channel, in_channel, 3, 1, 1))

    def forward(self, x):
        return x + self.body(x)
