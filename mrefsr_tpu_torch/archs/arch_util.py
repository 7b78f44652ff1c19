"""Shared arch building blocks (port of ``mrefsr_tpu/archs/arch_util.py``).

Module attribute names are the reference's torch names, so a reference
``.pth`` and the output of
:func:`mrefsr_tpu_torch.convert.state_dict_from_flax` load with
``load_state_dict(strict=True)``. The model builds its nets on ``meta``
and gives them values with :func:`normal_` and
:func:`srntt_normal_init_`, which draw from an explicit CPU
``torch.Generator``: the same seed gives the same weights on every
device, and the global RNG is never used.
"""
import torch
from torch import nn


def lrelu(x, slope=0.1):
    return nn.functional.leaky_relu(x, slope)


@torch.no_grad()
def normal_(tensor, std, generator):
    """Fill ``tensor`` with N(0, std) drawn on the CPU from ``generator``."""
    tensor.copy_(torch.randn(tensor.shape, generator=generator) * std)


@torch.no_grad()
def srntt_normal_init_(module, generator, std=0.02):
    """The reference's ``srntt_init_weights(net, 'normal', 0.02)``: every
    conv weight N(0, std), every bias 0, every PReLU 0.25."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            normal_(m.weight, std, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)


class ResidualBlockNoBN(nn.Module):
    """Conv-ReLU-Conv residual block (reference arch_util.py:89-117)."""

    def __init__(self, num_feat=64):
        super().__init__()
        self.conv1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)

    def forward(self, x):
        out = self.conv2(torch.relu(self.conv1(x)))
        return x + out


def make_layer(block_cls, num_blocks, **kwargs):
    """``num_blocks`` identical blocks in an ``nn.Sequential``: children
    named ``0``, ``1``, ... as in the reference."""
    return nn.Sequential(*(block_cls(**kwargs) for _ in range(num_blocks)))
