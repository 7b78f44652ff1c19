"""Discriminators (port of ``mrefsr_tpu/archs/discriminator_arch.py``):
the SRNTT ``ImageDiscriminator`` of the Ref models' GAN phase (:28-67) and
the ``VGGStyleDiscriminator`` of ``SRGANModel`` and the video GAN models
(:70-107). ``UNetDiscriminatorSN`` comes with Real-ESRGAN (ROADMAP
A10)."""
import torch
from torch import nn

from mrefsr_tpu_torch.parallel.batch_norm import BatchNorm2d
from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import default_init_, srntt_normal_init_


def _conv_block(in_ch, out_ch):
    """conv, BN, LReLU(0.2), stride-2 conv, BN, LReLU(0.2): the torch
    ``Sequential`` indices 0, 1, 3, 4 name the convs and the norms."""
    return nn.Sequential(
        nn.Conv2d(in_ch, out_ch, 3, 1, 1), BatchNorm2d(out_ch),
        nn.LeakyReLU(0.2),
        nn.Conv2d(out_ch, out_ch, 3, 2, 1), BatchNorm2d(out_ch),
        nn.LeakyReLU(0.2))


@ARCH_REGISTRY.register()
class ImageDiscriminator(nn.Module):
    """Five conv-BN blocks of widths ``ndf`` x 1, 2, 4, 8, 16, a global
    mean, 1x1 convs of 1024 and 1, and a sigmoid (reference
    discriminator_arch.py:11-45). NCHW in, (B, 1, 1, 1) out.

    In training mode the norms use their batch's statistics (over every
    rank's batch in a run of several: :mod:`..parallel.batch_norm`), as the
    reference trains its discriminator; ``train_mode`` is the JAX
    package's switch for that and is accepted for its options."""

    def __init__(self, in_nc=3, ndf=32, train_mode=False):
        super().__init__()
        self.conv_block1 = _conv_block(in_nc, ndf)
        self.conv_block2 = _conv_block(ndf, ndf * 2)
        self.conv_block3 = _conv_block(ndf * 2, ndf * 4)
        self.conv_block4 = _conv_block(ndf * 4, ndf * 8)
        self.conv_block5 = _conv_block(ndf * 8, ndf * 16)
        self.out_block = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(ndf * 16, 1024, 1),
            nn.LeakyReLU(0.2), nn.Conv2d(1024, 1, 1), nn.Sigmoid())

    def forward(self, x):
        for block in (self.conv_block1, self.conv_block2, self.conv_block3,
                      self.conv_block4, self.conv_block5, self.out_block):
            x = block(x)
        return x

    @torch.no_grad()
    def init_weights(self, generator):
        """``srntt_init_weights(0.02)``: N(0, 0.02) convs, zero biases;
        the norms at scale 1, shift 0, running mean 0 and variance 1."""
        srntt_normal_init_(self, generator)
        for m in self.modules():
            if isinstance(m, BatchNorm2d):
                m.reset_parameters()


@ARCH_REGISTRY.register()
class VGGStyleDiscriminator(nn.Module):
    """A 3x3 conv, then pairs of a bias-free 3x3 and a bias-free stride-2
    4x4 conv, each followed by a norm, at widths ``num_feat`` x 1, 2, 4, 8,
    8 (and 8 more for ``input_size`` 256), LeakyReLU(0.2) after each; the
    NCHW map flattened into ``linear1`` (100) and ``linear2`` (1)
    (reference discriminator_arch.py:48-126). Call ``x (B, 3, input_size,
    input_size)``; returns ``(B, 1)``.

    The norms use their batch's statistics in training mode, as the
    reference trains its discriminator (over every rank's batch where the
    model sets their ``sync``). ``train_mode`` is the JAX package's switch
    for that and is accepted for its options. The JAX package flattens
    the map NHWC: :func:`mrefsr_tpu_torch.convert.vgg_style_discriminator_
    state_dict_from_flax` permutes its ``linear1`` to this layout."""

    def __init__(self, num_in_ch=3, num_feat=64, input_size=160,
                 train_mode=False):
        super().__init__()
        if input_size not in (160, 256):
            raise ValueError(f'input size must be 160 or 256, got '
                             f'{input_size}')
        self.input_size = input_size
        nf = num_feat
        widths = [nf, nf * 2, nf * 4, nf * 8, nf * 8]
        if input_size == 256:
            widths.append(nf * 8)
        self.conv0_0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        self.conv0_1 = nn.Conv2d(nf, nf, 4, 2, 1, bias=False)
        self.bn0_1 = BatchNorm2d(nf)
        for idx in range(1, len(widths)):
            ch_in, ch = widths[idx - 1], widths[idx]
            setattr(self, f'conv{idx}_0', nn.Conv2d(ch_in, ch, 3, 1, 1,
                                                    bias=False))
            setattr(self, f'bn{idx}_0', BatchNorm2d(ch))
            setattr(self, f'conv{idx}_1', nn.Conv2d(ch, ch, 4, 2, 1,
                                                    bias=False))
            setattr(self, f'bn{idx}_1', BatchNorm2d(ch))
        self.num_levels = len(widths)
        side = input_size >> len(widths)
        self.linear1 = nn.Linear(nf * 8 * side * side, 100)
        self.linear2 = nn.Linear(100, 1)
        self.lrelu = nn.LeakyReLU(0.2)

    @torch.no_grad()
    def init_weights(self, generator):
        """torch's default convs and linears (U(+-1/sqrt(fan_in)), seeded);
        the norms at scale 1, shift 0, running mean 0 and variance 1."""
        default_init_(self, generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1 / m.weight.shape[1] ** 0.5
                for t in (m.weight, m.bias):
                    t.copy_(torch.rand(t.shape, generator=generator)
                            * (2 * bound) - bound)
            elif isinstance(m, BatchNorm2d):
                m.reset_parameters()

    def forward(self, x):
        if x.shape[2] != self.input_size or x.shape[3] != self.input_size:
            raise ValueError(f'input size must be {self.input_size}, got '
                             f'{tuple(x.shape)}')
        feat = self.lrelu(self.conv0_0(x))
        feat = self.lrelu(self.bn0_1(self.conv0_1(feat)))
        for idx in range(1, self.num_levels):
            for sub in (0, 1):
                conv = getattr(self, f'conv{idx}_{sub}')
                feat = self.lrelu(getattr(self, f'bn{idx}_{sub}')(conv(feat)))
        feat = self.lrelu(self.linear1(feat.flatten(1)))
        return self.linear2(feat)
