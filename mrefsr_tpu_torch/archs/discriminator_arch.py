"""The SRNTT discriminator of the Ref models' GAN phase (port of
``mrefsr_tpu/archs/discriminator_arch.py:28-67``, ``ImageDiscriminator``).
``VGGStyleDiscriminator`` and ``UNetDiscriminatorSN`` come with the SR
models that use them (ROADMAP A9, A10)."""
import torch
from torch import nn

from mrefsr_tpu_torch.parallel.batch_norm import BatchNorm2d
from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import srntt_normal_init_


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
