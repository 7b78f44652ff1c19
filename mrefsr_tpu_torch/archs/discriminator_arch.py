"""Discriminators (port of ``mrefsr_tpu/archs/discriminator_arch.py``):
the SRNTT ``ImageDiscriminator`` of the Ref models' GAN phase (:28-67) and
the ``VGGStyleDiscriminator`` of ``SRGANModel`` and the video GAN models
(:70-107), and Real-ESRGAN's ``UNetDiscriminatorSN`` (:110-160)."""
import contextlib

import torch
from torch import nn

from mrefsr_tpu_torch.ops import interpolate
from mrefsr_tpu_torch.parallel.batch_norm import BatchNorm2d
from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import (SNConv2d, default_init_, srntt_normal_init_,
                        torch_default_init_, uniform_)


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


@ARCH_REGISTRY.register()
class UNetDiscriminatorSN(nn.Module):
    """Real-ESRGAN's U-Net discriminator (reference
    discriminator_arch.py:128-186): a 3x3 conv, three stride-2 4x4
    spectral-norm convs down (``num_feat`` x 2, 4, 8), three 3x3 ones up
    after 2x bilinear upsampling (x 4, 2, 1; each added to the map of its
    size on the way down with ``skip_connection``), two more at
    ``num_feat`` and a 3x3 conv to one channel: a map of the input's size.
    ``conv1`` to ``conv8`` are :class:`~.arch_util.SNConv2d` without
    bias; LeakyReLU(0.2) after every conv but the last. NCHW, H and W
    multiples of 8.

    ``conv5``'s forward runs without cuDNN (ATen's im2col and a cuBLAS
    product): with TF32 off, cuDNN's heuristic, and its benchmark too,
    take FFT tiling for it at the published width (256 -> 128 channels at
    128 x 128, B 2 to 12 on an H100: 430-460 ms and 16 GB of workspace a
    forward, against 3.8 ms). Its backward stays on cuDNN."""

    def __init__(self, num_in_ch=3, num_feat=64, skip_connection=True):
        super().__init__()
        nf = num_feat
        self.skip_connection = skip_connection
        self.conv0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        for i, (cin, cout) in enumerate(((nf, nf * 2), (nf * 2, nf * 4),
                                         (nf * 4, nf * 8)), start=1):
            setattr(self, f'conv{i}', SNConv2d(cin, cout, 4, 2, 1,
                                               bias=False))
        for i, (cin, cout) in enumerate(((nf * 8, nf * 4), (nf * 4, nf * 2),
                                         (nf * 2, nf), (nf, nf), (nf, nf)),
                                        start=4):
            setattr(self, f'conv{i}', SNConv2d(cin, cout, 3, 1, 1,
                                               bias=False))
        self.conv9 = nn.Conv2d(nf, 1, 3, 1, 1)
        self.lrelu = nn.LeakyReLU(0.2)

    @torch.no_grad()
    def init_weights(self, generator):
        """torch's default convs (U(+-1/sqrt(fan_in)), seeded), as the
        reference initialises them, and normalised N(0, 1) power-iteration
        vectors."""
        for m in self.modules():
            if isinstance(m, SNConv2d):
                uniform_(m.weight_orig, 1 / m.weight_orig[0].numel() ** 0.5,
                         generator)
                m.reset_vectors_(generator)
            elif isinstance(m, nn.Conv2d):
                torch_default_init_(m, generator, (nn.Conv2d,))

    @staticmethod
    def _up(x):
        return interpolate(x.permute(0, 2, 3, 1), scale_factor=2,
                           mode='bilinear').permute(0, 3, 1, 2)

    def forward(self, x):
        act = self.lrelu
        x0 = act(self.conv0(x))
        x1 = act(self.conv1(x0))
        x2 = act(self.conv2(x1))
        x3 = act(self.conv3(x2))
        x4 = act(self.conv4(self._up(x3)))
        if self.skip_connection:
            x4 = x4 + x2
        with _without_cudnn():
            x5 = act(self.conv5(self._up(x4)))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = act(self.conv6(self._up(x5)))
        if self.skip_connection:
            x6 = x6 + x0
        out = act(self.conv7(x6))
        out = act(self.conv8(out))
        return self.conv9(out)


@contextlib.contextmanager
def _without_cudnn():
    """cuDNN off within the block (``torch.backends.cudnn.enabled``), its
    other settings as they are."""
    before = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = before
