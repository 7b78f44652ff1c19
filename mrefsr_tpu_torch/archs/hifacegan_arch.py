"""HiFaceGAN's generator and multi-scale discriminator (port of
``mrefsr_tpu/archs/hifacegan_arch.py``, the reference's
basicsr/archs/hifacegan_arch.py), NCHW.

The generator builds what the JAX package's builds: the up blocks
``ups.0`` to ``ups.{phase - 1}`` and the one ``to_rgbs.{phase - 1}`` its
forward runs (``phase`` is ``init_train_phase + 1`` where ``is_train``,
else 4), so the flax variables load strictly.
"""
import torch
from torch import nn
from torch.nn import functional as F

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import SNConv2d, avg_pool2d
from .hifacegan_util import (InstanceNorm2d, LIPEncoder, SPADEResnetBlock,
                             nearest_resize, torch_default_sn_init_)


@ARCH_REGISTRY.register()
class SPADEGenerator(nn.Module):
    """SPADE generator (reference hifacegan_arch.py:10-143): the input
    encoded at 1/32 of its size, ``head_0``, a 2x nearest upsampling, two
    middle blocks, then ``phase`` times a 2x upsampling and an up block
    (widths 16, 8, 4, 2, 1 x ``num_feat``), LeakyReLU(0.2), a 3x3 conv to
    RGB and tanh; every block is conditioned on the input itself. This
    class encodes by a nearest downsampling and the 3x3 conv ``fc``."""

    scale_ratio = 5

    def __init__(self, num_in_ch=3, num_feat=64, use_vae=False, z_dim=256,
                 crop_size=512, norm_g='spectralspadesyncbatch3x3',
                 is_train=True, init_train_phase=3):
        super().__init__()
        nf = num_feat
        self.num_in_ch, self.num_feat = num_in_ch, num_feat
        self.sw = crop_size // 2 ** self.scale_ratio
        self.phase = init_train_phase + 1 if is_train else 4
        self.make_encoder()
        self.head_0 = SPADEResnetBlock(16 * nf, 16 * nf, norm_g)
        self.g_middle_0 = SPADEResnetBlock(16 * nf, 16 * nf, norm_g)
        self.g_middle_1 = SPADEResnetBlock(16 * nf, 16 * nf, norm_g)
        up_channels = [(16 * nf, 8 * nf), (8 * nf, 4 * nf), (4 * nf, 2 * nf),
                       (2 * nf, nf)]
        self.ups = nn.ModuleList(SPADEResnetBlock(*up_channels[i], norm_g)
                                 for i in range(self.phase))
        self.to_rgbs = nn.ModuleDict({str(self.phase - 1): nn.Conv2d(
            up_channels[self.phase - 1][1], 3, 3, padding=1)})

    def make_encoder(self):
        self.fc = nn.Conv2d(self.num_in_ch, 16 * self.num_feat, 3, padding=1)

    def encode(self, x):
        h, w = x.shape[-2:]
        return self.fc(nearest_resize(x, (h // 2 ** self.scale_ratio,
                                          w // 2 ** self.scale_ratio)))

    @torch.no_grad()
    def init_weights(self, generator):
        """torch's default convs (seeded), normalised ``u`` / ``v``, unit
        affine norms, zero-mean unit-variance frozen norms."""
        torch_default_sn_init_(self, generator)

    def forward(self, x):
        seg = x
        x = self.encode(x)
        x = self.head_0(x, seg)
        x = F.interpolate(x, scale_factor=2, mode='nearest')
        x = self.g_middle_0(x, seg)
        x = self.g_middle_1(x, seg)
        for up in self.ups:
            x = up(F.interpolate(x, scale_factor=2, mode='nearest'), seg)
        x = self.to_rgbs[str(self.phase - 1)](F.leaky_relu(x, 0.2))
        return torch.tanh(x)


@ARCH_REGISTRY.register()
class HiFaceGAN(SPADEGenerator):
    """The SPADE generator with a LIP encoder ``lip_encoder`` (reference
    hifacegan_arch.py:145-165)."""

    def make_encoder(self):
        self.lip_encoder = LIPEncoder(self.num_in_ch, self.num_feat, self.sw,
                                      self.sw, self.scale_ratio)

    def encode(self, x):
        return self.lip_encoder(x)


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator (reference hifacegan_arch.py:222-259): 4x4
    convs at padding 2, the first stride 2 with a bias, then ``n_layers_d
    - 1`` bias-free ones (stride 2 but the last), spectral-normed where
    ``norm_d`` starts with ``spectral``, each followed by an instance norm,
    LeakyReLU(0.2) after all but the last conv to one channel. Returns
    every stage's output where ``keep_features``, else the last."""

    def __init__(self, input_nc, n_layers_d=4, num_feat=64,
                 norm_d='spectralinstance', keep_features=True):
        super().__init__()
        kw, padw = 4, 2
        nf = num_feat
        self.keep_features = keep_features
        self.num_stages = n_layers_d + 1
        conv = SNConv2d if norm_d.startswith('spectral') else nn.Conv2d
        self.model0 = nn.Sequential(
            nn.Conv2d(input_nc, nf, kw, stride=2, padding=padw),
            nn.LeakyReLU(0.2))
        for n in range(1, n_layers_d):
            nf_prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == n_layers_d - 1 else 2
            setattr(self, f'model{n}', nn.Sequential(
                nn.Sequential(conv(nf_prev, nf, kw, stride=stride,
                                   padding=padw, bias=False),
                              InstanceNorm2d(nf)),
                nn.LeakyReLU(0.2)))
        setattr(self, f'model{n_layers_d}', nn.Sequential(
            nn.Conv2d(nf, 1, kw, stride=1, padding=padw)))

    def forward(self, x):
        results = []
        for n in range(self.num_stages):
            x = getattr(self, f'model{n}')(x)
            results.append(x)
        return results if self.keep_features else results[-1]


@ARCH_REGISTRY.register()
class HiFaceGANDiscriminator(nn.Module):
    """pix2pixHD's multi-scale discriminator (reference
    hifacegan_arch.py:168-219): ``num_d`` :class:`NLayerDiscriminator`
    ``discriminator_{i}``, each on the input average-pooled (3x3, stride 2,
    ``count_include_pad=False``; :func:`~.arch_util.avg_pool2d`) once more
    than the last. The input is
    the channel concatenation (lq, output or gt) where ``conditional_d``.
    Returns one list of stage outputs a scale."""

    def __init__(self, num_in_ch=3, num_out_ch=3, conditional_d=True,
                 num_d=2, n_layers_d=4, num_feat=64,
                 norm_d='spectralinstance', keep_features=True):
        super().__init__()
        input_nc = num_in_ch + (num_out_ch if conditional_d else 0)
        self.num_d = num_d
        for i in range(num_d):
            setattr(self, f'discriminator_{i}', NLayerDiscriminator(
                input_nc, n_layers_d, num_feat, norm_d, keep_features))

    @torch.no_grad()
    def init_weights(self, generator):
        """torch's default convs (seeded), normalised ``u`` / ``v``."""
        torch_default_sn_init_(self, generator)

    def forward(self, x):
        result = []
        for i in range(self.num_d):
            result.append(getattr(self, f'discriminator_{i}')(x))
            if i < self.num_d - 1:
                x = avg_pool2d(x, 3, 2, 1, count_include_pad=False)
        return result
