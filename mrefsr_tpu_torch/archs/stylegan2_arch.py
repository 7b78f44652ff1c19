"""StyleGAN2 generator and discriminator (port of
``mrefsr_tpu/archs/stylegan2_arch.py``; reference
basicsr/archs/stylegan2_arch.py).

* Tensors are NCHW and parameters keep the reference's torch names and
  shapes, so one ``.pth`` loads into the reference, the JAX package and
  this one (``convert.stylegan2_state_dict_from_flax`` carries flax
  parameters across).
* ``ModulatedConv2d`` follows the JAX package's factored form: modulation
  is per input channel and demodulation per output channel, so the
  reference's per-sample weights and ``groups=b`` conv become
  ``conv(x * style, shared weight) * demod``, one batched cuDNN conv.
* ``upfirdn2d`` (every resampling filter) and ``fused_leaky_relu`` (every
  activation of G, the mapping net and D's biased convs) come from
  :mod:`mrefsr_tpu_torch.ops`: hand-written CUDA kernels on a CUDA tensor,
  their plain versions on a CPU tensor. The dense and transposed
  convolutions and the linear products stay cuDNN / cuBLAS.
* Randomness is explicit: injected noise is drawn from the
  ``torch.Generator`` the caller passes (or given as tensors), and the
  style-mixing crossover from a ``random.Random``. Weights come from
  ``init_weights(generator)`` or a state dict; a freshly built net holds
  uninitialised memory.
"""
import math

import torch
from torch import nn
from torch.nn import functional as F

from mrefsr_tpu_torch.ops import fused_leaky_relu, upfirdn2d
from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import normal_


def make_resample_kernel(k):
    """1-D magnitudes -> normalised 2-D FIR kernel (reference :26-40), a
    CPU tensor whatever the default device: ``upfirdn2d`` passes its
    values to the CUDA kernel by value."""
    k = torch.as_tensor(k, dtype=torch.float32, device='cpu')
    if k.dim() == 1:
        k = torch.outer(k, k)
    return k / k.sum()


def norm_style_code(x):
    """(reference NormStyleCode :12-23)"""
    return x * torch.rsqrt(torch.mean(x ** 2, dim=1, keepdim=True) + 1e-8)


class NormStyleCode(nn.Module):

    def forward(self, x):
        return norm_style_code(x)


class EqualLinear(nn.Module):
    """Equalized linear (reference :134-180); ``weight`` is (out, in)."""

    def __init__(self, in_channels, out_channels, bias=True, bias_init_val=0.,
                 lr_mul=1., activation=None):
        super().__init__()
        if activation not in (None, 'fused_lrelu'):
            raise ValueError(f'Wrong activation value in EqualLinear: '
                             f'{activation}. Supported ones are: '
                             f"['fused_lrelu', None].")
        self.lr_mul = lr_mul
        self.activation = activation
        self.bias_init_val = bias_init_val
        self.scale = (1 / math.sqrt(in_channels)) * lr_mul
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels))
        if bias:
            self.bias = nn.Parameter(torch.empty(out_channels))
        else:
            self.register_parameter('bias', None)

    def forward(self, x):
        bias = None if self.bias is None else self.bias * self.lr_mul
        out = F.linear(x, self.weight * self.scale)
        if self.activation == 'fused_lrelu':
            return fused_leaky_relu(out, bias)
        return out if bias is None else out + bias


def _smooth(x, kernel, upsample_factor, downsample_factor, kernel_size):
    """UpFirDnSmooth (reference :97-131): the FIR at stride 1, padded so
    that the strided conv of ``kernel_size`` beside it lands on the
    reference's sample grid."""
    k = kernel
    if upsample_factor > 1:
        k = k * (upsample_factor ** 2)
        pad = (k.shape[0] - upsample_factor) - (kernel_size - 1)
        pad = ((pad + 1) // 2 + upsample_factor - 1, pad // 2 + 1)
    elif downsample_factor > 1:
        pad = (k.shape[0] - downsample_factor) + (kernel_size - 1)
        pad = ((pad + 1) // 2, pad // 2)
    else:
        raise NotImplementedError
    return upfirdn2d(x, k, up=1, down=1, pad=pad)


def upfirdn_upsample(x, kernel, factor=2):
    """(reference UpFirDnUpsample :43-69)"""
    k = kernel * (factor ** 2)
    pad = k.shape[0] - factor
    return upfirdn2d(x, k, up=factor, down=1,
                     pad=((pad + 1) // 2 + factor - 1, pad // 2))


def upfirdn_downsample(x, kernel, factor=2):
    """(reference UpFirDnDownsample :72-94)"""
    pad = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=1, down=factor,
                     pad=((pad + 1) // 2, pad // 2))


class UpFirDnSmooth(nn.Module):
    """:func:`_smooth` as a parameter-free child, so that a ``ConvLayer``
    numbers its children as the reference's ``nn.Sequential`` does."""

    def __init__(self, resample_kernel, upsample_factor=1,
                 downsample_factor=1, kernel_size=1):
        super().__init__()
        self.kernel = make_resample_kernel(resample_kernel)
        self.factors = (upsample_factor, downsample_factor, kernel_size)

    def forward(self, x):
        return _smooth(x, self.kernel, *self.factors)


class FusedLeakyReLU(nn.Module):
    """Bias-owning fused leaky ReLU (reference
    ops/fused_act/fused_act.py:81-92)."""

    def __init__(self, num_channels):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(num_channels))

    def forward(self, x):
        return fused_leaky_relu(x, self.bias)


class ScaledLeakyReLU(nn.Module):
    """(reference ScaledLeakyReLU :589-602), the activation of a conv
    without bias; no net of this file builds one. Derivative 1 at 0, as
    ``fused_leaky_relu`` has it."""

    def __init__(self, negative_slope=0.2):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return fused_leaky_relu(x, None, self.negative_slope)


class ConstantInput(nn.Module):
    """Learned constant input (reference :377-392)."""

    def __init__(self, num_channel, size):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, num_channel, size, size))

    def forward(self, batch):
        return self.weight.repeat(batch, 1, 1, 1)


class ModulatedConv2d(nn.Module):
    """Modulated conv (reference :182-285) in the factored form:
    ``conv(x * s_in) * demod_out`` with one shared kernel. ``weight``
    keeps the reference's (1, out, in, k, k)."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 num_style_feat, demodulate=True, sample_mode=None,
                 resample_kernel=(1, 3, 3, 1), eps=1e-8):
        super().__init__()
        if sample_mode not in (None, 'upsample', 'downsample'):
            raise ValueError(f'Wrong sample mode {sample_mode}, supported '
                             f"ones are ['upsample', 'downsample', None].")
        self.kernel_size = kernel_size
        self.demodulate = demodulate
        self.sample_mode = sample_mode
        self.eps = eps
        self.scale = 1 / math.sqrt(in_channels * kernel_size ** 2)
        self.resample_kernel = make_resample_kernel(resample_kernel)
        self.modulation = EqualLinear(num_style_feat, in_channels, bias=True,
                                      bias_init_val=1)
        self.weight = nn.Parameter(torch.empty(
            1, out_channels, in_channels, kernel_size, kernel_size))
        self.padding = kernel_size // 2

    def forward(self, x, style):
        k = self.kernel_size
        style = self.modulation(style)                     # (b, c_in)
        weight = self.scale * self.weight[0]               # (out, in, k, k)
        if self.demodulate:
            # sum over (in, k, k) of (weight * style)^2, as one product
            demod = torch.rsqrt(F.linear(
                style ** 2, (weight ** 2).sum((2, 3))) + self.eps)
            demod = demod[:, :, None, None]                # (b, out, 1, 1)
        x = x * style[:, :, None, None]
        if self.sample_mode == 'upsample':
            out = F.conv_transpose2d(x, weight.transpose(0, 1), stride=2)
            if self.demodulate:
                out = out * demod
            return _smooth(out, self.resample_kernel, 2, 1, k)
        if self.sample_mode == 'downsample':
            x = _smooth(x, self.resample_kernel, 1, 2, k)
            out = F.conv2d(x, weight, stride=2)
        else:
            out = F.conv2d(x, weight, padding=self.padding)
        return out * demod if self.demodulate else out


def _randn(shape, like, generator):
    if generator is None:
        raise ValueError('no noise was given: pass noise tensors or the '
                         'torch.Generator to draw them from')
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


class StyleConv(nn.Module):
    """Modulated conv + noise injection + fused leaky ReLU
    (reference :288-333). ``weight`` is the noise strength."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 num_style_feat, demodulate=True, sample_mode=None,
                 resample_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.modulated_conv = ModulatedConv2d(
            in_channels, out_channels, kernel_size, num_style_feat,
            demodulate=demodulate, sample_mode=sample_mode,
            resample_kernel=resample_kernel)
        self.weight = nn.Parameter(torch.empty(1))
        self.activate = FusedLeakyReLU(out_channels)

    def forward(self, x, style, noise=None, generator=None):
        out = self.modulated_conv(x, style)
        if noise is None:
            b, _, h, w = out.shape
            noise = _randn((b, 1, h, w), out, generator)
        out = out + self.weight * noise
        return self.activate(out)


class ToRGB(nn.Module):
    """Feature -> RGB with skip (reference :336-374)."""

    def __init__(self, in_channels, num_style_feat, upsample=True,
                 resample_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.upsample = upsample
        self.resample_kernel = make_resample_kernel(resample_kernel)
        self.modulated_conv = ModulatedConv2d(
            in_channels, 3, kernel_size=1, num_style_feat=num_style_feat,
            demodulate=False, sample_mode=None)
        self.bias = nn.Parameter(torch.empty(1, 3, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.modulated_conv(x, style) + self.bias
        if skip is not None:
            if self.upsample:
                skip = upfirdn_upsample(skip, self.resample_kernel)
            out = out + skip
        return out


def _sg2_channels(channel_multiplier, narrow):
    return {
        '4': int(512 * narrow), '8': int(512 * narrow),
        '16': int(512 * narrow), '32': int(512 * narrow),
        '64': int(256 * channel_multiplier * narrow),
        '128': int(128 * channel_multiplier * narrow),
        '256': int(64 * channel_multiplier * narrow),
        '512': int(32 * channel_multiplier * narrow),
        '1024': int(16 * channel_multiplier * narrow),
    }


def _style_mlp(num_style_feat, num_mlp, lr_mlp):
    """``NormStyleCode`` then ``num_mlp`` linears: children 0 ..
    ``num_mlp``, the reference's ``style_mlp.{1..}`` keys."""
    return nn.Sequential(NormStyleCode(), *(
        EqualLinear(num_style_feat, num_style_feat, bias=True,
                    bias_init_val=0, lr_mul=lr_mlp, activation='fused_lrelu')
        for _ in range(num_mlp)))


@torch.no_grad()
def _init_stylegan2_weights(net, generator):
    """The reference's initial values, drawn on the CPU from
    ``generator``: N(0, 1) weights (over ``lr_mul`` for a linear), constant
    biases, zero noise strengths, N(0, 1) noise buffers."""
    for m in net.modules():
        if isinstance(m, EqualLinear):
            normal_(m.weight, 1 / m.lr_mul, generator)
            if m.bias is not None:
                m.bias.fill_(m.bias_init_val)
        elif isinstance(m, EqualConv2d):
            normal_(m.weight, 1, generator)
            if m.bias is not None:
                m.bias.fill_(m.bias_init_val)
        elif isinstance(m, (ModulatedConv2d, ConstantInput)):
            normal_(m.weight, 1, generator)
        elif isinstance(m, (FusedLeakyReLU, ToRGB)):
            m.bias.zero_()
        elif isinstance(m, StyleConv):
            m.weight.zero_()
    for buffer in net.buffers():
        normal_(buffer, 1, generator)


class StyleMLP(nn.Module):
    """The generator's z -> w mapping network alone, with the generator's
    ``style_mlp.{i}`` parameter names: load the ``style_mlp.*`` entries of
    a generator's state dict (or share the generator's ``style_mlp``) to
    compute mean latents and truncation anchors without synthesising
    images (the reference's ``g_ema.mean_latent()``,
    stylegan2_arch.py:491-495)."""

    def __init__(self, num_style_feat=512, num_mlp=8, lr_mlp=0.01):
        super().__init__()
        self.style_mlp = _style_mlp(num_style_feat, num_mlp, lr_mlp)

    def forward(self, s):
        return self.style_mlp(s)

    def init_weights(self, generator):
        _init_stylegan2_weights(self, generator)


@ARCH_REGISTRY.register()
class StyleGAN2Generator(nn.Module):
    """StyleGAN2 generator (reference :395-586). NCHW output.

    ``styles`` is a list of one or two (b, num_style_feat) codes. Noise:
    ``noise`` (a list of ``num_layers`` (b or 1, 1, h, w) tensors), else
    the ``noises.noise{i}`` buffers when ``randomize_noise`` is false,
    else drawn from ``generator``. With two styles the crossover is
    ``inject_index``, else drawn from ``rng`` (a ``random.Random``).
    Returns ``(image, latents or None)``.
    """

    def __init__(self, out_size, num_style_feat=512, num_mlp=8,
                 channel_multiplier=2, resample_kernel=(1, 3, 3, 1),
                 lr_mlp=0.01, narrow=1):
        super().__init__()
        self.num_style_feat = num_style_feat
        self.style_mlp = _style_mlp(num_style_feat, num_mlp, lr_mlp)
        channels = _sg2_channels(channel_multiplier, narrow)
        self.constant_input = ConstantInput(channels['4'], size=4)
        self.style_conv1 = StyleConv(
            channels['4'], channels['4'], 3, num_style_feat, demodulate=True,
            sample_mode=None, resample_kernel=resample_kernel)
        self.to_rgb1 = ToRGB(channels['4'], num_style_feat, upsample=False,
                             resample_kernel=resample_kernel)
        self.log_size = int(math.log(out_size, 2))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.num_latent = self.log_size * 2 - 2

        self.style_convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        self.noises = nn.Module()
        in_channels = channels['4']
        for layer_idx in range(self.num_layers):
            resolution = 2 ** ((layer_idx + 5) // 2)
            self.noises.register_buffer(
                f'noise{layer_idx}',
                torch.empty(1, 1, resolution, resolution))
        for i in range(3, self.log_size + 1):
            out_channels = channels[f'{2 ** i}']
            self.style_convs.append(StyleConv(
                in_channels, out_channels, 3, num_style_feat,
                demodulate=True, sample_mode='upsample',
                resample_kernel=resample_kernel))
            self.style_convs.append(StyleConv(
                out_channels, out_channels, 3, num_style_feat,
                demodulate=True, sample_mode=None,
                resample_kernel=resample_kernel))
            self.to_rgbs.append(ToRGB(out_channels, num_style_feat,
                                      upsample=True,
                                      resample_kernel=resample_kernel))
            in_channels = out_channels

    def init_weights(self, generator):
        _init_stylegan2_weights(self, generator)

    def forward(self, styles, input_is_latent=False, noise=None,
                randomize_noise=True, truncation=1, truncation_latent=None,
                inject_index=None, return_latents=False, generator=None,
                rng=None):
        if not isinstance(styles, (list, tuple)):
            styles = [styles]
        if not input_is_latent:
            styles = [self.style_mlp(s) for s in styles]
        if noise is None:
            if randomize_noise:
                noise = [None] * self.num_layers
            else:
                noise = [getattr(self.noises, f'noise{i}')
                         for i in range(self.num_layers)]
        if truncation < 1:
            styles = [truncation_latent + truncation
                      * (style - truncation_latent) for style in styles]

        if len(styles) == 1:
            if styles[0].dim() < 3:
                latent = styles[0].unsqueeze(1).repeat(1, self.num_latent, 1)
            else:
                latent = styles[0]
        elif len(styles) == 2:
            if inject_index is None:
                if rng is None:
                    raise ValueError('two styles need inject_index or the '
                                     'random.Random to draw it from')
                inject_index = rng.randint(1, self.num_latent - 1)
            inject_index = int(inject_index)
            latent = torch.cat([
                styles[0].unsqueeze(1).repeat(1, inject_index, 1),
                styles[1].unsqueeze(1).repeat(
                    1, self.num_latent - inject_index, 1)], 1)
        else:
            raise ValueError('styles must have 1 or 2 entries')

        out = self.constant_input(latent.shape[0])
        out = self.style_conv1(out, latent[:, 0], noise=noise[0],
                               generator=generator)
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for conv1, conv2, noise1, noise2, to_rgb in zip(
                self.style_convs[::2], self.style_convs[1::2], noise[1::2],
                noise[2::2], self.to_rgbs):
            out = conv1(out, latent[:, i], noise=noise1, generator=generator)
            out = conv2(out, latent[:, i + 1], noise=noise2,
                        generator=generator)
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        return skip, (latent if return_latents else None)


class EqualConv2d(nn.Module):
    """Equalized conv (reference :605-651); ``weight`` is OIHW."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, bias_init_val=0.):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.bias_init_val = bias_init_val
        self.scale = 1 / math.sqrt(in_channels * kernel_size ** 2)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))
        if bias:
            self.bias = nn.Parameter(torch.empty(out_channels))
        else:
            self.register_parameter('bias', None)

    def forward(self, x):
        return F.conv2d(x, self.weight * self.scale, bias=self.bias,
                        stride=self.stride, padding=self.padding)


class ConvLayer(nn.Sequential):
    """ConvLayer (reference :654-701): [smooth,] conv[, activation], the
    children numbered as the reference's (the conv is child 1 under
    ``downsample``, else 0)."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 downsample=False, resample_kernel=(1, 3, 3, 1), bias=True,
                 activate=True):
        layers = []
        if downsample:
            layers.append(UpFirDnSmooth(
                resample_kernel, upsample_factor=1, downsample_factor=2,
                kernel_size=kernel_size))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(
            in_channels, out_channels, kernel_size, stride=stride,
            padding=padding, bias=bias and not activate))
        if activate:
            layers.append(FusedLeakyReLU(out_channels) if bias
                          else ScaledLeakyReLU(0.2))
        super().__init__(*layers)


class ResBlock(nn.Module):
    """D residual block (reference :704-731)."""

    def __init__(self, in_channels, out_channels,
                 resample_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.conv1 = ConvLayer(in_channels, in_channels, 3, bias=True,
                               activate=True)
        self.conv2 = ConvLayer(in_channels, out_channels, 3, downsample=True,
                               resample_kernel=resample_kernel, bias=True,
                               activate=True)
        self.skip = ConvLayer(in_channels, out_channels, 1, downsample=True,
                              resample_kernel=resample_kernel, bias=False,
                              activate=False)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return (out + self.skip(x)) / math.sqrt(2)


@ARCH_REGISTRY.register()
class StyleGAN2Discriminator(nn.Module):
    """StyleGAN2 discriminator (reference :734-799). NCHW input,
    (b, 1) output."""

    def __init__(self, out_size, channel_multiplier=2,
                 resample_kernel=(1, 3, 3, 1), stddev_group=4, narrow=1):
        super().__init__()
        channels = _sg2_channels(channel_multiplier, narrow)
        log_size = int(math.log(out_size, 2))
        conv_body = [ConvLayer(3, channels[f'{out_size}'], 1, bias=True,
                               activate=True)]
        in_channels = channels[f'{out_size}']
        for i in range(log_size, 2, -1):
            out_channels = channels[f'{2 ** (i - 1)}']
            conv_body.append(ResBlock(in_channels, out_channels,
                                      resample_kernel))
            in_channels = out_channels
        self.conv_body = nn.Sequential(*conv_body)
        self.final_conv = ConvLayer(in_channels + 1, channels['4'], 3,
                                    bias=True, activate=True)
        self.final_linear = nn.Sequential(
            EqualLinear(channels['4'] * 4 * 4, channels['4'], bias=True,
                        bias_init_val=0, lr_mul=1, activation='fused_lrelu'),
            EqualLinear(channels['4'], 1, bias=True, bias_init_val=0,
                        lr_mul=1, activation=None))
        self.stddev_group = stddev_group

    def init_weights(self, generator):
        _init_stylegan2_weights(self, generator)

    def forward(self, x):
        out = self.conv_body(x)
        b, c, h, w = out.shape
        # minibatch standard deviation, one value per group member
        group = min(b, self.stddev_group)
        stddev = out.view(group, -1, 1, c, h, w)
        stddev = torch.sqrt(stddev.var(0, unbiased=False) + 1e-8)
        stddev = stddev.mean([2, 3, 4], keepdim=True).squeeze(2)
        stddev = stddev.repeat(group, 1, h, w)
        out = torch.cat([out, stddev], 1)
        out = self.final_conv(out)
        return self.final_linear(out.reshape(b, -1))
