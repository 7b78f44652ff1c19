"""Shared arch building blocks (port of ``mrefsr_tpu/archs/arch_util.py``).

Module attribute names are the reference's torch names, so a reference
``.pth`` and the output of
:func:`mrefsr_tpu_torch.convert.state_dict_from_flax` load with
``load_state_dict(strict=True)``. The model builds its nets on ``meta``
and gives them values with :func:`normal_` and
:func:`srntt_normal_init_`, which draw from an explicit CPU
``torch.Generator``: the same seed gives the same weights on every
device, and the global RNG is never used. The video nets take theirs
from :func:`default_init_`.
"""
import math

import torch
from torch import nn
from torch.nn import functional as F

from mrefsr_tpu_torch.ops import (flow_warp, interpolate,
                                  modulated_deform_conv2d,
                                  offset_mask_from_conv_out)


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


@torch.no_grad()
def uniform_(tensor, bound, generator):
    """Fill ``tensor`` with U(-bound, bound) drawn on the CPU from
    ``generator``."""
    tensor.copy_(torch.rand(tensor.shape, generator=generator) * (2 * bound)
                 - bound)


@torch.no_grad()
def torch_default_init_(module, generator, types=(nn.Conv2d, nn.Linear)):
    """Every submodule of ``module`` of one of ``types`` as torch
    initialises a fresh one: weight and bias U(+-1/sqrt(fan_in))
    (``kaiming_uniform_(a=sqrt(5))``), drawn from ``generator``."""
    for m in module.modules():
        if isinstance(m, types):
            bound = 1 / math.sqrt(m.weight[0].numel())
            uniform_(m.weight, bound, generator)
            if m.bias is not None:
                uniform_(m.bias, bound, generator)


@torch.no_grad()
def default_init_(module, generator):
    """Seeded weights as the reference initialises a fresh video net: every
    conv torch's default (weight and bias U(+-1/sqrt(fan_in)), i.e.
    ``kaiming_uniform_(a=sqrt(5))``); the two convs of each
    :class:`ResidualBlockNoBN` kaiming-normal (fan_in) x 0.1 with a zero
    bias (the reference's ``default_init_weights(..., 0.1)``); then each
    submodule's own ``reset_parameters_(generator)`` (the deformable convs'
    weights and zero offset convs, SpyNet's ImageNet constants)."""
    torch_default_init_(module, generator, (nn.Conv2d,))
    for m in module.modules():
        if isinstance(m, ResidualBlockNoBN):
            for conv in (m.conv1, m.conv2):
                normal_(conv.weight,
                        0.1 * math.sqrt(2 / conv.weight[0].numel()),
                        generator)
                conv.bias.zero_()
    for m in module.modules():
        if hasattr(m, 'reset_parameters_'):
            m.reset_parameters_(generator)


def _l2norm(v, eps=1e-12):
    return v / (torch.linalg.vector_norm(v) + eps)


class SNConv2d(nn.Conv2d):
    """A conv with spectral normalisation (the JAX package's ``SNConv``,
    hifacegan_util.py:40; torch's ``spectral_norm`` names): the parameter
    ``weight_orig`` (O, I, kh, kw) and the buffers ``weight_u`` (O) and
    ``weight_v`` (I * kh * kw) of the power iteration, so a reference
    ``.pth`` loads as it is. The conv's weight is ``weight_orig / sigma``,
    ``sigma = u . (W v)`` with W the weight as (O, I * kh * kw). In
    training mode each forward first takes one power iteration from the
    stored vectors (``v = norm(W^T u)``, ``u = norm(W v)``, x / (|x| +
    1e-12), no gradient) and stores them while :attr:`update_stats` is set
    (:func:`~mrefsr_tpu_torch.parallel.batch_norm.frozen_stats` clears it:
    the JAX GAN step iterates in the generator's pass and drops the
    result); in eval mode the stored vectors give sigma."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        weight = self.weight
        del self.weight
        self.weight_orig = nn.Parameter(weight.detach())
        self.register_buffer('weight_u', weight.new_empty(weight.shape[0]))
        self.register_buffer('weight_v', weight.new_empty(
            weight[0].numel()))
        self.update_stats = True

    @torch.no_grad()
    def reset_vectors_(self, generator):
        """``weight_u`` and ``weight_v`` normalised N(0, 1), from
        ``generator`` on the CPU."""
        for buf in (self.weight_u, self.weight_v):
            buf.copy_(_l2norm(torch.randn(buf.shape, generator=generator)))

    @torch.no_grad()
    def settle_vectors_(self, iterations):
        """``iterations`` power iterations from the stored vectors, kept:
        sigma then lies near the weight's largest singular value, as in a
        trained net (normalised random vectors give sigma any size and
        sign, and a net that never iterates, as one in eval mode, keeps
        them)."""
        w_mat = self.weight_orig.flatten(1)
        u = self.weight_u
        for _ in range(iterations):
            v = _l2norm(w_mat.t() @ u)
            u = _l2norm(w_mat @ v)
        self.weight_u.copy_(u)
        self.weight_v.copy_(v)

    def sn_weight(self):
        """``weight_orig / sigma``, after one power iteration in training
        mode."""
        w_mat = self.weight_orig.flatten(1)
        u, v = self.weight_u, self.weight_v
        if self.training:
            with torch.no_grad():
                v = _l2norm(w_mat.t() @ u)
                u = _l2norm(w_mat @ v)
                if self.update_stats:
                    self.weight_u.copy_(u)
                    self.weight_v.copy_(v)
        return self.weight_orig / (u @ (w_mat @ v))

    def forward(self, x):
        return self._conv_forward(x, self.sn_weight(), self.bias)


def avg_pool2d(x, *args, **kwargs):
    """``F.avg_pool2d`` of ``x`` in torch's contiguous layout. The CUDA
    kernel's backward for a channels-last input is wrong on the H100
    machine's PyTorch (2.11.0+cu128: a 3x3 stride-2 pool's input gradient
    off by 82-110 % of its largest entry, f32 and f64, whatever the
    cotangent's layout; contiguous inputs and the CPU agree to the last
    bit), and a conv of an NHWC-viewed input hands its output on in
    channels-last."""
    return F.avg_pool2d(x.contiguous(), *args, **kwargs)


def resize(x, scale_factor=None, size=None, mode='bilinear',
           align_corners=False):
    """:func:`mrefsr_tpu_torch.ops.interpolate` on an NCHW tensor."""
    return interpolate(x.permute(0, 2, 3, 1), scale_factor, size, mode,
                       align_corners).permute(0, 3, 1, 2)


def warp(x, flow, padding_mode='zeros'):
    """:func:`mrefsr_tpu_torch.ops.flow_warp` of an NCHW tensor by an NCHW
    flow ``(N, 2, H, W)`` as (dx, dy), bilinear."""
    return flow_warp(x.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1),
                     padding_mode=padding_mode).permute(0, 3, 1, 2)


class ResidualBlockNoBN(nn.Module):
    """Conv-ReLU-Conv residual block (reference arch_util.py:89-117), the
    branch scaled by ``res_scale``."""

    def __init__(self, num_feat=64, res_scale=1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)

    def forward(self, x):
        out = self.conv2(torch.relu(self.conv1(x)))
        return x + (out if self.res_scale == 1 else out * self.res_scale)


class Upsample(nn.Sequential):
    """Conv + pixel shuffle by 2, ``log2(scale)`` times, or once by 3
    (reference arch_util.py:120-141): convs ``0``, ``2``, ..., the
    shuffles between them."""

    def __init__(self, scale, num_feat):
        layers = []
        if scale & (scale - 1) == 0:
            for _ in range(int(math.log2(scale))):
                layers += [nn.Conv2d(num_feat, 4 * num_feat, 3, 1, 1),
                           nn.PixelShuffle(2)]
        elif scale == 3:
            layers += [nn.Conv2d(num_feat, 9 * num_feat, 3, 1, 1),
                       nn.PixelShuffle(3)]
        else:
            raise ValueError(f'scale {scale} is not supported. Supported '
                             'scales: 2^n and 3.')
        super().__init__(*layers)


def make_layer(block_cls, num_blocks, **kwargs):
    """``num_blocks`` identical blocks in an ``nn.Sequential``: children
    named ``0``, ``1``, ... as in the reference."""
    return nn.Sequential(*(block_cls(**kwargs) for _ in range(num_blocks)))


class ConvResidualBlocks(nn.Module):
    """Conv, LeakyReLU(0.1), then ``num_block`` residual blocks
    (reference basicvsr_arch.py:103-118): children ``main.0`` and
    ``main.2.{i}``."""

    def __init__(self, num_in_ch=3, num_out_ch=64, num_block=15):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv2d(num_in_ch, num_out_ch, 3, 1, 1), nn.LeakyReLU(0.1),
            make_layer(ResidualBlockNoBN, num_block, num_feat=num_out_ch))

    def forward(self, x):
        return self.main(x)


class RefAwareBlock(nn.Module):
    """A per-sample mixture of ``num_experts`` 3x3 convs (reference
    arch_util.py:142-197; the JAX package's arch_util.py:135): from the
    spatial mean of the concatenated (input, ref) features, a sigmoid
    routing mixes the experts' kernels and biases, the sample's own kernel
    is applied (all samples as one grouped conv), and an SE branch on the
    same mean gates the result. The reference's parameter names: ``weight``
    (E, out, in, 3, 3), ``bias`` (E, out), ``routing_func.0``, ``se.0``,
    ``se.2``. On no registered arch."""

    def __init__(self, out_channels=3, nf=64, ref_nf=256, num_experts=4):
        super().__init__()
        c = nf + ref_nf
        self.out_channels = out_channels
        self.weight = nn.Parameter(torch.empty(num_experts, out_channels, c,
                                               3, 3))
        self.bias = nn.Parameter(torch.empty(num_experts, out_channels))
        self.routing_func = nn.Sequential(nn.Linear(c, num_experts))
        self.se = nn.Sequential(nn.Conv2d(c, c, 1), nn.ReLU(),
                                nn.Conv2d(c, out_channels, 1))

    def init_weights(self, generator):
        """The experts N(0, 0.02) with zero biases, the routing and SE
        layers as torch initialises them."""
        normal_(self.weight, 0.02, generator)
        with torch.no_grad():
            self.bias.zero_()
        torch_default_init_(self, generator)

    def forward(self, x, ref, original_size=None):
        x = torch.cat([x, ref], 1)
        b, c, h, w = x.shape
        if original_size is not None:
            x_m = x[:, :, :original_size[0], :original_size[1]].mean((2, 3))
        else:
            x_m = x.mean((2, 3))
        routing = torch.sigmoid(self.routing_func(x_m))
        kernel = torch.einsum('be,eoihw->boihw', routing, self.weight)
        bias = routing @ self.bias
        out = F.conv2d(x.reshape(1, b * c, h, w),
                       kernel.reshape(b * self.out_channels, c, 3, 3),
                       bias.reshape(-1), padding=1, groups=b)
        se = torch.sigmoid(self.se(x_m[:, :, None, None]))
        return out.reshape(b, self.out_channels, h, w) * se


class DCNv2Pack(nn.Module):
    """Modulated deformable conv whose offsets and masks come from a second
    feature map (JAX package arch_util.py:81-132, the reference's
    ``ModulatedDeformConvPack``). Call ``(x, feat)``, both NCHW:
    ``conv_offset(feat)`` gives ``3 * dg * K`` channels, read as mmcv's
    interleaved (dy, dx) offsets and a mask through a sigmoid; ``x`` is
    sampled there. ``groups > 1`` splits the conv's channels into groups
    (weight ``(out, in // groups, k, k)``)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, dilation=1, groups=1, deformable_groups=8):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.stride, self.padding = k, stride, padding
        self.dilation, self.groups = dilation, groups
        self.deformable_groups = deformable_groups
        self.conv_offset = nn.Conv2d(in_channels, deformable_groups * 3 * k
                                     * k, k, stride, padding)
        self.weight = nn.Parameter(torch.empty(out_channels,
                                               in_channels // groups, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels))

    @torch.no_grad()
    def reset_parameters_(self, generator):
        """Zero offset conv (sampling starts on the grid, mask 0.5); the
        weight U(+-1/sqrt(fan_in)), the bias 0."""
        self.conv_offset.weight.zero_()
        self.conv_offset.bias.zero_()
        uniform_(self.weight, 1 / math.sqrt(self.weight[0].numel()),
                 generator)
        self.bias.zero_()

    def forward(self, x, feat):
        k, dg = self.kernel_size, self.deformable_groups
        out = self.conv_offset(feat).permute(0, 2, 3, 1)
        offset, mask = offset_mask_from_conv_out(out, dg, (k, k))
        return modulated_deform_conv2d(
            x.permute(0, 2, 3, 1), offset, torch.sigmoid(mask),
            self.weight.permute(2, 3, 1, 0), self.bias, stride=self.stride,
            padding=self.padding, dilation=self.dilation, groups=self.groups,
            deform_groups=dg).permute(0, 3, 1, 2)
