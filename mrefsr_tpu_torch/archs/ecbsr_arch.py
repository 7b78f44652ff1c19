"""ECBSR, the edge-oriented re-parameterisable SR net (port of
``mrefsr_tpu/archs/ecbsr_arch.py``, the reference's
basicsr/archs/ecbsr_arch.py: SeqConv3x3 :8, ECB :160, ECBSR :236). NCHW,
the reference's torch names and OIHW layouts for every branch
(``k0``, ``b0``, ``k1``, ``b1``, ``scale``, ``bias``, ``mask``).

As in the JAX package, the forward always runs the folded form: each
block's five branches summed into one dense 3x3 kernel and bias (the
reference's ``rep_params``, :135-158 and :222-234), which equals the
training-time sum of branches. The Sobel and Laplacian ``mask`` is a fixed
prior: a buffer here, which loads from a checkpoint and takes no gradient
(the reference's ``requires_grad=False`` parameter; the JAX package's
``stop_gradient``). It runs no kernel of this repository: one cuDNN
convolution a block and a pixel shuffle."""
import math

import torch
import torch.nn.functional as F
from torch import nn

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import torch_default_init_, uniform_

_EDGES = ('conv1x1-sobelx', 'conv1x1-sobely', 'conv1x1-laplacian')


def edge_mask(seq_type, out_channels):
    """The fixed 3x3 filter of an edge branch, one a channel, OIHW
    (reference ecbsr_arch.py:49-103)."""
    m = torch.zeros(3, 3)
    if seq_type == 'conv1x1-sobelx':
        m[:, 0] = torch.tensor([1., 2., 1.])
        m[:, 2] = torch.tensor([-1., -2., -1.])
    elif seq_type == 'conv1x1-sobely':
        m[0, :] = torch.tensor([1., 2., 1.])
        m[2, :] = torch.tensor([-1., -2., -1.])
    else:
        m[0, 1] = m[1, 0] = m[1, 2] = m[2, 1] = 1.
        m[1, 1] = -4.
    return m.expand(out_channels, 1, 3, 3).clone()


class SeqConv3x3(nn.Module):
    """A 1x1 conv followed by a 3x3 conv (``conv1x1-conv3x3``, ``mid =
    out * depth_multiplier`` channels between) or by a per-channel scaled
    edge filter (the other three types). :meth:`rep_params` folds it into
    one 3x3 kernel and bias: running the 1x1 conv over a zero-padded input
    equals the reference's pad-with-bias forward."""

    def __init__(self, seq_type, in_channels, out_channels,
                 depth_multiplier=1):
        super().__init__()
        self.seq_type = seq_type
        if seq_type == 'conv1x1-conv3x3':
            mid = int(out_channels * depth_multiplier)
            self.k0 = nn.Parameter(torch.empty(mid, in_channels, 1, 1))
            self.b0 = nn.Parameter(torch.empty(mid))
            self.k1 = nn.Parameter(torch.empty(out_channels, mid, 3, 3))
            self.b1 = nn.Parameter(torch.empty(out_channels))
        elif seq_type in _EDGES:
            self.k0 = nn.Parameter(torch.empty(out_channels, in_channels, 1,
                                               1))
            self.b0 = nn.Parameter(torch.empty(out_channels))
            self.scale = nn.Parameter(torch.empty(out_channels, 1, 1, 1))
            self.bias = nn.Parameter(torch.empty(out_channels))
            self.register_buffer('mask', torch.empty(out_channels, 1, 3, 3))
        else:
            raise ValueError(f'the type of seqconv {seq_type} is not '
                             'supported')

    @torch.no_grad()
    def reset_parameters_(self, generator):
        """The 1x1 and 3x3 convs torch's default, U(+-1/sqrt(fan_in));
        ``scale`` and ``bias`` N(0, 1e-3); the edge filter."""
        for w, b in ((self.k0, self.b0), (getattr(self, 'k1', None),
                                          getattr(self, 'b1', None))):
            if w is not None:
                bound = 1 / math.sqrt(w[0].numel())
                uniform_(w, bound, generator)
                uniform_(b, bound, generator)
        if self.seq_type in _EDGES:
            for t in (self.scale, self.bias):
                t.copy_(torch.randn(t.shape, generator=generator) * 1e-3)
            self.mask.copy_(edge_mask(self.seq_type, self.mask.shape[0]))

    def rep_params(self):
        """The branch as one ``(weight OIHW, bias)``."""
        if self.seq_type == 'conv1x1-conv3x3':
            weight = torch.einsum('omhw,mi->oihw', self.k1, self.k0[:, :, 0,
                                                                     0])
            bias = torch.einsum('omhw,m->o', self.k1, self.b0) + self.b1
            return weight, bias
        tmp = (self.scale * self.mask)[:, 0]
        weight = torch.einsum('ohw,oi->oihw', tmp, self.k0[:, :, 0, 0])
        return weight, tmp.sum(dim=(1, 2)) * self.b0 + self.bias


class ECB(nn.Module):
    """Edge-oriented convolution block (reference ecbsr_arch.py:160-234): a
    3x3 conv, a 1x1-3x3 branch and the three edge branches, plus the
    identity where ``with_idt`` and the widths agree, folded into one 3x3
    conv; then ``act_type`` ('prelu', one slope a channel; 'relu';
    'softplus'; 'linear')."""

    def __init__(self, in_channels, out_channels, depth_multiplier,
                 act_type='prelu', with_idt=False):
        super().__init__()
        if act_type not in ('prelu', 'relu', 'softplus', 'linear'):
            raise ValueError(f'activation {act_type} not supported')
        self.act_type = act_type
        self.with_idt = with_idt and in_channels == out_channels
        self.conv3x3 = nn.Conv2d(in_channels, out_channels, 3, 1, 1)
        self.conv1x1_3x3 = SeqConv3x3('conv1x1-conv3x3', in_channels,
                                      out_channels, depth_multiplier)
        self.conv1x1_sbx = SeqConv3x3('conv1x1-sobelx', in_channels,
                                      out_channels)
        self.conv1x1_sby = SeqConv3x3('conv1x1-sobely', in_channels,
                                      out_channels)
        self.conv1x1_lpl = SeqConv3x3('conv1x1-laplacian', in_channels,
                                      out_channels)
        if act_type == 'prelu':
            self.act = nn.PReLU(num_parameters=out_channels)

    def rep_params(self):
        """The block's five branches (and the identity) as one ``(weight
        OIHW, bias)``."""
        weight, bias = self.conv3x3.weight, self.conv3x3.bias
        for branch in (self.conv1x1_3x3, self.conv1x1_sbx, self.conv1x1_sby,
                       self.conv1x1_lpl):
            w, b = branch.rep_params()
            weight, bias = weight + w, bias + b
        if self.with_idt:
            idt = torch.zeros_like(weight)
            n = weight.shape[0]
            idt[torch.arange(n), torch.arange(n), 1, 1] = 1
            weight = weight + idt
        return weight, bias

    def forward(self, x):
        y = F.conv2d(x, *self.rep_params(), padding=1)
        if self.act_type == 'prelu':
            return self.act(y)
        if self.act_type == 'relu':
            return F.relu(y)
        if self.act_type == 'softplus':
            return F.softplus(y)
        return y


@ARCH_REGISTRY.register()
class ECBSR(nn.Module):
    """``num_block + 2`` ECBs (``backbone``), the input repeated over the
    output's ``scale^2`` channel groups added, a pixel shuffle by
    ``scale`` (reference ecbsr_arch.py:236-300). Call ``x (B, num_in_ch,
    H, W)``, 1 or 3 channels."""

    def __init__(self, num_in_ch, num_out_ch, num_block, num_channel,
                 with_idt, act_type, scale):
        super().__init__()
        self.num_in_ch, self.scale = num_in_ch, scale
        blocks = [ECB(num_in_ch, num_channel, 2.0, act_type, with_idt)]
        blocks += [ECB(num_channel, num_channel, 2.0, act_type, with_idt)
                   for _ in range(num_block)]
        blocks.append(ECB(num_channel, num_out_ch * scale ** 2, 2.0,
                          'linear', with_idt))
        self.backbone = nn.Sequential(*blocks)

    def init_weights(self, generator):
        """Each conv torch's default; the branches' own
        (:meth:`SeqConv3x3.reset_parameters_`); every PReLU slope 0.25."""
        torch_default_init_(self, generator)
        for m in self.modules():
            if isinstance(m, SeqConv3x3):
                m.reset_parameters_(generator)
            elif isinstance(m, nn.PReLU):
                m.weight.detach().fill_(0.25)

    def forward(self, x):
        shortcut = torch.repeat_interleave(x, self.scale ** 2, dim=1) \
            if self.num_in_ch > 1 else x
        return F.pixel_shuffle(self.backbone(x) + shortcut, self.scale)
