"""HiFaceGAN's building blocks (port of ``mrefsr_tpu/archs/hifacegan_util.py``,
the reference's basicsr/archs/hifacegan_util.py), NCHW.

Names are the JAX package's flax names, which are the reference's torch
names: a spectral-norm conv is :class:`~.arch_util.SNConv2d`
(``weight_orig``, ``weight_u``, ``weight_v``), an affine instance norm has
``weight`` / ``bias``. As in the JAX package, SPADE's ``mlp_gamma`` and
``mlp_beta`` have no bias.
"""
import re

import torch
from torch import nn
from torch.nn import functional as F

from .arch_util import SNConv2d, avg_pool2d, uniform_

SOFTGATE_COEFF = 12.0
# power iterations that settle a seeded spectral-norm conv's u / v
SETTLE_ITERATIONS = 16


def nearest_resize(x, size):
    """NCHW ``x`` at ``size`` (h, w) by torch's legacy nearest rule, source
    index ``floor(dst * in / out)`` in f32 (the JAX package's
    ``_nearest_resize``)."""
    h, w = x.shape[-2:]
    idx = [(torch.arange(out, dtype=torch.float32, device=x.device)
            * (src / out)).long().clamp_(0, src - 1)
           for src, out in ((h, size[0]), (w, size[1]))]
    return x[..., idx[0], :][..., idx[1]]


class InstanceNorm2d(nn.Module):
    """Each sample's channels normalised over H and W (biased variance, eps
    1e-5), then ``* weight + bias`` where ``affine``: torch's
    ``InstanceNorm2d`` without running statistics, as the JAX package
    computes it, and without torch's refusal of a 1 x 1 map in training
    mode (a map that small normalises to 0)."""

    def __init__(self, num_features, affine=False, eps=1e-5):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        mu = x.mean((2, 3), keepdim=True)
        var = x.var((2, 3), unbiased=False, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1,
                                                                   1)
        return y


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """A batch norm without affine parameters that always normalises by its
    running statistics (flax's ``BatchNorm(use_running_average=True,
    use_bias=False, use_scale=False)``, eps 1e-5), in training mode too:
    SPADE's ``batch`` norm in the JAX package."""

    def __init__(self, num_features):
        super().__init__(num_features, affine=False)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            training=False, eps=self.eps)


class SPADE(nn.Module):
    """Spatially-adaptive denormalisation (reference hifacegan_util.py:
    12-54): a parameter-free norm of ``x``, then ``* gamma + beta`` from
    convs of the segmentation map resized to ``x``'s size by nearest.
    ``config_text`` ``spade<norm><k>x<k>``: ``instance`` and ``syncbatch``
    (one process, as the reference on one card) give an instance norm,
    ``batch`` a norm by frozen running statistics."""

    def __init__(self, config_text, norm_nc, label_nc):
        super().__init__()
        parsed = re.search('spade(\\D+)(\\d)x\\d', config_text)
        norm_type = str(parsed.group(1))
        ks = int(parsed.group(2))
        if norm_type in ('instance', 'syncbatch'):
            self.param_free_norm = InstanceNorm2d(norm_nc, affine=False)
        elif norm_type == 'batch':
            self.param_free_norm = FrozenBatchNorm2d(norm_nc)
        else:
            raise ValueError(f'{norm_type} is not a recognized param-free '
                             'norm type in SPADE')
        nhidden = 128 if norm_nc > 128 else norm_nc
        pw = ks // 2
        self.mlp_shared = nn.Sequential(
            nn.Conv2d(label_nc, nhidden, ks, padding=pw), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, ks, padding=pw,
                                   bias=False)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, ks, padding=pw,
                                  bias=False)

    def forward(self, x, segmap):
        normalized = self.param_free_norm(x)
        actv = self.mlp_shared(nearest_resize(segmap, x.shape[-2:]))
        return normalized * self.mlp_gamma(actv) + self.mlp_beta(actv)


def _act(x):
    return F.leaky_relu(x, 0.2)


class SPADEResnetBlock(nn.Module):
    """Two SPADE + LeakyReLU(0.2) + 3x3 conv stages and a shortcut, learned
    (SPADE + bias-free 1x1 conv) where ``fin != fout`` (reference
    hifacegan_util.py:57-111). The convs are spectral-normed where
    ``norm_g`` says ``spectral``."""

    def __init__(self, fin, fout, norm_g='spectralspadesyncbatch3x3',
                 semantic_nc=3):
        super().__init__()
        self.learned_shortcut = fin != fout
        fmiddle = min(fin, fout)
        conv = SNConv2d if 'spectral' in norm_g else nn.Conv2d
        spade_config = norm_g.replace('spectral', '')
        self.norm_0 = SPADE(spade_config, fin, semantic_nc)
        self.conv_0 = conv(fin, fmiddle, 3, padding=1)
        self.norm_1 = SPADE(spade_config, fmiddle, semantic_nc)
        self.conv_1 = conv(fmiddle, fout, 3, padding=1)
        if self.learned_shortcut:
            self.norm_s = SPADE(spade_config, fin, semantic_nc)
            self.conv_s = conv(fin, fout, 1, bias=False)

    def forward(self, x, seg):
        dx = self.conv_0(_act(self.norm_0(x, seg)))
        dx = self.conv_1(_act(self.norm_1(dx, seg)))
        x_s = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut \
            else x
        return x_s + dx


def lip2d(x, logit, kernel=3, stride=2, padding=1):
    """Local importance pooling (reference hifacegan_util.py:154-157): the
    average pool of ``x * exp(logit)`` over that of ``exp(logit)``
    (:func:`~.arch_util.avg_pool2d`)."""
    weight = logit.exp()
    return avg_pool2d(x * weight, kernel, stride, padding) \
        / avg_pool2d(weight, kernel, stride, padding)


class SoftGate(nn.Module):
    """``sigmoid(x) * 12`` (reference hifacegan_util.py:160-164)."""

    def forward(self, x):
        return torch.sigmoid(x) * SOFTGATE_COEFF


class SimplifiedLIP(nn.Module):
    """LIP with logits from a bias-free 3x3 conv, an affine instance norm
    and the soft gate (reference hifacegan_util.py:166-180)."""

    def __init__(self, channels):
        super().__init__()
        self.logit = nn.Sequential(
            nn.Conv2d(channels, channels, 3, padding=1, bias=False),
            InstanceNorm2d(channels, affine=True), SoftGate())

    def forward(self, x):
        return lip2d(x, self.logit(x))


class LIPEncoder(nn.Module):
    """A bias-free conv, instance norm and ReLU, then ``n_2xdown`` times a
    LIP halving the map, a conv doubling the width (at most 16x) and an
    instance norm, ReLUs between (reference hifacegan_util.py:182-214):
    ``model`` indices as the reference's ``Sequential``."""

    def __init__(self, input_nc, ngf, sw, sh, n_2xdown):
        super().__init__()
        self.sw, self.sh = sw, sh
        max_ratio = 16
        layers = [nn.Conv2d(input_nc, ngf, 3, padding=1, bias=False),
                  InstanceNorm2d(ngf), nn.ReLU()]
        cur_ratio = 1
        for i in range(n_2xdown):
            next_ratio = min(cur_ratio * 2, max_ratio)
            layers += [SimplifiedLIP(ngf * cur_ratio),
                       nn.Conv2d(ngf * cur_ratio, ngf * next_ratio, 3,
                                 padding=1),
                       InstanceNorm2d(ngf * next_ratio)]
            cur_ratio = next_ratio
            if i < n_2xdown - 1:
                layers.append(nn.ReLU())
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


@torch.no_grad()
def torch_default_sn_init_(module, generator):
    """Every conv of ``module`` as torch initialises a fresh one (weight and
    bias U(+-1/sqrt(fan_in)), seeded), a spectral-norm conv's ``u`` / ``v``
    normalised N(0, 1) and then settled by ``SETTLE_ITERATIONS`` power
    iterations, every affine instance norm at scale 1 and shift 0, every
    frozen norm at mean 0 and variance 1."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            weight = m.weight_orig if isinstance(m, SNConv2d) else m.weight
            bound = 1 / weight[0].numel() ** 0.5
            uniform_(weight, bound, generator)
            if m.bias is not None:
                uniform_(m.bias, bound, generator)
            if isinstance(m, SNConv2d):
                m.reset_vectors_(generator)
                m.settle_vectors_(SETTLE_ITERATIONS)
        elif isinstance(m, InstanceNorm2d) and m.weight is not None:
            m.weight.fill_(1)
            m.bias.zero_()
        elif isinstance(m, FrozenBatchNorm2d):
            m.reset_running_stats()
