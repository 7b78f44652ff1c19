"""The FID Inception-v3 feature extractor (port of
``mrefsr_tpu/archs/inception.py``, the reference's
basicsr/archs/inception.py:17-303), NCHW: the TF-FID variant (the average
pools of the A, C and E blocks leave the padding out of the count; Mixed_7c
pools by max) with torchvision's names, so a ``pt_inception-2015-12-05``
``.pth`` loads as it is. Not registered, as in the reference.
"""
import torch
from torch import nn
from torch.nn import functional as F


class BasicConv2d(nn.Module):
    """A bias-free conv, batch norm (eps 1e-3, running statistics) and
    ReLU."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3x3(x):
    """3x3 stride-1 average pool, padding 1 left out of the count."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):

    def __init__(self, in_channels, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, 1)

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(_avg_pool3x3(x))], 1)


class InceptionB(nn.Module):

    def __init__(self, in_channels):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):

    def __init__(self, in_channels, channels_7x7):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f'branch7x7dbl_{i}')(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool3x3(x))], 1)


class InceptionD(nn.Module):

    def __init__(self, in_channels):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f'branch7x7x3_{i}')(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``use_max_pool`` makes it FID's Mixed_7c (reference
    inception.py:275-303)."""

    def __init__(self, in_channels, use_max_pool=False):
        super().__init__()
        self.use_max_pool = use_max_pool
        self.branch1x1 = BasicConv2d(in_channels, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.use_max_pool \
            else _avg_pool3x3(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         1)


class InceptionV3(nn.Module):
    """The FID Inception extractor (reference inception.py:17-152) on NCHW
    images in [0, 1] (``normalize_input`` maps them to [-1, 1]), resized
    to 299 x 299 by bilinear (``resize_input``). Returns the outputs of
    ``output_blocks``, ascending: 0 the 64 channels after the first max
    pool, 1 the 192 after the second, 2 the 768 of Mixed_6e, 3 the 2048 of
    the final average pool (N, 2048, 1, 1)."""

    def __init__(self, output_blocks=(3,), resize_input=True,
                 normalize_input=True):
        super().__init__()
        self.output_blocks = tuple(output_blocks)
        self.last = max(self.output_blocks)
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, use_max_pool=False)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)

    @torch.no_grad()
    def init_weights(self, generator):
        """Seeded stand-in weights: convs N(0, 2 / fan_in), the norms at
        scale 1, shift 0, mean 0, variance 1."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator)
                               * (2 / m.weight[0].numel()) ** 0.5)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x):
        outputs = []
        if self.resize_input:
            x = F.interpolate(x, size=(299, 299), mode='bilinear',
                              align_corners=False)
        if self.normalize_input:
            x = 2 * x - 1
        stages = (
            ('Conv2d_1a_3x3', 'Conv2d_2a_3x3', 'Conv2d_2b_3x3', 'pool'),
            ('Conv2d_3b_1x1', 'Conv2d_4a_3x3', 'pool'),
            ('Mixed_5b', 'Mixed_5c', 'Mixed_5d', 'Mixed_6a', 'Mixed_6b',
             'Mixed_6c', 'Mixed_6d', 'Mixed_6e'),
            ('Mixed_7a', 'Mixed_7b', 'Mixed_7c', 'mean'))
        for idx, stage in enumerate(stages):
            for name in stage:
                if name == 'pool':
                    x = F.max_pool2d(x, 3, 2)
                elif name == 'mean':
                    x = x.mean((2, 3), keepdim=True)
                else:
                    x = getattr(self, name)(x)
            if idx in self.output_blocks:
                outputs.append(x)
            if idx == self.last:
                break
        return outputs
