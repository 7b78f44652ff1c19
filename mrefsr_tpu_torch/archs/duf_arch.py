"""DUF: video SR by dynamic upsampling filters (port of
``mrefsr_tpu/archs/duf_arch.py``, the reference's
basicsr/archs/duf_arch.py:9-282). The 3-D convs are ``nn.Conv3d`` on
NCDHW (time the depth axis), the norms the port's
:class:`~mrefsr_tpu_torch.parallel.batch_norm.BatchNorm3d` (flax's
statistics and momentum), the reference's torch names. The per-pixel
filtering is plain PyTorch: the 5x5 neighbourhoods as shifted copies and
one ``einsum``."""
import torch
import torch.nn.functional as F
from torch import nn

from mrefsr_tpu_torch.parallel.batch_norm import BatchNorm3d
from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import default_init_

# num_layer -> (dense blocks, growth)
_DEPTHS = {16: (3, 32), 28: (9, 16), 52: (21, 16)}


def _dense_unit(ch, out_ch, eps, t_pad):
    """BN, ReLU, 1x1x1 conv, BN, ReLU, 3x3x3 conv (padding ``t_pad`` in T,
    1 in H and W): the ``Sequential`` indices 0, 2, 3, 5 name the norms
    and convs."""
    return nn.Sequential(
        BatchNorm3d(ch, eps=eps), nn.ReLU(), nn.Conv3d(ch, ch, 1),
        BatchNorm3d(ch, eps=eps), nn.ReLU(),
        nn.Conv3d(ch, out_ch, 3, padding=(t_pad, 1, 1)))


class DenseBlocks(nn.Module):
    """``num_block`` dense units, each adding ``num_grow_ch`` channels
    (reference duf_arch.py:80-134): ``dense_blocks.{i}``."""

    def __init__(self, num_block, num_feat=64, num_grow_ch=16, eps=1e-5):
        super().__init__()
        self.dense_blocks = nn.ModuleList(
            [_dense_unit(num_feat + i * num_grow_ch, num_grow_ch, eps, 1)
             for i in range(num_block)])

    def forward(self, x):
        for block in self.dense_blocks:
            x = torch.cat([x, block(x)], 1)
        return x


class DenseBlocksTemporalReduce(nn.Module):
    """Three dense units whose 3x3x3 conv is valid in T, each dropping the
    first and last frame (reference duf_arch.py:9-77):
    ``temporal_reduce{1,2,3}``."""

    def __init__(self, num_feat=64, num_grow_ch=32, eps=1e-5):
        super().__init__()
        for j in (1, 2, 3):
            setattr(self, f'temporal_reduce{j}', _dense_unit(
                num_feat + (j - 1) * num_grow_ch, num_grow_ch, eps, 0))

    def forward(self, x):
        for j in (1, 2, 3):
            y = getattr(self, f'temporal_reduce{j}')(x)
            x = torch.cat([x[:, :, 1:-1], y], 1)
        return x


def dynamic_upsampling_filter(x, filters):
    """Each pixel's own 5x5 filters (reference duf_arch.py:137-183).

    Args:
        x: ``(N, C, H, W)``, the centre frame.
        filters: ``(N, 25, r2, H, W)``, softmaxed over the 25 taps
            (``fi * 5 + fj``).

    Returns:
        ``(N, C * r2, H, W)``, channel ``c * r2 + u``, as ``pixel_shuffle``
        takes it.
    """
    n, c, h, w = x.shape
    xp = F.pad(x, (2, 2, 2, 2))
    taps = torch.stack([xp[:, :, fi:fi + h, fj:fj + w] for fi in range(5)
                        for fj in range(5)], 2)          # (n, c, 25, h, w)
    return torch.einsum('ncfhw,nfuhw->ncuhw', taps, filters).reshape(
        n, -1, h, w)


@ARCH_REGISTRY.register()
class DUF(nn.Module):
    """Call ``x (B, 7, 3, H, W)``; returns the centre frame ``(B, 3, scale
    H, scale W)``: a residual and a bank of 5x5 upsampling filters per
    pixel from 3-D dense blocks, the filters applied to the centre frame.
    ``num_layer`` is 16, 28 or 52; ``adapt_official_weights`` sets the
    official weights' norm eps, 1e-3 (else 1e-5)."""

    def __init__(self, scale=4, num_layer=52, adapt_official_weights=False):
        super().__init__()
        if num_layer not in _DEPTHS:
            raise ValueError(
                f'Only supported (16, 28, 52) layers, got {num_layer}.')
        self.scale = scale
        eps = 1e-3 if adapt_official_weights else 1e-5
        num_block, num_grow_ch = _DEPTHS[num_layer]
        self.conv3d1 = nn.Conv3d(3, 64, (1, 3, 3), padding=(0, 1, 1))
        self.dense_block1 = DenseBlocks(num_block, 64, num_grow_ch, eps)
        ch = 64 + num_grow_ch * num_block
        self.dense_block2 = DenseBlocksTemporalReduce(ch, num_grow_ch, eps)
        ch += 3 * num_grow_ch
        self.bn3d2 = BatchNorm3d(ch, eps=eps)
        self.conv3d2 = nn.Conv3d(ch, 256, (1, 3, 3), padding=(0, 1, 1))
        self.conv3d_r1 = nn.Conv3d(256, 256, 1)
        self.conv3d_r2 = nn.Conv3d(256, 3 * scale ** 2, 1)
        self.conv3d_f1 = nn.Conv3d(256, 512, 1)
        self.conv3d_f2 = nn.Conv3d(512, 25 * scale ** 2, 1)

    @torch.no_grad()
    def init_weights(self, generator):
        """torch's default conv weights (3-D too); norms at scale 1, shift
        0, running mean 0 and variance 1."""
        default_init_(self, generator)
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                bound = 1 / m.weight[0].numel() ** 0.5
                for t in (m.weight, m.bias):
                    t.copy_(torch.rand(t.shape, generator=generator)
                            * (2 * bound) - bound)
            elif isinstance(m, BatchNorm3d):
                m.reset_parameters()

    def forward(self, x):
        x_center = x[:, x.shape[1] // 2]
        x = self.conv3d1(x.transpose(1, 2))
        x = self.dense_block2(self.dense_block1(x))
        x = torch.relu(self.conv3d2(torch.relu(self.bn3d2(x))))
        res = self.conv3d_r2(torch.relu(self.conv3d_r1(x)))[:, :, 0]
        filt = self.conv3d_f2(torch.relu(self.conv3d_f1(x)))[:, :, 0]
        n, _, h, w = filt.shape
        filt = torch.softmax(filt.view(n, 25, self.scale ** 2, h, w), 1)
        out = dynamic_upsampling_filter(x_center, filt) + res
        return F.pixel_shuffle(out, self.scale)
