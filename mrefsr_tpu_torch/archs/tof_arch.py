"""TOFlow: task-oriented flow video SR (port of
``mrefsr_tpu/archs/tof_arch.py``, the reference's
basicsr/archs/tof_arch.py:9-180). NCHW frames ``(B, T, C, H, W)``, the
reference's torch names. Unlike SpyNet, the flow modules carry batch
norms: the port's :class:`~mrefsr_tpu_torch.parallel.batch_norm.BatchNorm2d`,
flax's statistics, running statistics in eval mode and the batch's in
training mode."""
import torch
import torch.nn.functional as F
from torch import nn

from mrefsr_tpu_torch.parallel.batch_norm import BatchNorm2d
from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import default_init_, resize, warp

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class BasicModule(nn.Module):
    """Five 7x7 convs, the first four bias-free, each followed by a batch
    norm and a ReLU (reference tof_arch.py:9-40): ``basic_module.{0, 3, 6,
    9, 12}`` the convs, ``{1, 4, 7, 10}`` the norms. (ref, warped supp,
    flow) in, a flow residual out."""

    def __init__(self):
        super().__init__()
        chans = (8, 32, 64, 32, 16)
        layers = []
        for i in range(4):
            layers += [nn.Conv2d(chans[i], chans[i + 1], 7, 1, 3, bias=False),
                       BatchNorm2d(chans[i + 1]), nn.ReLU()]
        layers.append(nn.Conv2d(16, 2, 7, 1, 3))
        self.basic_module = nn.Sequential(*layers)

    def forward(self, x):
        return self.basic_module(x)


class SPyNetTOF(nn.Module):
    """Four-level coarse-to-fine flow of TOFlow (reference
    tof_arch.py:43-94). Call ``(ref, supp)`` NCHW, normalised, H and W
    multiples of 16; returns the flow ``(N, 2, H, W)`` as (dx, dy)."""

    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList([BasicModule() for _ in range(4)])

    def forward(self, ref, supp):
        n, _, h, w = ref.shape
        refs, supps = [ref], [supp]
        for _ in range(3):
            refs.insert(0, F.avg_pool2d(refs[0], 2, 2))
            supps.insert(0, F.avg_pool2d(supps[0], 2, 2))
        flow = ref.new_zeros((n, 2, h // 16, w // 16))
        for i, module in enumerate(self.basic_module):
            flow_up = resize(flow, scale_factor=2, align_corners=True) * 2.0
            flow = flow_up + module(torch.cat(
                [refs[i], warp(supps[i], flow_up), flow_up], 1))
        return flow


@ARCH_REGISTRY.register()
class TOFlow(nn.Module):
    """Call ``lrs (B, 7, 3, H, W)``, the frames already upsampled to the
    output size, H and W multiples of 16; returns the centre frame ``(B,
    3, H, W)``. Each other frame is warped onto the centre one by its
    SPyNetTOF flow (one call a frame), the seven stacked frame-major into
    21 channels and refined by four convs into a residual of the centre
    frame, all on ImageNet-normalised values. ``adapt_official_weights``
    takes the official weights' frame order, the centre frame first."""

    def __init__(self, adapt_official_weights=False):
        super().__init__()
        self.adapt_official_weights = adapt_official_weights
        self.ref_idx = 0 if adapt_official_weights else 3
        self.register_buffer('mean', torch.tensor(_MEAN).view(1, 3, 1, 1))
        self.register_buffer('std', torch.tensor(_STD).view(1, 3, 1, 1))
        self.spynet = SPyNetTOF()
        self.conv_1 = nn.Conv2d(3 * 7, 64, 9, 1, 4)
        self.conv_2 = nn.Conv2d(64, 64, 9, 1, 4)
        self.conv_3 = nn.Conv2d(64, 64, 1)
        self.conv_4 = nn.Conv2d(64, 3, 1)

    @torch.no_grad()
    def init_weights(self, generator):
        """torch's default conv weights, norms at scale 1 and shift 0 with
        running mean 0 and variance 1, the ImageNet constants."""
        default_init_(self, generator)
        for m in self.modules():
            if isinstance(m, BatchNorm2d):
                m.reset_parameters()
        self.mean.copy_(torch.tensor(_MEAN).view(1, 3, 1, 1))
        self.std.copy_(torch.tensor(_STD).view(1, 3, 1, 1))

    def forward(self, lrs):
        if self.adapt_official_weights:
            lrs = lrs[:, [3, 0, 1, 2, 4, 5, 6]]
        lrs = (lrs - self.mean[:, None]) / self.std[:, None]
        lr_ref = lrs[:, self.ref_idx]
        aligned = [lr_ref if i == self.ref_idx else
                   warp(lrs[:, i], self.spynet(lr_ref, lrs[:, i]))
                   for i in range(7)]
        hr = torch.stack(aligned, 1).flatten(1, 2)
        hr = torch.relu(self.conv_2(torch.relu(self.conv_1(hr))))
        hr = self.conv_4(torch.relu(self.conv_3(hr))) + lr_ref
        return hr * self.std + self.mean
