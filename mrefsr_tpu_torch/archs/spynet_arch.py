"""SpyNet optical flow (port of ``mrefsr_tpu/archs/spynet_arch.py``, the
reference's basicsr/archs/spynet_arch.py:10-100). NCHW, the reference's
torch names: ``basic_module.{level}.basic_module.{0,2,4,6,8}`` and the
ImageNet ``mean`` / ``std`` buffers a published checkpoint carries."""
import math

import torch
import torch.nn.functional as F
from torch import nn

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import default_init_, resize, warp

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class BasicModule(nn.Module):
    """Five 7x7 convs with ReLUs between: (ref, warped supp, flow) in, a
    flow residual out (reference spynet_arch.py:10-25)."""

    def __init__(self):
        super().__init__()
        chans = (8, 32, 64, 32, 16, 2)
        layers = []
        for i in range(5):
            layers.append(nn.Conv2d(chans[i], chans[i + 1], 7, 1, 3))
            if i < 4:
                layers.append(nn.ReLU())
        self.basic_module = nn.Sequential(*layers)

    def forward(self, x):
        return self.basic_module(x)


@ARCH_REGISTRY.register()
class SpyNet(nn.Module):
    """Six-level coarse-to-fine flow. Call ``(ref, supp)``, NCHW RGB in
    [0, 1]; returns the flow ``(N, 2, H, W)`` as (dx, dy) that warps
    ``supp`` onto ``ref``. ``load_path`` is kept for the options' sake: the
    caller loads weights."""

    def __init__(self, load_path=None):
        super().__init__()
        self.load_path = load_path
        self.basic_module = nn.ModuleList([BasicModule() for _ in range(6)])
        self.register_buffer('mean', torch.tensor(_MEAN).view(1, 3, 1, 1))
        self.register_buffer('std', torch.tensor(_STD).view(1, 3, 1, 1))

    def init_weights(self, generator):
        default_init_(self, generator)

    @torch.no_grad()
    def reset_parameters_(self, generator):
        """The ImageNet constants (a net made on ``meta`` and moved with
        ``to_empty`` holds no values)."""
        self.mean.copy_(torch.tensor(_MEAN).view(1, 3, 1, 1))
        self.std.copy_(torch.tensor(_STD).view(1, 3, 1, 1))

    def process(self, ref, supp):
        ref = [(ref - self.mean) / self.std]
        supp = [(supp - self.mean) / self.std]
        for _ in range(5):
            ref.insert(0, F.avg_pool2d(ref[0], 2, 2))
            supp.insert(0, F.avg_pool2d(supp[0], 2, 2))
        n, _, h, w = ref[0].shape
        flow = ref[0].new_zeros((n, 2, h // 2, w // 2))
        for level, module in enumerate(self.basic_module):
            up = resize(flow, scale_factor=2, mode='bilinear',
                        align_corners=True) * 2.0
            warped = warp(supp[level], up, padding_mode='border')
            flow = module(torch.cat([ref[level], warped, up], 1)) + up
        return flow

    def forward(self, ref, supp):
        assert ref.shape == supp.shape
        h, w = ref.shape[2:]
        # the levels halve 5 times: a multiple of 32 (180 -> 192)
        w_floor = math.floor(math.ceil(w / 32.0) * 32.0)
        h_floor = math.floor(math.ceil(h / 32.0) * 32.0)
        ref = resize(ref, size=(h_floor, w_floor))
        supp = resize(supp, size=(h_floor, w_floor))
        flow = resize(self.process(ref, supp), size=(h, w))
        scale = torch.tensor([w / w_floor, h / h_floor], dtype=flow.dtype,
                             device=flow.device)
        return flow * scale.view(1, 2, 1, 1)
