"""SRVGGNetCompact, Real-ESRGAN's compact net (port of
``mrefsr_tpu/archs/srvgg_arch.py``, the reference's
basicsr/archs/srvgg_arch.py:8-70). NCHW, the reference's torch names. It
runs no kernel of this repository: cuDNN convolutions, a pixel shuffle
and a nearest upsample."""
import torch.nn.functional as F
from torch import nn

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import resize, torch_default_init_


@ARCH_REGISTRY.register()
class SRVGGNetCompact(nn.Module):
    """``num_conv + 2`` convs with an activation after all but the last
    (``act_type`` 'prelu', one slope a channel; 'relu'; else leaky ReLU
    0.1), a pixel shuffle by ``upscale``, plus the nearest-upsampled
    input. ``body`` holds the convs at even and the activations at odd
    indices. Call ``x (B, num_in_ch, H, W)``."""

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_conv=16,
                 upscale=4, act_type='prelu'):
        super().__init__()
        self.upscale = upscale

        def act():
            if act_type == 'relu':
                return nn.ReLU()
            if act_type == 'prelu':
                return nn.PReLU(num_parameters=num_feat)
            return nn.LeakyReLU(0.1)

        body = [nn.Conv2d(num_in_ch, num_feat, 3, 1, 1), act()]
        for _ in range(num_conv):
            body += [nn.Conv2d(num_feat, num_feat, 3, 1, 1), act()]
        body.append(nn.Conv2d(num_feat, num_out_ch * upscale ** 2, 3, 1, 1))
        self.body = nn.ModuleList(body)

    def init_weights(self, generator):
        """torch's default convs; every PReLU slope 0.25."""
        torch_default_init_(self, generator)
        for m in self.modules():
            if isinstance(m, nn.PReLU):
                m.weight.detach().fill_(0.25)

    def forward(self, x):
        out = x
        for layer in self.body:
            out = layer(out)
        return F.pixel_shuffle(out, self.upscale) + resize(
            x, self.upscale, mode='nearest')
