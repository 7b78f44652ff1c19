"""EDSR (port of ``mrefsr_tpu/archs/edsr_arch.py``, the reference's
basicsr/archs/edsr_arch.py:9-61). NCHW, the reference's torch names. It
runs no kernel of this repository: cuDNN convolutions and pixel
shuffles."""
import torch
from torch import nn

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import (ResidualBlockNoBN, Upsample, make_layer,
                        torch_default_init_)


class MeanRange(nn.Module):
    """The shared frame of EDSR, RCAN and SwinIR: ``(x - mean) *
    img_range`` in, ``out / img_range + mean`` out. The mean is a buffer
    the state dict leaves out, as the reference keeps it out."""

    def __init__(self, img_range, rgb_mean):
        super().__init__()
        self.img_range = img_range
        self.rgb_mean = tuple(rgb_mean)
        self.register_buffer('mean', torch.tensor(self.rgb_mean).view(
            1, -1, 1, 1), persistent=False)

    @torch.no_grad()
    def reset_parameters_(self, generator=None):
        """The mean's values (a net made on ``meta`` and moved with
        ``to_empty`` holds none)."""
        self.mean.copy_(torch.tensor(self.rgb_mean).view(1, -1, 1, 1))

    def normalise(self, x):
        return (x - self.mean) * self.img_range

    def restore(self, x):
        return x / self.img_range + self.mean


@ARCH_REGISTRY.register()
class EDSR(MeanRange):
    """A conv, ``num_block`` residual blocks (branch x ``res_scale``), a
    conv and the skip, pixel-shuffle upsampling by ``upscale``, a conv.
    Call ``x (B, num_in_ch, H, W)`` in [0, 1]."""

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_block=16,
                 upscale=4, res_scale=1.0, img_range=255.,
                 rgb_mean=(0.4488, 0.4371, 0.4040)):
        super().__init__(img_range, rgb_mean)
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(ResidualBlockNoBN, num_block,
                               num_feat=num_feat, res_scale=res_scale)
        self.conv_after_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.upsample = Upsample(upscale, num_feat)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def init_weights(self, generator):
        """torch's default convs (the reference's ``pytorch_init``
        blocks) and the mean."""
        torch_default_init_(self, generator)
        self.reset_parameters_()

    def forward(self, x):
        x = self.conv_first(self.normalise(x))
        res = self.conv_after_body(self.body(x)) + x
        return self.restore(self.conv_last(self.upsample(res)))
