"""MSRResNet, the modified SRResNet (port of
``mrefsr_tpu/archs/srresnet_arch.py``, the reference's
basicsr/archs/srresnet_arch.py:9-67). NCHW, the reference's torch names.
It runs no kernel of this repository: cuDNN convolutions, pixel shuffles
and a bilinear residual."""
import math

from torch import nn

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import (ResidualBlockNoBN, lrelu, make_layer, normal_,
                        resize)


@ARCH_REGISTRY.register()
class MSRResNet(nn.Module):
    """A conv, ``num_block`` residual blocks without norms, pixel-shuffle
    upsampling by ``upscale`` (2, 3 or 4), two convs, plus the bilinear
    upsampled input. Call ``x (B, num_in_ch, H, W)``."""

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_block=16,
                 upscale=4):
        super().__init__()
        self.upscale = upscale
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(ResidualBlockNoBN, num_block,
                               num_feat=num_feat)
        if upscale in (2, 3):
            self.upconv1 = nn.Conv2d(num_feat, num_feat * upscale ** 2, 3, 1,
                                     1)
            self.pixel_shuffle = nn.PixelShuffle(upscale)
        elif upscale == 4:
            self.upconv1 = nn.Conv2d(num_feat, num_feat * 4, 3, 1, 1)
            self.upconv2 = nn.Conv2d(num_feat, num_feat * 4, 3, 1, 1)
            self.pixel_shuffle = nn.PixelShuffle(2)
        else:
            raise ValueError(f'upscale {upscale} is not 2, 3 or 4')
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def init_weights(self, generator):
        """Every conv kaiming-normal (fan_in) x 0.1 with a zero bias, as the
        reference's ``default_init_weights(..., 0.1)`` and the JAX
        package's ``default_init(0.1)``."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                normal_(m.weight, 0.1 * math.sqrt(2 / m.weight[0].numel()),
                        generator)
                m.bias.detach().zero_()

    def forward(self, x):
        feat = lrelu(self.conv_first(x))
        out = self.body(feat)
        out = lrelu(self.pixel_shuffle(self.upconv1(out)))
        if self.upscale == 4:
            out = lrelu(self.pixel_shuffle(self.upconv2(out)))
        out = self.conv_last(lrelu(self.conv_hr(out)))
        return out + resize(x, scale_factor=self.upscale)
