"""BasicVSR, bidirectional recurrent video SR x4 (port of
``mrefsr_tpu/archs/basicvsr_arch.py::BasicVSR``, the reference's
basicsr/archs/basicvsr_arch.py:12-100). NCHW frames ``(B, T, C, H, W)``,
the reference's torch names. IconVSR is not ported yet."""
import torch
from torch import nn

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import ConvResidualBlocks, default_init_, lrelu, resize, warp
from .spynet_arch import SpyNet


@ARCH_REGISTRY.register()
class BasicVSR(nn.Module):
    """Call ``x (B, T, 3, H, W)`` in [0, 1]; returns ``(B, T, 3, 4H, 4W)``.
    Flows between neighbours from SpyNet; a backward and a forward trunk
    propagate features along them (``flow_warp``); each frame is fused,
    upsampled by two pixel shuffles and added to its bilinear x4."""

    def __init__(self, num_feat=64, num_block=15, spynet_path=None):
        super().__init__()
        self.num_feat = num_feat
        self.spynet = SpyNet(spynet_path)
        self.backward_trunk = ConvResidualBlocks(num_feat + 3, num_feat,
                                                 num_block)
        self.forward_trunk = ConvResidualBlocks(num_feat + 3, num_feat,
                                                num_block)
        self.fusion = nn.Conv2d(num_feat * 2, num_feat, 1, 1, 0)
        self.upconv1 = nn.Conv2d(num_feat, num_feat * 4, 3, 1, 1)
        self.upconv2 = nn.Conv2d(num_feat, 64 * 4, 3, 1, 1)
        self.conv_hr = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv_last = nn.Conv2d(64, 3, 3, 1, 1)
        self.pixel_shuffle = nn.PixelShuffle(2)

    def init_weights(self, generator):
        default_init_(self, generator)

    def get_flow(self, x):
        b, n, c, h, w = x.shape
        x_1 = x[:, :-1].reshape(-1, c, h, w)
        x_2 = x[:, 1:].reshape(-1, c, h, w)
        flows_backward = self.spynet(x_1, x_2).view(b, n - 1, 2, h, w)
        flows_forward = self.spynet(x_2, x_1).view(b, n - 1, 2, h, w)
        return flows_forward, flows_backward

    def forward(self, x):
        flows_forward, flows_backward = self.get_flow(x)
        b, n, _, h, w = x.shape
        out_l = [None] * n
        feat_prop = x.new_zeros(b, self.num_feat, h, w)
        for i in range(n - 1, -1, -1):
            if i < n - 1:
                feat_prop = warp(feat_prop, flows_backward[:, i])
            feat_prop = self.backward_trunk(torch.cat([x[:, i], feat_prop],
                                                      1))
            out_l[i] = feat_prop

        feat_prop = torch.zeros_like(feat_prop)
        for i in range(n):
            x_i = x[:, i]
            if i > 0:
                feat_prop = warp(feat_prop, flows_forward[:, i - 1])
            feat_prop = self.forward_trunk(torch.cat([x_i, feat_prop], 1))
            out = lrelu(self.fusion(torch.cat([out_l[i], feat_prop], 1)))
            out = lrelu(self.pixel_shuffle(self.upconv1(out)))
            out = lrelu(self.pixel_shuffle(self.upconv2(out)))
            out = self.conv_last(lrelu(self.conv_hr(out)))
            out_l[i] = out + resize(x_i, scale_factor=4)
        return torch.stack(out_l, dim=1)
