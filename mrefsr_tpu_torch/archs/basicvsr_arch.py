"""BasicVSR and IconVSR, bidirectional recurrent video SR x4 (port of
``mrefsr_tpu/archs/basicvsr_arch.py``, the reference's
basicsr/archs/basicvsr_arch.py:12-336). NCHW frames ``(B, T, C, H, W)``,
the reference's torch names."""
import os

import torch
import torch.nn.functional as F
from torch import nn

from mrefsr_tpu_torch.convert import load_torch_state_dict
from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import ConvResidualBlocks, default_init_, lrelu, resize, warp
from .edvr_arch import EDVRFeatureExtractor
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


# the frames mirrored in front of and behind the clip for the keyframes'
# EDVR windows, by temporal padding (reference basicvsr_arch.py:205-217)
_TEMPORAL_PADS = {2: ([4, 3], [-4, -5]), 3: ([6, 5, 4], [-5, -6, -7])}


@ARCH_REGISTRY.register()
class IconVSR(nn.Module):
    """Call ``x (B, T, 3, H, W)`` in [0, 1], ``T >= 2 * temporal_padding +
    1``; returns ``(B, T, 3, 4H, 4W)``. BasicVSR's two propagations, where
    at every ``keyframe_stride``-th frame and the last the propagated
    features are fused (``backward_fusion``, ``forward_fusion``) with an
    EDVR feature of the frame's ``2 * temporal_padding + 1`` neighbours
    (``edvr``, the clip mirrored past its ends); the forward trunk also
    takes the backward branch's features. H and W are reflect-padded to
    multiples of 4 and the output cropped back. ``spynet_path`` and
    ``edvr_path`` name ``.pth`` files (``params``) that
    :meth:`init_weights` loads into ``spynet`` and ``edvr``; a named file
    that is not there raises."""

    def __init__(self, num_feat=64, num_block=15, keyframe_stride=5,
                 temporal_padding=2, spynet_path=None, edvr_path=None):
        super().__init__()
        if temporal_padding not in _TEMPORAL_PADS:
            raise ValueError(f'temporal_padding {temporal_padding} not '
                             'supported (2 or 3)')
        self.num_feat = num_feat
        self.temporal_padding = temporal_padding
        self.keyframe_stride = keyframe_stride
        self.spynet_path, self.edvr_path = spynet_path, edvr_path
        self.edvr = EDVRFeatureExtractor(temporal_padding * 2 + 1, num_feat)
        self.backward_fusion = nn.Conv2d(2 * num_feat, num_feat, 3, 1, 1)
        self.backward_trunk = ConvResidualBlocks(num_feat + 3, num_feat,
                                                 num_block)
        self.forward_fusion = nn.Conv2d(2 * num_feat, num_feat, 3, 1, 1)
        self.forward_trunk = ConvResidualBlocks(2 * num_feat + 3, num_feat,
                                                num_block)
        self.upconv1 = nn.Conv2d(num_feat, num_feat * 4, 3, 1, 1)
        self.upconv2 = nn.Conv2d(num_feat, 64 * 4, 3, 1, 1)
        self.conv_hr = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv_last = nn.Conv2d(64, 3, 3, 1, 1)
        self.pixel_shuffle = nn.PixelShuffle(2)
        self.spynet = SpyNet(spynet_path)

    def init_weights(self, generator):
        """Seeded weights, then the named ``spynet_path`` / ``edvr_path``
        files over them (reference: each submodule loads its own)."""
        default_init_(self, generator)
        for net, path in ((self.spynet, self.spynet_path),
                          (self.edvr, self.edvr_path)):
            if path:
                if not os.path.isfile(path):
                    raise FileNotFoundError(
                        f'IconVSR names {path}, which does not exist (set '
                        'it to ~ to start from the seeded weights)')
                net.load_state_dict(load_torch_state_dict(path),
                                    strict=True)

    def keyframes(self, n):
        """Every ``keyframe_stride``-th frame of ``n``, and the last."""
        idx = list(range(0, n, self.keyframe_stride))
        if idx[-1] != n - 1:
            idx.append(n - 1)
        return idx

    def keyframe_features(self, x, keyframes):
        """``{i: EDVR feature (B, C, H, W)}`` of each keyframe ``i``: the
        windows of all keyframes folded into the batch, one EDVR call."""
        b, n = x.shape[:2]
        span = 2 * self.temporal_padding + 1
        if n < span:
            raise ValueError(f'IconVSR with temporal_padding '
                             f'{self.temporal_padding} needs at least {span} '
                             f'frames, got {n}')
        front, back = _TEMPORAL_PADS[self.temporal_padding]
        x_pad = torch.cat([x[:, front], x, x[:, back]], 1)
        windows = torch.stack([x_pad[:, i:i + span] for i in keyframes], 1)
        feats = self.edvr(windows.flatten(0, 1)).unflatten(
            0, (b, len(keyframes)))
        return {i: feats[:, k] for k, i in enumerate(keyframes)}

    def forward(self, x):
        b, n, c, h_input, w_input = x.shape
        pad_h, pad_w = (4 - h_input % 4) % 4, (4 - w_input % 4) % 4
        if pad_h or pad_w:
            x = F.pad(x.flatten(0, 1), (0, pad_w, 0, pad_h),
                      mode='reflect').unflatten(0, (b, n))
        h, w = x.shape[3:]
        keyframes = self.keyframes(n)
        x_1 = x[:, :-1].reshape(-1, c, h, w)
        x_2 = x[:, 1:].reshape(-1, c, h, w)
        flows_backward = self.spynet(x_1, x_2).view(b, n - 1, 2, h, w)
        flows_forward = self.spynet(x_2, x_1).view(b, n - 1, 2, h, w)
        feats_keyframe = self.keyframe_features(x, keyframes)

        out_l = [None] * n
        feat_prop = x.new_zeros(b, self.num_feat, h, w)
        for i in range(n - 1, -1, -1):
            if i < n - 1:
                feat_prop = warp(feat_prop, flows_backward[:, i])
            if i in feats_keyframe:
                feat_prop = self.backward_fusion(
                    torch.cat([feat_prop, feats_keyframe[i]], 1))
            feat_prop = self.backward_trunk(torch.cat([x[:, i], feat_prop],
                                                      1))
            out_l[i] = feat_prop

        feat_prop = torch.zeros_like(feat_prop)
        for i in range(n):
            x_i = x[:, i]
            if i > 0:
                feat_prop = warp(feat_prop, flows_forward[:, i - 1])
            if i in feats_keyframe:
                feat_prop = self.forward_fusion(
                    torch.cat([feat_prop, feats_keyframe[i]], 1))
            feat_prop = self.forward_trunk(torch.cat([x_i, out_l[i],
                                                      feat_prop], 1))
            out = lrelu(self.pixel_shuffle(self.upconv1(feat_prop)))
            out = lrelu(self.pixel_shuffle(self.upconv2(out)))
            out = self.conv_last(lrelu(self.conv_hr(out)))
            out_l[i] = out + resize(x_i, scale_factor=4)
        return torch.stack(out_l, dim=1)[..., :4 * h_input, :4 * w_input]
