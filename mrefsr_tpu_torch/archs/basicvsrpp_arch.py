"""BasicVSR++: second-order grid propagation with flow-guided deformable
alignment (port of ``mrefsr_tpu/archs/basicvsrpp_arch.py``, the
reference's basicsr/archs/basicvsrpp_arch.py:15-396). NCHW frames
``(B, T, C, H, W)``, the reference's torch names. As in the JAX package,
the reference's CPU cache is dropped and mirror extension is a flag the
caller passes, not a test on the data."""
import torch
from torch import nn

from mrefsr_tpu_torch.ops import modulated_deform_conv2d
from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import (ConvResidualBlocks, default_init_, lrelu, resize,
                        uniform_, warp)
from .spynet_arch import SpyNet

_BRANCHES = ('backward_1', 'forward_1', 'backward_2', 'forward_2')


class SecondOrderDeformableAlignment(nn.Module):
    """Deformable alignment guided by two flows (reference
    basicvsrpp_arch.py:338-396): ``conv_offset.{0,2,4,6}`` read the
    condition features and both flows and give offset residuals (at most
    ``max_residue_magnitude`` pixels) and masks; the first ``dg / 2``
    deform groups sample around ``flow_1``, the rest around ``flow_2``
    (the flows are flipped to (dy, dx) and tiled over the groups' taps).
    Call ``(x, extra_feat, flow_1, flow_2)``, NCHW, flows ``(N, 2, H, W)``
    as (dx, dy)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, padding=1,
                 deformable_groups=16, max_residue_magnitude=10):
        super().__init__()
        k, oc, dg = kernel_size, out_channels, deformable_groups
        self.kernel_size, self.padding = k, padding
        self.deformable_groups = dg
        self.max_residue_magnitude = max_residue_magnitude
        self.conv_offset = nn.Sequential(
            nn.Conv2d(3 * oc + 4, oc, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(oc, oc, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(oc, oc, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(oc, 27 * dg, 3, 1, 1))
        self.weight = nn.Parameter(torch.empty(oc, in_channels, k, k))
        self.bias = nn.Parameter(torch.empty(oc))

    @torch.no_grad()
    def reset_parameters_(self, generator):
        """The last offset conv zero (offsets start at the flows, masks at
        0.5); the weight U(+-1/sqrt(fan_in)), the bias 0."""
        self.conv_offset[-1].weight.zero_()
        self.conv_offset[-1].bias.zero_()
        uniform_(self.weight, 1 / self.weight[0].numel() ** 0.5, generator)
        self.bias.zero_()

    def forward(self, x, extra_feat, flow_1, flow_2):
        k, dg = self.kernel_size, self.deformable_groups
        out = self.conv_offset(torch.cat([extra_feat, flow_1, flow_2], 1))
        o1, o2, mask = torch.chunk(out, 3, dim=1)
        offset = self.max_residue_magnitude * torch.tanh(
            torch.cat((o1, o2), 1))
        offset_1, offset_2 = torch.chunk(offset, 2, dim=1)
        reps = offset_1.shape[1] // 2
        offset = torch.cat([offset_1 + flow_1.flip(1).repeat(1, reps, 1, 1),
                            offset_2 + flow_2.flip(1).repeat(1, reps, 1, 1)],
                           1)
        n, _, h, w = offset.shape
        offset = offset.permute(0, 2, 3, 1).reshape(n, h, w, dg, k * k, 2)
        mask = torch.sigmoid(mask).permute(0, 2, 3, 1).reshape(n, h, w, dg,
                                                               k * k)
        return modulated_deform_conv2d(
            x.permute(0, 2, 3, 1), offset, mask,
            self.weight.permute(2, 3, 1, 0), self.bias, stride=1,
            padding=self.padding, deform_groups=dg).permute(0, 3, 1, 2)


@ARCH_REGISTRY.register()
class BasicVSRPlusPlus(nn.Module):
    """Call ``lqs (B, T, 3, H, W)`` in [0, 1], ``is_mirror_extended`` true
    when the second half of the clip mirrors the first (the forward flows
    are then the backward ones reversed); returns ``(B, T, 3, 4H, 4W)``
    (``(B, T, 3, H, W)`` when ``is_low_res_input`` is false, for inputs
    that are 4x the flow resolution). ``cpu_cache_length`` is accepted for
    the options' sake and unused."""

    def __init__(self, mid_channels=64, num_blocks=7,
                 max_residue_magnitude=10, is_low_res_input=True,
                 spynet_path=None, cpu_cache_length=100):
        super().__init__()
        mid = mid_channels
        self.mid_channels = mid
        self.is_low_res_input = is_low_res_input
        self.spynet = SpyNet(spynet_path)
        if is_low_res_input:
            self.feat_extract = ConvResidualBlocks(3, mid, 5)
        else:
            self.feat_extract = nn.Sequential(
                nn.Conv2d(3, mid, 3, 2, 1), nn.LeakyReLU(0.1),
                nn.Conv2d(mid, mid, 3, 2, 1), nn.LeakyReLU(0.1),
                ConvResidualBlocks(mid, mid, 5))
        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        for i, module in enumerate(_BRANCHES):
            self.deform_align[module] = SecondOrderDeformableAlignment(
                2 * mid, mid, 3, padding=1, deformable_groups=16,
                max_residue_magnitude=max_residue_magnitude)
            self.backbone[module] = ConvResidualBlocks((2 + i) * mid, mid,
                                                       num_blocks)
        self.reconstruction = ConvResidualBlocks(5 * mid, mid, 5)
        self.upconv1 = nn.Conv2d(mid, mid * 4, 3, 1, 1)
        self.upconv2 = nn.Conv2d(mid, 64 * 4, 3, 1, 1)
        self.pixel_shuffle = nn.PixelShuffle(2)
        self.conv_hr = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv_last = nn.Conv2d(64, 3, 3, 1, 1)

    def init_weights(self, generator):
        default_init_(self, generator)

    def compute_flow(self, lqs, is_mirror_extended):
        b, t, c, h, w = lqs.shape
        assert h >= 64 and w >= 64, (
            'The height and width of low-res inputs must be at least 64, '
            f'but got {h} and {w}.')
        lqs_1 = lqs[:, :-1].reshape(-1, c, h, w)
        lqs_2 = lqs[:, 1:].reshape(-1, c, h, w)
        flows_backward = self.spynet(lqs_1, lqs_2).view(b, t - 1, 2, h, w)
        if is_mirror_extended:
            flows_forward = flows_backward.flip(1)
        else:
            flows_forward = self.spynet(lqs_2, lqs_1).view(b, t - 1, 2, h, w)
        return flows_forward, flows_backward

    def propagate(self, feats, flows, module_name):
        """Second-order propagation along one branch (reference
        :156-230): each frame's feature is aligned from the last two of
        this branch, the older one through the composed flow; zeros stand
        in for what the first two frames lack."""
        n, t_minus_1, _, h, w = flows.shape
        frame_idx = list(range(t_minus_1 + 1))
        flow_idx = list(range(-1, t_minus_1))
        mapping_idx = list(range(len(feats['spatial'])))
        mapping_idx += mapping_idx[::-1]
        if 'backward' in module_name:
            frame_idx = frame_idx[::-1]
            flow_idx = frame_idx
        align = self.deform_align[module_name]
        backbone = self.backbone[module_name]

        feats[module_name] = []
        feat_prop = flows.new_zeros(n, self.mid_channels, h, w)
        for i, idx in enumerate(frame_idx):
            feat_current = feats['spatial'][mapping_idx[idx]]
            if i > 0:
                flow_n1 = flows[:, flow_idx[i]]
                cond_n1 = warp(feat_prop, flow_n1)
                feat_n2 = torch.zeros_like(feat_prop)
                flow_n2 = torch.zeros_like(flow_n1)
                cond_n2 = torch.zeros_like(cond_n1)
                if i > 1:
                    feat_n2 = feats[module_name][-2]
                    flow_n2 = flow_n1 + warp(flows[:, flow_idx[i - 1]],
                                             flow_n1)
                    cond_n2 = warp(feat_n2, flow_n2)
                cond = torch.cat([cond_n1, feat_current, cond_n2], 1)
                feat_prop = align(torch.cat([feat_prop, feat_n2], 1), cond,
                                  flow_n1, flow_n2)
            feat = [feat_current] + [
                feats[k][idx] for k in feats
                if k not in ('spatial', module_name)] + [feat_prop]
            feat_prop = feat_prop + backbone(torch.cat(feat, 1))
            feats[module_name].append(feat_prop)
        if 'backward' in module_name:
            feats[module_name] = feats[module_name][::-1]
        return feats

    def upsample(self, lqs, feats):
        """Each frame from the spatial feature and the four branches' (in
        the order ``backward_1, forward_1, backward_2, forward_2``), x4."""
        outputs = []
        mapping_idx = list(range(len(feats['spatial'])))
        mapping_idx += mapping_idx[::-1]
        for i in range(lqs.shape[1]):
            hr = torch.cat([feats['spatial'][mapping_idx[i]]]
                           + [feats[k][i] for k in _BRANCHES], 1)
            hr = self.reconstruction(hr)
            hr = lrelu(self.pixel_shuffle(self.upconv1(hr)))
            hr = lrelu(self.pixel_shuffle(self.upconv2(hr)))
            hr = self.conv_last(lrelu(self.conv_hr(hr)))
            if self.is_low_res_input:
                hr = hr + resize(lqs[:, i], scale_factor=4)
            else:
                hr = hr + lqs[:, i]
            outputs.append(hr)
        return torch.stack(outputs, dim=1)

    def forward(self, lqs, is_mirror_extended=False):
        b, t, c, h, w = lqs.shape
        if self.is_low_res_input:
            lqs_downsample = lqs
        else:
            lqs_downsample = resize(lqs.reshape(-1, c, h, w),
                                    scale_factor=0.25, mode='bicubic').view(
                                        b, t, c, h // 4, w // 4)
        feats_spatial = self.feat_extract(lqs.reshape(-1, c, h, w))
        feats_spatial = feats_spatial.view(b, t, *feats_spatial.shape[1:])
        feats = {'spatial': [feats_spatial[:, i] for i in range(t)]}
        flows_forward, flows_backward = self.compute_flow(lqs_downsample,
                                                          is_mirror_extended)
        for module in _BRANCHES:
            flows = flows_backward if module.startswith('backward') \
                else flows_forward
            feats = self.propagate(feats, flows, module)
        return self.upsample(lqs, feats)
