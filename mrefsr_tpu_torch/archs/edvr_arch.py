"""EDVR: pyramid, cascading and deformable alignment with temporal-spatial
attention fusion (port of ``mrefsr_tpu/archs/edvr_arch.py``, the
reference's basicsr/archs/edvr_arch.py:9-383). NCHW frames
``(B, T, C, H, W)``, the reference's torch names.

The alignment's parameters are shared across frames, so the T frames run
folded into the batch through one PCD call (the JAX package loops over
them): every conv and deformable conv is per item, and the numbers do not
change."""
import torch
import torch.nn.functional as F
from torch import nn

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import (DCNv2Pack, ResidualBlockNoBN, default_init_, lrelu,
                        make_layer, resize)


def _up2(x):
    return resize(x, scale_factor=2)


class PCDAlignment(nn.Module):
    """Three pyramid levels of offset convs and DCNv2Pack, coarse to fine,
    each level's offsets and features upsampled x2 into the next (offsets
    also doubled), then a cascading DCNv2Pack (reference
    edvr_arch.py:9-101). Call ``(nbr_feat_l, ref_feat_l)``: lists of the
    L1, L2, L3 features, NCHW."""

    def __init__(self, num_feat=64, deformable_groups=8):
        super().__init__()
        nf, dg = num_feat, deformable_groups
        self.offset_conv1 = nn.ModuleDict()
        self.offset_conv2 = nn.ModuleDict()
        self.offset_conv3 = nn.ModuleDict()
        self.dcn_pack = nn.ModuleDict()
        self.feat_conv = nn.ModuleDict()
        for i in range(3, 0, -1):
            level = f'l{i}'
            self.offset_conv1[level] = nn.Conv2d(nf * 2, nf, 3, 1, 1)
            if i == 3:
                self.offset_conv2[level] = nn.Conv2d(nf, nf, 3, 1, 1)
            else:
                self.offset_conv2[level] = nn.Conv2d(nf * 2, nf, 3, 1, 1)
                self.offset_conv3[level] = nn.Conv2d(nf, nf, 3, 1, 1)
            self.dcn_pack[level] = DCNv2Pack(nf, nf, 3, padding=1,
                                             deformable_groups=dg)
            if i < 3:
                self.feat_conv[level] = nn.Conv2d(nf * 2, nf, 3, 1, 1)
        self.cas_offset_conv1 = nn.Conv2d(nf * 2, nf, 3, 1, 1)
        self.cas_offset_conv2 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.cas_dcnpack = DCNv2Pack(nf, nf, 3, padding=1,
                                     deformable_groups=dg)

    def forward(self, nbr_feat_l, ref_feat_l):
        upsampled_offset, upsampled_feat = None, None
        for i in range(3, 0, -1):
            level = f'l{i}'
            offset = lrelu(self.offset_conv1[level](
                torch.cat([nbr_feat_l[i - 1], ref_feat_l[i - 1]], 1)))
            if i == 3:
                offset = lrelu(self.offset_conv2[level](offset))
            else:
                offset = lrelu(self.offset_conv2[level](
                    torch.cat([offset, upsampled_offset], 1)))
                offset = lrelu(self.offset_conv3[level](offset))
            feat = self.dcn_pack[level](nbr_feat_l[i - 1], offset)
            if i < 3:
                feat = self.feat_conv[level](torch.cat([feat, upsampled_feat],
                                                       1))
            if i > 1:
                feat = lrelu(feat)
                upsampled_offset = _up2(offset) * 2
                upsampled_feat = _up2(feat)
        offset = torch.cat([feat, ref_feat_l[0]], 1)
        offset = lrelu(self.cas_offset_conv2(lrelu(
            self.cas_offset_conv1(offset))))
        return lrelu(self.cas_dcnpack(feat, offset))


def _max_pool(x):
    return F.max_pool2d(x, 3, 2, 1)          # pads with -inf


def _avg_pool(x):
    return F.avg_pool2d(x, 3, 2, 1)          # count_include_pad=True


class TSAFusion(nn.Module):
    """Temporal attention (each frame's embedding against the centre
    frame's, through a sigmoid), a 1x1 fusion over the frames' channels
    flattened t-major, and a two-level spatial attention (reference
    edvr_arch.py:104-211). Call ``aligned_feat (B, T, C, H, W)``; returns
    ``(B, C, H, W)``. H and W must be multiples of 4."""

    def __init__(self, num_feat=64, num_frame=5, center_frame_idx=2):
        super().__init__()
        nf = num_feat
        self.center_frame_idx = center_frame_idx
        self.temporal_attn1 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.temporal_attn2 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.feat_fusion = nn.Conv2d(num_frame * nf, nf, 1, 1)
        self.spatial_attn1 = nn.Conv2d(num_frame * nf, nf, 1)
        self.spatial_attn2 = nn.Conv2d(nf * 2, nf, 1)
        self.spatial_attn3 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.spatial_attn4 = nn.Conv2d(nf, nf, 1)
        self.spatial_attn5 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.spatial_attn_l1 = nn.Conv2d(nf, nf, 1)
        self.spatial_attn_l2 = nn.Conv2d(nf * 2, nf, 3, 1, 1)
        self.spatial_attn_l3 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.spatial_attn_add1 = nn.Conv2d(nf, nf, 1)
        self.spatial_attn_add2 = nn.Conv2d(nf, nf, 1)

    def forward(self, aligned_feat):
        b, t, c, h, w = aligned_feat.shape
        embedding_ref = self.temporal_attn1(
            aligned_feat[:, self.center_frame_idx])
        embedding = self.temporal_attn2(aligned_feat.reshape(-1, c, h, w))
        embedding = embedding.view(b, t, -1, h, w)
        corr = (embedding * embedding_ref[:, None]).sum(2)      # (b, t, h, w)
        aligned_feat = (aligned_feat * torch.sigmoid(corr)[:, :, None]) \
            .reshape(b, t * c, h, w)
        feat = lrelu(self.feat_fusion(aligned_feat))

        attn = lrelu(self.spatial_attn1(aligned_feat))
        attn = lrelu(self.spatial_attn2(torch.cat([_max_pool(attn),
                                                   _avg_pool(attn)], 1)))
        attn_level = lrelu(self.spatial_attn_l1(attn))
        attn_level = lrelu(self.spatial_attn_l2(torch.cat(
            [_max_pool(attn_level), _avg_pool(attn_level)], 1)))
        attn_level = _up2(lrelu(self.spatial_attn_l3(attn_level)))
        attn = lrelu(self.spatial_attn3(attn)) + attn_level
        attn = _up2(lrelu(self.spatial_attn4(attn)))
        attn = self.spatial_attn5(attn)
        attn_add = self.spatial_attn_add2(lrelu(self.spatial_attn_add1(attn)))
        return feat * torch.sigmoid(attn) * 2 + attn_add


class PredeblurModule(nn.Module):
    """Strided convs to three levels, residual blocks, and the coarse
    levels added back upsampled (reference edvr_arch.py:214-264). Call
    ``x (N, C, H, W)``; with ``hr_in`` two more stride-2 convs first."""

    def __init__(self, num_in_ch=3, num_feat=64, hr_in=False):
        super().__init__()
        nf = num_feat
        self.hr_in = hr_in
        self.conv_first = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        if hr_in:
            self.stride_conv_hr1 = nn.Conv2d(nf, nf, 3, 2, 1)
            self.stride_conv_hr2 = nn.Conv2d(nf, nf, 3, 2, 1)
        self.stride_conv_l2 = nn.Conv2d(nf, nf, 3, 2, 1)
        self.stride_conv_l3 = nn.Conv2d(nf, nf, 3, 2, 1)
        self.resblock_l3 = ResidualBlockNoBN(num_feat=nf)
        self.resblock_l2_1 = ResidualBlockNoBN(num_feat=nf)
        self.resblock_l2_2 = ResidualBlockNoBN(num_feat=nf)
        self.resblock_l1 = nn.ModuleList(
            [ResidualBlockNoBN(num_feat=nf) for _ in range(5)])

    def forward(self, x):
        feat_l1 = lrelu(self.conv_first(x))
        if self.hr_in:
            feat_l1 = lrelu(self.stride_conv_hr1(feat_l1))
            feat_l1 = lrelu(self.stride_conv_hr2(feat_l1))
        feat_l2 = lrelu(self.stride_conv_l2(feat_l1))
        feat_l3 = lrelu(self.stride_conv_l3(feat_l2))
        feat_l3 = _up2(self.resblock_l3(feat_l3))
        feat_l2 = self.resblock_l2_1(feat_l2) + feat_l3
        feat_l2 = _up2(self.resblock_l2_2(feat_l2))
        for block in self.resblock_l1[:2]:
            feat_l1 = block(feat_l1)
        feat_l1 = feat_l1 + feat_l2
        for block in self.resblock_l1[2:]:
            feat_l1 = block(feat_l1)
        return feat_l1


@ARCH_REGISTRY.register()
class EDVR(nn.Module):
    """Call ``x (B, T, 3, H, W)`` in [0, 1] (H, W multiples of 4, or of 16
    with ``hr_in``); returns the centre frame ``(B, 3, 4H, 4W)`` (``(B, 3,
    H, W)`` with ``hr_in``)."""

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_frame=5,
                 deformable_groups=8, num_extract_block=5,
                 num_reconstruct_block=10, center_frame_idx=None,
                 hr_in=False, with_predeblur=False, with_tsa=True):
        super().__init__()
        nf = num_feat
        self.center_frame_idx = (num_frame // 2 if center_frame_idx is None
                                 else center_frame_idx)
        self.hr_in = hr_in
        self.with_predeblur = with_predeblur
        self.with_tsa = with_tsa
        if with_predeblur:
            self.predeblur = PredeblurModule(num_feat=nf, hr_in=hr_in)
            self.conv_1x1 = nn.Conv2d(nf, nf, 1, 1)
        else:
            self.conv_first = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        self.feature_extraction = make_layer(ResidualBlockNoBN,
                                             num_extract_block, num_feat=nf)
        self.conv_l2_1 = nn.Conv2d(nf, nf, 3, 2, 1)
        self.conv_l2_2 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.conv_l3_1 = nn.Conv2d(nf, nf, 3, 2, 1)
        self.conv_l3_2 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.pcd_align = PCDAlignment(num_feat=nf,
                                      deformable_groups=deformable_groups)
        if with_tsa:
            self.fusion = TSAFusion(num_feat=nf, num_frame=num_frame,
                                    center_frame_idx=self.center_frame_idx)
        else:
            self.fusion = nn.Conv2d(num_frame * nf, nf, 1, 1)
        self.reconstruction = make_layer(ResidualBlockNoBN,
                                         num_reconstruct_block, num_feat=nf)
        self.upconv1 = nn.Conv2d(nf, nf * 4, 3, 1, 1)
        self.upconv2 = nn.Conv2d(nf, 64 * 4, 3, 1, 1)
        self.pixel_shuffle = nn.PixelShuffle(2)
        self.conv_hr = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv_last = nn.Conv2d(64, 3, 3, 1, 1)

    def init_weights(self, generator):
        default_init_(self, generator)

    def forward(self, x):
        b, t, c, h, w = x.shape
        m = 16 if self.hr_in else 4
        assert h % m == 0 and w % m == 0, (
            f'The height and width must be multiples of {m}, got {h}, {w}')
        x_center = x[:, self.center_frame_idx]
        flat = x.reshape(-1, c, h, w)
        if self.with_predeblur:
            feat_l1 = self.conv_1x1(self.predeblur(flat))
            if self.hr_in:
                h, w = h // 4, w // 4
        else:
            feat_l1 = lrelu(self.conv_first(flat))
        feat_l1 = self.feature_extraction(feat_l1)
        feat_l2 = lrelu(self.conv_l2_2(lrelu(self.conv_l2_1(feat_l1))))
        feat_l3 = lrelu(self.conv_l3_2(lrelu(self.conv_l3_1(feat_l2))))

        # frames folded into the batch, each beside the centre frame
        nbr = [feat_l1, feat_l2, feat_l3]
        ref = [f.view(b, t, *f.shape[1:])[:, self.center_frame_idx, None]
               .expand(b, t, *f.shape[1:]).reshape(f.shape) for f in nbr]
        aligned = self.pcd_align(nbr, ref).view(b, t, -1, h, w)

        if self.with_tsa:
            feat = self.fusion(aligned)
        else:
            feat = self.fusion(aligned.reshape(b, -1, h, w))
        out = self.reconstruction(feat)
        out = lrelu(self.pixel_shuffle(self.upconv1(out)))
        out = lrelu(self.pixel_shuffle(self.upconv2(out)))
        out = self.conv_last(lrelu(self.conv_hr(out)))
        base = x_center if self.hr_in else resize(x_center, scale_factor=4)
        return out + base


class EDVRFeatureExtractor(nn.Module):
    """IconVSR's keyframe features (JAX package edvr_arch.py:275-313, the
    reference's basicvsr_arch.py:273-336): EDVR's feature pyramid, PCD
    alignment (8 deform groups) of every frame against the centre frame,
    and TSA fusion. Call ``x (B, T, 3, H, W)`` with ``T ==
    num_input_frame`` and H, W multiples of 4; returns ``(B, C, H, W)``.
    As in :class:`EDVR`, the frames run folded into the batch through one
    PCD call (the JAX package calls it once a frame): each of its four
    deformable convs launches once for all ``B * T`` frames."""

    def __init__(self, num_input_frame, num_feat):
        super().__init__()
        nf = num_feat
        self.center_frame_idx = num_input_frame // 2
        self.conv_first = nn.Conv2d(3, nf, 3, 1, 1)
        self.feature_extraction = make_layer(ResidualBlockNoBN, 5,
                                             num_feat=nf)
        self.conv_l2_1 = nn.Conv2d(nf, nf, 3, 2, 1)
        self.conv_l2_2 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.conv_l3_1 = nn.Conv2d(nf, nf, 3, 2, 1)
        self.conv_l3_2 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.pcd_align = PCDAlignment(num_feat=nf, deformable_groups=8)
        self.fusion = TSAFusion(num_feat=nf, num_frame=num_input_frame,
                                center_frame_idx=self.center_frame_idx)

    def init_weights(self, generator):
        default_init_(self, generator)

    def forward(self, x):
        b, t, c, h, w = x.shape
        feat_l1 = self.feature_extraction(lrelu(self.conv_first(
            x.reshape(-1, c, h, w))))
        feat_l2 = lrelu(self.conv_l2_2(lrelu(self.conv_l2_1(feat_l1))))
        feat_l3 = lrelu(self.conv_l3_2(lrelu(self.conv_l3_1(feat_l2))))
        nbr = [feat_l1, feat_l2, feat_l3]
        ref = [f.view(b, t, *f.shape[1:])[:, self.center_frame_idx, None]
               .expand(b, t, *f.shape[1:]).reshape(f.shape) for f in nbr]
        return self.fusion(self.pcd_align(nbr, ref).view(b, t, -1, h, w))
