"""MRAPA multi-reference restoration network
(port of ``mrefsr_tpu/archs/ref_mrapa_restoration_arch.py``).

An SRNTT-style 3-scale decoder: at each VGG level (relu3_1 256 ch,
relu2_1 128 ch, relu1_1 64 ch) every ref is aligned by a DynAgg
deformable conv seeded with the match pre-offsets (or, with
``alignment='flow'``, by a FlowAgg warp seeded with their centre tap), the
T aligned refs are fused by per-pixel attention (MRAPAFusion), and a x2
pixel shuffle moves between scales; a bilinear x4 residual closes the net.

The alignment parameters are shared across refs, so the T refs run
folded into the batch (the JAX package scans over them to bound XLA's
memory). Activations are NCHW; the DCN op takes the free NHWC view of a
channels-last tensor.
"""
import torch
from torch import nn

from mrefsr_tpu_torch.ops import (deform_sample, modulated_deform_conv2d,
                                  offset_mask_from_conv_out)
from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import (ResidualBlockNoBN, lrelu, make_layer, normal_,
                        srntt_normal_init_)


def _channels_last(x):
    return x.contiguous(memory_format=torch.channels_last)


class DynAgg(nn.Module):
    """Deformable aggregation seeded with precomputed offsets (reference
    ref_mrapa_restoration_arch.py:11-76).

    Call ``(x, feat, pre_offset)``: ``x`` (N, C, H, W) is the ref feature
    to sample, ``feat`` (N, C, H, W) drives ``conv_offset_mask``, and
    ``pre_offset`` is (N, H, W, 9, 2) with last dim (x, y). ``groups > 1``
    splits the conv's channels into groups (weight ``(out, in // groups,
    k, k)``, as the JAX module's ``(k, k, in // groups, out)`` kernel).
    """

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, dilation=1, groups=1, deform_groups=8):
        super().__init__()
        k = kernel_size
        self.kernel_size = k
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.deform_groups = deform_groups
        self.conv_offset_mask = nn.Conv2d(in_channels,
                                          deform_groups * 3 * k * k, k,
                                          stride, padding)
        self.weight = nn.Parameter(torch.empty(out_channels,
                                               in_channels // groups, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x, feat, pre_offset):
        k = self.kernel_size
        out = self.conv_offset_mask(feat).permute(0, 2, 3, 1)
        offset, mask = offset_mask_from_conv_out(out, self.deform_groups,
                                                 (k, k))
        mask = torch.sigmoid(mask)
        # seed with the pre-offsets: (x, y) -> (dy, dx), broadcast over
        # the deform groups (reference :59-66)
        offset = offset + pre_offset.flip(-1)[:, :, :, None]
        out = modulated_deform_conv2d(
            x.permute(0, 2, 3, 1), offset, mask,
            self.weight.permute(2, 3, 1, 0), self.bias, stride=self.stride,
            padding=self.padding, dilation=self.dilation, groups=self.groups,
            deform_groups=self.deform_groups)
        return out.permute(0, 3, 1, 2)


class FlowAgg(nn.Module):
    """Flow-warp aggregation, the alternative to DynAgg (JAX package
    ref_mrapa_restoration_arch.py:101-145). Same call ``(x, feat,
    pre_offset)``: ``conv_flow_gate`` predicts one flow residual (dy, dx)
    and one gate per pixel and deform group from ``feat``; the flow is
    seeded with the centre tap of ``pre_offset``; ``x`` is warped by one
    grouped bilinear sample (``ops.deform_sample``), gated per group, and
    passed through a dense 3x3 conv.

    Its parameters are not the reference's DynAgg ones:
    ``convert.dcn_to_flow_state_dict`` warm-starts them from a DCN
    checkpoint.
    """

    def __init__(self, in_channels, out_channels, deform_groups=8):
        super().__init__()
        self.deform_groups = deform_groups
        self.conv_flow_gate = nn.Conv2d(in_channels, deform_groups * 3, 3,
                                        1, 1)
        self.conv_after_warp = nn.Conv2d(in_channels, out_channels, 3, 1, 1)

    def forward(self, x, feat, pre_offset):
        dg = self.deform_groups
        n, c, h, w = x.shape
        head = self.conv_flow_gate(feat).permute(0, 2, 3, 1)
        gate = torch.sigmoid(head[..., dg * 2:])             # (N, H, W, dg)
        # seed with the centre tap (4 of the 9 row-major taps),
        # (x, y) -> (dy, dx), broadcast over the deform groups
        flow = head[..., :dg * 2].reshape(n, h, w, dg, 2) \
            + pre_offset[:, :, :, 4].flip(-1)[:, :, :, None]
        warped = deform_sample(x.permute(0, 2, 3, 1), flow)  # (N, H, W, C)
        warped = (warped.reshape(n, h, w, dg, c // dg)
                  * gate[..., None]).reshape(n, h, w, c)
        return self.conv_after_warp(warped.permute(0, 3, 1, 2))


class ContentExtractor(nn.Module):
    """LR content tower: conv + n residual blocks (reference :79-98)."""

    def __init__(self, nf=64, n_blocks=16):
        super().__init__()
        self.conv_first = nn.Conv2d(3, nf, 3, 1, 1)
        self.body = make_layer(ResidualBlockNoBN, n_blocks, num_feat=nf)

    def forward(self, x):
        return self.body(lrelu(self.conv_first(x)))


class MRAPAFusion(nn.Module):
    """Relevance-embedded per-pixel attention over T aligned refs, then
    spatial attention (reference :262-348).

    Call ``(target (B, nf, H, W), refs (B, T, ref_nf, H, W))``.
    """

    def __init__(self, nf=64, ref_nf=256):
        super().__init__()
        c = ref_nf
        self.channels = c
        self.conv_emb1 = nn.Sequential(nn.Conv2d(nf, c, 1), nn.PReLU())
        self.conv_emb2 = nn.Sequential(nn.Conv2d(c, c, 3, 1, 1), nn.PReLU())
        self.conv_ass = nn.Conv2d(c, 2 * c, 3, 1, 1)
        self.spatial_attn = nn.Conv2d(nf + 2 * c, 2 * c, 1)
        self.spatial_attn_mul1 = nn.Conv2d(2 * c, 2 * c, 3, 1, 1)
        self.spatial_attn_mul2 = nn.Conv2d(2 * c, 2 * c, 3, 1, 1)
        self.spatial_attn_add1 = nn.Conv2d(2 * c, 2 * c, 3, 1, 1)
        self.spatial_attn_add2 = nn.Conv2d(2 * c, 2 * c, 3, 1, 1)
        self.feat_fusion = nn.Conv2d(nf + 2 * c, nf, 1)

    def forward(self, target, refs):
        b, t = refs.shape[:2]
        h_input, w_input = target.shape[-2:]
        refs_flat = refs.flatten(0, 1)
        # reflect-pad H, W to a multiple of 4 (reference :306-311)
        pad_h = (4 - h_input % 4) % 4
        pad_w = (4 - w_input % 4) % 4
        if pad_h or pad_w:
            pad = (0, pad_w, 0, pad_h)
            target = nn.functional.pad(target, pad, mode='reflect')
            refs_flat = nn.functional.pad(refs_flat, pad, mode='reflect')

        emb_t = self.conv_emb1(target) * (self.channels ** -0.5)
        emb_r = self.conv_emb2(refs_flat).unflatten(0, (b, t))
        ass = self.conv_ass(refs_flat).unflatten(0, (b, t))
        corr = (emb_t.unsqueeze(1) * emb_r).sum(2)           # (B, T, H, W)
        corr = torch.softmax(corr.float(), dim=1).to(target.dtype)
        fused = (corr.unsqueeze(2) * ass).sum(1)             # (B, 2C, H, W)

        # spatial attention (reference :337-344)
        attn = lrelu(self.spatial_attn(torch.cat([target, fused], 1)))
        attn_mul = self.spatial_attn_mul2(lrelu(self.spatial_attn_mul1(attn)))
        attn_add = self.spatial_attn_add2(lrelu(self.spatial_attn_add1(attn)))
        # *2 keeps the post-init expectation near 1 (reference :343)
        fused = fused * torch.sigmoid(attn_mul) * 2 + attn_add

        feat = lrelu(self.feat_fusion(torch.cat([target, fused], 1)))
        return feat[:, :, :h_input, :w_input]


class DynamicAggregationRestoration(nn.Module):
    """The 3-scale decoder (reference :140-259). Per scale ``p`` in
    small / medium / large: offset convs -> DynAgg (``p_dyn_agg``) or,
    with ``alignment='flow'``, FlowAgg (``p_flow_agg``) per ref ->
    MRAPAFusion -> residual blocks -> tail.

    Call ``(x (B, ngf, h, w), pre_offset {level: (B, T, H, W, 9, 2)},
    img_ref_feat {level: (B, T, C, H, W)})``.
    """

    _SCALES = (('small', 'relu3_1', 256), ('medium', 'relu2_1', 128),
               ('large', 'relu1_1', 64))

    def __init__(self, ngf=64, n_blocks=16, groups=8, alignment='dcn'):
        super().__init__()
        if alignment not in ('dcn', 'flow'):
            raise ValueError(f"alignment is 'dcn' or 'flow', got "
                             f'{alignment!r}')
        self._agg = 'flow_agg' if alignment == 'flow' else 'dyn_agg'
        for p, _, ref_nf in self._SCALES:
            setattr(self, f'{p}_offset_conv1',
                    nn.Conv2d(ngf + ref_nf, ref_nf, 3, 1, 1))
            setattr(self, f'{p}_offset_conv2',
                    nn.Conv2d(ref_nf, ref_nf, 3, 1, 1))
            if alignment == 'flow':
                agg = FlowAgg(ref_nf, ref_nf, deform_groups=groups)
            else:
                agg = DynAgg(ref_nf, ref_nf, 3, deform_groups=groups)
            setattr(self, f'{p}_{self._agg}', agg)
            setattr(self, f'head_{p}', MRAPAFusion(nf=ngf, ref_nf=ref_nf))
            setattr(self, f'body_{p}',
                    make_layer(ResidualBlockNoBN, n_blocks, num_feat=ngf))
        self.tail_small = nn.Sequential(nn.Conv2d(ngf, ngf * 4, 3, 1, 1))
        self.tail_medium = nn.Sequential(nn.Conv2d(ngf, ngf * 4, 3, 1, 1))
        self.tail_large = nn.Sequential(
            nn.Conv2d(ngf, ngf // 2, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(ngf // 2, 3, 3, 1, 1))

    def _stage(self, p, x, pre_offset, ref_feat):
        b, t = ref_feat.shape[:2]
        refs = ref_feat.flatten(0, 1)                        # (B*T, C, H, W)
        x_t = x.unsqueeze(1).expand(-1, t, -1, -1, -1).flatten(0, 1)
        off = torch.cat([x_t, refs], 1)
        off = lrelu(getattr(self, f'{p}_offset_conv1')(off))
        off = lrelu(getattr(self, f'{p}_offset_conv2')(off))
        swapped = lrelu(getattr(self, f'{p}_{self._agg}')(
            refs, off, pre_offset.flatten(0, 1)))
        h = getattr(self, f'head_{p}')(x, swapped.unflatten(0, (b, t)))
        h = getattr(self, f'body_{p}')(h) + x
        h = getattr(self, f'tail_{p}')(h)
        if p == 'large':
            return h
        return _channels_last(lrelu(nn.functional.pixel_shuffle(h, 2)))

    def forward(self, x, pre_offset, img_ref_feat):
        for p, level, _ in self._SCALES:
            x = self._stage(p, x, pre_offset[level], img_ref_feat[level])
        return x


@ARCH_REGISTRY.register()
class MRAPARestorationNet(nn.Module):
    """The LMR 5-ref restoration net (reference :102-137).

    Call ``(x (B, 3, h, w) LR input, pre_offset {level: (B, T, H, W, 9, 2)},
    img_ref_feat {level: (B, T, C, H, W)})``; returns (B, 3, 4h, 4w).

    ``alignment`` is ``'dcn'`` (DynAgg, loads the reference's
    checkpoints) or ``'flow'`` (FlowAgg). ``ref_unroll``,
    ``dcn_outer_remat`` and ``fusion_remat`` shape only how XLA holds the
    JAX package's memory; they are accepted and ignored here.
    """

    def __init__(self, ngf=64, n_blocks=16, groups=8, ref_unroll=1,
                 dcn_outer_remat=False, fusion_remat=False, alignment='dcn'):
        super().__init__()
        self.content_extractor = ContentExtractor(ngf, n_blocks)
        self.dyn_agg_restore = DynamicAggregationRestoration(
            ngf, n_blocks, groups, alignment)

    def forward(self, x, pre_offset, img_ref_feat):
        base = nn.functional.interpolate(x, scale_factor=4, mode='bilinear',
                                         align_corners=False)
        content_feat = self.content_extractor(x)
        return self.dyn_agg_restore(content_feat, pre_offset,
                                    img_ref_feat) + base

    @torch.no_grad()
    def init_weights(self, generator):
        """The reference's init: N(0, 0.02) for every conv and DynAgg
        weight, zero biases, PReLU 0.25, and zero ``conv_offset_mask``
        and ``conv_flow_gate`` (``re_init_dcn_offset``: sampling starts at
        the pre-offsets)."""
        srntt_normal_init_(self, generator)
        for m in self.modules():
            if isinstance(m, DynAgg):
                normal_(m.weight, 0.02, generator)
                m.bias.zero_()
                m.conv_offset_mask.weight.zero_()
                m.conv_offset_mask.bias.zero_()
            elif isinstance(m, FlowAgg):
                m.conv_flow_gate.weight.zero_()
                m.conv_flow_gate.bias.zero_()
