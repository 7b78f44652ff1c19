"""SwinIR, the shifted-window transformer for image restoration (port of
``mrefsr_tpu/archs/swinir_arch.py``, the reference's
basicsr/archs/swinir_arch.py:95-956). The convolutions run NCHW, the
transformer on token sequences (B, H * W, C); the reference's torch names
(``layers.{i}.residual_group.blocks.{j}.attn.qkv`` ...).

* **Attention** is written as the JAX package writes it: a matrix product,
  plus the relative-position bias, plus the shifted-window mask, a softmax
  in f32 and a second product. At bf16 the logits are the bf16 product
  widened to f32 (the JAX package keeps them f32 from its product). It is
  ``torch.matmul`` and the softmax, no kernel of this repository.
* **Buffers.** ``relative_position_index`` and each shifted block's
  ``attn_mask`` (for ``img_size``) are persistent buffers, so a reference
  ``.pth`` that carries them loads strictly; a file without them loads
  too, keeping the computed ones (``constant_buffers`` in
  ``models/base_model.py``). An input of another size gets its mask
  computed on the device for that size (and cached), as the JAX net
  recomputes it for each size.
* **Stochastic depth** (``drop_path_rate``, rising linearly over all the
  blocks): each block's attention and MLP branches are dropped per sample
  in training mode when :attr:`SwinIR.generator` holds a
  ``torch.Generator`` (``SRModel``'s step sets one, seeded by the step),
  and are the identity otherwise, as the JAX net drops them only when a
  ``droppath`` key is given. ``drop_rate`` and ``attn_drop_rate`` are
  accepted and, as in the JAX package, unused (SR configurations set 0).
"""
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import Upsample, normal_, resize, torch_default_init_
from .edsr_arch import MeanRange


def window_partition(x, window_size):
    """(B, H, W, C) -> (num_windows * B, ws, ws, C) (reference :60-74)."""
    b, h, w, c = x.shape
    x = x.view(b, h // window_size, window_size, w // window_size,
               window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size,
                                               c)


def window_reverse(windows, window_size, h, w):
    """The inverse of :func:`window_partition` (reference :77-92)."""
    b = windows.shape[0] // (h * w // window_size // window_size)
    x = windows.view(b, h // window_size, w // window_size, window_size,
                     window_size, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(window_size):
    """(ws^2, ws^2) index of each token pair's entry in the bias table
    (reference :122-134)."""
    coords = torch.stack(torch.meshgrid(torch.arange(window_size),
                                        torch.arange(window_size),
                                        indexing='ij')).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (window_size - 1)
    return rel[:, :, 0] * (2 * window_size - 1) + rel[:, :, 1]


def calculate_mask(h, w, window_size, shift_size, device=None):
    """The shifted-window attention mask (nW, ws^2, ws^2): 0 within a
    region of the rolled image, -100 across regions (reference
    calculate_mask :262-281)."""
    img_mask = torch.zeros((1, h, w, 1), device=device)
    cuts = (slice(0, -window_size), slice(-window_size, -shift_size),
            slice(-shift_size, None))
    cnt = 0
    for hs in cuts:
        for ws in cuts:
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    windows = window_partition(img_mask, window_size).view(
        -1, window_size * window_size)
    mask = windows[:, None, :] - windows[:, :, None]
    return torch.where(mask != 0, -100.0, 0.0)


@functools.lru_cache(maxsize=4)
def _mask_for(h, w, window_size, shift_size, device):
    return calculate_mask(h, w, window_size, shift_size, device)


def drop_path(x, p, generator, training):
    """Per-sample stochastic depth: each sample's ``x`` zeroed with
    probability ``p``, the rest divided by ``1 - p``, the draws from
    ``generator``; ``x`` itself outside training, without a generator or
    at ``p`` 0."""
    if p <= 0 or not training or generator is None:
        return x
    keep = 1.0 - p
    mask = torch.empty((x.shape[0],) + (1,) * (x.dim() - 1),
                       device=x.device).bernoulli_(keep, generator=generator)
    return x * mask.to(x.dtype) / keep


class Mlp(nn.Module):
    """Linear, exact GELU, linear."""

    def __init__(self, in_features, hidden_features):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden_features, in_features)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class WindowAttention(nn.Module):
    """Multi-head self-attention within a window, with a learned bias per
    relative position (reference :95-177). Call ``(x (B * nW, ws^2, C),
    mask (nW, ws^2, ws^2) or None)``."""

    def __init__(self, dim, window_size, num_heads, qkv_bias=True,
                 qk_scale=None):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer('relative_position_index',
                             relative_position_index(window_size))
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    @torch.no_grad()
    def reset_parameters_(self, generator):
        normal_(self.relative_position_bias_table, 0.02, generator)
        self.relative_position_index.copy_(
            relative_position_index(self.window_size))

    def forward(self, x, mask=None):
        b_, n, c = x.shape
        nh = self.num_heads
        q, k, v = self.qkv(x).reshape(b_, n, 3, nh, c // nh).permute(
            2, 0, 3, 1, 4).unbind(0)
        attn = torch.matmul(q * self.scale, k.transpose(-2, -1)).float()
        bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).float()[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.view(b_ // nw, nw, nh, n, n)
                    + mask.float()[None, :, None]).view(-1, nh, n, n)
        attn = attn.softmax(dim=-1).to(x.dtype)
        x = torch.matmul(attn, v).transpose(1, 2).reshape(b_, n, c)
        return self.proj(x)


class SwinTransformerBlock(nn.Module):
    """Norm, (shifted) window attention, residual; norm, MLP, residual
    (reference :194-328). A resolution no larger than the window takes one
    unshifted window of that size."""

    def __init__(self, dim, input_resolution, num_heads, window_size=7,
                 shift_size=0, mlp_ratio=4., qkv_bias=True, qk_scale=None,
                 drop_path=0.):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        if min(self.input_resolution) <= window_size:
            shift_size, window_size = 0, min(self.input_resolution)
        self.window_size, self.shift_size = window_size, shift_size
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias,
                                    qk_scale)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if shift_size > 0:
            self.register_buffer('attn_mask', calculate_mask(
                *self.input_resolution, window_size, shift_size))

    @torch.no_grad()
    def reset_parameters_(self, generator=None):
        if self.shift_size > 0:
            self.attn_mask.copy_(calculate_mask(
                *self.input_resolution, self.window_size, self.shift_size))

    def forward(self, x, x_size, generator=None):
        h, w = x_size
        b, _, c = x.shape
        ws, shift = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x).view(b, h, w, c)
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = self.attn_mask if tuple(x_size) == self.input_resolution \
                else _mask_for(h, w, ws, shift, x.device)
        windows = self.attn(window_partition(x, ws).view(-1, ws * ws, c),
                            mask)
        x = window_reverse(windows.view(-1, ws, ws, c), ws, h, w)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + drop_path(x.reshape(b, h * w, c), self.drop_path,
                                 generator, self.training)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path,
                             generator, self.training)


class BasicLayer(nn.Module):
    """``depth`` blocks, every other one shifted by half a window
    (reference :395-478)."""

    def __init__(self, dim, input_resolution, depth, num_heads, window_size,
                 mlp_ratio=4., qkv_bias=True, qk_scale=None, drop_path=()):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, input_resolution, num_heads,
                                 window_size,
                                 0 if i % 2 == 0 else window_size // 2,
                                 mlp_ratio, qkv_bias, qk_scale,
                                 drop_path[i] if drop_path else 0.)
            for i in range(depth))

    def forward(self, x, x_size, generator=None):
        for block in self.blocks:
            x = block(x, x_size, generator)
        return x


class RSTB(nn.Module):
    """Residual Swin transformer block: a :class:`BasicLayer`, then one conv
    (``1conv``) or three (``3conv``: 3x3, 1x1, 3x3 at a quarter of the
    width, leaky ReLUs 0.2 between) on the image, plus the input
    (reference :480-568)."""

    def __init__(self, dim, input_resolution, depth, num_heads, window_size,
                 mlp_ratio=4., qkv_bias=True, qk_scale=None, drop_path=(),
                 resi_connection='1conv'):
        super().__init__()
        self.residual_group = BasicLayer(dim, input_resolution, depth,
                                         num_heads, window_size, mlp_ratio,
                                         qkv_bias, qk_scale, drop_path)
        self.conv = _resi_conv(dim, resi_connection)

    def forward(self, x, x_size, generator=None):
        h, w = x_size
        b, _, c = x.shape
        img = self.residual_group(x, x_size, generator).transpose(1, 2)
        img = self.conv(img.reshape(b, c, h, w))
        return img.flatten(2).transpose(1, 2) + x


def _resi_conv(dim, resi_connection):
    if resi_connection == '1conv':
        return nn.Conv2d(dim, dim, 3, 1, 1)
    if resi_connection == '3conv':
        return nn.Sequential(
            nn.Conv2d(dim, dim // 4, 3, 1, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(dim // 4, dim // 4, 1, 1, 0), nn.LeakyReLU(0.2),
            nn.Conv2d(dim // 4, dim, 3, 1, 1))
    raise ValueError(f'resi_connection {resi_connection!r} is not 1conv or '
                     '3conv')


class PatchEmbed(nn.Module):
    """Holds the patch norm at ``patch_embed.norm`` as the reference's
    state dict does."""

    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(dim)


@ARCH_REGISTRY.register()
class SwinIR(MeanRange):
    """A conv, the RSTB stages (patch norm, absolute position embedding
    with ``ape``, a final norm), a conv and the skip, then the
    ``upsampler``: 'pixelshuffle' (a conv, leaky ReLU 0.01, conv + pixel
    shuffle steps, a conv), 'pixelshuffledirect' (one conv and a shuffle),
    'nearest+conv' (x4: two nearest x2 upsamples, each with a conv) or ''
    (denoising and JPEG artefact removal: a conv added to the input)
    (reference :694-936). Call ``x (B, in_chans, H, W)`` in [0, 1], H and
    W multiples of ``window_size``."""

    def __init__(self, img_size=64, patch_size=1, in_chans=3, embed_dim=96,
                 depths=(6, 6, 6, 6), num_heads=(6, 6, 6, 6), window_size=7,
                 mlp_ratio=4., qkv_bias=True, qk_scale=None, drop_rate=0.,
                 attn_drop_rate=0., drop_path_rate=0.1, ape=False,
                 patch_norm=True, use_checkpoint=False, upscale=2,
                 img_range=1., upsampler='', resi_connection='1conv'):
        super().__init__(img_range, (0.4488, 0.4371, 0.4040)
                         if in_chans == 3 else (0.,))
        num_feat = 64
        self.upscale, self.upsampler = upscale, upsampler
        self.ape, self.patch_norm = ape, patch_norm
        self.drop_path_rate = drop_path_rate
        # the step's drop-path generator (module docstring)
        self.generator = None
        size = (img_size, img_size) if isinstance(img_size, int) \
            else tuple(img_size)
        resolution = (size[0] // patch_size, size[1] // patch_size)
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, 1, 1)
        if patch_norm:
            self.patch_embed = PatchEmbed(embed_dim)
        if ape:
            self.absolute_pos_embed = nn.Parameter(
                torch.empty(1, resolution[0] * resolution[1], embed_dim))
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList(
            RSTB(embed_dim, resolution, depths[i], num_heads[i], window_size,
                 mlp_ratio, qkv_bias, qk_scale,
                 tuple(dpr[sum(depths[:i]):sum(depths[:i + 1])]),
                 resi_connection)
            for i in range(len(depths)))
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = _resi_conv(embed_dim, resi_connection)
        if upsampler == 'pixelshuffle':
            self.conv_before_upsample = nn.Sequential(
                nn.Conv2d(embed_dim, num_feat, 3, 1, 1), nn.LeakyReLU(0.01))
            self.upsample = Upsample(upscale, num_feat)
            self.conv_last = nn.Conv2d(num_feat, in_chans, 3, 1, 1)
        elif upsampler == 'pixelshuffledirect':
            self.upsample = nn.Sequential(
                nn.Conv2d(embed_dim, in_chans * upscale ** 2, 3, 1, 1),
                nn.PixelShuffle(upscale))
        elif upsampler == 'nearest+conv':
            if upscale != 4:
                raise ValueError('nearest+conv only supports x4')
            self.conv_before_upsample = nn.Sequential(
                nn.Conv2d(embed_dim, num_feat, 3, 1, 1), nn.LeakyReLU(0.01))
            self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            self.conv_last = nn.Conv2d(num_feat, in_chans, 3, 1, 1)
        elif upsampler == '':
            self.conv_last = nn.Conv2d(embed_dim, in_chans, 3, 1, 1)
        else:
            raise ValueError(f'upsampler {upsampler!r} is not supported')

    def init_weights(self, generator):
        """The reference's ``_init_weights``: linears N(0, 0.02) (its
        ``trunc_normal_`` cuts at +-2, a hundred deviations out) with zero
        biases, norms at 1 and 0, the bias tables and ``ape`` N(0, 0.02);
        convs torch's default; the buffers and the mean."""
        torch_default_init_(self, generator, (nn.Conv2d,))
        for m in self.modules():
            if isinstance(m, nn.Linear):
                normal_(m.weight, 0.02, generator)
                if m.bias is not None:
                    m.bias.detach().zero_()
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, (WindowAttention, SwinTransformerBlock)):
                m.reset_parameters_(generator)
        if self.ape:
            normal_(self.absolute_pos_embed, 0.02, generator)
        self.reset_parameters_()

    def forward_features(self, x):
        b, c, h, w = x.shape
        seq = x.flatten(2).transpose(1, 2)
        if self.patch_norm:
            seq = self.patch_embed.norm(seq)
        if self.ape:
            seq = seq + self.absolute_pos_embed
        for layer in self.layers:
            seq = layer(seq, (h, w), self.generator)
        return self.norm(seq).transpose(1, 2).reshape(b, c, h, w)

    def forward(self, x):
        x = self.normalise(x)
        if self.upsampler == '':
            first = self.conv_first(x)
            res = self.conv_after_body(self.forward_features(first)) + first
            return self.restore(x + self.conv_last(res))
        x = self.conv_first(x)
        x = self.conv_after_body(self.forward_features(x)) + x
        if self.upsampler == 'pixelshuffle':
            x = self.conv_last(self.upsample(self.conv_before_upsample(x)))
        elif self.upsampler == 'pixelshuffledirect':
            x = self.upsample(x)
        else:
            x = self.conv_before_upsample(x)
            x = F.leaky_relu(self.conv_up1(resize(x, 2, mode='nearest')), 0.2)
            x = F.leaky_relu(self.conv_up2(resize(x, 2, mode='nearest')), 0.2)
            x = self.conv_last(F.leaky_relu(self.conv_hr(x), 0.2))
        return self.restore(x)
