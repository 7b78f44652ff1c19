"""DFDNet, face restoration by a facial-component dictionary (port of
``mrefsr_tpu/archs/dfdnet_arch.py``, the reference's
basicsr/archs/dfdnet_arch.py), NCHW, batch 1, inference only.

The JAX package keeps its shapes static under ``jit``: it samples a part's
box at the dictionary's size by coordinates, pastes the chosen atom back
through an inverse nearest warp and runs the part's attention convs on the
whole map under the box's mask. This eager port takes each box as host
integers and works on the box alone, with the JAX package's arithmetic, so
its result is the same, edges included:

* :func:`crop_resize_bilinear` samples at the JAX package's half-pixel
  coordinates, the corners clamped to the box, then to the map;
* :func:`paste_indices` maps the box's pixels to the atom's by torch's
  legacy ``floor(dst * in / out)``, in f32, from the box's own corner;
* the attention convs run on the part of the box inside the map with zero
  padding, which is what the masked full-map convs compute there.
"""
import torch
from torch import nn

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import SNConv2d, resize
from .dfdnet_util import (MSDilationBlock, UpResBlock,
                          adaptive_instance_normalization, blur)
from .hifacegan_util import torch_default_sn_init_
from .vgg_arch import VGGFeatureExtractor

PARTS = ('left_eye', 'right_eye', 'nose', 'mouth')
FEATURE_SIZES = (256, 128, 64, 32)
CHANNEL_SIZES = (128, 256, 512, 512)
VGG_LAYERS = ('relu2_2', 'relu3_4', 'relu4_4', 'conv5_4')


def _f32_ratio(num, den):
    """``num / den`` as one f32 value."""
    return torch.tensor(num, dtype=torch.float32) \
        / torch.tensor(den, dtype=torch.float32)


def crop_resize_bilinear(x, box, out_size):
    """The ``box`` (y0, x0, y1, x1; host integers) of NCHW ``x`` sampled at
    ``out_size``: bilinear at half-pixel centres, as ``F.interpolate`` of
    the crop with ``align_corners=False`` where the box lies inside the
    map; the JAX package's ``crop_resize_bilinear`` everywhere (corners
    clamped to the box, then to the map)."""
    y0, x0, y1, x1 = box
    h, w = x.shape[-2:]
    taps = []
    for start, length, out, size in ((y0, y1 - y0, out_size[0], h),
                                      (x0, x1 - x0, out_size[1], w)):
        src = (torch.arange(out, dtype=torch.float32) + 0.5) \
            * _f32_ratio(length, out) - 0.5
        i0 = torch.floor(src)
        lo = (i0.long().clamp(0, length - 1) + start).clamp(0, size - 1)
        hi = ((i0.long() + 1).clamp(0, length - 1) + start).clamp(0, size - 1)
        taps.append((lo.to(x.device), hi.to(x.device),
                     (src - i0).to(device=x.device, dtype=x.dtype)))
    (ry0, ry1, wy), (rx0, rx1, wx) = taps
    wy, wx = wy[:, None], wx[None, :]

    def row(idx):
        rows = x[:, :, idx]
        return rows[..., rx0] * (1 - wx) + rows[..., rx1] * wx

    return row(ry0) * (1 - wy) + row(ry1) * wy


def paste_indices(box, atom_hw, full_hw):
    """Where the atom lands: the part of ``box`` inside the map, as the
    slices ``(rows, cols)``, and for each of its rows and columns the
    atom's row and column (torch's legacy nearest, ``floor((dst - start) *
    atom / box)`` in f32, from the box's own corner). None where that part
    is empty."""
    y0, x0, y1, x1 = box
    out = []
    for start, stop, atom, size in ((y0, y1, atom_hw[0], full_hw[0]),
                                    (x0, x1, atom_hw[1], full_hw[1])):
        lo, hi = max(start, 0), min(stop, size)
        if hi <= lo:
            return None
        idx = ((torch.arange(lo, hi) - start).float()
               * _f32_ratio(atom, stop - start)).long().clamp(0, atom - 1)
        out.append((slice(lo, hi), idx))
    return out


def paste_nearest(atom, box, full_hw):
    """``atom`` (C, h, w) pasted by :func:`paste_indices` into the ``box``
    of a zero (1, C, H, W) map of ``full_hw``; returns the map and the
    (1, 1, H, W) mask of the pasted pixels (the JAX package's
    dfdnet_arch.py:74)."""
    full = atom.new_zeros((1, atom.shape[0], *full_hw))
    mask = atom.new_zeros((1, 1, *full_hw))
    where = paste_indices(box, atom.shape[-2:], full_hw)
    if where is not None:
        (rows, iy), (cols, ix) = where
        full[0, :, rows, cols] = atom[:, iy.to(atom.device)][
            :, :, ix.to(atom.device)]
        mask[..., rows, cols] = 1
    return full, mask


def load_dfdnet_dict(dict_path, device='cpu'):
    """The facial-component dictionary (``DictionaryCenter512.pth``):
    ``{'256': {'left_eye': (K, C, h, w), ...}, ...}`` as float32 tensors on
    ``device``."""
    raw = torch.load(dict_path, map_location='cpu', weights_only=True)
    return {size: {part: torch.as_tensor(atoms, dtype=torch.float32)
                   .to(device) for part, atoms in parts.items()}
            for size, parts in raw.items()}


def _sn_pair(in_channel, out_channel):
    """Spectral-norm 3x3 conv, LeakyReLU(0.2), spectral-norm 3x3 conv: the
    attention blocks and SFT's scale and shift blocks."""
    return nn.Sequential(SNConv2d(in_channel, out_channel, 3, 1, 1),
                         nn.LeakyReLU(0.2),
                         SNConv2d(out_channel, out_channel, 3, 1, 1))


class SFTUpBlock(nn.Module):
    """Blur, spectral-norm conv, LeakyReLU(0.04); then ``* scale + shift``
    from the updated VGG features (the shift through a sigmoid), a 2x
    bilinear upsampling, a spectral-norm conv and LeakyReLU(0.2)
    (reference dfdnet_arch.py:12-54)."""

    def __init__(self, in_channel, out_channel, kernel_size=3, padding=1):
        super().__init__()
        # index 0 of conv1 and convup is the reference's blur and
        # upsampling, which forward applies (no parameters)
        self.conv1 = nn.Sequential(
            nn.Identity(), SNConv2d(in_channel, out_channel, kernel_size,
                                    padding=padding), nn.LeakyReLU(0.04))
        self.convup = nn.Sequential(
            nn.Identity(), SNConv2d(out_channel, out_channel, kernel_size,
                                    padding=padding), nn.LeakyReLU(0.2))
        self.scale_block = _sn_pair(in_channel, out_channel)
        self.shift_block = _sn_pair(in_channel, out_channel)

    def forward(self, x, updated_feat):
        out = self.conv1(blur(x))
        scale = self.scale_block(updated_feat)
        shift = torch.sigmoid(self.shift_block(updated_feat))
        out = out * scale + shift
        return self.convup(resize(out, scale_factor=2))


@ARCH_REGISTRY.register()
class DFDNet(nn.Module):
    """DFDNet (reference dfdnet_arch.py:57-169). Call with an NCHW 512x512
    face in [-1, 1] (batch 1), the four parts' boxes (a list of (B, 4)
    xyxy integer arrays in 512-space, left eye, right eye, nose, mouth)
    and the dictionary of :func:`load_dfdnet_dict`. ``dict_path`` is kept
    for the options; the dictionary is an argument of the call."""

    def __init__(self, num_feat=64, dict_path=None):
        super().__init__()
        self.dict_path = dict_path
        self.vgg_extractor = VGGFeatureExtractor(
            layer_name_list=list(VGG_LAYERS), vgg_type='vgg19',
            use_input_norm=True, range_norm=True)
        self.attn_blocks = nn.ModuleDict(
            {f'{part}_{size}': _sn_pair(channels, channels)
             for part in PARTS
             for size, channels in zip(FEATURE_SIZES, CHANNEL_SIZES)})
        self.multi_scale_dilation = MSDilationBlock(num_feat * 8,
                                                    dilation=(4, 3, 2, 1))
        self.upsample0 = SFTUpBlock(num_feat * 8, num_feat * 8)
        self.upsample1 = SFTUpBlock(num_feat * 8, num_feat * 4)
        self.upsample2 = SFTUpBlock(num_feat * 4, num_feat * 2)
        self.upsample3 = SFTUpBlock(num_feat * 2, num_feat)
        self.upsample4 = nn.Sequential(
            SNConv2d(num_feat, num_feat, 3, 1, 1), nn.LeakyReLU(0.2),
            UpResBlock(num_feat), UpResBlock(num_feat),
            nn.Conv2d(num_feat, 3, 3, 1, 1), nn.Tanh())

    @torch.no_grad()
    def init_weights(self, generator):
        """torch's default convs and normalised ``u`` / ``v`` (seeded),
        then the VGG tower's seeded stand-in (N(0, 1/fan_in))."""
        torch_default_sn_init_(self, generator)
        self.vgg_extractor.init_weights(generator)

    def swap_feat(self, vgg_feat, updated_feat, dict_feat, location,
                  part_name, f_size):
        """The part's features swapped for their nearest dictionary atom
        (reference dfdnet_arch.py:107-126): the box sampled at the atoms'
        size, the atoms re-styled to it (AdaIN), the atom of the largest
        softmaxed correlation pasted back by nearest, and ``attn * atom +
        part`` written into ``updated_feat`` inside the box (module
        docstring). ``location`` is (x0, y0, x1, y1) at this scale."""
        x0, y0, x1, y1 = (int(v) for v in location)
        box = (y0, x0, y1, x1)
        where = paste_indices(box, dict_feat.shape[-2:], vgg_feat.shape[-2:])
        if where is None:
            return updated_feat
        part_resize = crop_resize_bilinear(vgg_feat, box,
                                           dict_feat.shape[-2:])
        dict_feat = adaptive_instance_normalization(dict_feat, part_resize)
        sim = torch.einsum('chw,kchw->k', part_resize[0], dict_feat)
        atom = dict_feat[torch.softmax(sim, 0).argmax()]
        (rows, iy), (cols, ix) = where
        swap = atom[:, iy.to(atom.device)][:, :, ix.to(atom.device)][None]
        part = vgg_feat[:, :, rows, cols]
        attn = self.attn_blocks[f'{part_name}_{f_size}'](swap - part)
        updated_feat = updated_feat.clone()
        updated_feat[:, :, rows, cols] = attn * swap + part
        return updated_feat

    def forward(self, x, part_locations, face_dict):
        if x.shape[0] != 1:
            raise ValueError('DFDNet takes batch 1 only, got '
                             f'{tuple(x.shape)}')
        vgg_features = self.vgg_extractor(x)
        updated = []
        for vgg_layer, f_size in zip(VGG_LAYERS, FEATURE_SIZES):
            dict_features = face_dict[f'{f_size}']
            vgg_feat = vgg_features[vgg_layer]
            updated_feat = vgg_feat
            for part_idx, part_name in enumerate(PARTS):
                location = [int(v) // (512 // f_size)
                            for v in part_locations[part_idx][0]]
                updated_feat = self.swap_feat(
                    vgg_feat, updated_feat, dict_features[part_name],
                    location, part_name, f_size)
            updated.append(updated_feat)
        feat = self.multi_scale_dilation(vgg_features['conv5_4'])
        feat = self.upsample0(feat, updated[3])
        feat = self.upsample1(feat, updated[2])
        feat = self.upsample2(feat, updated[1])
        feat = self.upsample3(feat, updated[0])
        return self.upsample4(feat)
